// The matrix-product four-step passes on Hopper's int8 tensor cores (M1).
//
// Counterpart of agilex_ntt_tpu/ops/mxu_ntt.py: _digit_matmul (:149) and
// its callers fwd_ntt_fourstep_mxu and fwd_col_pass_mxu.  The JAX module is
// plain jnp and dot_general, so M1 replaces no Pallas kernel.  It is ported
// because the card's int8 tensor cores (1,979 TOPS dense) run about 59
// times its int32 lanes, where the TPU measured the matrix form at 0.18 to
// 0.22 of its vector path.  Nothing dispatches to it, as in the JAX package.
//
// Both passes are one product C = A B mod q with the constant DFT matrix as
// A (M x K, M = K = the size of the pass's transforms) and the data as B
// (K x N):
//   column pass: A = D (n1 x n1), B[r, (b, c)] = X[b, r, c], N = B n2;
//                C[k, (b, c)] is written to G[b, k, c];
//   row pass:    A = R (n2 x n2), B[c, (b, r)] = T[r, c] G[b, r, c] mod q,
//                N = B n1; C[p, (b, r)] is written to H[b, r, p].
// As on the TPU's matrix unit, the mod-q product is built from int8 digits.
// A is split on the host into its four balanced signed base-256 digits A_i,
// A = sum_i 256^i A_i.  The data are taken at two powers, B^(0) = B and
// B^(1) = 2^16 B mod q, each split into its digits B^(p)_j.  Then
// A B = (A_0 + 256 A_1) B + (A_2 + 256 A_3) 2^16 B is congruent to
// sum_s 256^s P_s with the five partials
//   P_s = sum_{u + j = s} (A_u B^(0)_j + A_(2 + u) B^(1)_j),  u < 2,
// 16 digit products (as the JAX package's seven partials take), exact in
// s32: |P_s| <= 4 K 2^14 = 2^27 at K = 2048.  The epilogue writes
// sum_s P_s (256^s mod q) mod q once, in int64 (mxu_reduce).  The result in
// [0, q) is unique, so every word equals the JAX package's Horner
// reconstruction of its seven partials.  kMxuPowers generalises this (one
// power: the seven partials; four: four partials, 16 planes of B); two is
// the balance on this card: seven partials would take 224 accumulator
// registers a thread at a 64-column tile, four cost the converter three
// Shoup products and 16 planes a word (a pass at 2^16 took 0.50 ms against
// two powers' 0.41 in turns, PERF.md).  Splitting A^(j) = 256^j A mod q on
// the host instead would read 16 planes of A a tile (2 GiB from L2 a pass
// at 2^16).
//
// Bound on this card: the tensor cores.  A pass does 16 B n K int8
// multiply-adds and moves 8 B n bytes (and the matrix's 4 K^2 once): at
// n = 2^16 (K = 256, B = 512) 0.139 ms of tensor-core issue against 0.080
// ms of memory.  The design, a persistent CTA of three warpgroups an SM:
//   * the products are wgmma.mma_async m64n64k32 s32.s8.s8, both operands
//     read from shared memory through matrix descriptors.  A CTA tile is
//     128 x 64 of C: two consumer warpgroups of 64 rows each hold the five
//     partials of their 64 x 64 block, 160 accumulator registers a thread;
//   * shared memory holds a ring of kMxuStages stages, each one k step of
//     32: A's four 64 x 32 digit blocks for each consumer (16 KiB) and B's
//     8 planes B^(p)_j, 64 rows n x 32 k (16 KiB).  The s8 wgmma takes
//     both operands K-major, so every block is [row][k] in the layout
//     without swizzle: 8-row x 16-byte core matrices, the two k halves of a
//     row group 128 bytes apart, row groups 256 (mxu_core_offset).  A's
//     tables are stored in that order on the host (ops/mxu_ntt.py
//     _kernel_tiles), so a stage's A is one bulk copy (cp.async.bulk) a
//     consumer, issued by the first consumer's thread 0 as soon as both
//     consumers release the stage;
//   * the first warpgroup converts.  Its thread 0 keeps the raw data of the
//     next kMxuRawStages<kRow> chunks in flight (TMA: one box of the column
//     pass's x, three of the row pass's x, tw and twp, through tensor maps
//     built on the host), on mbarriers; its 128 threads turn a raw chunk
//     into B's planes, 16 words of one row n a thread: the reduction from
//     [0, 4q) (column pass) or the inter-pass twiddle (row pass), a Shoup
//     product by 2^16, the two-instruction digit split and the byte
//     transpose, one 16-byte store a plane.  The column pass's data are
//     n-contiguous in device memory, so the thread reads down a column of
//     the raw box (the transpose); the row pass's boxes land with the
//     128-byte swizzle so that 8 rows read at once touch distinct banks;
//   * mbarriers guard both rings: a stage is full when the converter's 128
//     threads have arrived and A's bytes have landed, empty when both
//     consumers' products on it are done (wgmma.wait_group 1 releases the
//     stage before last); the converter's writes pass to the tensor cores
//     through fence.proxy.async;
//   * setmaxnreg moves registers from the converter (72) to the consumers
//     (216);
//   * each CTA walks the (M tile, N tile) pairs t = blockIdx.x + i
//     gridDim.x, the M tiles of an N tile adjacent, so that CTAs running at
//     once share their data tiles in L2; the int64 epilogue and stores of
//     one tile overlap the copies and conversion of the next.
// M = 64 (n1 or n2 = 64) runs with one consumer.  The converter is what
// the consumers wait for (utils/mxu_probe.py --clocks, PERF.md).
//
// The digit split, the converter's layout and the epilogue's arithmetic are
// __host__ __device__, as ntt_arith.cuh's are: tests/test_torch_arith_host.py
// builds them with g++.  The kernel body is device code only (__CUDACC__).
#pragma once

#include <stdint.h>
#include <string.h>

#include "ntt_arith.cuh"

constexpr int kMxuDigits = 4;
// The data's powers B^(p) = 2^(32 p / kMxuPowers) B mod q (p < kMxuPowers),
// A's digits kMxuSpan to a power: A_i with i = p kMxuSpan + u meets
// B^(p)_j at weight 256^(u + j), so the partials are P_s for s <
// kMxuSpan + 3.  One power would be the JAX package's seven partials, four
// four partials and 16 planes of B; the kernel takes two: five partials
// and 8 planes.
constexpr int kMxuPowers = 2;
constexpr int kMxuSpan = kMxuDigits / kMxuPowers;
constexpr int kMxuParts = kMxuSpan + kMxuDigits - 1;
constexpr int kMxuPlanes = kMxuPowers * kMxuDigits;  // B's a stage
// log2 of the pass sizes M = K the kernel takes: its tile below, the bound
// of the partials (and of the JAX reconstruction's offset) above.
constexpr int kMxuMinLog = 6;
constexpr int kMxuMaxLog = 11;
// k a stage (one wgmma k step of s8), the rows of a block of A or B, and
// the no-swizzle K-major layout's strides (bytes)
constexpr int kMxuTileK = 32;
constexpr int kMxuBlockRows = 64;
constexpr int kMxuBlockBytes = kMxuBlockRows * kMxuTileK;
constexpr int kMxuCoreLbo = 128;  // between a row group's two k halves
constexpr int kMxuCoreSbo = 256;  // between row groups of 8

// The epilogue's and the converter's constants of q: c[j] = 256^j mod q
// (below 2^30, so each term is one 32 x 32 -> 64-bit multiply-add) and
// their Shoup words cp[j], off a multiple of q above 2^61 that makes the
// signed sum positive, mu = floor(2^64 / q).
struct MxuConsts {
  int32_t c[kMxuParts];
  uint32_t cp[kMxuParts];
  uint64_t off;
  uint64_t mu;
  uint32_t q;
};

NTT_HD MxuConsts make_mxu_consts(uint32_t q) {
  MxuConsts k;
  uint64_t c = 1 % q;
  for (int s = 0; s < kMxuParts; ++s) {
    k.c[s] = (int32_t)c;
    k.cp[s] = (uint32_t)((c << 32) / q);
    c = c * 256 % q;
  }
  k.off = ((1ull << 61) / q + 1) * q;
  k.mu = ~0ull / q;  // q odd: floor((2^64 - 1) / q) = floor(2^64 / q)
  k.q = q;
  return k;
}

// High 64 bits of a 64 x 64-bit product.
NTT_HD uint64_t mxu_mulhi64(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  return __umul64hi(a, b);
#else
  return (uint64_t)(((unsigned __int128)a * b) >> 64);
#endif
}

// sum_s p[s] 256^s mod q in [0, q), for |p[s]| <= 2^27, at most seven of
// them, and q < 2^30: each term is below 2^57 in size and the sum below
// 2^60, so t = sum + off lies in [0, 2^62); Barrett by mu leaves
// t - floor(t mu / 2^64) q in [0, 2q).
NTT_HD uint32_t mxu_reduce(const int32_t* p, const MxuConsts& k) {
  int64_t s = 0;
  NTT_UNROLL
  for (int i = 0; i < kMxuParts; ++i) s += (int64_t)p[i] * (int64_t)k.c[i];
  const uint64_t t = (uint64_t)s + k.off;
  const uint64_t r = t - mxu_mulhi64(t, k.mu) * k.q;
  return ntt_cond_sub((uint32_t)r, k.q);
}

// Byte i of the result is byte (s >> 4 i) & 7 of the eight bytes (y:x), x
// the low four (PRMT, CUDA's __byte_perm).
NTT_HD uint32_t mxu_byte_perm(uint32_t x, uint32_t y, uint32_t s) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, y, s);
#else
  const uint64_t xy = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i)
    r |= (uint32_t)((xy >> (8 * ((s >> (4 * i)) & 7))) & 255u) << (8 * i);
  return r;
#endif
}

// The four balanced signed base-256 digits of v < 2^30 as the bytes of one
// word (two's complement): v = sum_i d_i 256^i with d_i in [-128, 127] for
// i < 3 and 0 <= d_3 <= 64, the representation the JAX package's carry
// loop gives (it is unique).  With u = v + 0x808080 written in plain base
// 256 as (e_3, e_2, e_1, e_0), d_i = e_i - 128 for i < 3, whose byte is
// e_i ^ 0x80, and d_3 = e_3.
NTT_HD uint32_t mxu_digits(uint32_t v) {
  return (v + 0x808080u) ^ 0x808080u;
}

// The digits of v[0..3] < 2^30 as planes: byte j of w[i] is digit i of
// v[j], a 4 x 4 transpose of mxu_digits' bytes.
NTT_HD void mxu_pack_digits(const uint32_t* v, uint32_t* w) {
  const uint32_t d0 = mxu_digits(v[0]), d1 = mxu_digits(v[1]);
  const uint32_t d2 = mxu_digits(v[2]), d3 = mxu_digits(v[3]);
  const uint32_t lo01 = mxu_byte_perm(d0, d1, 0x5140);  // d0.0 d1.0 d0.1 d1.1
  const uint32_t lo23 = mxu_byte_perm(d2, d3, 0x5140);
  const uint32_t hi01 = mxu_byte_perm(d0, d1, 0x7362);  // d0.2 d1.2 d0.3 d1.3
  const uint32_t hi23 = mxu_byte_perm(d2, d3, 0x7362);
  w[0] = mxu_byte_perm(lo01, lo23, 0x5410);
  w[1] = mxu_byte_perm(lo01, lo23, 0x7632);
  w[2] = mxu_byte_perm(hi01, hi23, 0x5410);
  w[3] = mxu_byte_perm(hi01, hi23, 0x7632);
}

// x - b if x >= b, else x, for x < b + 2^32 - b (x < 2b and b < 2^31): one
// subtraction and an unsigned minimum.
NTT_HD uint32_t mxu_sub_if(uint32_t x, uint32_t b) {
  const uint32_t d = x - b;
  return d < x ? d : x;
}

// The byte of (row, k) in a block of rows x 32 k bytes, K-major without
// swizzle as wgmma reads it: core matrices of 8 rows x 16 bytes (128
// contiguous bytes), the two k halves of a row group kMxuCoreLbo apart,
// row groups kMxuCoreSbo apart.
NTT_HD int mxu_core_offset(int row, int k) {
  return (row >> 3) * kMxuCoreSbo + ((k >> 4) & 1) * kMxuCoreLbo +
         (row & 7) * 16 + (k & 15);
}

NTT_HD void mxu_store16(uint8_t* dst, const uint32_t* w) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
#else
  memcpy(dst, w, 16);
#endif
}

// The converter's work for one thread: the words v[0..15] < q of row `row`
// at k = 16 half .. 16 half + 15 of a stage, into B's kMxuPlanes planes
// (each a block of kMxuBlockBytes, plane 4 p + j holding digit j of
// B^(p) = 256^(p kMxuSpan) v mod q): a Shoup product by 256^(p kMxuSpan)
// (c[p kMxuSpan]), the digit split, one 16-byte store a plane.
NTT_HD void mxu_convert16(const uint32_t* v, uint8_t* planes, int row,
                          int half, const MxuConsts& k) {
  const int at = mxu_core_offset(row, 16 * half);
  NTT_UNROLL
  for (int i = 0; i < kMxuPowers; ++i) {
    uint32_t w[16];
    NTT_UNROLL
    for (int e = 0; e < 16; ++e)
      w[e] = i == 0 ? v[e]
                    : mxu_sub_if(ntt_shoup_lazy(v[e],
                                                (uint32_t)k.c[i * kMxuSpan],
                                                k.cp[i * kMxuSpan], k.q),
                                 k.q);
    uint32_t p[kMxuDigits][4];
    NTT_UNROLL
    for (int e = 0; e < 4; ++e) {
      uint32_t d[kMxuDigits];
      mxu_pack_digits(w + 4 * e, d);
      NTT_UNROLL
      for (int j = 0; j < kMxuDigits; ++j) p[j][e] = d[j];
    }
    NTT_UNROLL
    for (int j = 0; j < kMxuDigits; ++j)
      mxu_store16(planes + (kMxuDigits * i + j) * kMxuBlockBytes + at, p[j]);
  }
}

#ifdef __CUDACC__

#include <cuda.h>  // CUtensorMap

// warpgroups that copy and convert, and that multiply
constexpr int kMxuConverters = 1;
constexpr int kMxuConsumers = 2;
constexpr int kMxuThreads = 128 * (kMxuConverters + kMxuConsumers);
constexpr int kMxuTileN = kMxuBlockRows;  // 64
constexpr int kMxuStages = 4;
constexpr int kMxuAStage = kMxuConsumers * kMxuDigits * kMxuBlockBytes;
constexpr int kMxuBStage = kMxuPlanes * kMxuBlockBytes;
constexpr int kMxuStageBytes = kMxuAStage + kMxuBStage;  // 32 KiB
// a raw box: the column pass's 32 rows k x 64 words, or one of the row
// pass's three 64 rows n x 32 words (x, tw, twp; 128-byte swizzle)
constexpr int kMxuBoxBytes = 4 * kMxuTileK * kMxuTileN;
template <bool kRow>
constexpr int kMxuRawStages = kRow ? 3 : 4;
template <bool kRow>
constexpr int kMxuRawBytes = (kRow ? 3 : 1) * kMxuBoxBytes;
// the stages, the raw stages, the barriers, and 1 KiB to align the start
// (a 128-byte swizzle's box lands on 1024 bytes)
template <bool kRow>
constexpr int kMxuSmemBytes =
    kMxuStages * kMxuStageBytes + kMxuRawStages<kRow> * kMxuRawBytes<kRow> +
    8 * (2 * kMxuStages + kMxuRawStages<kRow>) + 1024;
// setmaxnreg: the launch gives 65536 / kMxuThreads registers a thread (down
// to a multiple of 8: 168); the converter hands 96 of its to the consumers,
// whose 160 accumulators spilled at 200 and 208 (72 / 216: no spill)
constexpr int kMxuLaunchRegs = 65536 / kMxuThreads / 8 * 8;
constexpr int kMxuConverterRegs = 72, kMxuConsumerRegs = 216;
static_assert(kMxuConverters * kMxuConverterRegs +
                      kMxuConsumers * kMxuConsumerRegs <=
                  (kMxuConverters + kMxuConsumers) * kMxuLaunchRegs,
              "setmaxnreg moves registers, it adds none");
static_assert(kMxuSmemBytes<true> <= 232448 && kMxuSmemBytes<false> <= 232448,
              "a CTA's shared memory");

// A pass: log2 M (= log2 K), the (n1, n2) split, the 128-row tiles of M
// (one of 64 rows at M = 64), the consumers with rows, the tiles, and q's
// constants.
struct MxuShape {
  int logm;
  int logn1, logn2;
  int mtiles;
  int consumers;
  long long tiles;
  MxuConsts k;
};

// Cycle counters of one CTA's roles (utils/mxu_probe.py builds the
// library with -DNTT_MXU_CLOCKS): the converter's waits for an empty stage
// and for its raw words, its conversion; a consumer's waits for a full
// stage, its products (issue to wgmma.wait_group), its epilogue.
constexpr int kMxuClockSlots = 8;
enum MxuClockSlot {
  kClkEmpty, kClkRaw, kClkConvert, kClkConverter,
  kClkFull, kClkProducts, kClkEpilogue, kClkConsumer
};
#ifdef NTT_MXU_CLOCKS
__device__ long long g_mxu_clocks[kMxuClockSlots];
__device__ __forceinline__ long long mxu_clock() {
#ifdef __CUDA_ARCH__
  return clock64();
#else
  return 0;
#endif
}
struct MxuClock {
  long long t0, t, sum[kMxuClockSlots];
  __device__ MxuClock() : t0(mxu_clock()), t(t0) {
    for (int s = 0; s < kMxuClockSlots; ++s) sum[s] = 0;
  }
  __device__ void lap(int slot) {
    const long long now = mxu_clock();
    sum[slot] += now - t;
    t = now;
  }
  __device__ void flush(int first, int last, int total) {
    if (blockIdx.x != 0) return;
    for (int s = first; s < last; ++s) g_mxu_clocks[s] = sum[s];
    g_mxu_clocks[total] = mxu_clock() - t0;
  }
};
#else
struct MxuClock {
  __device__ void lap(int) {}
  __device__ void flush(int, int, int) {}
};
#endif

__device__ __forceinline__ uint32_t mxu_sa(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mxu_bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(mxu_sa(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mxu_bar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(mxu_sa(bar))
      : "memory");
}

// Arrive and add `bytes` to the phase's expected transaction count.
__device__ __forceinline__ void mxu_bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          mxu_sa(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mxu_bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = mxu_sa(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// A box of a tensor map at coordinates (c0, c1[, c2]), innermost first,
// into shared memory, counted on `bar` when it lands (TMA).
__device__ __forceinline__ void mxu_tma2(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(mxu_sa(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(mxu_sa(bar))
      : "memory");
}

__device__ __forceinline__ void mxu_tma3(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(mxu_sa(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(mxu_sa(bar))
      : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from device memory
// to shared memory, counted on `bar` when they land.
__device__ __forceinline__ void mxu_bulk(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(mxu_sa(dst)),
      "l"(src), "r"(bytes), "r"(mxu_sa(bar))
      : "memory");
}

// A matrix descriptor of a block at p: no swizzle, kMxuCoreLbo and
// kMxuCoreSbo in 16-byte units.
__device__ __forceinline__ uint64_t mxu_desc(const void* p) {
  return (uint64_t)((mxu_sa(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(kMxuCoreLbo >> 4) << 16) |
         ((uint64_t)(kMxuCoreSbo >> 4) << 32);
}

// d += a b: a 64 x 32 s8 block of A and a 64 x 32 s8 block of B (both
// K-major, from shared memory), d the warpgroup's 64 x 64 s32 sum.
__device__ __forceinline__ void mxu_wgmma(int32_t* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
__device__ __forceinline__ void mxu_fence_acc(int32_t (*acc)[32]) {
  NTT_UNROLL
  for (int j = 0; j < kMxuParts; ++j)
    NTT_UNROLL
    for (int r = 0; r < 32; ++r) asm volatile("" : "+r"(acc[j][r])::"memory");
}

template <int kPending>
__device__ __forceinline__ void mxu_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// The tensor maps of a pass's raw data (built on the host per launch,
// passed as __grid_constant__ parameters): the column pass's x as (n2, n1,
// B) words, boxes of 64 x 32 x 1; the row pass's x as (n2, B n1), tw and
// twp as (n2, n1), boxes of 32 x 64 with the 128-byte swizzle.
struct MxuMaps {
  const CUtensorMap* x;
  const CUtensorMap* tw;
  const CUtensorMap* twp;
};

// Chunk (N tile at n0, k0) of the raw data into a raw stage, one thread:
// the column pass's box of 32 rows k x 64 words ([k][n]), the row pass's
// three boxes of 64 rows n x 32 words ([n][k], each 16-byte piece c of row
// r at c ^ (r & 7)).
template <bool kRow>
__device__ __forceinline__ void mxu_issue_raw(uint8_t* raw, uint64_t* bar,
                                              const MxuMaps& maps,
                                              const MxuShape& sh,
                                              long long n0, int k0) {
  mxu_bar_expect(bar, kMxuRawBytes<kRow>);
  if constexpr (!kRow) {
    mxu_tma3(raw, maps.x, (int)(n0 & ((1LL << sh.logn2) - 1)), k0,
             (int)(n0 >> sh.logn2), bar);
  } else {
    const int r0 = (int)(n0 & ((1LL << sh.logn1) - 1));
    mxu_tma2(raw, maps.x, k0, (int)n0, bar);
    mxu_tma2(raw + kMxuBoxBytes, maps.tw, k0, r0, bar);
    mxu_tma2(raw + 2 * kMxuBoxBytes, maps.twp, k0, r0, bar);
  }
}

// One converter thread's 16 words of a raw chunk into B's planes: row
// t % 64, k half t / 64; the column pass reduces [0, 4q) to [0, q) (reading
// down a column: the transpose), the row pass applies the twiddle T[r, c]
// (a Shoup product and a conditional subtraction).
template <bool kRow>
__device__ __forceinline__ void mxu_convert(const uint8_t* raw,
                                            uint8_t* planes,
                                            const MxuConsts& k, int t) {
  const int row = t & (kMxuTileN - 1), half = t / kMxuTileN;
  uint32_t v[16];
  if constexpr (!kRow) {
    const uint32_t* r = reinterpret_cast<const uint32_t*>(raw);
    NTT_UNROLL
    for (int e = 0; e < 16; ++e)
      v[e] = mxu_sub_if(
          mxu_sub_if(r[(16 * half + e) * kMxuTileN + row], 2 * k.q), k.q);
  } else {
    NTT_UNROLL
    for (int e = 0; e < 4; ++e) {
      // the swizzle puts 8 rows' same pieces on distinct banks
      const uint8_t* at = raw + row * 4 * kMxuTileK +
                          16 * ((4 * half + e) ^ (row & 7));
      const uint4 a = *reinterpret_cast<const uint4*>(at);
      const uint4 w = *reinterpret_cast<const uint4*>(at + kMxuBoxBytes);
      const uint4 wp =
          *reinterpret_cast<const uint4*>(at + 2 * kMxuBoxBytes);
      v[4 * e] = mxu_sub_if(ntt_shoup_lazy(a.x, w.x, wp.x, k.q), k.q);
      v[4 * e + 1] = mxu_sub_if(ntt_shoup_lazy(a.y, w.y, wp.y, k.q), k.q);
      v[4 * e + 2] = mxu_sub_if(ntt_shoup_lazy(a.z, w.z, wp.z, k.q), k.q);
      v[4 * e + 3] = mxu_sub_if(ntt_shoup_lazy(a.w, w.w, wp.w, k.q), k.q);
    }
  }
  mxu_convert16(v, planes, row, half, k);
}

// Chunk c of this CTA's tiles (K / 32 a tile): its tile and its k block.
struct MxuChunk {
  long long tile;
  int kb;
};

__device__ __forceinline__ MxuChunk mxu_chunk(long long c, int chunks) {
  return MxuChunk{blockIdx.x + (c / chunks) * gridDim.x, (int)(c % chunks)};
}

// A's blocks of chunk c into its stage, one thread: the four digits' 64 x
// 32 blocks of each consumer's rows, one bulk copy a consumer.
__device__ __forceinline__ void mxu_issue_a(uint8_t* smem, uint64_t* full,
                                            const int8_t* __restrict__ mat,
                                            const MxuShape& sh, long long c,
                                            int chunks) {
  constexpr int kBytes = kMxuDigits * kMxuBlockBytes;
  const int s = (int)(c % kMxuStages);
  const MxuChunk ch = mxu_chunk(c, chunks);
  const long long mb = (ch.tile % sh.mtiles) * sh.consumers;
  mxu_bar_expect(&full[s], sh.consumers * kBytes);
  for (int w = 0; w < sh.consumers; ++w)
    mxu_bulk(smem + s * kMxuStageBytes + w * kBytes,
             mat + ((mb + w) * chunks + ch.kb) * (long long)kBytes, kBytes,
             &full[s]);
}

// The first warpgroup(s): for each chunk c of this CTA's tiles, wait for
// its stage to be empty and for its raw words, convert them into B's
// planes, arrive; then refill the raw stage with chunk c + kMxuRawStages
// (thread 0).
template <bool kRow>
__device__ __forceinline__ void mxu_converter(const MxuMaps& maps,
                                              const MxuShape& sh,
                                              uint8_t* smem, uint64_t* full,
                                              uint64_t* empty,
                                              uint64_t* arrived) {
  constexpr int kRaw = kMxuRawStages<kRow>;
  uint8_t* raw = smem + kMxuStages * kMxuStageBytes;
  const int t = threadIdx.x;
  const int chunks = 1 << (sh.logm - 5);
  const long long mine =
      blockIdx.x < sh.tiles ? (sh.tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long total = mine * chunks;
  // the raw chunk c: its N tile's first column and its k
  auto issue = [&](long long c) {
    const MxuChunk ch = mxu_chunk(c, chunks);
    const int r = (int)(c % kRaw);
    mxu_issue_raw<kRow>(raw + r * kMxuRawBytes<kRow>, &arrived[r], maps, sh,
                        (ch.tile / sh.mtiles) * kMxuTileN, ch.kb * kMxuTileK);
  };
  if (t == 0)
    for (long long c = 0; c < total && c < kRaw; ++c) issue(c);
  MxuClock clk;
  for (long long c = 0; c < total; ++c) {
    const int s = (int)(c % kMxuStages);
    uint8_t* stage = smem + s * kMxuStageBytes;
    mxu_bar_wait(&empty[s], (uint32_t)((c / kMxuStages) & 1) ^ 1u);
    clk.lap(kClkEmpty);
    const int r = (int)(c % kRaw);
    mxu_bar_wait(&arrived[r], (uint32_t)((c / kRaw) & 1));
    clk.lap(kClkRaw);
    mxu_convert<kRow>(raw + r * kMxuRawBytes<kRow>, stage + kMxuAStage, sh.k,
                      t);
    // the planes were written by threads; the tensor cores read them
    // through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mxu_bar_arrive(&full[s]);
    // every converter thread is done with the raw stage
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kMxuConverters) : "memory");
    if (t == 0 && c + kRaw < total) issue(c + kRaw);
    clk.lap(kClkConvert);
  }
  if (t == 0) clk.flush(kClkEmpty, kClkConverter, kClkConverter);
}

// A consumer warpgroup (w: its 64 rows of the tile): for each of this CTA's
// tiles, the 16 products of every chunk into the partials, then the
// epilogue.  Lane (g, t4) of warp v holds, for r < 32, the sum at row
// 16 v + g + 8 ((r >> 1) & 1), column 8 (r >> 2) + 2 t4 + (r & 1).  The
// first consumer's thread 0 copies A: chunks 0 .. kMxuStages - 1 at the
// start, chunk c + kMxuStages as soon as both consumers release chunk c's
// stage.
template <bool kRow>
__device__ __forceinline__ void mxu_consumer(uint32_t* __restrict__ y,
                                             const int8_t* __restrict__ mat,
                                             const MxuShape& sh,
                                             uint8_t* smem, uint64_t* full,
                                             uint64_t* empty, int w) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int chunks = 1 << (sh.logm - 5);
  const long long mask2 = (1LL << sh.logn2) - 1;
  const long long mine =
      blockIdx.x < sh.tiles ? (sh.tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long total = mine * chunks;
  const bool loader = w == 0 && tid == 0;
  // release chunk c's stage; the loader refills it with chunk c + stages
  auto release = [&](long long c) {
    const int s = (int)(c % kMxuStages);
    mxu_bar_arrive(&empty[s]);
    if (loader && c + kMxuStages < total) {
      mxu_bar_wait(&empty[s], (uint32_t)((c / kMxuStages) & 1));
      mxu_issue_a(smem, full, mat, sh, c + kMxuStages, chunks);
    }
  };
  if (loader)
    for (long long c = 0; c < total && c < kMxuStages; ++c)
      mxu_issue_a(smem, full, mat, sh, c, chunks);
  int32_t acc[kMxuParts][32];
  long long c = 0;
  MxuClock clk;
  for (long long tile = blockIdx.x; tile < sh.tiles; tile += gridDim.x) {
    NTT_UNROLL
    for (int j = 0; j < kMxuParts; ++j)
      NTT_UNROLL
      for (int r = 0; r < 32; ++r) acc[j][r] = 0;
    mxu_fence_acc(acc);
    NTT_NO_UNROLL
    for (int kb = 0; kb < chunks; ++kb, ++c) {
      const int s = (int)(c % kMxuStages);
      mxu_bar_wait(&full[s], (uint32_t)((c / kMxuStages) & 1));
      clk.lap(kClkFull);
      const uint8_t* stage = smem + s * kMxuStageBytes;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      // A_i with i = p kMxuSpan + u meets B^(p)_j in the partial u + j
      NTT_UNROLL
      for (int i = 0; i < kMxuDigits; ++i) {
        const int pw = i / kMxuSpan, u = i % kMxuSpan;
        const uint64_t da =
            mxu_desc(stage + (w * kMxuDigits + i) * kMxuBlockBytes);
        NTT_UNROLL
        for (int j = 0; j < kMxuDigits; ++j)
          mxu_wgmma(acc[u + j], da,
                    mxu_desc(stage + kMxuAStage +
                             (kMxuDigits * pw + j) * kMxuBlockBytes));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the chunk before is done: release its stage
      mxu_wgmma_wait<1>();
      if (kb > 0) release(c - 1);
      clk.lap(kClkProducts);
    }
    mxu_wgmma_wait<0>();
    mxu_fence_acc(acc);
    release(c - 1);
    clk.lap(kClkProducts);

    // the tile's first word (G[b, 0, c0] or H[n0, 0]); offsets from it fit
    // in 32 bits (m << logn2 < 2^22, n < 64)
    const long long n0 = (tile / sh.mtiles) * kMxuTileN;
    uint32_t* yt = kRow ? y + (n0 << sh.logn2)
                        : y + ((n0 >> sh.logn2) << (sh.logn1 + sh.logn2)) +
                              (n0 & mask2);
    const int m0 = (int)(tile % sh.mtiles) * sh.consumers * kMxuBlockRows +
                   w * kMxuBlockRows + 16 * warp + g;
    NTT_UNROLL
    for (int r = 0; r < 32; r += 2) {
      const int m = m0 + 8 * ((r >> 1) & 1);
      const int n = 8 * (r >> 2) + 2 * t4;
      uint32_t out[2];
      NTT_UNROLL
      for (int e = 0; e < 2; ++e) {
        int32_t p[kMxuParts];
        NTT_UNROLL
        for (int j = 0; j < kMxuParts; ++j) p[j] = acc[j][r + e];
        out[e] = mxu_reduce(p, sh.k);
      }
      if constexpr (!kRow) {
        *reinterpret_cast<uint2*>(yt + (m << sh.logn2) + n) =
            make_uint2(out[0], out[1]);
      } else {
        yt[(n << sh.logn2) + m] = out[0];
        yt[((n + 1) << sh.logn2) + m] = out[1];
      }
    }
    clk.lap(kClkEpilogue);
  }
  if (threadIdx.x == 128 * kMxuConverters)
    clk.flush(kClkFull, kClkConsumer, kClkConsumer);
}

// One persistent CTA: maps the raw data's tensor maps (x: (B, n1, n2)
// words; tw, twp: the (n1, n2) twiddles, row pass), y the (B, n1, n2)
// output, mat A's digit blocks in _kernel_tiles' order.  Warpgroup 0
// converts, warpgroups 1 .. sh.consumers multiply.
template <bool kRow>
__device__ __forceinline__ void mxu_pass_body(const MxuMaps& maps,
                                              uint32_t* __restrict__ y,
                                              const int8_t* __restrict__ mat,
                                              const MxuShape& sh,
                                              uint8_t* base) {
  uint8_t* smem = base + ((1024 - (mxu_sa(base) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + kMxuStages * kMxuStageBytes +
      kMxuRawStages<kRow> * kMxuRawBytes<kRow>);
  uint64_t* empty = full + kMxuStages;
  uint64_t* arrived = empty + kMxuStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMxuStages; ++s) {
      // A's copy, the converters' threads
      mxu_bar_init(&full[s], 1 + 128 * kMxuConverters);
      mxu_bar_init(&empty[s], 128 * sh.consumers);
    }
    for (int s = 0; s < kMxuRawStages<kRow>; ++s) mxu_bar_init(&arrived[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg < kMxuConverters) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kMxuConverterRegs));
    mxu_converter<kRow>(maps, sh, smem, full, empty, arrived);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kMxuConsumerRegs));
    if (wg < kMxuConverters + sh.consumers)
      mxu_consumer<kRow>(y, mat, sh, smem, full, empty, wg - kMxuConverters);
  }
}

#endif  // __CUDACC__
