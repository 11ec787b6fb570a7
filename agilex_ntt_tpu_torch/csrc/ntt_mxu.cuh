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
// As on the TPU's matrix unit, the mod-q product is built from int8 digits:
// A and B are split into four balanced signed base-256 digits (A's on the
// host, B's in the prologue), the 16 digit products run on the tensor cores
// (mma.sync m16n8k32, s8 x s8 -> s32) into the seven partials
// P_s = sum_{i + j = s} A_i B_j, exact in s32 (|P_s| <= 4 K 2^14 = 2^27 at
// K = 2048), and the epilogue writes sum_s P_s (256^s mod q) mod q once, in
// int64 (mxu_reduce).  The result in [0, q) is unique, so every word equals
// the JAX package's Horner reconstruction.
//
// Bound on this card: the tensor cores.  A pass does 16 B n K int8
// multiply-adds and moves 8 B n bytes (and the matrix's 4 K^2 once): at
// n = 2^16 (K = 256, B = 512) 0.139 ms of tensor-core issue against 0.080
// ms of memory.  The design:
//   * a CTA of 4 warps owns a 64 x 32 tile of C and walks K in chunks of 64
//     through shared memory; each warp holds a 32 x 16 tile as 7 partials of
//     2 x 2 mma tiles, 112 accumulator registers a thread;
//   * chunk c + 1's A digits and B words are copied by cp.async into a
//     second stage while chunk c is converted and multiplied, so that no
//     warp waits on device memory between its products;
//   * the s8 mma takes both operands K-major (4 consecutive k in a
//     register), so every digit plane sits in shared memory as [row][k]: A's
//     rows are m, B's are n.  The row pass's data is K-contiguous in device
//     memory; the column pass's is n-contiguous, so its prologue transposes
//     by hand (ldmatrix.trans does not move 8-bit elements): a thread reads
//     4 rows at one column of the stage and packs their digits into one
//     word a plane;
//   * the fragments come by ldmatrix (four 8 x 16-byte tiles an
//     instruction: an A fragment, or both n tiles' B fragments of a digit);
//     rows of a plane are 80 bytes apart, so a tile's 8 rows touch 32
//     distinct banks;
//   * the digit split is two instructions a word (the balanced digits are
//     the bytes of (v + 0x808080) ^ 0x808080) and a byte transpose into the
//     planes by PRMT;
//   * the M tiles of one N tile are neighbouring CTAs, so the data tile they
//     share comes from device memory once and from L2 after.
// On the H100 the kernels take 242-244 registers, two CTAs an SM; capped
// at three CTAs an SM (168 registers) they spill and run 20-50% slower.
// mma.sync alone reaches 65% of the dense int8 rate there, M1 24-32% of its
// bound, so the tensor cores' rate is not what holds it; the conversion and
// the epilogue between a CTA's products are the likely cause, unmeasured
// (utils/mxu_probe.py, PERF.md).
//
// The digit split and the epilogue's arithmetic are __host__ __device__, as
// ntt_arith.cuh's are: tests/test_torch_arith_host.py builds them with g++.
// The kernel body is device code only (__CUDACC__).
#pragma once

#include <stdint.h>

#include "ntt_arith.cuh"

constexpr int kMxuDigits = 4;
constexpr int kMxuParts = 2 * kMxuDigits - 1;
// log2 of the pass sizes M = K the kernel takes: its tile below, the bound
// of the partials (and of the JAX reconstruction's offset) above.
constexpr int kMxuMinLog = 6;
constexpr int kMxuMaxLog = 11;

// The epilogue's constants of q: c[s] = 256^s mod q (below 2^30, so each
// term is one 32 x 32 -> 64-bit multiply-add), off a multiple of q above
// 2^61 that makes the signed sum positive, mu = floor(2^64 / q).
struct MxuConsts {
  int32_t c[kMxuParts];
  uint64_t off;
  uint64_t mu;
  uint32_t q;
};

NTT_HD MxuConsts make_mxu_consts(uint32_t q) {
  MxuConsts k;
  uint64_t c = 1 % q;
  for (int s = 0; s < kMxuParts; ++s) {
    k.c[s] = (int32_t)c;
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

// sum_s p[s] 256^s mod q in [0, q), for |p[s]| <= 2^27 and q < 2^30: each
// term is below 2^57 in size and the sum below 2^60, so t = sum + off lies
// in [0, 2^62); Barrett by mu leaves t - floor(t mu / 2^64) q in [0, 2q).
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

#ifdef __CUDACC__

constexpr int kMxuThreads = 128;
constexpr int kMxuWarps = kMxuThreads / 32;
constexpr int kMxuWarpsM = 2;  // warps along M; kMxuWarps / 2 along N
constexpr int kMxuWarpM = 32, kMxuWarpN = 16;
constexpr int kMxuTileM = kMxuWarpsM * kMxuWarpM;                 // 64
constexpr int kMxuTileN = (kMxuWarps / kMxuWarpsM) * kMxuWarpN;  // 32
constexpr int kMxuTileK = 64;
constexpr int kMxuPitch = kMxuTileK + 16;  // bytes a row of a digit plane
constexpr int kMxuPlaneA = kMxuTileM * kMxuPitch;
constexpr int kMxuPlaneB = kMxuTileN * kMxuPitch;
constexpr int kMxuRawWords = kMxuTileK * kMxuTileN;  // B's words a chunk
// A stage: A's digit planes and B's words of one chunk, as they arrive (the
// row pass's with their twiddles and Shoup words); two stages and B's digit
// planes a CTA: 66 KiB for the column pass, 98 KiB for the row pass.
template <bool kRow>
constexpr int kMxuStageBytes =
    kMxuDigits * kMxuPlaneA + (kRow ? 3 : 1) * kMxuRawWords * 4;
template <bool kRow>
constexpr int kMxuSmemBytes =
    2 * kMxuStageBytes<kRow> + kMxuDigits * kMxuPlaneB;
static_assert(kMxuTileK / 4 == 4 * kMxuWarps,
              "the column conversion gives each warp 4 words of k");
static_assert(kMxuTileN == 32, "a lane a column of the column conversion");

// A pass: log2 M (= log2 K), the (n1, n2) split, the M tiles of an N tile,
// and q's epilogue constants.
struct MxuShape {
  int logm;
  int logn1, logn2;
  int mtiles;
  MxuConsts k;
};

// c += a b on the tensor cores: a 16 x 32 s8 tile (row-major fragment), a
// 32 x 8 s8 tile (column-major fragment), a 16 x 8 s32 sum.
__device__ __forceinline__ void mxu_mma(int32_t* c, const uint32_t* a,
                                        const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 tiles of 16-bit words from shared memory, one a register
// (ldmatrix): lanes 8 m to 8 m + 7 give the 16-byte rows of tile m, and lane
// l gets bytes 4 (l % 4) to 4 (l % 4) + 3 of row l / 4 of each tile: for
// s8 data, exactly an mma fragment's 4 k of a row.
__device__ __forceinline__ void mxu_ldmatrix4(uint32_t* r, const uint8_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((uint32_t)__cvta_generic_to_shared(p)));
}

// 16 bytes from device memory to shared memory without a register
// (cp.async); mxu_copy_commit closes a chunk's group, mxu_copy_wait waits
// for all of this thread's copies.
__device__ __forceinline__ void mxu_copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void mxu_copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void mxu_copy_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Chunk [k0, k0 + 64) into a stage, as one group of copies: A's digit
// planes at rows [m0, m0 + 64) (16-byte pieces of the (4, M, K) int8
// matrix, 8 a thread), then B's words: the column pass's 64 rows k of 32
// words of one batch row ([k][n]), or the row pass's 32 rows n of 64 words
// ([n][k]) with their twiddles and Shoup words (4 pieces a thread each).
template <bool kRow>
__device__ __forceinline__ void mxu_prefetch(
    uint8_t* stage, const int8_t* __restrict__ mat,
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ tw,
    const uint32_t* __restrict__ twp, const MxuShape& sh, int m0,
    long long n0, int k0) {
  constexpr int kRowPieces = kMxuTileK / 16;
  constexpr int kPieces = kMxuDigits * kMxuTileM * kRowPieces;
  NTT_UNROLL
  for (int r = 0; r < kPieces / kMxuThreads; ++r) {
    const int i = threadIdx.x + r * kMxuThreads;
    const int piece = i % kRowPieces;
    const int row = (i / kRowPieces) % kMxuTileM;
    const int d = i / (kRowPieces * kMxuTileM);
    mxu_copy16(stage + d * kMxuPlaneA + row * kMxuPitch + 16 * piece,
               mat + ((long long)d << (2 * sh.logm)) +
                   ((long long)(m0 + row) << sh.logm) + k0 + 16 * piece);
  }
  uint32_t* raw = reinterpret_cast<uint32_t*>(stage + kMxuDigits * kMxuPlaneA);
  if constexpr (!kRow) {
    constexpr int kLinePieces = kMxuTileN / 4;
    const uint32_t* src = x + ((n0 >> sh.logn2) << (sh.logn1 + sh.logn2)) +
                          (n0 & ((1LL << sh.logn2) - 1)) +
                          ((long long)k0 << sh.logn2);
    NTT_UNROLL
    for (int r = 0; r < kMxuRawWords / 4 / kMxuThreads; ++r) {
      const int i = threadIdx.x + r * kMxuThreads;
      const int piece = i % kLinePieces, k = i / kLinePieces;
      mxu_copy16(raw + k * kMxuTileN + 4 * piece,
                 src + ((long long)k << sh.logn2) + 4 * piece);
    }
  } else {
    constexpr int kLinePieces = kMxuTileK / 4;
    const long long mask1 = (1LL << sh.logn1) - 1;
    NTT_UNROLL
    for (int r = 0; r < kMxuRawWords / 4 / kMxuThreads; ++r) {
      const int i = threadIdx.x + r * kMxuThreads;
      const int piece = i % kLinePieces, row = i / kLinePieces;
      const long long n = n0 + row;
      const int at = row * kMxuTileK + 4 * piece;
      const long long t = ((n & mask1) << sh.logn2) + k0 + 4 * piece;
      mxu_copy16(raw + at, x + (n << sh.logn2) + k0 + 4 * piece);
      mxu_copy16(raw + kMxuRawWords + at, tw + t);
      mxu_copy16(raw + 2 * kMxuRawWords + at, twp + t);
    }
  }
  mxu_copy_commit();
}

// Four words of k at [4 k4, 4 k4 + 4) of B's row `row`, as digit planes.
__device__ __forceinline__ void mxu_store_planes(uint8_t* bs, int row, int k4,
                                                 const uint32_t* v) {
  uint32_t w[kMxuDigits];
  mxu_pack_digits(v, w);
  NTT_UNROLL
  for (int i = 0; i < kMxuDigits; ++i)
    *reinterpret_cast<uint32_t*>(bs + i * kMxuPlaneB + row * kMxuPitch +
                                 4 * k4) = w[i];
}

// The prologue of a chunk: B's words of a stage reduced to [0, q) and split
// into digit planes.  Column pass: words in [0, 4q), two conditional
// subtractions; a lane a column n, each warp 4 words of 4 rows k, so the
// planes' [n][k] rows come out transposed.  Row pass: the twiddle T[r, c]
// (Shoup, then a conditional subtraction); 16 lanes a row of 64 words.
template <bool kRow>
__device__ __forceinline__ void mxu_convert(uint8_t* bs, const uint32_t* raw,
                                            uint32_t q) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (!kRow) {
    NTT_UNROLL
    for (int i = 0; i < 4; ++i) {
      const int k4 = warp + kMxuWarps * i;
      uint32_t v[4];
      NTT_UNROLL
      for (int j = 0; j < 4; ++j)
        v[j] = ntt_reduce_4q(raw[(4 * k4 + j) * kMxuTileN + lane], q);
      mxu_store_planes(bs, lane, k4, v);
    }
  } else {
    const int k4 = lane & 15;
    NTT_UNROLL
    for (int i = 0; i < kMxuTileN / (2 * kMxuWarps); ++i) {
      const int row = (lane >> 4) + 2 * (warp + kMxuWarps * i);
      const int at = row * kMxuTileK + 4 * k4;
      const uint4 a = *reinterpret_cast<const uint4*>(raw + at);
      const uint4 w = *reinterpret_cast<const uint4*>(raw + kMxuRawWords + at);
      const uint4 wp =
          *reinterpret_cast<const uint4*>(raw + 2 * kMxuRawWords + at);
      const uint32_t v[4] = {ntt_scale_reduce(a.x, w.x, wp.x, q),
                             ntt_scale_reduce(a.y, w.y, wp.y, q),
                             ntt_scale_reduce(a.z, w.z, wp.z, q),
                             ntt_scale_reduce(a.w, w.w, wp.w, q)};
      mxu_store_planes(bs, row, k4, v);
    }
  }
}

// One CTA: the tile (m0, n0) of C = A B mod q, blockIdx.x = n tile *
// mtiles + m tile.  x: (B, n1, n2) words, y: the (B, n1, n2) output, mat:
// A's (4, M, K) digits; tw, twp: the (n1, n2) twiddles (row pass).  Chunk
// c + 1's copies fly while chunk c is converted and multiplied: two stages,
// two barriers a chunk.
template <bool kRow>
__device__ __forceinline__ void mxu_pass_body(
    const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
    const int8_t* __restrict__ mat, const uint32_t* __restrict__ tw,
    const uint32_t* __restrict__ twp, const MxuShape& sh, uint8_t* smem) {
  constexpr int kStage = kMxuStageBytes<kRow>;
  uint8_t* bs = smem + 2 * kStage;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row, tile
  const int wm = warp % kMxuWarpsM, wn = warp / kMxuWarpsM;
  const int m0 = (int)(blockIdx.x % sh.mtiles) * kMxuTileM;
  const long long n0 = (long long)(blockIdx.x / sh.mtiles) * kMxuTileN;
  int32_t acc[kMxuParts][2][2][4];
  NTT_UNROLL
  for (int s = 0; s < kMxuParts; ++s)
    NTT_UNROLL
    for (int mi = 0; mi < 2; ++mi)
      NTT_UNROLL
      for (int ni = 0; ni < 2; ++ni)
        NTT_UNROLL
        for (int c = 0; c < 4; ++c) acc[s][mi][ni][c] = 0;

  const int chunks = (1 << sh.logm) / kMxuTileK;
  mxu_prefetch<kRow>(smem, mat, x, tw, twp, sh, m0, n0, 0);
  NTT_NO_UNROLL
  for (int ch = 0; ch < chunks; ++ch) {
    const uint8_t* as = smem + (ch & 1) * kStage;
    mxu_copy_wait();
    __syncthreads();  // the chunk is in; the last chunk's products are done
    if (ch + 1 < chunks)
      mxu_prefetch<kRow>(smem + ((ch + 1) & 1) * kStage, mat, x, tw, twp, sh,
                         m0, n0, (ch + 1) * kMxuTileK);
    mxu_convert<kRow>(
        bs, reinterpret_cast<const uint32_t*>(as + kMxuDigits * kMxuPlaneA),
        sh.k.q);
    __syncthreads();
    NTT_UNROLL
    for (int kk = 0; kk < kMxuTileK; kk += 32) {
      // B's fragments of both n tiles of digit j in one ldmatrix: tiles
      // (n 0-7, k 0-15), (n 0-7, k 16-31), (n 8-15, k 0-15), (n 8-15,
      // k 16-31)
      uint32_t b[kMxuDigits][2][2];
      NTT_UNROLL
      for (int j = 0; j < kMxuDigits; ++j)
        mxu_ldmatrix4(&b[j][0][0],
                      bs + j * kMxuPlaneB +
                          (wn * kMxuWarpN + 8 * (lm >> 1) + lr) * kMxuPitch +
                          kk + 16 * (lm & 1));
      NTT_UNROLL
      for (int i = 0; i < kMxuDigits; ++i) {
        // A's fragment a0..a3: tiles (m 0-7, k 0-15), (m 8-15, k 0-15),
        // (m 0-7, k 16-31), (m 8-15, k 16-31)
        uint32_t a[2][4];
        NTT_UNROLL
        for (int mi = 0; mi < 2; ++mi)
          mxu_ldmatrix4(a[mi], as + i * kMxuPlaneA +
                                   (wm * kMxuWarpM + mi * 16 + 8 * (lm & 1) +
                                    lr) * kMxuPitch +
                                   kk + 16 * (lm >> 1));
        NTT_UNROLL
        for (int j = 0; j < kMxuDigits; ++j)
          NTT_UNROLL
          for (int mi = 0; mi < 2; ++mi)
            NTT_UNROLL
            for (int ni = 0; ni < 2; ++ni)
              mxu_mma(acc[i + j][mi][ni], a[mi], b[j][ni]);
      }
    }
  }

  // the epilogue: lane (g, t) holds rows g and g + 8 of each 16 x 8 tile at
  // columns 2t and 2t + 1
  const long long mask2 = (1LL << sh.logn2) - 1;
  NTT_UNROLL
  for (int mi = 0; mi < 2; ++mi)
    NTT_UNROLL
    for (int ni = 0; ni < 2; ++ni)
      NTT_UNROLL
      for (int h = 0; h < 2; ++h) {
        const long long m = m0 + wm * kMxuWarpM + mi * 16 + g + 8 * h;
        const long long n = n0 + wn * kMxuWarpN + ni * 8 + 2 * t;
        uint32_t out[2];
        NTT_UNROLL
        for (int e = 0; e < 2; ++e) {
          int32_t p[kMxuParts];
          NTT_UNROLL
          for (int s = 0; s < kMxuParts; ++s) p[s] = acc[s][mi][ni][2 * h + e];
          out[e] = mxu_reduce(p, sh.k);
        }
        if constexpr (!kRow) {
          *reinterpret_cast<uint2*>(
              y + ((n >> sh.logn2) << (sh.logn1 + sh.logn2)) +
              (m << sh.logn2) + (n & mask2)) = make_uint2(out[0], out[1]);
        } else {
          y[(n << sh.logn2) + m] = out[0];
          y[((n + 1) << sh.logn2) + m] = out[1];
        }
      }
}

#endif  // __CUDACC__
