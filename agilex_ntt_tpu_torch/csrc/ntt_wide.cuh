// The wide-modulus ring on native 64-bit words: one prime q < 2^62, so that
// Harvey's lazy range [0, 4q) fits a u64 word.
//
// Replaces no Pallas kernel: the JAX package runs its wide ring in plain jnp
// on 32-bit limb pairs (agilex_ntt_tpu/ops/wide.py: fwd_stages64,
// inv_stages64, and the pointwise bodies of api.py::WideRing).  The card
// multiplies 64-bit words directly (__umul64hi and 64-bit low products), so
// the kernels join each word's (lo, hi) uint32 limbs in registers and work
// on u64, with the same wrapping mod 2^64 as the limb arithmetic.  The
// outputs are canonical ([0, q)), so every output word is the one
// ops/wide.py computes; the internal order of the butterflies and their
// lazy ranges are free.
//
// Written once for the device and the host: ntt_kernels.cu includes this
// file, and tests/test_torch_wide.py builds it with g++ (__host__,
// __device__ defined away, __int128 for the high product) and runs the core
// and the bodies below on host threads (std::barrier for both barriers, one
// host array a CTA's slab, reached by the others as through
// map_shared_rank), at small layout constants, against the plain version.
//
// What bounds the transforms on this card: the 64-bit products.  A
// butterfly is a 64x64 high product (four 32x32 wide products), two 64-bit
// low products and the 64-bit adds and compares, about 16 multiplies and 18
// other int32 operations, against 16 bytes a word moved once each way; at
// n = 4096 the transform is bound by operations (utils/report.py
// OPS_WIDE_*).  The radix-2 kernels these replace ran one stage a barrier
// through shared memory, loaded a twiddle pair a butterfly with 64-bit
// index arithmetic and, above n = 16384, ran one launch a stage through
// device memory: a third of that bound.
//
// Design: the layout of the 32-bit transforms (ntt_rns_transform.cuh,
// ntt_polydot_cluster.cuh) on u64 words.
//   * A CTA of 256 threads holds S = 2^kWideCtaLog = 4096 words (16 a
//     thread) in a slab of rows of 8 words at pitch 9 (36 KiB), so that a
//     warp on 32 consecutive rows, or on 8 columns of 4 rows, reaches the
//     banks at the 64-bit minimum of two wavefronts; four CTAs an SM.  A
//     block of L = 2^logl words runs on a cluster of L / S CTAs (CTA `rank`
//     holds words [rank S, rank S + S)), or L < S as S / L blocks a CTA.  A
//     unit is what a cluster holds at once: those blocks, or one block.
//   * The load: 16-byte loads of 4 lo and 4 hi limbs, joined in registers
//     and stored to the slab, every load of a thread in flight at once.
//   * Forward: the first log2 C stages as radix groups of at most 8 across
//     the cluster through distributed shared memory (wide_cross_pass; C =
//     16 takes two radix-4 passes), the column passes (wide_col_fwd_pass,
//     radix-8 groups of 8 registers, a warp on 8 columns of 4 rows sharing
//     one twiddle set), and the last 3 stages as one radix-8 group a row,
//     reduced to [0, q) in registers and stored straight to device memory
//     (16-byte stores of the lo and hi limbs).  A radix-2^K group loads its
//     2^K - 1 twiddle pairs once, at 32-bit offsets.  n = 4096: four passes,
//     three barriers after the load, where the radix-2 body took twelve.
//   * Inverse: the mirror order.  The row pass first, the column passes,
//     the cross passes; the pass that holds stage 0 folds the scale and
//     stores straight to device memory.
//   * A transform of up to S 2^kWideMaxClusterLog words (65536) is one
//     launch, on clusters of up to 16 CTAs (non-portable above 8).  Above
//     that, passes in device memory (wide_fwd_pass_group, radix-2^K groups
//     of up to 3 stages, a launch a pass) take the first stages until the
//     independent blocks fit a cluster, and the cluster body runs each block
//     at its stage offset; the inverse runs the body first and the passes
//     after, the last of them scaled.
//   * The pointwise products and sums: one thread a word.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include "ntt_arith.cuh"
#include "ntt_fourstep_cluster.cuh"

// Words a CTA holds (the host test sets fewer, so that small transforms
// take clusters and device passes), and CTAs a cluster at most.
#ifndef NTT_WIDE_CTA_LOG
#define NTT_WIDE_CTA_LOG 12
#endif
constexpr int kWideCtaLog = NTT_WIDE_CTA_LOG;
constexpr int kWideMaxClusterLog = 4;
constexpr int kWideThreads = 256;
// The last forward pass (the first inverse one): rows of 8 words.
constexpr int kWideLogRow = 3;

// Pointwise modes (ntt_wide_pointwise).
enum WideMode { kWideMont = 0, kWideExact = 1, kWideAdd = 2, kWideSub = 3 };

// ---------------------------------------------------------------------------
// The u64 core
// ---------------------------------------------------------------------------

// High 64 bits of a 64x64-bit product.
NTT_HD uint64_t wide_mulhi(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  return __umul64hi(a, b);
#else
  return (uint64_t)(((unsigned __int128)a * b) >> 64);
#endif
}

NTT_HD uint64_t wide_join(uint32_t lo, uint32_t hi) {
  return ((uint64_t)hi << 32) | lo;
}

// x - bound if x >= bound else x.
NTT_HD uint64_t wide_cond_sub(uint64_t x, uint64_t bound) {
  return x >= bound ? x - bound : x;
}

// w * a mod q in [0, 2q) by Shoup's trick (wide.py shoup_mulmod_lazy64):
// w a - mulhi(a, wp) q mod 2^64, for w < q, wp = floor(w 2^64 / q), a < 4q.
NTT_HD uint64_t wide_shoup_lazy(uint64_t a, uint64_t w, uint64_t wp,
                                uint64_t q) {
  return w * a - wide_mulhi(a, wp) * q;
}

// Montgomery REDC with R = 2^64 (wide.py mont_mul_lazy64): a b 2^-64 mod q
// in [0, 2q) for a b < 2^64 q; the low words of a b and m q cancel, and
// carry out exactly when lo(a b) != 0.
NTT_HD uint64_t wide_mont_lazy(uint64_t a, uint64_t b, uint64_t q,
                               uint64_t qinv_neg) {
  const uint64_t lo = a * b;
  const uint64_t m = lo * qinv_neg;
  return wide_mulhi(a, b) + wide_mulhi(m, q) + (lo != 0 ? 1u : 0u);
}

// Harvey's Cooley-Tukey butterfly (fwd_stages64): x, y in [0, 4q) ->
// (x + w y, x - w y + 2q) in [0, 4q), or reduced to [0, q) at the last stage.
NTT_HD void wide_ct_butterfly(uint64_t& x, uint64_t& y, uint64_t w,
                              uint64_t wp, uint64_t q, bool last) {
  const uint64_t two_q = 2 * q;
  const uint64_t tx = wide_cond_sub(x, two_q);
  const uint64_t t = wide_shoup_lazy(y, w, wp, q);
  x = tx + t;
  y = tx - t + two_q;
  if (last) {
    x = wide_cond_sub(wide_cond_sub(x, two_q), q);
    y = wide_cond_sub(wide_cond_sub(y, two_q), q);
  }
}

// Harvey's Gentleman-Sande butterfly (inv_stages64): x, y in [0, 2q) ->
// (x + y, w (x - y + 2q)) in [0, 2q).
NTT_HD void wide_gs_butterfly(uint64_t& x, uint64_t& y, uint64_t w,
                              uint64_t wp, uint64_t q) {
  const uint64_t two_q = 2 * q;
  const uint64_t s = wide_cond_sub(x + y, two_q);
  const uint64_t d = x - y + two_q;
  x = s;
  y = wide_shoup_lazy(d, w, wp, q);
}

// The inverse's closing scale: s x mod q in [0, q), sp = floor(s 2^64 / q)
// mod 2^64.
NTT_HD uint64_t wide_scale(uint64_t x, uint64_t s, uint64_t sp, uint64_t q) {
  return wide_cond_sub(wide_shoup_lazy(x, s, sp, q), q);
}

// One word of WideRing's elementwise calls: the polymul's Montgomery
// product (lazy [0, 2q)), pointwise_mul (two REDCs, the second by R^2 mod q,
// and a conditional subtraction), add and sub, each mod 2^64 as wide.py.
NTT_HD uint64_t wide_pointwise(uint64_t a, uint64_t b, int mode, uint64_t q,
                               uint64_t qinv_neg, uint64_t r2) {
  switch (mode) {
    case kWideMont:
      return wide_mont_lazy(a, b, q, qinv_neg);
    case kWideExact:
      return wide_cond_sub(
          wide_mont_lazy(wide_mont_lazy(a, b, q, qinv_neg), r2, q, qinv_neg),
          q);
    case kWideAdd:
      return wide_cond_sub(a + b, q);
    default:
      return wide_cond_sub(a - b + q, q);
  }
}

// ---------------------------------------------------------------------------
// Radix groups
// ---------------------------------------------------------------------------

// K consecutive forward stages on the 2^K words of a radix-2^K group held
// in registers (ntt_ct_radix's order and twiddle places: level l pairs v[j]
// and v[j + 2^(K-1-l)] with w[2^l - 1 + (j >> (K - l))]); `last`: the group
// holds the transform's last stage, whose outputs are reduced to [0, q).
template <int K>
NTT_HD void wide_ct_radix(uint64_t* v, const uint64_t* w, const uint64_t* wp,
                          uint64_t q, bool last) {
  NTT_UNROLL
  for (int l = 0; l < K; ++l) {
    const int half = 1 << (K - 1 - l);
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) {
      if (j & half) continue;
      const int i = (1 << l) - 1 + (j >> (K - l));
      wide_ct_butterfly(v[j], v[j + half], w[i], wp[i], q,
                        last && l == K - 1);
    }
  }
}

// The inverse stages of the same group, level K - 1 first; with `scale`
// (the group holds stage 0) every output times (sc, scp), to [0, q).
template <int K>
NTT_HD void wide_gs_radix(uint64_t* v, const uint64_t* w, const uint64_t* wp,
                          uint64_t q, bool scale, uint64_t sc, uint64_t scp) {
  NTT_UNROLL
  for (int l = K - 1; l >= 0; --l) {
    const int half = 1 << (K - 1 - l);
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) {
      if (j & half) continue;
      const int i = (1 << l) - 1 + (j >> (K - l));
      wide_gs_butterfly(v[j], v[j + half], w[i], wp[i], q);
    }
  }
  if (scale) {
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) v[j] = wide_scale(v[j], sc, scp, q);
  }
}

// A table word through the read-only cache.
__device__ __forceinline__ uint64_t wide_ldg(const uint64_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(reinterpret_cast<const unsigned long long*>(p));
#else
  return *p;
#endif
}

// The 2^K - 1 twiddle pairs of a group at stages [st, st + K), block blk of
// stage st: roots[2^(st+l) + blk 2^l + i] at 2^l - 1 + i (32-bit offsets).
template <int K>
__device__ __forceinline__ void wide_group_twiddles(
    uint64_t* w, uint64_t* wp, const uint64_t* __restrict__ roots,
    const uint64_t* __restrict__ precon, int st, int blk) {
  NTT_UNROLL
  for (int l = 0; l < K; ++l) {
    const int base = (1 << (st + l)) + (blk << l);
    NTT_UNROLL
    for (int i = 0; i < (1 << l); ++i) {
      w[(1 << l) - 1 + i] = wide_ldg(roots + base + i);
      wp[(1 << l) - 1 + i] = wide_ldg(precon + base + i);
    }
  }
}

// ---------------------------------------------------------------------------
// The cluster body's layout
// ---------------------------------------------------------------------------

// Threads a CTA: a compile-time constant on the card (the loops over a
// thread's words unroll), the host harness's choice on the host.
__device__ __forceinline__ int wide_threads() {
#ifdef __CUDA_ARCH__
  return kWideThreads;
#else
  return (int)blockDim.x;
#endif
}

// One launch of the cluster body: blocks of 2^logl words, the last logl
// stages of transforms of 2^logn words (logn - logl device passes before
// the forward body, after the inverse one).
struct WideShape {
  int logn;
  int logl;    // the block: min(logn, kWideCtaLog + kWideMaxClusterLog)
  int logc;    // CTAs a block (a cluster): logl - kWideCtaLog, or 0
  int logp;    // blocks a CTA: kWideCtaLog - logl, or 0
  int logw;    // words a row: min(kWideLogRow, logl)
  int logr;    // rows of a block's part: logl - logc - logw
  int pitch;   // u64 words between rows: 2^logw + 1
  long long blocks;  // batch 2^(logn - logl)
  uint64_t q;
};

NTT_HD WideShape make_wide_shape(int logn, long long batch, uint64_t q) {
  WideShape s;
  const int most = kWideCtaLog + kWideMaxClusterLog;
  s.logn = logn;
  s.logl = logn < most ? logn : most;
  s.logc = s.logl > kWideCtaLog ? s.logl - kWideCtaLog : 0;
  s.logp = s.logl < kWideCtaLog ? kWideCtaLog - s.logl : 0;
  s.logw = s.logl < kWideLogRow ? s.logl : kWideLogRow;
  s.logr = s.logl - s.logc - s.logw;
  s.pitch = (1 << s.logw) + 1;
  s.blocks = batch << (logn - s.logl);
  s.q = q;
  return s;
}

// Units (clusters) of a body launch, and a CTA's shared memory in bytes.
NTT_HD long long wide_units(const WideShape& s) {
  return (s.blocks + (1LL << s.logp) - 1) >> s.logp;
}

NTT_HD size_t wide_smem_bytes(const WideShape& s) {
  return sizeof(uint64_t) * ((size_t)s.pitch << (kWideCtaLog - s.logw));
}

// The slab word of logical word e of a CTA's part, 2^logw to a row.
NTT_HD int wide_word(const WideShape& s, int e) {
  return (e >> s.logw) * s.pitch + (e & ((1 << s.logw) - 1));
}

// A CTA's part of unit u: S contiguous words of device memory from `base`,
// the first `valid` of them in the batch; `pos` the block's position in its
// row (0 unless device passes split the rows into blocks).
struct WidePart {
  size_t base;
  int valid;
  int pos;
};

__device__ __forceinline__ WidePart wide_part(const WideShape& s, int rank,
                                              long long u) {
  const long long first = u << (s.logl + s.logp);
  const long long left =
      (s.blocks << s.logl) - first - ((long long)rank << kWideCtaLog);
  WidePart p;
  p.base = (size_t)first + ((size_t)rank << kWideCtaLog);
  p.valid = left < (1LL << kWideCtaLog) ? (int)left : 1 << kWideCtaLog;
  p.pos = (int)(u & ((1LL << (s.logn - s.logl)) - 1));
  return p;
}

// The part into slab sa: each thread takes quads of words 4 (tid + i T),
// two 16-byte loads (4 lo and 4 hi limbs) each, all in flight, joined in
// registers; words past the batch read as zero.
__device__ __forceinline__ void wide_load(uint64_t* sa,
                                          const uint32_t* xlo,
                                          const uint32_t* xhi,
                                          const WideShape& s,
                                          const WidePart& p) {
  const int threads = wide_threads();
  const int quads = (1 << kWideCtaLog) / (4 * threads);
  NTT_UNROLL
  for (int i = 0; i < quads; ++i) {
    const int f = 4 * ((int)threadIdx.x + i * threads);
    uint32_t lo[4], hi[4];
#ifdef __CUDA_ARCH__
    if (f + 4 <= p.valid) {
      const uint4 a = *reinterpret_cast<const uint4*>(xlo + p.base + f);
      const uint4 b = *reinterpret_cast<const uint4*>(xhi + p.base + f);
      lo[0] = a.x, lo[1] = a.y, lo[2] = a.z, lo[3] = a.w;
      hi[0] = b.x, hi[1] = b.y, hi[2] = b.z, hi[3] = b.w;
    } else
#endif
    {
      NTT_UNROLL
      for (int k = 0; k < 4; ++k) {
        const bool in = f + k < p.valid;
        lo[k] = in ? xlo[p.base + f + k] : 0u;
        hi[k] = in ? xhi[p.base + f + k] : 0u;
      }
    }
    NTT_UNROLL
    for (int k = 0; k < 4; ++k) sa[wide_word(s, f + k)] = wide_join(lo[k], hi[k]);
  }
}

// A row's 2^K words to device memory at word `at` of (ylo, yhi): 16-byte
// stores of 4 limbs on the card (at is a multiple of 4 for K >= 2).
template <int K>
__device__ __forceinline__ void wide_store_row(uint32_t* ylo, uint32_t* yhi,
                                               size_t at, const uint64_t* v) {
#ifdef __CUDA_ARCH__
  if constexpr (K >= 2) {
    NTT_UNROLL
    for (int j = 0; j < (1 << K); j += 4) {
      *reinterpret_cast<uint4*>(ylo + at + j) =
          make_uint4((uint32_t)v[j], (uint32_t)v[j + 1], (uint32_t)v[j + 2],
                     (uint32_t)v[j + 3]);
      *reinterpret_cast<uint4*>(yhi + at + j) = make_uint4(
          (uint32_t)(v[j] >> 32), (uint32_t)(v[j + 1] >> 32),
          (uint32_t)(v[j + 2] >> 32), (uint32_t)(v[j + 3] >> 32));
    }
  } else
#endif
  {
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) {
      ylo[at + j] = (uint32_t)v[j];
      yhi[at + j] = (uint32_t)(v[j] >> 32);
    }
  }
}

NTT_HD void wide_store_word(uint32_t* ylo, uint32_t* yhi, size_t at,
                            uint64_t v) {
  ylo[at] = (uint32_t)v;
  yhi[at] = (uint32_t)(v >> 32);
}

// ---------------------------------------------------------------------------
// The passes of the cluster body
// ---------------------------------------------------------------------------

// Block stages [c0, c0 + K) of the first logc, which pair CTAs: stage s
// pairs rank r with r ^ 2^(logc - 1 - s) at the same slab word.  A group
// takes one slab word of the 2^K CTAs hi 2^(logc - c0) + j 2^(logc - c0 - K)
// + lo; CTA `rank` runs group (hi, lo) = rank >> K over slab words
// [sub S / 2^K, (sub + 1) S / 2^K), sub = rank mod 2^K, one twiddle set.
// Forward (kInv false) or inverse, back into the slabs; or, with `store`
// (the inverse's stage 0), to device memory, scaled when `scale`.
template <int K, bool kInv, class Cluster>
__device__ __forceinline__ void wide_cross_pass(
    Cluster& cl, uint64_t* sa, uint32_t* ylo, uint32_t* yhi,
    const WideShape& s, const WidePart& p, int rank, long long u, int c0,
    const uint64_t* __restrict__ roots, const uint64_t* __restrict__ precon,
    bool store, bool scale, uint64_t sc, uint64_t scp) {
  const int lo_log = s.logc - c0 - K;
  const int combo = rank >> K;
  const int hi = combo >> lo_log;
  const int first = (hi << (s.logc - c0)) + (combo & ((1 << lo_log) - 1));
  uint64_t w[(1 << K) - 1], wp[(1 << K) - 1];
  wide_group_twiddles<K>(w, wp, roots, precon, s.logn - s.logl + c0,
                         (p.pos << c0) + hi);
  const int each = kWideCtaLog - K;
  const int e0 = (rank & ((1 << K) - 1)) << each;
  const size_t block = (size_t)u << s.logl;
  for (int i = (int)threadIdx.x; i < (1 << each); i += wide_threads()) {
    const int e = e0 + i;
    uint64_t* word = sa + wide_word(s, e);
    uint64_t v[1 << K];
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j)
      v[j] = *cl.map_shared_rank(word, first + (j << lo_log));
    if (kInv) {
      wide_gs_radix<K>(v, w, wp, s.q, scale, sc, scp);
    } else {
      wide_ct_radix<K>(v, w, wp, s.q, false);
    }
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) {
      const int r = first + (j << lo_log);
      if (store) {
        wide_store_word(ylo, yhi, block + ((size_t)r << kWideCtaLog) + e, v[j]);
      } else {
        *cl.map_shared_rank(word, r) = v[j];
      }
    }
  }
}

// A column group of block stage sl (logc <= sl < logc + logr; a pass of K
// stages): column c of a row (fastest), offset o < 2^logu, block `blk` of
// this CTA's rows (for several blocks a CTA its top bits are the block);
// rows r0 + j 2^logu.  lblk: its block at stage sl of the size-L transform.
struct WideColGroup {
  int c, r0, lblk;
};

template <int K>
__device__ __forceinline__ WideColGroup wide_col_group(int g,
                                                       const WideShape& s,
                                                       int rank, int sc,
                                                       int logu) {
  WideColGroup cg;
  cg.c = g & ((1 << s.logw) - 1);
  const int rest = g >> s.logw;
  const int blk = rest >> logu;
  cg.r0 = (blk << (K + logu)) + (rest & ((1 << logu) - 1));
  cg.lblk = (rank << sc) + (blk & ((1 << sc) - 1));
  return cg;
}

// Forward block stages [sl, sl + K) on the slab's columns.
template <int K>
__device__ __forceinline__ void wide_col_fwd_pass(
    uint64_t* sa, const WideShape& s, const WidePart& p, int rank, int sl,
    const uint64_t* __restrict__ roots, const uint64_t* __restrict__ precon) {
  const int sc = sl - s.logc;
  const int logu = s.logr - sc - K;
  const int so = s.logn - s.logl;
  NTT_NO_UNROLL
  for (int g = (int)threadIdx.x; g < (1 << (kWideCtaLog - K));
       g += wide_threads()) {
    const WideColGroup cg = wide_col_group<K>(g, s, rank, sc, logu);
    uint64_t* col = sa + cg.r0 * s.pitch + cg.c;
    const int step = s.pitch << logu;
    uint64_t v[1 << K];
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) v[j] = col[j * step];
    uint64_t w[(1 << K) - 1], wp[(1 << K) - 1];
    wide_group_twiddles<K>(w, wp, roots, precon, so + sl,
                           (p.pos << sl) + cg.lblk);
    wide_ct_radix<K>(v, w, wp, s.q, false);
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) col[j * step] = v[j];
  }
}

// Inverse block stages [sl, sl + K) on the slab's columns; with `store`
// (sl = 0 without a cluster: the block is the whole transform) the words
// are scaled and go to device memory, consecutive threads on consecutive
// words.
template <int K>
__device__ __forceinline__ void wide_col_inv_pass(
    uint64_t* sa, uint32_t* ylo, uint32_t* yhi, const WideShape& s,
    const WidePart& p, int rank, int sl, const uint64_t* __restrict__ iroots,
    const uint64_t* __restrict__ iprecon, bool store, uint64_t sc,
    uint64_t scp) {
  const int sc_ = sl - s.logc;
  const int logu = s.logr - sc_ - K;
  const int so = s.logn - s.logl;
  NTT_NO_UNROLL
  for (int g = (int)threadIdx.x; g < (1 << (kWideCtaLog - K));
       g += wide_threads()) {
    const WideColGroup cg = wide_col_group<K>(g, s, rank, sc_, logu);
    uint64_t* col = sa + cg.r0 * s.pitch + cg.c;
    const int step = s.pitch << logu;
    uint64_t v[1 << K];
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) v[j] = col[j * step];
    uint64_t w[(1 << K) - 1], wp[(1 << K) - 1];
    wide_group_twiddles<K>(w, wp, iroots, iprecon, so + sl,
                           (p.pos << sl) + cg.lblk);
    wide_gs_radix<K>(v, w, wp, s.q, store, sc, scp);
    if (store) {
      const int e0 = (cg.r0 << s.logw) + cg.c;
      NTT_UNROLL
      for (int j = 0; j < (1 << K); ++j) {
        const int e = e0 + (j << (logu + s.logw));
        if (e < p.valid) wide_store_word(ylo, yhi, p.base + e, v[j]);
      }
    } else {
      NTT_UNROLL
      for (int j = 0; j < (1 << K); ++j) col[j * step] = v[j];
    }
  }
}

// The forward row pass, block stages [logc + logr, logl) (K = logw): row r
// (one a thread, consecutive rows on consecutive threads), transformed,
// reduced to [0, q) and stored to its words of the part.
template <int K>
__device__ __forceinline__ void wide_row_fwd_pass(
    const uint64_t* sa, uint32_t* ylo, uint32_t* yhi, const WideShape& s,
    const WidePart& p, int rank, const uint64_t* __restrict__ roots,
    const uint64_t* __restrict__ precon) {
  const int sl = s.logc + s.logr;
  const int so = s.logn - s.logl;
  NTT_NO_UNROLL
  for (int r = (int)threadIdx.x; r < (1 << (kWideCtaLog - K));
       r += wide_threads()) {
    const int lblk = (rank << s.logr) + (r & ((1 << s.logr) - 1));
    uint64_t v[1 << K];
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) v[j] = sa[r * s.pitch + j];
    uint64_t w[(1 << K) - 1], wp[(1 << K) - 1];
    wide_group_twiddles<K>(w, wp, roots, precon, so + sl, (p.pos << sl) + lblk);
    wide_ct_radix<K>(v, w, wp, s.q, true);
    if ((r << K) < p.valid) wide_store_row<K>(ylo, yhi, p.base + (r << K), v);
  }
}

// The inverse row pass, the same stages: back into the slab, or, when the
// rows are the whole transform (n <= 8), scaled and stored.
template <int K>
__device__ __forceinline__ void wide_row_inv_pass(
    uint64_t* sa, uint32_t* ylo, uint32_t* yhi, const WideShape& s,
    const WidePart& p, int rank, const uint64_t* __restrict__ iroots,
    const uint64_t* __restrict__ iprecon, bool store, uint64_t sc,
    uint64_t scp) {
  const int sl = s.logc + s.logr;
  const int so = s.logn - s.logl;
  NTT_NO_UNROLL
  for (int r = (int)threadIdx.x; r < (1 << (kWideCtaLog - K));
       r += wide_threads()) {
    const int lblk = (rank << s.logr) + (r & ((1 << s.logr) - 1));
    uint64_t v[1 << K];
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) v[j] = sa[r * s.pitch + j];
    uint64_t w[(1 << K) - 1], wp[(1 << K) - 1];
    wide_group_twiddles<K>(w, wp, iroots, iprecon, so + sl,
                           (p.pos << sl) + lblk);
    wide_gs_radix<K>(v, w, wp, s.q, store, sc, scp);
    if (!store) {
      NTT_UNROLL
      for (int j = 0; j < (1 << K); ++j) sa[r * s.pitch + j] = v[j];
    } else if ((r << K) < p.valid) {
      wide_store_row<K>(ylo, yhi, p.base + (r << K), v);
    }
  }
}

// ---------------------------------------------------------------------------
// The bodies
// ---------------------------------------------------------------------------

// The forward transforms of unit u (this CTA is `rank` of its cluster): x
// in [0, 4q) -> y in [0, q).  Every thread of the cluster calls it.
template <class Cluster>
__device__ __forceinline__ void wide_fwd_body(
    Cluster& cl, uint64_t* sa, const uint32_t* xlo, const uint32_t* xhi,
    uint32_t* ylo, uint32_t* yhi, const uint64_t* __restrict__ roots,
    const uint64_t* __restrict__ precon, const WideShape& s, int rank,
    long long u) {
  const WidePart p = wide_part(s, rank, u);
  wide_load(sa, xlo, xhi, s, p);
  if (s.logc > 0) {
    cl.sync();  // every CTA's part of the block has arrived
    for (int c0 = 0; c0 < s.logc;) {
      const int k = fwd_pass_stages(s.logc - c0);
      with_radix<k4RadixLog>(k, [&](auto r) {
        wide_cross_pass<decltype(r)::value, false>(
            cl, sa, ylo, yhi, s, p, rank, u, c0, roots, precon, false, false,
            0, 0);
      });
      c0 += k;
      cl.sync();
    }
  } else {
    __syncthreads();
  }
  const int top = s.logc + s.logr;
  for (int sl = s.logc; sl < top;) {
    const int k = fwd_pass_stages(top - sl);
    with_radix<k4RadixLog>(k, [&](auto r) {
      wide_col_fwd_pass<decltype(r)::value>(sa, s, p, rank, sl, roots,
                                            precon);
    });
    sl += k;
    __syncthreads();
  }
  with_radix<kWideLogRow>(s.logw, [&](auto r) {
    wide_row_fwd_pass<decltype(r)::value>(sa, ylo, yhi, s, p, rank, roots,
                                          precon);
  });
}

// The inverse transforms of unit u: x in [0, 2q) -> y, the block's stages;
// when the block is the whole transform (no device passes follow) the last
// stage folds the scale (sc, scp) and y is in [0, q).
template <class Cluster>
__device__ __forceinline__ void wide_inv_body(
    Cluster& cl, uint64_t* sa, const uint32_t* xlo, const uint32_t* xhi,
    uint32_t* ylo, uint32_t* yhi, const uint64_t* __restrict__ iroots,
    const uint64_t* __restrict__ iprecon, const WideShape& s, int rank,
    long long u, uint64_t sc, uint64_t scp) {
  const WidePart p = wide_part(s, rank, u);
  const bool scale = s.logl == s.logn;
  wide_load(sa, xlo, xhi, s, p);
  __syncthreads();
  with_radix<kWideLogRow>(s.logw, [&](auto r) {
    wide_row_inv_pass<decltype(r)::value>(sa, ylo, yhi, s, p, rank, iroots,
                                          iprecon, s.logl == s.logw, sc, scp);
  });
  for (int hi = s.logc + s.logr; hi > s.logc;) {
    __syncthreads();
    const int k = inv_pass_stages(hi - s.logc);
    hi -= k;
    with_radix<k4RadixLog>(k, [&](auto r) {
      wide_col_inv_pass<decltype(r)::value>(sa, ylo, yhi, s, p, rank, hi,
                                            iroots, iprecon, hi == 0, sc,
                                            scp);
    });
  }
  for (int hi = s.logc; hi > 0;) {
    cl.sync();  // the words a cross pass reads are final
    const int k = inv_pass_stages(hi);
    hi -= k;
    with_radix<k4RadixLog>(k, [&](auto r) {
      wide_cross_pass<decltype(r)::value, true>(
          cl, sa, ylo, yhi, s, p, rank, u, hi, iroots, iprecon, hi == 0,
          scale && hi == 0, sc, scp);
    });
  }
  if (s.logc > 0) cl.sync();  // no CTA exits from a slab another reads
}

// ---------------------------------------------------------------------------
// Passes in device memory (n above what a cluster holds)
// ---------------------------------------------------------------------------

// Stages [st, st + K) of the transform, group k of B n / 2^K: words
// row n + blk 2^(logn - st) + o + j 2^(logn - st - K) (o fastest, so that a
// warp reads consecutive words), from x to y (which may be x).  The forward
// pass is never the last stage (the body holds it); the inverse's pass at
// st = 0 scales.
template <int K>
__device__ __forceinline__ size_t wide_pass_base(int logn, int st,
                                                 long long k, int* blk) {
  const int logu = logn - st - K;
  const long long rest = k >> logu;
  *blk = (int)(rest & ((1LL << st) - 1));
  return ((size_t)(rest >> st) << logn) + ((size_t)*blk << (logn - st)) +
         (size_t)(k & ((1LL << logu) - 1));
}

template <int K>
__device__ __forceinline__ void wide_fwd_pass_group(
    const uint32_t* xlo, const uint32_t* xhi, uint32_t* ylo, uint32_t* yhi,
    const uint64_t* __restrict__ roots, const uint64_t* __restrict__ precon,
    uint64_t q, int logn, int st, long long k) {
  int blk;
  const size_t base = wide_pass_base<K>(logn, st, k, &blk);
  const int logu = logn - st - K;
  uint64_t v[1 << K];
  NTT_UNROLL
  for (int j = 0; j < (1 << K); ++j)
    v[j] = wide_join(xlo[base + ((size_t)j << logu)],
                     xhi[base + ((size_t)j << logu)]);
  uint64_t w[(1 << K) - 1], wp[(1 << K) - 1];
  wide_group_twiddles<K>(w, wp, roots, precon, st, blk);
  wide_ct_radix<K>(v, w, wp, q, false);
  NTT_UNROLL
  for (int j = 0; j < (1 << K); ++j)
    wide_store_word(ylo, yhi, base + ((size_t)j << logu), v[j]);
}

template <int K>
__device__ __forceinline__ void wide_inv_pass_group(
    const uint32_t* xlo, const uint32_t* xhi, uint32_t* ylo, uint32_t* yhi,
    const uint64_t* __restrict__ iroots, const uint64_t* __restrict__ iprecon,
    uint64_t q, int logn, int st, long long k, uint64_t sc, uint64_t scp) {
  int blk;
  const size_t base = wide_pass_base<K>(logn, st, k, &blk);
  const int logu = logn - st - K;
  uint64_t v[1 << K];
  NTT_UNROLL
  for (int j = 0; j < (1 << K); ++j)
    v[j] = wide_join(xlo[base + ((size_t)j << logu)],
                     xhi[base + ((size_t)j << logu)]);
  uint64_t w[(1 << K) - 1], wp[(1 << K) - 1];
  wide_group_twiddles<K>(w, wp, iroots, iprecon, st, blk);
  wide_gs_radix<K>(v, w, wp, q, st == 0, sc, scp);
  NTT_UNROLL
  for (int j = 0; j < (1 << K); ++j)
    wide_store_word(ylo, yhi, base + ((size_t)j << logu), v[j]);
}
