// The wide-modulus ring on native 64-bit words: one prime q < 2^62, so that
// Harvey's lazy range [0, 4q) fits a u64 word.
//
// Replaces no Pallas kernel: the JAX package runs its wide ring in plain jnp
// on 32-bit limb pairs (agilex_ntt_tpu/ops/wide.py: fwd_stages64,
// inv_stages64, and the pointwise bodies of api.py::WideRing).  The card
// multiplies 64-bit words directly (__umul64hi and 64-bit low products), so
// the kernels join each word's (lo, hi) uint32 limbs in registers and work
// on u64, with the same wrapping mod 2^64 as the limb arithmetic: every
// output word is the one ops/wide.py computes, lazy words included.
//
// Written once for the device and the host: ntt_kernels.cu includes this
// file, and tests/test_torch_wide.py builds it with g++ (__host__,
// __device__ defined away, __int128 for the high product) and runs the core
// and the bodies below, one host thread doing a CTA's work, against the
// plain version.
//
// Routes (ntt_kernels.cu: ntt_wide_fwd, ntt_wide_inv, ntt_wide_pointwise):
//   * a transform of n <= 2^kWideBlockLog words runs in one launch, one
//     CTA a tile of 2^kWideTileLog words or more (rows of n < 4096 share a
//     CTA), every stage through shared memory, one barrier a stage;
//   * a larger n first runs radix-2 stage passes in device memory, one
//     launch a stage, until the independent blocks are 2^kWideBlockLog long,
//     then the shared-memory body on each block at its stage offset (the
//     inverse: the body first, then the passes, the last one scaled);
//   * the pointwise products and sums: one thread a word.
// Bound on this card: the 64-bit products.  A butterfly is a 64x64 high
// product (four 32x32 wide products), two 64-bit low products and the
// 64-bit adds and compares, about 16 multiplies and 20 other int32
// operations, against 16 bytes a word moved once each way; at n = 4096 the
// transform is bound by operations (chip_smoke.py OPS_WIDE_*).  This first
// version does one radix-2 stage a barrier through shared memory; a
// register-radix version is later work.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include "ntt_arith.cuh"

// Largest block a CTA transforms in shared memory: 2^14 words, 128 KiB.
// Smallest tile a CTA takes: 2^12 words (rows of n < 4096 share a CTA).
// The host test sets smaller ones, so that small transforms take the
// stage passes and tiles of several blocks.
#ifndef NTT_WIDE_BLOCK_LOG
#define NTT_WIDE_BLOCK_LOG 14
#define NTT_WIDE_TILE_LOG 12
#endif
constexpr int kWideBlockLog = NTT_WIDE_BLOCK_LOG;
constexpr int kWideTileLog = NTT_WIDE_TILE_LOG;
constexpr int kWideThreads = 256;

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
// The kernel bodies: a thread `tid` of `threads` does every threads-th item
// ---------------------------------------------------------------------------

NTT_HD void wide_sync() {
#ifdef __CUDA_ARCH__
  __syncthreads();
#endif
}

// One body launch: blocks of 2^logl words (the last logl stages of a
// transform of 2^logn words), 2^logp blocks a CTA's tile, `blocks` blocks in
// all.  Block g sits at word g 2^logl of the (B, n) operand, at position
// g mod 2^(logn - logl) of its row.
struct WideBody {
  int logn;
  int logl;
  int logp;
  long long blocks;
  uint64_t q;
};

NTT_HD int wide_block_log(int logn) {
  return logn < kWideBlockLog ? logn : kWideBlockLog;
}

NTT_HD WideBody wide_body(int logn, long long batch, uint64_t q) {
  WideBody b;
  b.logn = logn;
  b.logl = wide_block_log(logn);
  b.logp = b.logl < kWideTileLog ? kWideTileLog - b.logl : 0;
  b.blocks = batch << (logn - b.logl);
  b.q = q;
  return b;
}

// CTAs of a body launch, and its shared memory in bytes.
NTT_HD long long wide_tiles(const WideBody& b) {
  return (b.blocks + (1LL << b.logp) - 1) >> b.logp;
}

NTT_HD size_t wide_smem_bytes(const WideBody& b) {
  return sizeof(uint64_t) << (b.logl + b.logp);
}

// The tile of CTA `tile` into v (joined words), and back (split, scaled by
// (s, sp) when `scale`).  Blocks past the last are neither read nor written.
NTT_HD void wide_load(uint64_t* v, const uint32_t* __restrict__ lo,
                      const uint32_t* __restrict__ hi, long long tile,
                      const WideBody& b, int tid, int threads) {
  const long long base = tile << (b.logl + b.logp);
  const long long end = b.blocks << b.logl;
  for (int i = tid; i < (1 << (b.logl + b.logp)); i += threads)
    if (base + i < end) v[i] = wide_join(lo[base + i], hi[base + i]);
}

NTT_HD void wide_store(const uint64_t* v, uint32_t* __restrict__ lo,
                       uint32_t* __restrict__ hi, long long tile,
                       const WideBody& b, bool scale, uint64_t s, uint64_t sp,
                       int tid, int threads) {
  const long long base = tile << (b.logl + b.logp);
  const long long end = b.blocks << b.logl;
  for (int i = tid; i < (1 << (b.logl + b.logp)); i += threads) {
    if (base + i >= end) continue;
    const uint64_t w = scale ? wide_scale(v[i], s, sp, b.q) : v[i];
    lo[base + i] = (uint32_t)w;
    hi[base + i] = (uint32_t)(w >> 32);
  }
}

// The twiddle of butterfly group i of a block's local stage of 2^s groups:
// block g at row position c holds groups c 2^s .. of the transform's stage
// of m = 2^(logn - logl + s) groups, so its twiddle is roots[m + c 2^s + i]
// = roots[(m0 + c) 2^s + i], m0 = 2^(logn - logl).
NTT_HD long long wide_twiddle(const WideBody& b, long long g, int s, int i) {
  const long long m0 = 1LL << (b.logn - b.logl);
  return ((m0 + (g & (m0 - 1))) << s) + i;
}

// The forward stages of every block of a tile, in place in v (the stages
// m0 .. n/2 of the transform; the last one reduces to [0, q)).  Ends on a
// barrier.
NTT_HD void wide_fwd_body(uint64_t* v, long long tile, const WideBody& b,
                          const uint64_t* __restrict__ roots,
                          const uint64_t* __restrict__ precon, int tid,
                          int threads) {
  const int half_log = b.logl - 1;
  const long long g0 = tile << b.logp;
  for (int s = 0; s < b.logl; ++s) {
    const int logt = half_log - s;
    const bool last = s == half_log;
    for (int k = tid; k < (1 << (half_log + b.logp)); k += threads) {
      const int p = k >> half_log;
      if (g0 + p >= b.blocks) break;  // k grows: every later k is past too
      const int kk = k & ((1 << half_log) - 1);
      const int i = kk >> logt;
      const int x = (p << b.logl) + (i << (logt + 1)) + (kk & ((1 << logt) - 1));
      const long long w = wide_twiddle(b, g0 + p, s, i);
      wide_ct_butterfly(v[x], v[x + (1 << logt)], roots[w], precon[w], b.q,
                        last);
    }
    wide_sync();
  }
}

// The inverse stages n/2 .. m0 of every block of a tile, in place in v,
// [0, 2q) in and out.  Ends on a barrier.
NTT_HD void wide_inv_body(uint64_t* v, long long tile, const WideBody& b,
                          const uint64_t* __restrict__ iroots,
                          const uint64_t* __restrict__ iprecon, int tid,
                          int threads) {
  const int half_log = b.logl - 1;
  const long long g0 = tile << b.logp;
  for (int s = half_log; s >= 0; --s) {
    const int logt = half_log - s;
    for (int k = tid; k < (1 << (half_log + b.logp)); k += threads) {
      const int p = k >> half_log;
      if (g0 + p >= b.blocks) break;
      const int kk = k & ((1 << half_log) - 1);
      const int i = kk >> logt;
      const int x = (p << b.logl) + (i << (logt + 1)) + (kk & ((1 << logt) - 1));
      const long long w = wide_twiddle(b, g0 + p, s, i);
      wide_gs_butterfly(v[x], v[x + (1 << logt)], iroots[w], iprecon[w], b.q);
    }
    wide_sync();
  }
}

// Butterfly k (of B n/2) of a stage pass in device memory: stage s of the
// transform (2^s groups of stride t = n / 2^(s+1)), from (xlo, xhi) to
// (ylo, yhi), which may be the same words.  The forward pass is never the
// last stage (the body holds it); the inverse's stage s = 0 applies the
// scale (sc, scp) to both outputs.
NTT_HD long long wide_pass_word(int logn, int s, long long k) {
  const int logt = logn - 1 - s;
  const long long row = k >> (logn - 1);
  const long long kk = k & ((1LL << (logn - 1)) - 1);
  return (row << logn) + ((kk >> logt) << (logt + 1)) +
         (kk & ((1LL << logt) - 1));
}

NTT_HD void wide_fwd_pass(const uint32_t* xlo, const uint32_t* xhi,
                          uint32_t* ylo, uint32_t* yhi,
                          const uint64_t* __restrict__ roots,
                          const uint64_t* __restrict__ precon, uint64_t q,
                          int logn, int s, long long k) {
  const long long x = wide_pass_word(logn, s, k);
  const long long y = x + (1LL << (logn - 1 - s));
  const long long w =
      (1LL << s) + ((k & ((1LL << (logn - 1)) - 1)) >> (logn - 1 - s));
  uint64_t u = wide_join(xlo[x], xhi[x]);
  uint64_t v = wide_join(xlo[y], xhi[y]);
  wide_ct_butterfly(u, v, roots[w], precon[w], q, false);
  ylo[x] = (uint32_t)u;
  yhi[x] = (uint32_t)(u >> 32);
  ylo[y] = (uint32_t)v;
  yhi[y] = (uint32_t)(v >> 32);
}

NTT_HD void wide_inv_pass(const uint32_t* xlo, const uint32_t* xhi,
                          uint32_t* ylo, uint32_t* yhi,
                          const uint64_t* __restrict__ iroots,
                          const uint64_t* __restrict__ iprecon, uint64_t q,
                          int logn, int s, long long k, uint64_t sc,
                          uint64_t scp) {
  const long long x = wide_pass_word(logn, s, k);
  const long long y = x + (1LL << (logn - 1 - s));
  const long long w =
      (1LL << s) + ((k & ((1LL << (logn - 1)) - 1)) >> (logn - 1 - s));
  uint64_t u = wide_join(xlo[x], xhi[x]);
  uint64_t v = wide_join(xlo[y], xhi[y]);
  wide_gs_butterfly(u, v, iroots[w], iprecon[w], q);
  if (s == 0) {
    u = wide_scale(u, sc, scp, q);
    v = wide_scale(v, sc, scp, q);
  }
  ylo[x] = (uint32_t)u;
  yhi[x] = (uint32_t)(u >> 32);
  ylo[y] = (uint32_t)v;
  yhi[y] = (uint32_t)(v >> 32);
}
