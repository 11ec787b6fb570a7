// The multi-prime forward and inverse transforms (K4a, K4b) on the
// register-radix passes of the multi-prime polydot (ntt_polydot_cluster.cuh):
//   fwd_rns_body <- _fwd_rns_kernel (K4a,
//                   agilex_ntt_tpu/ops/ntt_kernel.py:340)
//   inv_rns_body <- _inv_rns_kernel (K4b,
//                   agilex_ntt_tpu/ops/ntt_kernel.py:350)
// and, at one channel, the single-prime transforms (ntt_fwd, ntt_inv):
//   fwd_rns_body <- _fwd_kernel (K1, agilex_ntt_tpu/ops/ntt_kernel.py:97)
//   inv_rns_body <- _inv_kernel (K2, agilex_ntt_tpu/ops/ntt_kernel.py:110)
// on the negacyclic, cyclic (CyclicRing, the four-step row pass),
// stage-shard and four-step column tables of their callers; and the DIT
// inverse on the forward passes:
//   dit_inv_rns_body <- _dit_inv_kernel (K12,
//                       agilex_ntt_tpu/ops/dit_inv.py:121)
// Per channel l and polynomial b of (L, B, n): the forward negacyclic NTT,
// any word in [0, 4 q_l) in, [0, q_l) out in the HEXL bit-reversed order of
// the radix-2 network; the inverse, [0, 2 q_l) in, [0, q_l) out, its last
// stage scaled by the channel's (su, su', sv, sv') (n^-1 by default, or the
// caller's scale, for example the polymul scale).
//
// What bounds them on this card: bytes.  A call moves each word in and out
// once (2 L B n 4 bytes, plus the tables), 0.0602 ms at (3, 2048, 4096);
// its 12 radix-2 stages and final reductions need a little over half of
// that in int32 issue (chip_smoke.py computes both).  The kernels these
// replace ran one CTA of 512 threads a polynomial, a radix-2 stage a
// barrier and a twiddle load a butterfly: 16-18% of the bound.  What holds
// these back is instruction issue rather than bytes, so the passes keep
// per-word address arithmetic to an offset from a base taken once a unit
// (PERF.md: a 64-bit address a word cost the inverse a quarter).
//
// Design: the polydot body's layout and passes with one operand.
//   * A CTA holds S = kDotSumWords x threads words (4096 at 256 threads) in
//     a slab of rows of 8 words at pitch 9 (18 KiB): n > S on a cluster of
//     n / S CTAs, smaller n as P = S / n polynomials a CTA.  A unit is what
//     a cluster holds at once: P polynomials, or one on a cluster.
//   * One unit a cluster, one slab a CTA (18 KiB): six CTAs an SM overlap
//     one's load with the others' arithmetic.  A cluster that took several
//     units in turn, loading the next into a second slab by cp.async while
//     it transformed the current one, measured 8-15% slower on the H100
//     (PERF.md) and was not kept.
//   * Each part of a unit is S contiguous words of device memory: the load
//     is one cp.async a word, a warp on 32 consecutive words.
//   * Forward: the first log2 C stages as one radix-C group across the
//     cluster (dot_cross_pass), the column passes (dot_col_fwd_pass, a warp
//     on 8 columns of 4 rows shares one twiddle set), and the last 3 stages
//     as one radix-8 group a row, reduced to [0, q) in registers and stored
//     straight to device memory, 8 consecutive words a thread (two 16-byte
//     stores; consecutive threads on consecutive rows).
//   * Inverse: the mirror order.  The row pass first (GS radix-8 a row,
//     back into the slab, or scaled straight to device memory when the rows
//     are the whole transform, n <= 8), the column inverse passes
//     (dot_col_inv_pass; without a cluster the last, rns_col_inv_store_pass,
//     folds the scale and stores, a warp on 32 consecutive words), and with
//     a cluster the radix-C group across it, which folds the scale and
//     stores.
//   * K12: the forward order on a cyclic table, the post row folded into
//     the row pass's store.  The TPU kernel multiplies the bit-reversed
//     input by the pre row psi^k and runs the forward network on the psi^-1
//     tables; with z_k = x_k psi^k that network gives
//     sum_k x_k psi^-(2 br(m)) k, the cyclic transform of omega = psi^-2.
//     So the body runs fwd_rns_body's passes on the cyclic tables of omega
//     (DitTables.cyclic) with no pre row: a Shoup product and two row reads
//     a word fewer.  The row pass then multiplies by the post row n^-1
//     inv_roots[k] (Shoup) and reduces once, to [0, q).
// The output words are canonical, so they equal the plain version's and the
// TPU kernel's.
//
// The bodies take the cluster as a template parameter, as the polydot body
// does, so that tests/test_torch_arith_host.py runs them on host threads.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include "ntt_arith.cuh"
#include "ntt_fourstep_cluster.cuh"
#include "ntt_polydot_cluster.cuh"

namespace {

// Shared memory of a transform CTA: one slab.
inline size_t rns_smem_bytes(const DotShape& s) {
  return (size_t)4 * dot_slab_words(s);
}

// Units of a channel: clusters' worth of polynomials.
inline long long rns_units(const DotShape& s,
                                               long long batch) {
  return (batch + (1LL << s.logp) - 1) >> s.logp;
}

// This CTA's part of unit u in device memory: its S words are contiguous
// (the P polynomials of the unit, or words [rank S, rank S + S) of one), at
// word `base` of the channel's (B, n) data; the first `valid` of them (a
// multiple of n) lie in the batch.
struct RnsPart {
  size_t base;
  int valid;
};

__device__ __forceinline__ RnsPart rns_part(const DotShape& s, int rank,
                                            long long u, long long batch) {
  const long long poly0 = u << s.logp;
  const long long left = batch > poly0 ? (batch - poly0) << s.logn : 0;
  RnsPart p;
  p.base = ((size_t)poly0 << s.logn) + ((size_t)rank << s.logs);
  p.valid = left < (1LL << s.logs) ? (int)left : 1 << s.logs;
  return p;
}

// A part (src: its first word) into slab sa, by cp.async, as one committed
// group; words past the batch read as zero.  A thread takes words tid + i
// threads, i < kDotSumWords (S = kDotSumWords threads), in one unrolled
// burst, with the slab's shared-memory address converted once.
__device__ __forceinline__ void rns_load(uint32_t* sa,
                                         const uint32_t* __restrict__ src,
                                         const DotShape& s, int valid) {
#ifdef __CUDA_ARCH__
  const uint32_t shared = (uint32_t)__cvta_generic_to_shared(sa);
#endif
  const int tid = dot_tid();
  NTT_UNROLL
  for (int i = 0; i < kDotSumWords; ++i) {
    const int f = tid + i * (int)blockDim.x;
    const int w = dot_word(s, f);
    if (f < valid) {
#ifdef __CUDA_ARCH__
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       shared + 4u * (uint32_t)w),
                   "l"(src + f)
                   : "memory");
#else
      sa[w] = src[f];
#endif
    } else {
      sa[w] = 0u;
    }
  }
  copy_async_commit();
}

// A row's 2^K words to device memory at dst (2^K consecutive words, 16-byte
// aligned for K >= 2): 16-byte stores on the card.
template <int K>
__device__ __forceinline__ void rns_store_row(uint32_t* __restrict__ dst,
                                              const uint32_t* v) {
#ifdef __CUDA_ARCH__
  if constexpr (K >= 2) {
    NTT_UNROLL
    for (int j = 0; j < (1 << K); j += 4)
      *reinterpret_cast<uint4*>(dst + j) =
          make_uint4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    return;
  }
#endif
  NTT_UNROLL
  for (int j = 0; j < (1 << K); ++j) dst[j] = v[j];
}

// The forward row pass, stages [logc + logr, logn) (K = logw): row r (one a
// thread, consecutive rows on consecutive threads) of slab sa, transformed,
// reduced to [0, q) and stored to its words of the part (dst: its first
// word; `valid` words in the batch).
template <int K>
__device__ __forceinline__ void rns_fwd_row_pass(
    const uint32_t* sa, uint32_t* __restrict__ dst, const DotShape& s,
    int rank, int valid, const uint32_t* __restrict__ roots,
    const uint32_t* __restrict__ precon, uint32_t q) {
  const int st = s.logc + s.logr;
  for (int r = dot_tid(); r < (1 << (s.logs - K)); r += blockDim.x) {
    const int gblk = (rank << s.logr) + (r & ((1 << s.logr) - 1));
    uint32_t v[1 << K];
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) v[j] = sa[r * s.pitch + j];
    uint32_t w[(1 << K) - 1], wp[(1 << K) - 1];
    load_group_twiddles<K>(w, wp, roots, precon, st, gblk);
    ntt_ct_radix<K>(v, w, wp, q);
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) v[j] = ntt_reduce_4q(v[j], q);
    if ((r << K) < valid) rns_store_row<K>(dst + (r << K), v);
  }
}

// A row's 2^K words from device memory at src (16-byte aligned for K >= 2),
// through the read-only cache: 16-byte loads on the card.
template <int K>
__device__ __forceinline__ void rns_load_row(uint32_t* v,
                                             const uint32_t* __restrict__ src) {
#ifdef __CUDA_ARCH__
  if constexpr (K >= 2) {
    NTT_UNROLL
    for (int j = 0; j < (1 << K); j += 4) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(src + j));
      v[j] = a.x;
      v[j + 1] = a.y;
      v[j + 2] = a.z;
      v[j + 3] = a.w;
    }
    return;
  }
#endif
  NTT_UNROLL
  for (int j = 0; j < (1 << K); ++j) v[j] = __ldg(src + j);
}

// K12's row pass: rns_fwd_row_pass's stages, then, in place of the final
// reduction, the post row (post[k] = n^-1 inv_roots[k] at the word's index
// k in its polynomial, Shoup constant post_p[k]) with one conditional
// subtraction, to [0, q), stored as that pass stores.  The post row is read
// a half row at a time, after the twiddles are dead.
template <int K>
__device__ __forceinline__ void rns_dit_row_pass(
    const uint32_t* sa, uint32_t* __restrict__ dst, const DotShape& s,
    int rank, int valid, const uint32_t* __restrict__ roots,
    const uint32_t* __restrict__ precon, const uint32_t* __restrict__ post,
    const uint32_t* __restrict__ post_p, uint32_t q) {
  const int st = s.logc + s.logr;
  const int nmask = (1 << s.logn) - 1;
  constexpr int kHalf = K >= 3 ? 4 : 1 << K;
  for (int r = dot_tid(); r < (1 << (s.logs - K)); r += blockDim.x) {
    const int gblk = (rank << s.logr) + (r & ((1 << s.logr) - 1));
    uint32_t v[1 << K];
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) v[j] = sa[r * s.pitch + j];
    uint32_t w[(1 << K) - 1], wp[(1 << K) - 1];
    load_group_twiddles<K>(w, wp, roots, precon, st, gblk);
    ntt_ct_radix<K>(v, w, wp, q);
    const int k0 = ((rank << s.logs) + (r << K)) & nmask;
    NTT_UNROLL
    for (int h = 0; h < (1 << K); h += kHalf) {
      uint32_t p[kHalf], pp[kHalf];
      rns_load_row<K >= 3 ? 2 : K>(p, post + k0 + h);
      rns_load_row<K >= 3 ? 2 : K>(pp, post_p + k0 + h);
      NTT_UNROLL
      for (int j = 0; j < kHalf; ++j)
        v[h + j] = ntt_scale_reduce(v[h + j], p[j], pp[j], q);
    }
    if ((r << K) < valid) rns_store_row<K>(dst + (r << K), v);
  }
}

// The inverse row pass, the same stages: row r of slab sa back into the
// slab, or, when these are all the stages (n <= 8), scaled and stored to
// the part's words (dst, valid).
template <int K>
__device__ __forceinline__ void rns_inv_row_pass(
    uint32_t* sa, uint32_t* __restrict__ dst, const DotShape& s, int rank,
    int valid, const uint32_t* __restrict__ iroots,
    const uint32_t* __restrict__ iprecon, const uint32_t* scale, uint32_t q) {
  const int st = s.logc + s.logr;
  for (int r = dot_tid(); r < (1 << (s.logs - K)); r += blockDim.x) {
    const int gblk = (rank << s.logr) + (r & ((1 << s.logr) - 1));
    uint32_t v[1 << K];
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) v[j] = sa[r * s.pitch + j];
    uint32_t w[(1 << K) - 1], wp[(1 << K) - 1];
    load_group_twiddles<K>(w, wp, iroots, iprecon, st, gblk);
    ntt_gs_radix<K>(v, w, wp, q, st == 0 ? scale : nullptr);
    if (st != 0) {
      NTT_UNROLL
      for (int j = 0; j < (1 << K); ++j) sa[r * s.pitch + j] = v[j];
    } else if ((r << K) < valid) {
      rns_store_row<K>(dst + (r << K), v);
    }
  }
}

// The last inverse column pass without a cluster, stages [0, K): a group's
// 2^K words lie in one polynomial, scaled and stored to the part's words
// (dst, valid) u rows apart; consecutive threads on consecutive words.
template <int K>
__device__ __forceinline__ void rns_col_inv_store_pass(
    const uint32_t* sa, uint32_t* __restrict__ dst, const DotShape& s,
    int valid, const uint32_t* __restrict__ iroots,
    const uint32_t* __restrict__ iprecon, const uint32_t* scale, uint32_t q) {
  const int logu = s.logr - K;
  for (int g = dot_tid(); g < (1 << (s.logs - K)); g += blockDim.x) {
    const DotColGroup cg = dot_col_group<K>(g, s, 0, 0, logu);
    uint32_t v[1 << K];
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j)
      v[j] = sa[(cg.r0 + (j << logu)) * s.pitch + cg.c];
    uint32_t w[(1 << K) - 1], wp[(1 << K) - 1];
    load_group_twiddles<K>(w, wp, iroots, iprecon, 0, 0);
    ntt_gs_radix<K>(v, w, wp, q, scale);
    const int e = (cg.r0 << s.logw) + cg.c;
    if (e < valid) {
      NTT_UNROLL
      for (int j = 0; j < (1 << K); ++j)
        dst[e + (j << (logu + s.logw))] = v[j];
    }
  }
}

// The forward passes but the row pass, on unit u (this CTA is `rank` of
// its cluster) of x (B, n) of the channel, with its tables and q: the
// load, the cross stages and the column passes, into the slab sa.  Returns
// the part of unit u this CTA stores.  Every thread of the cluster calls
// it.
template <class Cluster>
__device__ __forceinline__ RnsPart fwd_rns_passes(
    Cluster& cl, uint32_t* sa, const uint32_t* __restrict__ x,
    const uint32_t* __restrict__ roots, const uint32_t* __restrict__ precon,
    long long batch, const DotShape& s, int rank, long long u, uint32_t q) {
  const int top = s.logc + s.logr;  // the row pass's first stage
  const RnsPart part = rns_part(s, rank, u, batch);
  rns_load(sa, x + part.base, s, part.valid);
  copy_async_wait();
  if (s.logc > 0) {
    cl.sync();  // every CTA's part of unit u has arrived
    with_radix<kDotMaxClusterLog>(s.logc, [&](auto r) {
      dot_cross_pass<decltype(r)::value, false, 1>(
          cl, sa, nullptr, nullptr, s, rank, u, roots, precon, nullptr, q);
    });
    cl.sync();
  } else {
    __syncthreads();
  }
  for (int st = s.logc; st < top;) {
    const int kk = fwd_pass_stages(top - st);
    with_radix<k4RadixLog>(kk, [&](auto r) {
      dot_col_fwd_pass<decltype(r)::value, 1>(sa, nullptr, s, rank, st, roots,
                                              precon, q);
    });
    st += kk;
    __syncthreads();
  }
  return part;
}

// One channel's forward transforms of unit u: fwd_rns_passes, then the row
// pass, which stores to y (B, n).
template <class Cluster>
__device__ __forceinline__ void fwd_rns_body(
    Cluster& cl, uint32_t* sa, const uint32_t* __restrict__ x,
    uint32_t* __restrict__ y, const uint32_t* __restrict__ roots,
    const uint32_t* __restrict__ precon, long long batch, const DotShape& s,
    int rank, long long u, uint32_t q) {
  const RnsPart part =
      fwd_rns_passes(cl, sa, x, roots, precon, batch, s, rank, u, q);
  with_radix<kDotLogRow>(s.logw, [&](auto r) {
    rns_fwd_row_pass<decltype(r)::value>(sa, y + part.base, s, rank,
                                         part.valid, roots, precon, q);
  });
}

// K12, the DIT inverse between its bit-reversals, on unit u of (B, n) z
// (already bit-reversed, any words below 4q) -> y in [0, q): fwd_rns_passes
// on the cyclic tables of omega = psi^-2 (roots, precon), then
// rns_dit_row_pass with the post row (post, post_p).
template <class Cluster>
__device__ __forceinline__ void dit_inv_rns_body(
    Cluster& cl, uint32_t* sa, const uint32_t* __restrict__ x,
    uint32_t* __restrict__ y, const uint32_t* __restrict__ roots,
    const uint32_t* __restrict__ precon, const uint32_t* __restrict__ post,
    const uint32_t* __restrict__ post_p, long long batch, const DotShape& s,
    int rank, long long u, uint32_t q) {
  const RnsPart part =
      fwd_rns_passes(cl, sa, x, roots, precon, batch, s, rank, u, q);
  with_radix<kDotLogRow>(s.logw, [&](auto r) {
    rns_dit_row_pass<decltype(r)::value>(sa, y + part.base, s, rank,
                                         part.valid, roots, precon, post,
                                         post_p, q);
  });
}

// One channel's inverse transforms of unit u; `scale` points at the
// channel's four words (su, su', sv, sv') of the scaled last stage.
template <class Cluster>
__device__ __forceinline__ void inv_rns_body(
    Cluster& cl, uint32_t* sa, const uint32_t* __restrict__ x,
    uint32_t* __restrict__ y, const uint32_t* __restrict__ iroots,
    const uint32_t* __restrict__ iprecon, long long batch, const DotShape& s,
    int rank, long long u, uint32_t q, const uint32_t* scale) {
  const int top = s.logc + s.logr;
  const RnsPart part = rns_part(s, rank, u, batch);
  rns_load(sa, x + part.base, s, part.valid);
  copy_async_wait();
  __syncthreads();
  with_radix<kDotLogRow>(s.logw, [&](auto r) {
    rns_inv_row_pass<decltype(r)::value>(sa, y + part.base, s, rank,
                                         part.valid, iroots, iprecon, scale,
                                         q);
  });
  for (int hi = top; hi > s.logc;) {
    __syncthreads();
    const int kk = inv_pass_stages(hi - s.logc);
    hi -= kk;
    with_radix<k4RadixLog>(kk, [&](auto r) {
      if (hi == 0) {
        rns_col_inv_store_pass<decltype(r)::value>(
            sa, y + part.base, s, part.valid, iroots, iprecon, scale, q);
      } else {
        dot_col_inv_pass<decltype(r)::value>(sa, nullptr, s, rank, hi, 0, 0,
                                             iroots, iprecon, nullptr, q);
      }
    });
  }
  if (s.logc > 0) {
    cl.sync();
    with_radix<kDotMaxClusterLog>(s.logc, [&](auto r) {
      dot_cross_pass<decltype(r)::value, true>(cl, sa, nullptr, y, s, rank, u,
                                               iroots, iprecon, scale, q);
    });
    cl.sync();  // no CTA exits from a slab another reads
  }
}

}  // namespace
