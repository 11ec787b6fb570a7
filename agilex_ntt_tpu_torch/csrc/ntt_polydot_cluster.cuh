// The fused polydot (K6b, and K5 as its k = 1; at one channel K6a and K3)
// on register-radix passes with the lazy sum kept in registers:
//   polydot_rns_body <- _polydot_rns_kernel (K6b,
//                       agilex_ntt_tpu/ops/ntt_kernel.py:646)
//                    and _polymul_rns_kernel (K5,
//                       agilex_ntt_tpu/ops/ntt_kernel.py:360)
//                    and, launched with L = 1 on one prime's tables
//                    (negacyclic or cyclic), _polydot_kernel (K6a,
//                       agilex_ntt_tpu/ops/ntt_kernel.py:760)
//                    and _polymul_kernel (K3,
//                       agilex_ntt_tpu/ops/ntt_kernel.py:241)
// Per channel l and polynomial b: sum_i a_i b_i mod (X^n + 1, q_l) for
// (L, B, k, n) operands, out (L, B, n) in [0, q_l): per term the forward
// transforms of a_i and b_i, their Montgomery product added to the lazy sum,
// and after the last term the inverse of the sum scaled by the channel's
// polymul scale (n^-1 2^32, which absorbs the Montgomery factor).
//
// What bounds it on this card: int32 issue.  At the key switch's shape (L =
// K = 5 primes, B = 64, k = dnum = 4, n = 16384) the 2k + 1 = 9 transforms
// of 14 stages and the products need 0.0796 ms of issue against 0.057 ms to
// move the bytes (chip_smoke.py computes both).  The radix-2 kernel this
// body replaced (one CTA of 512 threads a polynomial, a radix-2 stage a
// barrier, the first transform parked in a second tile and the sum in a
// third) ran at 5% of that bound (K3 and K6a at 10% of theirs),
// latency-bound with one CTA an SM.
//
// Design:
//   * A CTA holds S = kDotSumWords x threads words of each operand: 4096 at
//     256 threads.  A polynomial of n > S words is split over a cluster of C
//     = n / S CTAs (CTA `rank` holds words [rank S, rank S + S)); below S a
//     CTA holds P = S / n whole polynomials.  Both operands of a term are
//     resident (two slabs), and the next term's pair is loaded into two more
//     by cp.async while the current term's passes run: 72 KiB a CTA, so
//     three CTAs of 256 threads share an SM (24 warps).
//   * The transform is the radix-2 network of the TPU kernel (stage s pairs
//     word j with j + n / 2^(s+1), twiddles roots[2^s + j >> (log n - s)],
//     the compact HEXL tables), run in passes of at most k4RadixLog stages
//     in registers (ntt_ct_radix / ntt_gs_radix, the twiddles of a group
//     loaded once): about 5 barriers a transform instead of 14.
//       - the first log2 C stages pair words of different CTAs: one radix-C
//         group through distributed shared memory at every slab word, as the
//         four-step cluster kernels' cross_pass does;
//       - the next stages (strides of 8 words and more) run on groups whose
//         consecutive threads take consecutive words, so a warp shares one
//         set of twiddles (one broadcast load);
//       - the last 3 stages (strides 4, 2, 1) take one group of 8
//         consecutive words a thread.  The slab stores each 8 words in a row
//         of pitch 9, so that 32 threads on 32 consecutive rows hit 32 banks,
//         and the group's twiddles for consecutive rows are consecutive
//         words (a few cache lines a warp, not 32).
//   * The last forward pass is the turn pass: it transforms both operands'
//     rows, reduces them to [0, q), adds their Montgomery product to the sum
//     (acc = t_0, then cond_sub(acc + t_i, 2q): [0, 2q), the TPU kernel's
//     order) and keeps the sum in registers, 16 words a thread across the k
//     terms; after the last term the same pass runs the first inverse pass
//     on them.  There is no copy of the first transform and no accumulate
//     pass.
//   * The inverse runs the mirror passes; its last stage (s = 0: the radix-C
//     group across the cluster, else the top column pass) folds the scale
//     and stores straight to device memory.
// The output words are canonical, so they equal the plain version's and
// the TPU kernel's; the spectrum's internal order and lazy ranges are free.
//
// The body takes the cluster as a template parameter, as the four-step
// bodies do, so that tests/test_torch_arith_host.py runs it on host threads.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include "ntt_arith.cuh"
#include "ntt_fourstep_cluster.cuh"

namespace {

// Words of the lazy sum a thread keeps in registers; a CTA holds this many
// words a thread of each operand.
constexpr int kDotLogSumWords = 4;
constexpr int kDotSumWords = 1 << kDotLogSumWords;
// The last forward pass: rows of 8 words.
constexpr int kDotLogRow = 3;
// Most CTAs a polynomial (n = 32768 at 256 threads a CTA): the portable
// cluster size.
constexpr int kDotMaxClusterLog = 3;

// The layout of one CTA's part of the operands.
struct DotShape {
  int logn;   // the transform's size
  int logs;   // words a CTA holds of an operand: kDotSumWords x threads
  int logc;   // CTAs a polynomial (a cluster): n / S, or 0
  int logp;   // polynomials a CTA: S / n, or 0
  int logw;   // words a row: min(kDotLogRow, logn)
  int logr;   // rows a polynomial's part: logn - logc - logw
  int pitch;  // words between rows: 2^logw + 1
};

inline DotShape make_dot_shape(int logn, int logthreads) {
  DotShape s;
  s.logn = logn;
  s.logs = logthreads + kDotLogSumWords;
  s.logc = logn > s.logs ? logn - s.logs : 0;
  s.logp = logn < s.logs ? s.logs - logn : 0;
  s.logw = logn < kDotLogRow ? logn : kDotLogRow;
  s.logr = logn - s.logc - s.logw;
  s.pitch = (1 << s.logw) + 1;
  return s;
}

// Words of one slab (one operand of one term).
__host__ __device__ inline size_t dot_slab_words(const DotShape& s) {
  return (size_t)s.pitch << (s.logs - s.logw);
}

// Shared memory of a CTA: two slabs, and two more for the next term's pair
// when there is one.
inline size_t dot_smem_bytes(const DotShape& s, int k) {
  return (size_t)(k > 1 ? 4 : 2) * 4 * dot_slab_words(s);
}

// A slab word: logical word e of the CTA's part, 8 (2^logw) to a row.
__device__ __forceinline__ int dot_word(const DotShape& s, int e) {
  return (e >> s.logw) * s.pitch + (e & ((1 << s.logw) - 1));
}

// The device-memory index of logical word e of polynomial row `row` (poly
// k + term of an operand, or poly of the output): its polynomial's words
// start at row << logn; this CTA's part at rank S.
__device__ __forceinline__ size_t dot_global(const DotShape& s, long long row,
                                             int rank, int e) {
  return ((size_t)row << s.logn) + ((size_t)rank << s.logs) +
         (e & ((1 << s.logn) - 1));
}

__device__ __forceinline__ void copy_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Waits for all but the most recently committed group of copies.
__device__ __forceinline__ void copy_async_wait_prior() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
#endif
}

// threadIdx.x, read anew at every call: arithmetic on it then stays inside
// the pass that calls it.  (Hoisted out of the term loop, the passes'
// addresses for all of a thread's words took more registers than the
// kernel has and pushed them and the sum to local memory.)
__device__ __forceinline__ int dot_tid() {
#ifdef __CUDA_ARCH__
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
#else
  return (int)threadIdx.x;
#endif
}

// Term `term` of a and b (this CTA's part of polynomials poly0 ...) into
// slabs sa and sb, by cp.async, as one committed group; polynomials past
// the batch read as zero.
__device__ __forceinline__ void dot_load(uint32_t* sa, uint32_t* sb,
                                         const uint32_t* __restrict__ a,
                                         const uint32_t* __restrict__ b,
                                         const DotShape& s, int rank,
                                         long long poly0, long long batch,
                                         int k, int term) {
  NTT_NO_UNROLL
  for (int f = dot_tid(); f < (1 << s.logs); f += blockDim.x) {
    const long long poly = poly0 + (f >> s.logn);
    const int w = dot_word(s, f);
    if (poly < batch) {
      const size_t g = dot_global(s, poly * k + term, rank, f);
      copy_async(sa + w, a + g);
      copy_async(sb + w, b + g);
    } else {
      sa[w] = 0u;
      sb[w] = 0u;
    }
  }
  copy_async_commit();
}

// The radix-C groups across the cluster, stages [0, logc) (block 0: one
// set of twiddles): this CTA takes words [rank S / C, (rank + 1) S / C) of
// every CTA's slab.  Forward on slabs sa and sb (kOps = 2, the dot's pair)
// or on sa alone (kOps = 1, the transforms of ntt_rns_transform.cuh: g
// then never reaches sb); inverse (kInv) on sa, scaled, storing CTA j's
// results to its words of `out` (poly0 < batch: with a cluster a CTA holds
// one polynomial).
template <int K, bool kInv, int kOps = (kInv ? 1 : 2), class Cluster>
__device__ __forceinline__ void dot_cross_pass(
    Cluster& cl, uint32_t* sa, uint32_t* sb, uint32_t* __restrict__ out,
    const DotShape& s, int rank, long long poly0,
    const uint32_t* __restrict__ roots, const uint32_t* __restrict__ precon,
    const uint32_t* scale, uint32_t q) {
  uint32_t w[(1 << K) - 1], wp[(1 << K) - 1];
  load_group_twiddles<K>(w, wp, roots, precon, 0, 0);
  const int loge = s.logs - K;  // this CTA's words of a slab
  const int count = kOps << loge;
  for (int g = dot_tid(); g < count; g += blockDim.x) {
    const int e = (rank << loge) + (g & ((1 << loge) - 1));
    uint32_t* word = ((g >> loge) != 0 ? sb : sa) + dot_word(s, e);
    uint32_t v[1 << K];
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) v[j] = *cl.map_shared_rank(word, j);
    if (kInv) {
      ntt_gs_radix<K>(v, w, wp, q, scale);
      NTT_UNROLL
      for (int j = 0; j < (1 << K); ++j) out[dot_global(s, poly0, j, e)] = v[j];
    } else {
      ntt_ct_radix<K>(v, w, wp, q);
      NTT_UNROLL
      for (int j = 0; j < (1 << K); ++j) *cl.map_shared_rank(word, j) = v[j];
    }
  }
}

// A column group of stage s (logc <= s < logc + logr; a pass of K stages):
// column c of a row (fastest), offset o < u, block `blk` of this CTA's
// rows (for P > 1 its top bits are the polynomial); rows r0 + j u.
struct DotColGroup {
  int c, r0, gblk;  // gblk: the block of the size-n transform
};

template <int K>
__device__ __forceinline__ DotColGroup dot_col_group(int g, const DotShape& s,
                                                     int rank, int st,
                                                     int logu) {
  DotColGroup cg;
  cg.c = g & ((1 << s.logw) - 1);
  const int rest = g >> s.logw;
  const int blk = rest >> logu;
  cg.r0 = (blk << (K + logu)) + (rest & ((1 << logu) - 1));
  cg.gblk = (rank << st) + (blk & ((1 << st) - 1));
  return cg;
}

// Forward stages [s, s + K) on the columns of slabs sa and sb (kOps = 2)
// or of sa alone (kOps = 1: g then never reaches sb).
template <int K, int kOps = 2>
__device__ __forceinline__ void dot_col_fwd_pass(
    uint32_t* sa, uint32_t* sb, const DotShape& s, int rank, int st,
    const uint32_t* __restrict__ roots, const uint32_t* __restrict__ precon,
    uint32_t q) {
  const int sc = st - s.logc;             // stage within the columns
  const int logu = s.logr - sc - K;       // rows between a group's words
  const int logg = s.logs - K;            // groups of one slab
  for (int g = dot_tid(); g < (kOps << logg); g += blockDim.x) {
    uint32_t* slab = (g >> logg) != 0 ? sb : sa;
    const DotColGroup cg = dot_col_group<K>(g & ((1 << logg) - 1), s, rank,
                                            sc, logu);
    uint32_t v[1 << K];
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j)
      v[j] = slab[(cg.r0 + (j << logu)) * s.pitch + cg.c];
    uint32_t w[(1 << K) - 1], wp[(1 << K) - 1];
    load_group_twiddles<K>(w, wp, roots, precon, st, cg.gblk);
    ntt_ct_radix<K>(v, w, wp, q);
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j)
      slab[(cg.r0 + (j << logu)) * s.pitch + cg.c] = v[j];
  }
}

// Inverse stages [s, s + K) on the columns of slab sa; with `out` (s = 0,
// no cluster: the last stage, scaled) the results go to device memory.
template <int K>
__device__ __forceinline__ void dot_col_inv_pass(
    uint32_t* sa, uint32_t* __restrict__ out, const DotShape& s, int rank,
    int st, long long poly0, long long batch,
    const uint32_t* __restrict__ iroots, const uint32_t* __restrict__ iprecon,
    const uint32_t* scale, uint32_t q) {
  const int sc = st - s.logc;
  const int logu = s.logr - sc - K;
  for (int g = dot_tid(); g < (1 << (s.logs - K)); g += blockDim.x) {
    const DotColGroup cg = dot_col_group<K>(g, s, rank, sc, logu);
    uint32_t v[1 << K];
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j)
      v[j] = sa[(cg.r0 + (j << logu)) * s.pitch + cg.c];
    uint32_t w[(1 << K) - 1], wp[(1 << K) - 1];
    load_group_twiddles<K>(w, wp, iroots, iprecon, st, cg.gblk);
    ntt_gs_radix<K>(v, w, wp, q, st == 0 ? scale : nullptr);
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) {
      const int r = cg.r0 + (j << logu);
      if (out == nullptr) {
        sa[r * s.pitch + cg.c] = v[j];
      } else {
        const int e = (r << s.logw) + cg.c;
        const long long poly = poly0 + (e >> s.logn);
        if (poly < batch) out[dot_global(s, poly, rank, e)] = v[j];
      }
    }
  }
}

// The turn pass, stages [logc + logr, logn) (K = logw): row r (one a thread,
// consecutive rows on consecutive threads) of both slabs, transformed,
// reduced and multiplied, added to the sum acc (kDotSumWords words: the
// thread's rows r = threadIdx.x + i blockDim.x, 2^K words each); on the
// last term the first inverse pass on the sum, into sa, or scaled into
// `out` when these are all the stages (n <= 8).
template <int K>
__device__ __forceinline__ void dot_turn_pass(
    uint32_t* sa, const uint32_t* sb, uint32_t (&acc)[kDotSumWords],
    uint32_t* __restrict__ out, const DotShape& s, int rank, long long poly0,
    long long batch, const uint32_t* __restrict__ roots,
    const uint32_t* __restrict__ precon, const uint32_t* __restrict__ iroots,
    const uint32_t* __restrict__ iprecon, const uint32_t* scale, uint32_t q,
    uint32_t qinv_neg, bool first, bool last) {
  const int st = s.logc + s.logr;
  const uint32_t two_q = 2u * q;
  const int tid = dot_tid();
  NTT_UNROLL
  for (int i = 0; i < (kDotSumWords >> K); ++i) {
    const int r = tid + i * blockDim.x;
    const int gblk = (rank << s.logr) + (r & ((1 << s.logr) - 1));
    uint32_t va[1 << K], vb[1 << K];
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) {
      va[j] = sa[r * s.pitch + j];
      vb[j] = sb[r * s.pitch + j];
    }
    uint32_t w[(1 << K) - 1], wp[(1 << K) - 1];
    load_group_twiddles<K>(w, wp, roots, precon, st, gblk);
    ntt_ct_radix<K>(va, w, wp, q);
    ntt_ct_radix<K>(vb, w, wp, q);
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) {
      const uint32_t t = ntt_mont_lazy(ntt_reduce_4q(va[j], q),
                                       ntt_reduce_4q(vb[j], q), q, qinv_neg);
      uint32_t& sum = acc[(i << K) + j];
      sum = first ? t : ntt_cond_sub(sum + t, two_q);
    }
    if (last) {
      NTT_UNROLL
      for (int j = 0; j < (1 << K); ++j) va[j] = acc[(i << K) + j];
      load_group_twiddles<K>(w, wp, iroots, iprecon, st, gblk);
      ntt_gs_radix<K>(va, w, wp, q, st == 0 ? scale : nullptr);
      NTT_UNROLL
      for (int j = 0; j < (1 << K); ++j) {
        if (st != 0) {
          sa[r * s.pitch + j] = va[j];
        } else {
          const int e = (r << s.logw) + j;
          const long long poly = poly0 + (e >> s.logn);
          if (poly < batch) out[dot_global(s, poly, rank, e)] = va[j];
        }
      }
    }
  }
}

// One channel's part: a, b (B, k, n) and out (B, n) of the channel, its
// tables, q, -q^-1 mod 2^32 and (in device memory) the four words of its
// scaled last stage.  This CTA
// is `rank` of its cluster and holds polynomials poly0 .. poly0 + P - 1 (or
// its part of poly0).  Every thread of the cluster calls it.
template <class Cluster>
__device__ __forceinline__ void polydot_rns_body(
    Cluster& cl, uint32_t* smem, const uint32_t* __restrict__ a,
    const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
    const uint32_t* __restrict__ roots, const uint32_t* __restrict__ precon,
    const uint32_t* __restrict__ iroots, const uint32_t* __restrict__ iprecon,
    long long batch, int k, const DotShape& s, int rank, long long poly0,
    uint32_t q, uint32_t qinv_neg, const uint32_t* scale) {
  const int slab = (int)dot_slab_words(s);
  uint32_t acc[kDotSumWords];
  const int top = s.logc + s.logr;  // the turn pass's first stage
  dot_load(smem, smem + slab, a, b, s, rank, poly0, batch, k, 0);
  for (int term = 0; term < k; ++term) {
    uint32_t* sa = smem + 2 * (term & 1) * slab;
    uint32_t* sb = sa + slab;
    if (term + 1 < k) {
      uint32_t* na = smem + 2 * ((term + 1) & 1) * slab;
      dot_load(na, na + slab, a, b, s, rank, poly0, batch, k, term + 1);
      copy_async_wait_prior();
    } else {
      copy_async_wait();
    }
    if (s.logc > 0) {
      cl.sync();  // every CTA's pair has arrived
      with_radix<kDotMaxClusterLog>(s.logc, [&](auto r) {
        dot_cross_pass<decltype(r)::value, false>(cl, sa, sb, nullptr, s,
                                                  rank, poly0, roots, precon,
                                                  nullptr, q);
      });
      cl.sync();
    } else {
      __syncthreads();
    }
    for (int st = s.logc; st < top;) {
      const int kk = fwd_pass_stages(top - st);
      with_radix<k4RadixLog>(kk, [&](auto r) {
        dot_col_fwd_pass<decltype(r)::value>(sa, sb, s, rank, st, roots,
                                             precon, q);
      });
      st += kk;
      __syncthreads();
    }
    with_radix<kDotLogRow>(s.logw, [&](auto r) {
      dot_turn_pass<decltype(r)::value>(
          sa, sb, acc, out, s, rank, poly0, batch, roots, precon, iroots,
          iprecon, scale, q, qinv_neg, term == 0, term == k - 1);
    });
    // the next iteration loads into this pair; the inverse reads sa
    __syncthreads();
  }
  uint32_t* sa = smem + 2 * ((k - 1) & 1) * slab;
  for (int hi = top; hi > s.logc;) {
    const int kk = inv_pass_stages(hi - s.logc);
    hi -= kk;
    with_radix<k4RadixLog>(kk, [&](auto r) {
      dot_col_inv_pass<decltype(r)::value>(sa, hi == 0 ? out : nullptr, s,
                                           rank, hi, poly0, batch, iroots,
                                           iprecon, scale, q);
    });
    if (hi > 0) __syncthreads();
  }
  if (s.logc > 0) {
    cl.sync();
    with_radix<kDotMaxClusterLog>(s.logc, [&](auto r) {
      dot_cross_pass<decltype(r)::value, true>(cl, sa, nullptr, out, s, rank,
                                               poly0, iroots, iprecon, scale,
                                               q);
    });
    cl.sync();  // no CTA exits while another reads its slab
  }
}

}  // namespace
