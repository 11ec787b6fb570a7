// The four-step forward transform (K7a), inverse (K7b) and polymul (K8)
// with one polynomial's whole (n1, n2) matrix on chip, in the shared memory
// of a thread-block cluster, and the column passes (K9a, K9b) on column
// slabs.
//
// They replace, for every matrix that fits (ntt_kernels.cu launches its
// walking kernels fwd4_kernel, inv4_kernel, polymul4_kernel,
// col_fwd4_kernel and col_inv4_kernel above that):
//   fwd4_cluster_body     <- _full_fwd_kernel     (K7a,
//                            agilex_ntt_tpu/ops/fourstep.py:345)
//   inv4_cluster_body     <- _full_inv_kernel     (K7b,
//                            agilex_ntt_tpu/ops/fourstep.py:362)
//   polymul4_cluster_body <- _full_polymul_kernel (K8,
//                            agilex_ntt_tpu/ops/fourstep.py:449)
//   col_fwd_slab_body     <- _col_fwd_kernel      (K9a,
//                            agilex_ntt_tpu/ops/fourstep.py:194)
//   col_inv_slab_body     <- _col_inv_kernel      (K9b,
//                            agilex_ntt_tpu/ops/fourstep.py:208)
// The TPU kernels keep the matrix in VMEM from the column pass to the row
// pass.  On an H100 a 2^16-word matrix (256 KiB) exceeds the 227 KiB of
// one block; a cluster's distributed shared memory is Hopper's counterpart
// of VMEM.  Each word then crosses device memory once in and once out, the
// bytes the bound counts (the walking kernels move it two or three times).
// K9a's and K9b's columns are independent, so they need no cluster: one CTA
// a slab of w columns, as wide as three CTAs an SM allow, loaded in one
// burst and transformed by the same register-radix column passes (K9b's
// are K7b's: T^-1 on the first, the last storing to device memory).
//
// Layout.  C = 2^logc CTAs of one cluster hold one polynomial.  CTA `rank`
// holds the columns [rank w, rank w + w) of every row (w = n2 / C) in its
// slab: row r at words r * pitch, pitch = w + 1.  The pitch is odd, so
// that 32 threads on 32 consecutive columns of a row, or on one column of
// 32 consecutive rows, hit 32 different banks.
//
// Passes, each ending on a barrier:
//   0. the load: every thread puts all its words of the slab in flight at
//      once (cp.async, device memory to shared memory, a warp on 32
//      consecutive columns: 128 bytes of a row), then waits.
//   1. the column pass: the size-n1 stages down the slab's own columns; its
//      last pass multiplies by T.
//   2. the first logc row stages.  Row stage s < logc pairs column j with
//      column j + n2 / 2^(s+1): the same slab word in another CTA.  So the
//      logc stages are a radix-C group across the cluster at every slab
//      word.  Each CTA takes 1/C of the words, reads the C words of each
//      group through distributed shared memory (map_shared_rank), runs the
//      logc stages in registers and writes them back.  An all-to-all of row
//      slabs would move as many words, but it needs a second buffer; this
//      needs none, which is what leaves room for K8's two operands.
//   3. the last log2(w) row stages, local to the slab.
//   4. K7a: the slab to device memory, coalesced.  K8: see
//      polymul4_cluster_body.
// K7b runs the inverse passes in the mirror order (rows local, rows across
// the cluster, columns storing to device memory): K8's inverse half.
// Every local pass is a register-radix pass: a thread loads the 2^K words
// of a group (K <= k4RadixLog), loads its 2^K - 1 twiddles once, and runs K
// stages in registers (ntt_ct_radix / ntt_gs_radix) between two trips
// through shared memory: a third of the trips and barriers of the walking
// kernels' radix-2 stage loop (fwd_stages, inv_stages).  Column passes put
// consecutive threads on consecutive columns, row passes on consecutive
// rows; both then share each twiddle across the warp (one broadcast load).
//
// Bound on this card, as for the walking kernels: bytes for K7a (each word
// in and out once, plus T, T' and the tables), int32 issue for K8.  They
// reach a quarter and a fifth of those bounds; what holds them back is
// latency at few warps an SM (PERF.md), so ntt_kernels.cu launches three
// CTAs of 256 threads an SM wherever the slabs allow it.
//
// The bodies take the cluster as a template parameter (on the card
// cooperative_groups::cluster_group: block_rank(), sync(),
// map_shared_rank()), so this header needs no CUDA header:
// tests/test_torch_arith_host.py runs them on host threads.  It is
// included by ntt_kernels.cu, which defines the kernels and their
// launchers.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include "ntt_arith.cuh"

namespace {

struct Tabs4 {
  const uint32_t* col;        // column transform's roots (or inverse roots)
  const uint32_t* col_precon;
  const uint32_t* row;        // row transform's roots (or inverse roots)
  const uint32_t* row_precon;
  const uint32_t* tw;         // (n1, n2) twiddles T (or T^-1)
  const uint32_t* tw_precon;
};

struct Scale4 {
  uint32_t su, sup, sv, svp;  // the last inverse stage's constants
};

// Most stages a local pass runs in registers.
constexpr int k4RadixLog = 3;
// Most CTAs a cluster may have: 16 (8 is the portable limit).
constexpr int k4MaxClusterLog = 4;

// One CTA's part of a polynomial's (n1, n2) matrix.
struct Slab4 {
  int logn1, logn2;  // the matrix
  int logc;          // the cluster's 2^logc CTAs
  int logw;          // the slab's columns: logn2 - logc
  int pitch;         // words a slab row: w + 1
};

inline Slab4 make_slab4(int logn1, int logn2, int logc) {
  Slab4 s;
  s.logn1 = logn1;
  s.logn2 = logn2;
  s.logc = logc;
  s.logw = logn2 - logc;
  s.pitch = (1 << s.logw) + 1;
  return s;
}

// Shared memory of one CTA holding `mats` slabs (1: K7a, 2: K8).
inline size_t cluster_smem_bytes(int mats, int logn1, int logn2, int logc) {
  return (size_t)mats * 4 * ((size_t)1 << logn1) *
         (((size_t)1 << (logn2 - logc)) + 1);
}

// log2 of the CTAs that hold `mats` (n1, n2) matrices: the fewest whose
// slabs fit in `max_bytes` of shared memory each.  -1 where no cluster
// does (more than 16 CTAs, or slabs narrower than 2 columns): the caller
// launches the walking kernel.
inline int cluster_logc(int mats, int logn1, int logn2, size_t max_bytes) {
  for (int logc = 0; logc <= k4MaxClusterLog && logc < logn2; ++logc) {
    if (logn1 + logn2 < 2 * logc) break;  // fewer words a CTA than CTAs
    if (cluster_smem_bytes(mats, logn1, logn2, logc) <= max_bytes) return logc;
  }
  return -1;
}

// log2 of K9a's slab width: the widest slab of at most n2 and at least 2
// columns that fits in `max_bytes` of shared memory, or -1 (n1 = 2^15).
inline int slab_logw(int logn1, int logn2, size_t max_bytes) {
  for (int logw = logn2; logw >= 1; --logw)
    if (cluster_smem_bytes(1, logn1, logn2, logn2 - logw) <= max_bytes)
      return logw;
  return -1;
}

// A transform's stages run in passes of at most k4RadixLog, whose sizes
// differ by at most one, the larger ones at the bottom (smallest strides):
// top down a pass takes the floor share of the `rem` stages left, bottom up
// the ceiling share, so both walks give the same passes (K8's product pass
// needs the last forward pass and the first inverse pass to coincide).
__host__ __device__ inline int passes_left(int rem) {
  return (rem + k4RadixLog - 1) / k4RadixLog;
}
__host__ __device__ inline int fwd_pass_stages(int rem) {
  return rem / passes_left(rem);
}
__host__ __device__ inline int inv_pass_stages(int rem) {
  const int p = passes_left(rem);
  return (rem + p - 1) / p;
}

template <int V>
struct RadixLog {
  static constexpr int value = V;
};

// f(RadixLog<k>()) for k in [1, Max], Max <= 4: only those instances.
template <int Max, class F>
__device__ __forceinline__ void with_radix(int k, F&& f) {
  switch (k) {
    case 1: f(RadixLog<1>()); break;
    case 2: if constexpr (Max >= 2) f(RadixLog<2>()); break;
    case 3: if constexpr (Max >= 3) f(RadixLog<3>()); break;
    default: if constexpr (Max >= 4) f(RadixLog<4>()); break;
  }
}

// The twiddles of a radix-2^K group at stages [s, s + K), block `blk`, in
// ntt_ct_radix's order: roots[2^(s+l) + blk 2^l + i] at 2^l - 1 + i.
template <int K>
__device__ __forceinline__ void load_group_twiddles(
    uint32_t* w, uint32_t* wp, const uint32_t* __restrict__ roots,
    const uint32_t* __restrict__ precon, int s, int blk) {
  NTT_UNROLL
  for (int l = 0; l < K; ++l) {
    NTT_UNROLL
    for (int i = 0; i < (1 << l); ++i) {
      const int g = (1 << (s + l)) + (blk << l) + i;
      w[(1 << l) - 1 + i] = __ldg(roots + g);
      wp[(1 << l) - 1 + i] = __ldg(precon + g);
    }
  }
}

// -- local passes -------------------------------------------------------------
//
// Column pass groups: column c of the slab (fastest), offset o < u, block
// blk; rows r0 + j u, r0 = blk 2^K u + o.  Row pass groups: row r
// (fastest), o, blk; words r * pitch + blk 2^K u + o + j u, global block
// rank 2^(s - logc) + blk of the size-n2 row transform.

// One word from device memory to shared memory without a register: the
// thread goes on at once (cp.async); copy_async_wait() waits for all of its
// copies.
__device__ __forceinline__ void copy_async(uint32_t* dst, const uint32_t* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copy_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// The slab's words of matrix g0 into slab b0 (and of g1 into b1, when not
// null); ends on a barrier.
__device__ __forceinline__ void load_slabs(uint32_t* b0, uint32_t* b1,
                                           const uint32_t* __restrict__ g0,
                                           const uint32_t* __restrict__ g1,
                                           const Slab4& sl, int rank) {
  const int logs = sl.logn1 + sl.logw;  // words of one slab
  const int count = (b1 != nullptr ? 2 : 1) << logs;
  const size_t col0 = (size_t)rank << sl.logw;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const bool second = (e >> logs) != 0;
    const int f = e & ((1 << logs) - 1);
    const int r = f >> sl.logw, c = f & ((1 << sl.logw) - 1);
    copy_async((second ? b1 : b0) + r * sl.pitch + c,
               (second ? g1 : g0) + ((size_t)r << sl.logn2) + col0 + c);
  }
  copy_async_wait();
  __syncthreads();
}

// Forward stages [s, s + K) of the size-n1 column transforms of slab b0
// (and b1, when not null).  With `twiddle` (the last pass: u = 1) each
// result is multiplied by T (lazy [0, 2q)), first reduced to [0, q) with
// `reduce` (K9a: its lazy words must be the reference's, whose column
// transform ends reduced; the lazy Shoup product of x and x + q differ).
template <int K>
__device__ __forceinline__ void col_fwd_pass(uint32_t* b0, uint32_t* b1,
                                             const Slab4& sl, int rank, int s,
                                             const Tabs4& t, uint32_t q,
                                             bool twiddle, bool reduce) {
  const int logu = sl.logn1 - s - K;
  const int logg = sl.logn1 - K + sl.logw;  // groups of one slab
  const int count = (b1 != nullptr ? 2 : 1) << logg;
  const size_t col0 = (size_t)rank << sl.logw;
  for (int g = threadIdx.x; g < count; g += blockDim.x) {
    const bool second = (g >> logg) != 0;
    const int c = g & ((1 << sl.logw) - 1);
    const int rest = (g & ((1 << logg) - 1)) >> sl.logw;
    const int blk = rest >> logu;
    const int r0 = (blk << (K + logu)) + (rest & ((1 << logu) - 1));
    uint32_t* slab = second ? b1 : b0;
    uint32_t v[1 << K];
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j)
      v[j] = slab[(r0 + (j << logu)) * sl.pitch + c];
    uint32_t tw[1 << K], twp[1 << K];
    if (twiddle) {
      NTT_UNROLL
      for (int j = 0; j < (1 << K); ++j) {
        const size_t e = ((size_t)(r0 + j) << sl.logn2) + col0 + c;
        tw[j] = __ldg(t.tw + e);
        twp[j] = __ldg(t.tw_precon + e);
      }
    }
    uint32_t w[(1 << K) - 1], wp[(1 << K) - 1];
    load_group_twiddles<K>(w, wp, t.col, t.col_precon, s, blk);
    ntt_ct_radix<K>(v, w, wp, q);
    if (twiddle) {
      NTT_UNROLL
      for (int j = 0; j < (1 << K); ++j)
        v[j] = ntt_shoup_lazy(reduce ? ntt_reduce_4q(v[j], q) : v[j], tw[j],
                              twp[j], q);
    }
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j)
      slab[(r0 + (j << logu)) * sl.pitch + c] = v[j];
  }
}

// Inverse stages [s, s + K) of the column transforms of the slab.  With
// `twiddle` (the first inverse pass: u = 1) the words are multiplied by
// T^-1 first (any word in, [0, 2q)); `scale` (s = 0) scales the last
// stage; with `dst` (this polynomial's output matrix) the results go there
// instead of the slab.
template <int K>
__device__ __forceinline__ void col_inv_pass(uint32_t* slab,
                                             uint32_t* __restrict__ dst,
                                             const Slab4& sl, int rank, int s,
                                             const Tabs4& t,
                                             const uint32_t* scale, uint32_t q,
                                             bool twiddle) {
  const int logu = sl.logn1 - s - K;
  const int count = 1 << (sl.logn1 - K + sl.logw);
  const size_t col0 = (size_t)rank << sl.logw;
  for (int g = threadIdx.x; g < count; g += blockDim.x) {
    const int c = g & ((1 << sl.logw) - 1);
    const int rest = g >> sl.logw;
    const int blk = rest >> logu;
    const int r0 = (blk << (K + logu)) + (rest & ((1 << logu) - 1));
    uint32_t v[1 << K];
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j)
      v[j] = slab[(r0 + (j << logu)) * sl.pitch + c];
    if (twiddle) {
      NTT_UNROLL
      for (int j = 0; j < (1 << K); ++j) {
        const size_t e = ((size_t)(r0 + j) << sl.logn2) + col0 + c;
        v[j] = ntt_shoup_lazy(v[j], __ldg(t.tw + e), __ldg(t.tw_precon + e), q);
      }
    }
    uint32_t w[(1 << K) - 1], wp[(1 << K) - 1];
    load_group_twiddles<K>(w, wp, t.col, t.col_precon, s, blk);
    ntt_gs_radix<K>(v, w, wp, q, scale);
    if (dst != nullptr) {
      NTT_UNROLL
      for (int j = 0; j < (1 << K); ++j)
        dst[((size_t)(r0 + (j << logu)) << sl.logn2) + col0 + c] = v[j];
    } else {
      NTT_UNROLL
      for (int j = 0; j < (1 << K); ++j)
        slab[(r0 + (j << logu)) * sl.pitch + c] = v[j];
    }
  }
}

// The column inverse of the slab, stages logn1 - 1 .. 0 in passes: T^-1
// first (any word in), the scale cs on the last stage, the last pass
// storing straight to dst (in [0, q)).  Shared by K7b and K8 (after their
// row stages) and K9b.
__device__ __forceinline__ void col_inv_passes(uint32_t* slab,
                                               uint32_t* __restrict__ dst,
                                               const Slab4& sl, int rank,
                                               const Tabs4& i,
                                               const uint32_t* cs,
                                               uint32_t q) {
  for (int hi = sl.logn1; hi > 0;) {
    const int k = inv_pass_stages(hi);
    const bool first = hi == sl.logn1;
    hi -= k;
    with_radix<k4RadixLog>(k, [&](auto r) {
      col_inv_pass<decltype(r)::value>(slab, hi == 0 ? dst : nullptr, sl,
                                       rank, hi, i, hi == 0 ? cs : nullptr, q,
                                       first);
    });
    if (hi > 0) __syncthreads();
  }
}

// The row pass group g's first word and global block.
struct RowGroup {
  int word, blk;
};

template <int K>
__device__ __forceinline__ RowGroup row_group(int g, const Slab4& sl, int rank,
                                              int s, int logu) {
  const int r = g & ((1 << sl.logn1) - 1);
  const int rest = g >> sl.logn1;
  const int blk = rest >> logu;
  RowGroup rg;
  rg.word = r * sl.pitch + (blk << (K + logu)) + (rest & ((1 << logu) - 1));
  rg.blk = (rank << (s - sl.logc)) + blk;
  return rg;
}

// Forward row stages [s, s + K), s >= logc, of slab b0 (and b1); with
// `reduce` (the last stage) the results are reduced to [0, q).
template <int K>
__device__ __forceinline__ void row_fwd_pass(uint32_t* b0, uint32_t* b1,
                                             const Slab4& sl, int rank, int s,
                                             const Tabs4& t, uint32_t q,
                                             bool reduce) {
  const int logu = sl.logn2 - s - K;
  const int logg = sl.logn1 + sl.logw - K;
  const int count = (b1 != nullptr ? 2 : 1) << logg;
  for (int g = threadIdx.x; g < count; g += blockDim.x) {
    uint32_t* slab = (g >> logg) != 0 ? b1 : b0;
    const RowGroup rg = row_group<K>(g & ((1 << logg) - 1), sl, rank, s, logu);
    uint32_t v[1 << K];
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) v[j] = slab[rg.word + (j << logu)];
    uint32_t w[(1 << K) - 1], wp[(1 << K) - 1];
    load_group_twiddles<K>(w, wp, t.row, t.row_precon, s, rg.blk);
    ntt_ct_radix<K>(v, w, wp, q);
    if (reduce) {
      NTT_UNROLL
      for (int j = 0; j < (1 << K); ++j) v[j] = ntt_reduce_4q(v[j], q);
    }
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) slab[rg.word + (j << logu)] = v[j];
  }
}

// Inverse row stages [s, s + K), s >= logc, of the slab; `scale` when
// s = 0 (a cluster of one CTA).
template <int K>
__device__ __forceinline__ void row_inv_pass(uint32_t* slab, const Slab4& sl,
                                             int rank, int s, const Tabs4& t,
                                             const uint32_t* scale,
                                             uint32_t q) {
  const int logu = sl.logn2 - s - K;
  const int count = 1 << (sl.logn1 + sl.logw - K);
  for (int g = threadIdx.x; g < count; g += blockDim.x) {
    const RowGroup rg = row_group<K>(g, sl, rank, s, logu);
    uint32_t v[1 << K];
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) v[j] = slab[rg.word + (j << logu)];
    uint32_t w[(1 << K) - 1], wp[(1 << K) - 1];
    load_group_twiddles<K>(w, wp, t.row, t.row_precon, s, rg.blk);
    ntt_gs_radix<K>(v, w, wp, q, scale);
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) slab[rg.word + (j << logu)] = v[j];
  }
}

// K8's turn from forward to inverse, stages [s, logn2) (u = 1): the last
// forward row pass of both slabs (reduced to [0, q)), their Montgomery
// product (a b 2^-32, lazy [0, 2q)) and the first inverse row pass on it,
// into slab a; group by group in registers.
template <int K>
__device__ __forceinline__ void row_product_pass(
    uint32_t* a, const uint32_t* b, const Slab4& sl, int rank, int s,
    const Tabs4& f, const Tabs4& i, const uint32_t* scale, uint32_t q,
    uint32_t qinv_neg) {
  const int count = 1 << (sl.logn1 + sl.logw - K);
  for (int g = threadIdx.x; g < count; g += blockDim.x) {
    const RowGroup rg = row_group<K>(g, sl, rank, s, 0);
    uint32_t va[1 << K], vb[1 << K];
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) {
      va[j] = a[rg.word + j];
      vb[j] = b[rg.word + j];
    }
    uint32_t w[(1 << K) - 1], wp[(1 << K) - 1];
    load_group_twiddles<K>(w, wp, f.row, f.row_precon, s, rg.blk);
    ntt_ct_radix<K>(va, w, wp, q);
    ntt_ct_radix<K>(vb, w, wp, q);
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j)
      va[j] = ntt_mont_lazy(ntt_reduce_4q(va[j], q), ntt_reduce_4q(vb[j], q),
                            q, qinv_neg);
    load_group_twiddles<K>(w, wp, i.row, i.row_precon, s, rg.blk);
    ntt_gs_radix<K>(va, w, wp, q, scale);
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) a[rg.word + j] = va[j];
  }
}

// -- the row stages across the cluster ----------------------------------------
//
// Row stages [0, logc) (K = logc): the group at slab word e is word e of
// every CTA, CTA j's word at j; block 0, so one set of twiddles serves every
// group.  This CTA takes the words [rank S / C, (rank + 1) S / C) of the
// S = n1 w, 32 consecutive ones a warp.  The inverse runs row stages
// logc - 1 .. 0, the last scaled by `scale`.

__device__ __forceinline__ int cross_word(int idx, const Slab4& sl) {
  return (idx >> sl.logw) * sl.pitch + (idx & ((1 << sl.logw) - 1));
}

// The radix-C group of each of this CTA's words: load the C words, run
// the stages (kInv: ntt_gs_radix with `scale`, else ntt_ct_radix), store.
template <int K, bool kInv, class Cluster>
__device__ __forceinline__ void cross_pass(Cluster& cl, uint32_t* slab,
                                           const Slab4& sl, int rank,
                                           const Tabs4& t,
                                           const uint32_t* scale,
                                           uint32_t q) {
  uint32_t w[(1 << K) - 1], wp[(1 << K) - 1];
  load_group_twiddles<K>(w, wp, t.row, t.row_precon, 0, 0);
  const int loge = sl.logn1 + sl.logw - K;  // this CTA's words
  for (int e = threadIdx.x; e < (1 << loge); e += blockDim.x) {
    uint32_t* word = slab + cross_word((rank << loge) + e, sl);
    uint32_t v[1 << K];
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) v[j] = *cl.map_shared_rank(word, j);
    if (kInv) {
      ntt_gs_radix<K>(v, w, wp, q, scale);
    } else {
      ntt_ct_radix<K>(v, w, wp, q);
    }
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) *cl.map_shared_rank(word, j) = v[j];
  }
}

// -- the bodies ---------------------------------------------------------------
//
// One polynomial a cluster: x, y (a, b, out) point at its (n1, n2) matrix.
// The last access to another CTA's shared memory is followed by a
// cluster.sync(), so no CTA exits while another still reads its slab.

// The load and the column pass of slab b0 (and b1) from their matrices
// in device memory, T applied (`reduce`: see col_fwd_pass); no barrier
// after the last pass.
__device__ __forceinline__ void col_fwd_slabs(uint32_t* b0, uint32_t* b1,
                                              const uint32_t* g0,
                                              const uint32_t* g1,
                                              const Slab4& sl, int rank,
                                              const Tabs4& t, uint32_t q,
                                              bool reduce) {
  load_slabs(b0, b1, g0, g1, sl, rank);
  for (int s = 0; s < sl.logn1;) {
    const int k = fwd_pass_stages(sl.logn1 - s);
    with_radix<k4RadixLog>(k, [&](auto r) {
      col_fwd_pass<decltype(r)::value>(b0, b1, sl, rank, s, t, q,
                                       s + k == sl.logn1, reduce);
    });
    s += k;
    if (s < sl.logn1) __syncthreads();
  }
}

// The same for K7a and K8 (no reduction: their row pass follows), ending
// on a cluster-wide barrier.
template <class Cluster>
__device__ __forceinline__ void col_fwd_all(Cluster& cl, uint32_t* b0,
                                            uint32_t* b1, const uint32_t* g0,
                                            const uint32_t* g1,
                                            const Slab4& sl, int rank,
                                            const Tabs4& t, uint32_t q) {
  col_fwd_slabs(b0, b1, g0, g1, sl, rank, t, q, false);
  cl.sync();
}

// The slab to its columns of y, a warp on consecutive columns.
__device__ __forceinline__ void store_slab(const uint32_t* slab,
                                           uint32_t* __restrict__ y,
                                           const Slab4& sl, int rank) {
  const size_t col0 = (size_t)rank << sl.logw;
  for (int e = threadIdx.x; e < (1 << (sl.logn1 + sl.logw)); e += blockDim.x) {
    const int r = e >> sl.logw, c = e & ((1 << sl.logw) - 1);
    y[((size_t)r << sl.logn2) + col0 + c] = slab[r * sl.pitch + c];
  }
}

// K7a: x in [0, 4q), y in [0, q).
template <class Cluster>
__device__ __forceinline__ void fwd4_cluster_body(
    Cluster& cl, uint32_t* slab, const uint32_t* __restrict__ x,
    uint32_t* __restrict__ y, const Tabs4& t, const Slab4& sl, uint32_t q) {
  const int rank = (int)cl.block_rank();
  col_fwd_all(cl, slab, nullptr, x, nullptr, sl, rank, t, q);
  if (sl.logc > 0) {
    with_radix<k4MaxClusterLog>(sl.logc, [&](auto r) {
      cross_pass<decltype(r)::value, false>(cl, slab, sl, rank, t, nullptr,
                                             q);
    });
    cl.sync();
  }
  for (int s = sl.logc; s < sl.logn2;) {
    const int k = fwd_pass_stages(sl.logn2 - s);
    with_radix<k4RadixLog>(k, [&](auto r) {
      row_fwd_pass<decltype(r)::value>(slab, nullptr, sl, rank, s, t, q,
                                       s + k == sl.logn2);
    });
    s += k;
    __syncthreads();
  }
  store_slab(slab, y, sl, rank);
}

// The inverse from row stage hi down, shared by K7b and K8: the local row
// passes [logc, hi) bottom up (each after a barrier), the radix-C group
// across the cluster (scale rs: n2^-1; on the last row stage when logc =
// 0), then the column inverse, T^-1 first and the scale cs last, storing
// straight to dst.  The slab's words in [0, 2q); dst in [0, q).
template <class Cluster>
__device__ __forceinline__ void inv_rows_cols(Cluster& cl, uint32_t* slab,
                                              uint32_t* __restrict__ dst,
                                              const Slab4& sl, int rank,
                                              int hi, const Tabs4& i,
                                              const uint32_t* rs,
                                              const uint32_t* cs,
                                              uint32_t q) {
  while (hi > sl.logc) {
    __syncthreads();
    const int k = inv_pass_stages(hi - sl.logc);
    hi -= k;
    with_radix<k4RadixLog>(k, [&](auto r) {
      row_inv_pass<decltype(r)::value>(slab, sl, rank, hi, i,
                                       hi == 0 ? rs : nullptr, q);
    });
  }
  cl.sync();
  if (sl.logc > 0) {
    with_radix<k4MaxClusterLog>(sl.logc, [&](auto r) {
      cross_pass<decltype(r)::value, true>(cl, slab, sl, rank, i, rs, q);
    });
    cl.sync();
  }
  col_inv_passes(slab, dst, sl, rank, i, cs, q);
}

// K7b: x in [0, 2q), y in [0, q); the row inverse scaled by rs (n2^-1),
// the column inverse by cs (scale n2).  Every pass is K8's inverse half.
template <class Cluster>
__device__ __forceinline__ void inv4_cluster_body(
    Cluster& cl, uint32_t* slab, const uint32_t* __restrict__ x,
    uint32_t* __restrict__ y, const Tabs4& t, const Slab4& sl,
    const uint32_t* rs, const uint32_t* cs, uint32_t q) {
  const int rank = (int)cl.block_rank();
  load_slabs(slab, nullptr, x, nullptr, sl, rank);
  inv_rows_cols(cl, slab, y, sl, rank, sl.logn2, t, rs, cs, q);
}

// K8: a, b in [0, q), out = a b in [0, q).  Both operands stay in shared
// memory (slabs sa, sb): the column and row forward passes of both, the
// product in the turn pass, then inv_rows_cols on sa.  No device scratch:
// 2 reads and 1 write of every word.
template <class Cluster>
__device__ __forceinline__ void polymul4_cluster_body(
    Cluster& cl, uint32_t* smem, const uint32_t* __restrict__ a,
    const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
    const Tabs4& f, const Tabs4& i, const Slab4& sl, const uint32_t* rs,
    const uint32_t* cs, uint32_t q, uint32_t qinv_neg) {
  const int rank = (int)cl.block_rank();
  uint32_t* sa = smem;
  uint32_t* sb = smem + (sl.pitch << sl.logn1);
  col_fwd_all(cl, sa, sb, a, b, sl, rank, f, q);
  if (sl.logc > 0) {
    with_radix<k4MaxClusterLog>(sl.logc, [&](auto r) {
      cross_pass<decltype(r)::value, false>(cl, sa, sl, rank, f, nullptr, q);
      cross_pass<decltype(r)::value, false>(cl, sb, sl, rank, f, nullptr, q);
    });
    cl.sync();
  }
  int s = sl.logc;
  for (;;) {
    const int k = fwd_pass_stages(sl.logn2 - s);
    if (s + k == sl.logn2) {
      with_radix<k4RadixLog>(k, [&](auto r) {
        row_product_pass<decltype(r)::value>(sa, sb, sl, rank, s, f, i,
                                             s == 0 ? rs : nullptr, q,
                                             qinv_neg);
      });
      break;
    }
    with_radix<k4RadixLog>(k, [&](auto r) {
      row_fwd_pass<decltype(r)::value>(sa, sb, sl, rank, s, f, q, false);
    });
    s += k;
    __syncthreads();
  }
  // the product pass ran the inverse stages [s, logn2)
  inv_rows_cols(cl, sa, out, sl, rank, s, i, rs, cs, q);
}

// K9a on slab `rank` (w = 2^logw consecutive columns; sl.logc = logn2 -
// logw slabs a polynomial, no cluster): x in [0, 4q), y = T (column NTT)
// lazy in [0, 2q).
__device__ __forceinline__ void col_fwd_slab_body(
    uint32_t* slab, const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
    const Tabs4& t, const Slab4& sl, int rank, uint32_t q) {
  col_fwd_slabs(slab, nullptr, x, nullptr, sl, rank, t, q, true);
  __syncthreads();
  store_slab(slab, y, sl, rank);
}

// K9b on slab `rank` (as K9a's): x any words, y = the column inverse of
// T^-1 x scaled by cs, in [0, q).
__device__ __forceinline__ void col_inv_slab_body(
    uint32_t* slab, const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
    const Tabs4& t, const Slab4& sl, int rank, const uint32_t* cs,
    uint32_t q) {
  load_slabs(slab, nullptr, x, nullptr, sl, rank);
  col_inv_passes(slab, y, sl, rank, t, cs, q);
}

}  // namespace
