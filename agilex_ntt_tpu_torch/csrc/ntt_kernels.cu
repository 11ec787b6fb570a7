// Hopper (sm_90a) kernels of the negacyclic NTT, single- and multi-prime,
// radix-2 and four-step.
//
// Replaces eight Pallas TPU kernels of agilex_ntt_tpu/ops/ntt_kernel.py:
//   fwd_rns_cluster_kernel <- _fwd_rns_kernel (K4a, the forward
//                                        Cooley-Tukey NTT over L primes)
//   inv_rns_cluster_kernel <- _inv_rns_kernel (K4b, the Gentleman-Sande
//                                        inverse over L primes, a scale per
//                                        channel folded into the last
//                                        stage; both on the polydot's
//                                        register-radix passes, see
//                                        ntt_rns_transform.cuh)
//                   and, launched at one channel (L = 1),
//                       _fwd_kernel       (K1, ntt_fwd)
//                   and _inv_kernel       (K2, ntt_inv)
//   polydot_rns_cluster_kernel <- _polymul_rns_kernel (K5, k = 1)
//                   and _polydot_rns_kernel   (K6b, K6a over L primes; see
//                                        ntt_polydot_cluster.cuh for its
//                                        design)
//                   and, launched at one channel (L = 1),
//                       _polymul_kernel   (K3, k = 1)
//                   and _polydot_kernel   (K6a, sum of k products)
// the DIT inverse of agilex_ntt_tpu/ops/dit_inv.py and the cross-device
// stage of agilex_ntt_tpu/parallel/overlap.py:
//   dit_inv_cluster_kernel <- _dit_inv_kernel (K12, on the forward
//                                        transform's register-radix passes;
//                                        see ntt_rns_transform.cuh)
//   xchg_group_kernel      <- kernel in _xchg_call (K11, a group of
//                                        butterfly pairs a launch; see
//                                        ntt_xchg.cuh)
// the wide-modulus ring (q < 2^62 on u64 words; no Pallas kernel, the JAX
// package's plain jnp of agilex_ntt_tpu/ops/wide.py; see ntt_wide.cuh):
//   wide_fwd_cluster_kernel, wide_fwd_pass_kernel  <- fwd_stages64
//   wide_inv_cluster_kernel, wide_inv_pass_kernel  <- inv_stages64
//   wide_pointwise_kernel                  <- WideRing's elementwise bodies
// the matrix-product four-step passes on the int8 tensor cores (no Pallas
// kernel, the JAX package's jnp dot_general of agilex_ntt_tpu/ops/
// mxu_ntt.py; see ntt_mxu.cuh):
//   mxu_col_kernel, mxu_row_kernel         <- _digit_matmul (M1)
// and five of agilex_ntt_tpu/ops/fourstep.py (n = n1 * n2 > 32768; see the
// four-step section below and ntt_fourstep_cluster.cuh for their design):
//   fwd4_cluster_kernel, where the matrix fits in a cluster, else
//   fwd4_kernel     <- _full_fwd_kernel     (K7a)
//   inv4_cluster_kernel, where the matrix fits in a cluster, else
//   inv4_kernel     <- _full_inv_kernel     (K7b)
//   polymul4_cluster_kernel, where both matrices fit in a cluster, else
//   polymul4_kernel <- _full_polymul_kernel (K8)
//   col_fwd4_slab_kernel, where a slab of 2 columns fits a block, else
//   col_fwd4_kernel <- _col_fwd_kernel      (K9a)
//   col_inv4_slab_kernel, where a slab of 2 columns fits a block, else
//   col_inv4_kernel <- _col_inv_kernel      (K9b)
// The multi-prime kernels run with the channel on blockIdx.y (K4a and K4b
// on fwd_rns_body/inv_rns_body, K5/K6b on polydot_rns_body, K3/K6a there
// at one channel): each block
// reads its channel's q, -q^-1 and inverse-scale constants from (L,) and
// (L, 4) arrays and its twiddles from row l of the (L, n) tables, where the
// TPU kernels take q from SMEM and (L, log n, n) positional tables per grid
// step.
// They compute what the TPU kernels compute, not the TPU's layout: each
// butterfly is computed once (the TPU computes it at both slots of a pair
// and finds partners by lane rolls), on the compact HEXL twiddle tables
// roots[m + i] instead of (log n, n) positional tables.
//
// Bound on this card: memory for fwd/inv, int32 issue for the fused ones.
// A call must move 2 B n 4 bytes for fwd/inv, 3 B n 4 for the polymul and
// (2k + 1) B n 4 for the polydot; a multi-prime call L times that (B
// polynomials in each of L channels) plus its table words (L 2 n for a
// transform, L 4 n for the fused ones), and does L times the operations.  A transform also does (n/2) log2(n)
// butterflies of 3 multiplies (FMA pipe only), one unsigned min (ALU pipe
// only) and 3 adds (either pipe).  An H100 SM runs 64 lanes of each pipe
// and issues 128 lane-operations a clock: 16.75 T multiplies/s and 33.5 T
// operations/s at the clock behind its 67 TFLOP/s float32.  At n = 4096,
// B = 8192 the forward transform moves 268 MB (80 us at 3.35 TB/s) and
// needs 46 us of issue, so memory bounds it; the polymul's three
// transforms and pointwise product need 143 us of issue against 120 us of
// memory.  chip_smoke.py computes both for every kernel.
//
// Design against that bound: each polynomial is read from device memory
// once and written once, and no butterfly is computed twice.  The
// transforms and the fused kernels run register-radix passes on slabs of
// 4096 words a CTA (a polynomial of n > 4096 words on a cluster of n / 4096
// CTAs, smaller ones several to a CTA): the polydot (K5, K6b, and K3, K6a
// at one channel) with the sum in registers (ntt_polydot_cluster.cuh), the
// transforms (K4a, K4b, and K1, K2 at one channel) on the same passes with
// one operand (ntt_rns_transform.cuh), and the DIT inverse (K12) on the
// forward passes.  Twiddles come from the n-word tables in device memory,
// which stay in L2.  The walking four-step kernels still run the radix-2
// stages below, one block-wide barrier a stage, every stage through shared
// memory.
//
// Every launcher returns cudaGetLastError(): a launch the card refuses (too
// much shared memory, a bad configuration) never runs, and a later
// synchronize does not report it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ntt_arith.cuh"
#include "ntt_fourstep_cluster.cuh"
#include "ntt_mxu.cuh"
#include "ntt_polydot_cluster.cuh"
#include "ntt_rns_transform.cuh"
#include "ntt_wide.cuh"
#include "ntt_xchg.cuh"

namespace {

// Shared memory a block may opt in to on sm_90 (227 KB).
constexpr size_t kMaxSmemBytes = 232448;
// Above this a kernel needs cudaFuncAttributeMaxDynamicSharedMemorySize.
constexpr size_t kDefaultSmemBytes = 48 * 1024;
// Most channels a multi-prime launch takes: gridDim.y.
constexpr int kMaxChannels = 65535;

// Forward stages m = 1, 2, ..., n/2 (stride t = n/2m) on every polynomial of
// the tile; polynomial p starts at word p * pitch (pitch >= n: the
// four-step column tiles pad each column to n1 + 1 words, so that a warp
// storing one row of a transposed tile hits 32 different banks).  In
// [0, 4q), out [0, q).  Ends on a __syncthreads().
__device__ void fwd_stages(uint32_t* tile, int logn, int polys,
                           const uint32_t* __restrict__ roots,
                           const uint32_t* __restrict__ precon, uint32_t q,
                           int pitch) {
  const int half = 1 << (logn - 1);
  const int butterflies = polys * half;
  const uint32_t two_q = 2u * q;
  for (int s = 0; s < logn; ++s) {
    const int m = 1 << s;
    const int logt = logn - 1 - s;
    const int t = 1 << logt;
    const bool last = s == logn - 1;
    for (int j = threadIdx.x; j < butterflies; j += blockDim.x) {
      const int b = j & (half - 1);
      const int i = b >> logt;
      uint32_t* u = tile + (j >> (logn - 1)) * pitch + (i << (logt + 1)) +
                    (b & (t - 1));
      uint32_t x = u[0];
      uint32_t y = u[t];
      ntt_ct_butterfly(x, y, __ldg(roots + m + i), __ldg(precon + m + i), q);
      if (last) {
        x = ntt_cond_sub(ntt_cond_sub(x, two_q), q);
        y = ntt_cond_sub(ntt_cond_sub(y, two_q), q);
      }
      u[0] = x;
      u[t] = y;
    }
    __syncthreads();
  }
}

// Inverse stages m = n/2, ..., 1 (stride t = n/2m).  In [0, 2q), out [0, q).
// The last stage (m = 1) multiplies the sum by `su` and the difference by
// `sv` = scale * inv_roots[1] instead of a separate scaling pass, as the
// TPU kernel's last twiddle row does.  Polynomial p starts at word
// p * pitch, as in fwd_stages.  Ends on a __syncthreads().
__device__ void inv_stages(uint32_t* tile, int logn, int polys,
                           const uint32_t* __restrict__ iroots,
                           const uint32_t* __restrict__ iprecon, uint32_t q,
                           uint32_t su, uint32_t sup, uint32_t sv,
                           uint32_t svp, int pitch) {
  const int half = 1 << (logn - 1);
  const int butterflies = polys * half;
  const uint32_t two_q = 2u * q;
  for (int s = 0; s < logn; ++s) {
    const int m = half >> s;
    const int t = 1 << s;
    const bool last = s == logn - 1;
    for (int j = threadIdx.x; j < butterflies; j += blockDim.x) {
      const int b = j & (half - 1);
      const int i = b >> s;
      uint32_t* u = tile + (j >> (logn - 1)) * pitch + (i << (s + 1)) +
                    (b & (t - 1));
      uint32_t x = u[0];
      uint32_t y = u[t];
      if (last) {
        const uint32_t sum = x + y;
        const uint32_t diff = x + two_q - y;
        x = ntt_cond_sub(ntt_shoup_lazy(sum, su, sup, q), q);
        y = ntt_cond_sub(ntt_shoup_lazy(diff, sv, svp, q), q);
      } else {
        ntt_gs_butterfly(x, y, __ldg(iroots + m + i), __ldg(iprecon + m + i),
                         q);
      }
      u[0] = x;
      u[t] = y;
    }
    __syncthreads();
  }
}

// -- L primes (K4a, K4b, K5/K6b): channel l = blockIdx.y ---------------------
//
// Channel l's data starts at l * batch * n (l * batch * k * n for the dot's
// operands), its tables at row l of the (L, n) tables, and its scalars are
// qs[l], qinvs[l] and scales[4 l .. 4 l + 3] = (su, su', sv, sv').  All
// four run on clusters: fwd_rns_cluster_kernel, inv_rns_cluster_kernel and
// polydot_rns_cluster_kernel, after the four-step section.  The
// single-prime K1, K2, K3 and K6a are these kernels at L = 1, their (n,)
// tables read as (1, n) and their scalars from device memory.  K12
// (dit_inv_cluster_kernel) takes K1's launch.

// -- four-step, n = n1 * n2 (K7a, K7b, K8, K9a, K9b) ---------------------------
//
// A polynomial is an (n1, n2) matrix, row r holding coefficients r n2 ..
// r n2 + n2 - 1.  The forward transform runs a size-n1 NTT down every
// column, multiplies by the twiddle T[r, c] (Shoup, lazy [0, 2q)), then a
// size-n2 cyclic NTT along every row; the inverse runs the row inverse
// (scale n2^-1), the product with T^-1 and the column inverse (scale
// col_scale), as agilex_ntt_tpu/ops/fourstep.py does.  A polynomial of
// 2^16 words is 256 KiB, more than the 227 KiB a block may have, so the
// matrix cannot stay in shared memory as it stays in the TPU's VMEM.  Here
// one block owns one polynomial (K7a, K7b, K8) and walks it in tiles:
//   column tiles of tc consecutive columns (tc = 32: 128 contiguous bytes a
//     row where the tile fits), stored transposed with each column padded to
//     n1 + 1 words, so that the stage loop sees tc length-n1 polynomials;
//   the block's own slice of the output, in device memory (mostly L2 at
//     n = 2^16 .. 2^18), between the column pass and the row pass, ordered
//     by __syncthreads() since no other block touches it;
//   row tiles of whole rows.
// K9a/K9b are the column pass alone, one block a column tile; their row
// pass is K1/K2 (ntt_fwd/ntt_inv) on (B n1, n2) rows with the cyclic tables.
// K8 keeps the first operand's transform in a scratch buffer in device
// memory (B n words) and multiplies (Montgomery) while loading the inverse's
// row tiles.
//
// K7a, K7b and K8 run these walking bodies only where the matrix does not
// fit in a cluster's shared memory (n >= 2^20 for K7a and K7b, n >= 2^19
// for K8 with the balanced split).  Below that, fwd4_cluster_kernel,
// inv4_cluster_kernel and polymul4_cluster_kernel hold the whole matrix
// (both, for K8) in the shared memory of a cluster of up to 16 CTAs
// (ntt_fourstep_cluster.cuh): a choice by shape between two hand-written
// kernels, made in ntt_fwd4, ntt_inv4 and ntt_polymul4.  K9a runs
// col_fwd4_slab_kernel (one CTA a slab of columns, register-radix passes)
// wherever a slab of 2 columns fits a block, that is for n1 <= 2^14, and
// the walking col_fwd4_kernel at n1 = 2^15; K9b likewise
// (col_inv4_slab_kernel, col_inv4_kernel).  A cluster launch the card
// refuses returns its error.

constexpr int k4Threads = 1024;
// Words of one tile: 128 KiB, one block an SM.
constexpr int k4TileWords = 32768;
// Most columns a column tile takes: 128 bytes of a row.
constexpr int k4MaxCols = 32;
constexpr int k4MaxLogSide = 15;

struct Shape4 {
  int logn1, logn2;
  int logtc;  // log2 of the columns of a column tile
  int rows;   // rows of a row tile
};

Shape4 make_shape4(int logn1, int logn2) {
  Shape4 s;
  s.logn1 = logn1;
  s.logn2 = logn2;
  int logtc = 5;  // log2(k4MaxCols)
  while (logtc > 0 && ((1 << logtc) > (1 << logn2) ||
                       (1 << (logtc + logn1)) > k4TileWords))
    --logtc;
  s.logtc = logtc;
  const int fit = k4TileWords >> logn2;
  s.rows = fit < (1 << logn1) ? fit : 1 << logn1;
  return s;
}

size_t smem4_bytes(const Shape4& s, bool rows) {
  const size_t col = (size_t)(1 << s.logtc) * ((1 << s.logn1) + 1);
  const size_t row = rows ? (size_t)s.rows << s.logn2 : 0;
  return 4 * (col > row ? col : row);
}

bool shape4_ok(int logn1, int logn2, long long batch) {
  return logn1 >= 1 && logn2 >= 1 && logn1 <= k4MaxLogSide &&
         logn2 <= k4MaxLogSide && batch >= 1;
}

// Column tile c0 .. c0 + tc - 1 of one polynomial: load x transposed, the
// size-n1 forward stages, y = T x (lazy [0, 2q)).  x in [0, 4q).
__device__ void col_fwd_tile(const uint32_t* x, uint32_t* y, uint32_t* tile,
                             int c0, const Shape4& s, const Tabs4& t,
                             uint32_t q) {
  const int pitch = (1 << s.logn1) + 1;
  const int words = 1 << (s.logtc + s.logn1);
  const int cmask = (1 << s.logtc) - 1;
  for (int e = threadIdx.x; e < words; e += blockDim.x) {
    const int r = e >> s.logtc, c = e & cmask;
    tile[c * pitch + r] = x[((size_t)r << s.logn2) + c0 + c];
  }
  __syncthreads();
  fwd_stages(tile, s.logn1, 1 << s.logtc, t.col, t.col_precon, q, pitch);
  for (int e = threadIdx.x; e < words; e += blockDim.x) {
    const int r = e >> s.logtc, c = e & cmask;
    const size_t g = ((size_t)r << s.logn2) + c0 + c;
    y[g] = ntt_shoup_lazy(tile[c * pitch + r], __ldg(t.tw + g),
                          __ldg(t.tw_precon + g), q);
  }
  __syncthreads();
}

// Column tile of the inverse: load T^-1 x transposed (x any word), the
// size-n1 inverse stages scaled by cs, store.  Out [0, q).  x may be y.
__device__ void col_inv_tile(const uint32_t* x, uint32_t* y, uint32_t* tile,
                             int c0, const Shape4& s, const Tabs4& t,
                             const Scale4& cs, uint32_t q) {
  const int pitch = (1 << s.logn1) + 1;
  const int words = 1 << (s.logtc + s.logn1);
  const int cmask = (1 << s.logtc) - 1;
  for (int e = threadIdx.x; e < words; e += blockDim.x) {
    const int r = e >> s.logtc, c = e & cmask;
    const size_t g = ((size_t)r << s.logn2) + c0 + c;
    tile[c * pitch + r] =
        ntt_shoup_lazy(x[g], __ldg(t.tw + g), __ldg(t.tw_precon + g), q);
  }
  __syncthreads();
  inv_stages(tile, s.logn1, 1 << s.logtc, t.col, t.col_precon, q, cs.su,
             cs.sup, cs.sv, cs.svp, pitch);
  for (int e = threadIdx.x; e < words; e += blockDim.x) {
    const int r = e >> s.logtc, c = e & cmask;
    y[((size_t)r << s.logn2) + c0 + c] = tile[c * pitch + r];
  }
  __syncthreads();
}

// The forward transform of one polynomial, x -> y (x is not written).
__device__ void fwd4_poly(const uint32_t* x, uint32_t* y, uint32_t* tile,
                          const Shape4& s, const Tabs4& t, uint32_t q) {
  const int n2 = 1 << s.logn2;
  for (int c0 = 0; c0 < n2; c0 += 1 << s.logtc)
    col_fwd_tile(x, y, tile, c0, s, t, q);
  const int words = s.rows << s.logn2;
  for (int r0 = 0; r0 < (1 << s.logn1); r0 += s.rows) {
    uint32_t* g = y + ((size_t)r0 << s.logn2);
    for (int e = threadIdx.x; e < words; e += blockDim.x) tile[e] = g[e];
    __syncthreads();
    fwd_stages(tile, s.logn2, s.rows, t.row, t.row_precon, q, n2);
    for (int e = threadIdx.x; e < words; e += blockDim.x) g[e] = tile[e];
    __syncthreads();
  }
}

// The inverse transform of one polynomial, x -> y; with x2 it transforms
// the Montgomery product x2 x 2^-32 (lazy [0, 2q)) instead.  x may be y.
__device__ void inv4_poly(const uint32_t* x, const uint32_t* x2, uint32_t* y,
                          uint32_t* tile, const Shape4& s, const Tabs4& t,
                          const Scale4& rs, const Scale4& cs, uint32_t q,
                          uint32_t qinv_neg) {
  const int n2 = 1 << s.logn2;
  const int words = s.rows << s.logn2;
  for (int r0 = 0; r0 < (1 << s.logn1); r0 += s.rows) {
    const size_t off = (size_t)r0 << s.logn2;
    for (int e = threadIdx.x; e < words; e += blockDim.x) {
      const uint32_t v = x[off + e];
      tile[e] = x2 != nullptr ? ntt_mont_lazy(x2[off + e], v, q, qinv_neg) : v;
    }
    __syncthreads();
    inv_stages(tile, s.logn2, s.rows, t.row, t.row_precon, q, rs.su, rs.sup,
               rs.sv, rs.svp, n2);
    for (int e = threadIdx.x; e < words; e += blockDim.x) y[off + e] = tile[e];
    __syncthreads();
  }
  for (int c0 = 0; c0 < n2; c0 += 1 << s.logtc)
    col_inv_tile(y, y, tile, c0, s, t, cs, q);
}

// K7a: blockIdx.x is the polynomial.
__global__ void __launch_bounds__(k4Threads)
fwd4_kernel(const uint32_t* __restrict__ x, uint32_t* y, Tabs4 t, Shape4 s,
            uint32_t q) {
  extern __shared__ uint32_t smem[];
  const size_t off = (size_t)blockIdx.x << (s.logn1 + s.logn2);
  fwd4_poly(x + off, y + off, smem, s, t, q);
}

// K7b above a cluster.
__global__ void __launch_bounds__(k4Threads)
inv4_kernel(const uint32_t* __restrict__ x, uint32_t* y, Tabs4 t, Shape4 s,
            Scale4 rs, Scale4 cs, uint32_t q) {
  extern __shared__ uint32_t smem[];
  const size_t off = (size_t)blockIdx.x << (s.logn1 + s.logn2);
  inv4_poly(x + off, nullptr, y + off, smem, s, t, rs, cs, q, 0u);
}

// K8: fa -> scratch, fb -> out, then the scaled inverse of their
// Montgomery product in place in out.
__global__ void __launch_bounds__(k4Threads)
polymul4_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                uint32_t* out, uint32_t* scratch, Tabs4 f, Tabs4 i, Shape4 s,
                Scale4 rs, Scale4 cs, uint32_t q, uint32_t qinv_neg) {
  extern __shared__ uint32_t smem[];
  const size_t off = (size_t)blockIdx.x << (s.logn1 + s.logn2);
  fwd4_poly(a + off, scratch + off, smem, s, f, q);
  fwd4_poly(b + off, out + off, smem, s, f, q);
  inv4_poly(out + off, scratch + off, out + off, smem, s, i, rs, cs, q,
            qinv_neg);
}

// The cluster kernels: cluster blockIdx.x >> logc holds polynomial
// blockIdx.x >> logc.  Each comes in the two launch shapes of
// cluster_shape: <k4SmallThreads, k4SmallCtas> and <k4LargeThreads, 1>.
template <int kThreads, int kCtasPerSm>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
fwd4_cluster_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                    Tabs4 t, Slab4 sl, uint32_t q) {
  extern __shared__ uint32_t smem[];
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  const size_t off = (size_t)(blockIdx.x >> sl.logc)
                     << (sl.logn1 + sl.logn2);
  fwd4_cluster_body(cl, smem, x + off, y + off, t, sl, q);
}

template <int kThreads, int kCtasPerSm>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
inv4_cluster_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                    Tabs4 t, Slab4 sl, Scale4 rs, Scale4 cs, uint32_t q) {
  extern __shared__ uint32_t smem[];
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  const size_t off = (size_t)(blockIdx.x >> sl.logc)
                     << (sl.logn1 + sl.logn2);
  const uint32_t rw[4] = {rs.su, rs.sup, rs.sv, rs.svp};
  const uint32_t cw[4] = {cs.su, cs.sup, cs.sv, cs.svp};
  inv4_cluster_body(cl, smem, x + off, y + off, t, sl, rw, cw, q);
}

template <int kThreads, int kCtasPerSm>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
polymul4_cluster_kernel(const uint32_t* __restrict__ a,
                        const uint32_t* __restrict__ b,
                        uint32_t* __restrict__ out, Tabs4 f, Tabs4 i,
                        Slab4 sl, Scale4 rs, Scale4 cs, uint32_t q,
                        uint32_t qinv_neg) {
  extern __shared__ uint32_t smem[];
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  const size_t off = (size_t)(blockIdx.x >> sl.logc)
                     << (sl.logn1 + sl.logn2);
  const uint32_t rw[4] = {rs.su, rs.sup, rs.sv, rs.svp};
  const uint32_t cw[4] = {cs.su, cs.sup, cs.sv, cs.svp};
  polymul4_cluster_body(cl, smem, a + off, b + off, out + off, f, i, sl, rw,
                        cw, q, qinv_neg);
}

// K9a on slabs: blockIdx.x is the polynomial, blockIdx.y the slab (the
// launch shapes of slab_shape).
template <int kThreads, int kCtasPerSm>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
col_fwd4_slab_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                     Tabs4 t, Slab4 sl, uint32_t q) {
  extern __shared__ uint32_t smem[];
  const size_t off = (size_t)blockIdx.x << (sl.logn1 + sl.logn2);
  col_fwd_slab_body(smem, x + off, y + off, t, sl, (int)blockIdx.y, q);
}

// K9b on slabs, as K9a's.
template <int kThreads, int kCtasPerSm>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
col_inv4_slab_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                     Tabs4 t, Slab4 sl, Scale4 cs, uint32_t q) {
  extern __shared__ uint32_t smem[];
  const size_t off = (size_t)blockIdx.x << (sl.logn1 + sl.logn2);
  const uint32_t cw[4] = {cs.su, cs.sup, cs.sv, cs.svp};
  col_inv_slab_body(smem, x + off, y + off, t, sl, (int)blockIdx.y, cw, q);
}

// K9a at n1 = 2^15: blockIdx.x is the polynomial, blockIdx.y the column
// tile.
__global__ void __launch_bounds__(k4Threads)
col_fwd4_kernel(const uint32_t* __restrict__ x, uint32_t* y, Tabs4 t,
                Shape4 s, uint32_t q) {
  extern __shared__ uint32_t smem[];
  const size_t off = (size_t)blockIdx.x << (s.logn1 + s.logn2);
  col_fwd_tile(x + off, y + off, smem, blockIdx.y << s.logtc, s, t, q);
}

// K9b at n1 = 2^15.
__global__ void __launch_bounds__(k4Threads)
col_inv4_kernel(const uint32_t* __restrict__ x, uint32_t* y, Tabs4 t,
                Shape4 s, Scale4 cs, uint32_t q) {
  extern __shared__ uint32_t smem[];
  const size_t off = (size_t)blockIdx.x << (s.logn1 + s.logn2);
  col_inv_tile(x + off, y + off, smem, blockIdx.y << s.logtc, s, t, cs, q);
}

Tabs4 tabs4(const void* const* p) {
  Tabs4 t;
  t.col = (const uint32_t*)p[0];
  t.col_precon = (const uint32_t*)p[1];
  t.row = (const uint32_t*)p[2];
  t.row_precon = (const uint32_t*)p[3];
  t.tw = (const uint32_t*)p[4];
  t.tw_precon = (const uint32_t*)p[5];
  return t;
}

Scale4 scale4(const uint32_t* w) { return Scale4{w[0], w[1], w[2], w[3]}; }


cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= kDefaultSmemBytes) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The cluster kernel's attributes for one launch shape: its shared memory
// and, above 8 CTAs, the non-portable cluster size.
template <typename Kernel>
cudaError_t allow_cluster(Kernel kernel, int logc, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess || logc <= 3) return err;
  return cudaFuncSetAttribute((const void*)kernel,
                              cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
}

// A launch configuration of `clusters` clusters of 2^logc CTAs.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  ClusterLaunch(long long clusters, int logc, int threads, size_t bytes,
                void* stream, unsigned grid_y = 1) {
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3((unsigned)(clusters << logc), grid_y);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = (cudaStream_t)stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 1u << logc;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// The cluster kernels' two launch shapes.  The kernels are bound by
// latency with few warps an SM (PERF.md, measured with
// utils/cluster_probe.py), so where slabs of a third of an SM's shared
// memory take at most 16 CTAs, three CTAs of 256 threads share an SM (at
// most 85 registers a thread, a few spilled; one CTA's load and store run
// beside the others' arithmetic); else one CTA of 512 threads an SM (128
// registers), slabs up to a block's 227 KiB.
constexpr int k4SmallThreads = 256;
constexpr int k4SmallCtas = 3;
constexpr size_t k4SmallSlabBytes = 76800;  // (228 KiB - 3 x 1 KiB) / 3
constexpr int k4LargeThreads = 512;

struct ClusterShape {
  int logc;    // -1: no cluster holds the matrices (K9a: no slab fits)
  bool small;  // three CTAs an SM
  int threads;
  size_t bytes;
};

ClusterShape shape_of(int mats, int logn1, int logn2, int logc, bool small) {
  ClusterShape c;
  c.logc = logc;
  c.small = small;
  c.threads = small ? k4SmallThreads : k4LargeThreads;
  c.bytes = logc < 0 ? 0 : cluster_smem_bytes(mats, logn1, logn2, logc);
  return c;
}

ClusterShape cluster_shape(int mats, int logn1, int logn2) {
  const int logc = cluster_logc(mats, logn1, logn2, k4SmallSlabBytes);
  if (logc >= 0) return shape_of(mats, logn1, logn2, logc, true);
  return shape_of(mats, logn1, logn2,
                  cluster_logc(mats, logn1, logn2, kMaxSmemBytes), false);
}

// K9a's and K9b's slabs, in the same two launch shapes: the widest slab
// that fits a third of an SM, else the widest that fits a block; logc =
// logn2 - logw slabs a polynomial, one CTA each.
ClusterShape slab_shape(int logn1, int logn2) {
  const int logw = slab_logw(logn1, logn2, k4SmallSlabBytes);
  if (logw >= 0) return shape_of(1, logn1, logn2, logn2 - logw, true);
  const int wide = slab_logw(logn1, logn2, kMaxSmemBytes);
  return shape_of(1, logn1, logn2, wide < 0 ? -1 : logn2 - wide, false);
}

// One launch of a cluster kernel at shape c (attributes set first).
template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, const ClusterShape& c,
                           long long batch, void* stream, Args... args) {
  cudaError_t err = allow_cluster(kernel, c.logc, c.bytes);
  if (err != cudaSuccess) return err;
  ClusterLaunch launch(batch, c.logc, c.threads, c.bytes, stream);
  err = cudaLaunchKernelEx(&launch.cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// One launch of K9a's or K9b's slab kernel at shape c (grid: batch x
// slabs).
template <typename Kernel, typename... Args>
cudaError_t launch_slabs(Kernel kernel, const ClusterShape& c,
                         long long batch, void* stream, Args... args) {
  cudaError_t err = allow_smem((const void*)kernel, c.bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)batch, 1u << c.logc), c.threads, c.bytes,
           (cudaStream_t)stream>>>(args...);
  return cudaGetLastError();
}

// The four-step kernels that ntt_fourstep_launch_info describes.
enum Kernel4 {
  kFwd4 = 0, kInv4 = 1, kPolymul4 = 2, kColFwd4 = 3, kColInv4 = 4
};

// The kernel of `which` at a launch shape.
const void* shaped_kernel(int which, bool small) {
  switch (which) {
    case kFwd4:
      return small
                 ? (const void*)fwd4_cluster_kernel<k4SmallThreads, k4SmallCtas>
                 : (const void*)fwd4_cluster_kernel<k4LargeThreads, 1>;
    case kInv4:
      return small
                 ? (const void*)inv4_cluster_kernel<k4SmallThreads, k4SmallCtas>
                 : (const void*)inv4_cluster_kernel<k4LargeThreads, 1>;
    case kPolymul4:
      return small ? (const void*)
                         polymul4_cluster_kernel<k4SmallThreads, k4SmallCtas>
                   : (const void*)polymul4_cluster_kernel<k4LargeThreads, 1>;
    case kColFwd4:
      return small ? (const void*)
                         col_fwd4_slab_kernel<k4SmallThreads, k4SmallCtas>
                   : (const void*)col_fwd4_slab_kernel<k4LargeThreads, 1>;
    default:
      return small ? (const void*)
                         col_inv4_slab_kernel<k4SmallThreads, k4SmallCtas>
                   : (const void*)col_inv4_slab_kernel<k4LargeThreads, 1>;
  }
}

bool is_slab_kernel(int which) {
  return which == kColFwd4 || which == kColInv4;
}

// Its launch shape: a cluster of logc CTAs (K9a, K9b: 2^logc slabs), or
// logc -1 for the walking kernel.
ClusterShape kernel_shape(int which, int logn1, int logn2) {
  if (is_slab_kernel(which)) return slab_shape(logn1, logn2);
  return cluster_shape(which == kPolymul4 ? 2 : 1, logn1, logn2);
}

// One cluster a polynomial: grid.x = batch << logc must fit an int.
bool cluster_grid_ok(long long batch, int logc) {
  return batch >= 1 && batch <= (0x7fffffffLL >> logc);
}

// K5/K6b (ntt_polydot_cluster.cuh): CTAs of 256 threads, three an SM; a
// CTA holds kDotSumWords x 256 = 4096 words of each operand.
constexpr int kDotLogThreads = 8;
constexpr int kDotCtasPerSm = 3;

// Cluster blockIdx.x >> logc of channel blockIdx.y holds polynomials
// (blockIdx.x >> logc) << logp ..., or with a cluster one polynomial.
__global__ void __launch_bounds__(1 << kDotLogThreads, kDotCtasPerSm)
polydot_rns_cluster_kernel(const uint32_t* __restrict__ a,
                           const uint32_t* __restrict__ b,
                           uint32_t* __restrict__ out,
                           const uint32_t* __restrict__ roots,
                           const uint32_t* __restrict__ precon,
                           const uint32_t* __restrict__ iroots,
                           const uint32_t* __restrict__ iprecon,
                           const uint32_t* __restrict__ qs,
                           const uint32_t* __restrict__ qinvs,
                           const uint32_t* __restrict__ scales,
                           long long batch, int k, DotShape sh) {
  extern __shared__ uint32_t smem[];
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  const int l = blockIdx.y;
  const long long data = ((long long)l * batch) << sh.logn;
  const long long tab = (long long)l << sh.logn;
  const long long poly0 = (long long)(blockIdx.x >> sh.logc) << sh.logp;
  polydot_rns_body(cl, smem, a + data * k, b + data * k, out + data,
                   roots + tab, precon + tab, iroots + tab, iprecon + tab,
                   batch, k, sh, (int)cl.block_rank(), poly0, __ldg(qs + l),
                   __ldg(qinvs + l), scales + 4 * l);
}

// Its launch at (L, B, k, n): the shape, the clusters a channel, the
// kernel's attributes set.
struct DotLaunch {
  DotShape sh;
  long long clusters;
  size_t bytes;
};

cudaError_t dot_launch(int channels, long long batch, int k, int logn,
                       DotLaunch* d) {
  if (channels < 1 || channels > kMaxChannels || batch < 1 || k < 1 ||
      logn < 1 || logn > k4MaxLogSide)
    return cudaErrorInvalidValue;
  d->sh = make_dot_shape(logn, kDotLogThreads);
  d->clusters = (batch + (1LL << d->sh.logp) - 1) >> d->sh.logp;
  d->bytes = dot_smem_bytes(d->sh, k);
  if (d->sh.logc > kDotMaxClusterLog ||
      !cluster_grid_ok(d->clusters, d->sh.logc))
    return cudaErrorInvalidValue;
  return allow_cluster(polydot_rns_cluster_kernel, d->sh.logc, d->bytes);
}

// K4a/K4b (ntt_rns_transform.cuh): CTAs of 256 threads, each holding 4096
// words of a slab (a cluster of n / 4096 CTAs a polynomial, or 4096 / n
// polynomials a CTA), kRnsCtasPerSm an SM: at most 40 registers and a few
// spilled, which measured 3-6% faster than four an SM without a spill.
// One unit a cluster and one slab (18 KiB a CTA): a cluster that took
// several units in turn, loading the next into a second slab, measured
// 8-15% slower on the H100 at every shape timed (PERF.md).
constexpr int kRnsLogThreads = 8;
constexpr int kRnsCtasPerSm = 6;

// Cluster blockIdx.x >> logc of channel blockIdx.y transforms unit
// blockIdx.x >> logc.
__global__ void __launch_bounds__(1 << kRnsLogThreads, kRnsCtasPerSm)
fwd_rns_cluster_kernel(const uint32_t* __restrict__ x,
                       uint32_t* __restrict__ y,
                       const uint32_t* __restrict__ roots,
                       const uint32_t* __restrict__ precon,
                       const uint32_t* __restrict__ qs, long long batch,
                       DotShape sh) {
  extern __shared__ uint32_t smem[];
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  const int l = blockIdx.y;
  const long long data = ((long long)l * batch) << sh.logn;
  const long long tab = (long long)l << sh.logn;
  fwd_rns_body(cl, smem, x + data, y + data, roots + tab, precon + tab, batch,
               sh, (int)cl.block_rank(), blockIdx.x >> sh.logc,
               __ldg(qs + l));
}

__global__ void __launch_bounds__(1 << kRnsLogThreads, kRnsCtasPerSm)
inv_rns_cluster_kernel(const uint32_t* __restrict__ x,
                       uint32_t* __restrict__ y,
                       const uint32_t* __restrict__ iroots,
                       const uint32_t* __restrict__ iprecon,
                       const uint32_t* __restrict__ qs,
                       const uint32_t* __restrict__ scales, long long batch,
                       DotShape sh) {
  extern __shared__ uint32_t smem[];
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  const int l = blockIdx.y;
  const long long data = ((long long)l * batch) << sh.logn;
  const long long tab = (long long)l << sh.logn;
  inv_rns_body(cl, smem, x + data, y + data, iroots + tab, iprecon + tab,
               batch, sh, (int)cl.block_rank(), blockIdx.x >> sh.logc,
               __ldg(qs + l), scales + 4 * l);
}

// K12 on K1's launch: unit blockIdx.x >> logc of (B, n) z, bit-reversed,
// -> y in [0, q); roots, precon: the cyclic tables of omega = psi^-2 (the
// forward network on the psi^-1 tables with the pre row psi^k folded in);
// rows: the (4, n) scale rows (pre, pre', post, post'), of which the
// kernel reads the post row.
__global__ void __launch_bounds__(1 << kRnsLogThreads, kRnsCtasPerSm)
dit_inv_cluster_kernel(const uint32_t* __restrict__ x,
                       uint32_t* __restrict__ y,
                       const uint32_t* __restrict__ roots,
                       const uint32_t* __restrict__ precon,
                       const uint32_t* __restrict__ rows, long long batch,
                       uint32_t q, DotShape sh) {
  extern __shared__ uint32_t smem[];
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  const size_t n = (size_t)1 << sh.logn;
  dit_inv_rns_body(cl, smem, x, y, roots, precon, rows + 2 * n, rows + 3 * n,
                   batch, sh, (int)cl.block_rank(), blockIdx.x >> sh.logc, q);
}

// The transform kernels by launch: 0 K4a (K1), 1 K4b (K2), 2 K12.
enum RnsKernel { kRnsFwd = 0, kRnsInv = 1, kRnsDit = 2 };

const void* rns_kernel(int which) {
  return which == kRnsInv   ? (const void*)inv_rns_cluster_kernel
         : which == kRnsDit ? (const void*)dit_inv_cluster_kernel
                            : (const void*)fwd_rns_cluster_kernel;
}

// A transform launch at (L, B, n): the shape, the clusters a channel (one
// a unit), the kernel's attributes set.
struct RnsLaunch {
  DotShape sh;
  long long clusters;
  size_t bytes;
};

cudaError_t rns_launch(int which, int channels, long long batch, int logn,
                       RnsLaunch* d) {
  if (which < kRnsFwd || which > kRnsDit || channels < 1 ||
      channels > kMaxChannels || batch < 1 || logn < 1)
    return cudaErrorInvalidValue;
  d->sh = make_dot_shape(logn, kRnsLogThreads);
  if (d->sh.logc > kDotMaxClusterLog) return cudaErrorInvalidValue;
  d->bytes = rns_smem_bytes(d->sh);
  d->clusters = rns_units(d->sh, batch);
  if (!cluster_grid_ok(d->clusters, d->sh.logc)) return cudaErrorInvalidValue;
  return allow_cluster(rns_kernel(which), d->sh.logc, d->bytes);
}

// K11 (ntt_xchg.cuh): the threads of entry blockIdx.y stride over its
// quads, one a thread a turn.
template <bool kFwd>
__global__ void __launch_bounds__(kXchgThreads)
xchg_group_kernel(const __grid_constant__ XchgStage st) {
  for (long long i = (long long)blockIdx.x * kXchgThreads + threadIdx.x;
       i < st.quads; i += (long long)gridDim.x * kXchgThreads)
    xchg_group_body<kFwd>(st, blockIdx.y, i);
}

// The wide ring (ntt_wide.cuh).  The cluster kernels: cluster blockIdx.x
// >> logc transforms unit blockIdx.x >> logc; CTAs of 256 threads holding
// 4096 words (36 KiB of shared memory), four an SM: at most 64 registers
// and about 100-190 bytes spilled, which measured 3-6% faster than three
// an SM (80 registers) and than five, and 8-14% faster than two without a
// spill (utils/wide_probe.py --variants; PERF.md): the passes wait on
// latency more than on instruction throughput.
constexpr int kWideCtasPerSm = 4;

__global__ void __launch_bounds__(kWideThreads, kWideCtasPerSm)
wide_fwd_cluster_kernel(const uint32_t* xlo, const uint32_t* xhi,
                        uint32_t* ylo, uint32_t* yhi,
                        const uint64_t* __restrict__ roots,
                        const uint64_t* __restrict__ precon,
                        const WideShape sh) {
  extern __shared__ uint64_t wide_slab[];
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  wide_fwd_body(cl, wide_slab, xlo, xhi, ylo, yhi, roots, precon, sh,
                (int)cl.block_rank(), blockIdx.x >> sh.logc);
}

__global__ void __launch_bounds__(kWideThreads, kWideCtasPerSm)
wide_inv_cluster_kernel(const uint32_t* xlo, const uint32_t* xhi,
                        uint32_t* ylo, uint32_t* yhi,
                        const uint64_t* __restrict__ iroots,
                        const uint64_t* __restrict__ iprecon,
                        const WideShape sh, uint64_t sc, uint64_t scp) {
  extern __shared__ uint64_t wide_slab[];
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  wide_inv_body(cl, wide_slab, xlo, xhi, ylo, yhi, iroots, iprecon, sh,
                (int)cl.block_rank(), blockIdx.x >> sh.logc, sc, scp);
}

// A pass in device memory, stages [st, st + k) (k <= 3) of every row: one
// group of 2^k words a thread a turn.
__global__ void __launch_bounds__(kWideThreads)
wide_fwd_pass_kernel(const uint32_t* xlo, const uint32_t* xhi, uint32_t* ylo,
                     uint32_t* yhi, const uint64_t* __restrict__ roots,
                     const uint64_t* __restrict__ precon, uint64_t q,
                     int logn, int st, int k, long long groups) {
  with_radix<k4RadixLog>(k, [&](auto r) {
    for (long long g = (long long)blockIdx.x * kWideThreads + threadIdx.x;
         g < groups; g += (long long)gridDim.x * kWideThreads)
      wide_fwd_pass_group<decltype(r)::value>(xlo, xhi, ylo, yhi, roots,
                                              precon, q, logn, st, g);
  });
}

__global__ void __launch_bounds__(kWideThreads)
wide_inv_pass_kernel(const uint32_t* xlo, const uint32_t* xhi, uint32_t* ylo,
                     uint32_t* yhi, const uint64_t* __restrict__ iroots,
                     const uint64_t* __restrict__ iprecon, uint64_t q,
                     int logn, int st, int k, long long groups, uint64_t sc,
                     uint64_t scp) {
  with_radix<k4RadixLog>(k, [&](auto r) {
    for (long long g = (long long)blockIdx.x * kWideThreads + threadIdx.x;
         g < groups; g += (long long)gridDim.x * kWideThreads)
      wide_inv_pass_group<decltype(r)::value>(xlo, xhi, ylo, yhi, iroots,
                                              iprecon, q, logn, st, g, sc,
                                              scp);
  });
}

__global__ void __launch_bounds__(kWideThreads)
wide_pointwise_kernel(const uint32_t* __restrict__ alo,
                      const uint32_t* __restrict__ ahi,
                      const uint32_t* __restrict__ blo,
                      const uint32_t* __restrict__ bhi, uint32_t* ylo,
                      uint32_t* yhi, long long count, int mode, uint64_t q,
                      uint64_t qinv_neg, uint64_t r2) {
  for (long long i = (long long)blockIdx.x * kWideThreads + threadIdx.x;
       i < count; i += (long long)gridDim.x * kWideThreads) {
    const uint64_t w = wide_pointwise(wide_join(alo[i], ahi[i]),
                                      wide_join(blo[i], bhi[i]), mode, q,
                                      qinv_neg, r2);
    ylo[i] = (uint32_t)w;
    yhi[i] = (uint32_t)(w >> 32);
  }
}

// Most CTAs of a grid-striding wide launch (the rest loop).
constexpr long long kWideMaxBlocks = 1LL << 20;

unsigned wide_grid(long long items) {
  const long long blocks = (items + kWideThreads - 1) / kWideThreads;
  return (unsigned)(blocks < kWideMaxBlocks ? blocks : kWideMaxBlocks);
}

// The cluster kernel of a wide transform (0 forward, 1 inverse).
const void* wide_kernel(int which) {
  return which == 1 ? (const void*)wide_inv_cluster_kernel
                    : (const void*)wide_fwd_cluster_kernel;
}

// A cluster launch of a wide transform at (B, 2^logn): its shape, and the
// kernel's attributes set (shared memory; the non-portable cluster size
// above 8 CTAs).
cudaError_t wide_launch(int which, int logn, long long batch, uint64_t q,
                        WideShape* sh) {
  if (logn < 1 || logn > 30 || batch < 1 || (which != 0 && which != 1))
    return cudaErrorInvalidValue;
  *sh = make_wide_shape(logn, batch, q);
  if (!cluster_grid_ok(wide_units(*sh), sh->logc)) return cudaErrorInvalidValue;
  return allow_cluster(wide_kernel(which), sh->logc, wide_smem_bytes(*sh));
}

// The device passes of a transform: stages [0, logn - logl) in passes of at
// most 3, `launch(st, k)` each; the forward walks them top down, the
// inverse bottom up.  Returns the first error.
template <typename Launch>
cudaError_t wide_passes(const WideShape& sh, bool inverse, Launch launch) {
  const int so = sh.logn - sh.logl;
  for (int done = 0; done < so;) {
    const int k = inverse ? inv_pass_stages(so - done)
                          : fwd_pass_stages(so - done);
    const int st = inverse ? so - done - k : done;
    const cudaError_t err = launch(st, k);
    if (err != cudaSuccess) return err;
    done += k;
  }
  return cudaSuccess;
}

// M1 (ntt_mxu.cuh): persistent CTAs of three warpgroups (a converter, two
// consumers on wgmma) that walk the 128 x 64 tiles of a pass, the column
// pass (G = D X) and the row pass (H = T G R^T) on one template, with
// kMxuSmemBytes of dynamic shared memory; one CTA an SM.
__global__ void __launch_bounds__(kMxuThreads, 1)
mxu_col_kernel(const __grid_constant__ CUtensorMap x,
               uint32_t* __restrict__ y, const int8_t* __restrict__ mat,
               const MxuShape sh) {
  extern __shared__ __align__(128) uint8_t mxu_smem[];
  mxu_pass_body<false>(MxuMaps{&x, nullptr, nullptr}, y, mat, sh, mxu_smem);
}

__global__ void __launch_bounds__(kMxuThreads, 1)
mxu_row_kernel(const __grid_constant__ CUtensorMap x,
               const __grid_constant__ CUtensorMap tw,
               const __grid_constant__ CUtensorMap twp,
               uint32_t* __restrict__ y, const int8_t* __restrict__ mat,
               const MxuShape sh) {
  extern __shared__ __align__(128) uint8_t mxu_smem[];
  mxu_pass_body<true>(MxuMaps{&x, &tw, &twp}, y, mat, sh, mxu_smem);
}

// cuTensorMapEncodeTiled, a driver function, through the runtime's entry
// point (the library links no libcuda); null where the driver has none.
typedef CUresult (*MxuEncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

MxuEncodeTiled mxu_encoder() {
  static MxuEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (MxuEncodeTiled)p;
  }
  return fn;
}

// A tensor map of uint32 words: dims (innermost first) and the byte
// strides of the outer dims, the box, the swizzle.
cudaError_t mxu_map(CUtensorMap* map, const uint32_t* base, int rank,
                    const cuuint64_t* dims, const cuuint64_t* strides,
                    const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const MxuEncodeTiled encode = mxu_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT32, (cuuint32_t)rank,
      const_cast<uint32_t*>(base), dims, strides, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

const void* mxu_kernel(int row) {
  return row ? (const void*)mxu_row_kernel : (const void*)mxu_col_kernel;
}

size_t mxu_smem_bytes(int row) {
  return row ? kMxuSmemBytes<true> : kMxuSmemBytes<false>;
}

// A pass over (B, 2^logn1, 2^logn2) words (row: the row pass, else the
// column pass): its shape (N / 64 N tiles of M / 128 M tiles, one of 64
// rows at M = 64), the CTAs an SM and the persistent grid, the CTAs the
// card runs at once or the tiles, the fewer.
cudaError_t mxu_launch(int row, int logn1, int logn2, long long batch,
                       uint32_t q, MxuShape* sh, long long* blocks,
                       int* per_sm) {
  if (logn1 < kMxuMinLog || logn1 > kMxuMaxLog || logn2 < kMxuMinLog ||
      logn2 > kMxuMaxLog || batch < 1 || q < 3 || (row != 0 && row != 1))
    return cudaErrorInvalidValue;
  sh->logm = row ? logn2 : logn1;
  sh->logn1 = logn1;
  sh->logn2 = logn2;
  sh->consumers = sh->logm > kMxuMinLog ? kMxuConsumers : 1;
  sh->mtiles = (1 << sh->logm) / (sh->consumers * kMxuBlockRows);
  sh->k = make_mxu_consts(q);
  const long long cols = batch << (row ? logn1 : logn2);
  sh->tiles = cols / kMxuTileN * sh->mtiles;
  cudaError_t err = allow_smem(mxu_kernel(row), mxu_smem_bytes(row));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, mxu_kernel(row), kMxuThreads, mxu_smem_bytes(row));
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long resident = (long long)sms * *per_sm;
  *blocks = sh->tiles < resident ? sh->tiles : resident;
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* ntt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K4a, K4b: one launch for every channel.
int ntt_fwd_rns(const uint32_t* x, uint32_t* y, const uint32_t* roots,
                const uint32_t* precon, const uint32_t* qs, int channels,
                long long batch, int logn, void* stream) {
  RnsLaunch d;
  cudaError_t err = rns_launch(kRnsFwd, channels, batch, logn, &d);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch launch(d.clusters, d.sh.logc, 1 << kRnsLogThreads, d.bytes,
                       stream, (unsigned)channels);
  err = cudaLaunchKernelEx(&launch.cfg, fwd_rns_cluster_kernel, x, y, roots,
                           precon, qs, batch, d.sh);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int ntt_inv_rns(const uint32_t* x, uint32_t* y, const uint32_t* iroots,
                const uint32_t* iprecon, const uint32_t* qs,
                const uint32_t* scales, int channels, long long batch,
                int logn, void* stream) {
  RnsLaunch d;
  cudaError_t err = rns_launch(kRnsInv, channels, batch, logn, &d);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch launch(d.clusters, d.sh.logc, 1 << kRnsLogThreads, d.bytes,
                       stream, (unsigned)channels);
  err = cudaLaunchKernelEx(&launch.cfg, inv_rns_cluster_kernel, x, y, iroots,
                           iprecon, qs, scales, batch, d.sh);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K1, K2: K4a's and K4b's kernels at one channel.  qs: device memory whose
// word 0 is q (RingTables.dot_words); scales: device memory holding the
// inverse's (su, su', sv, sv'); the (n,) twiddle tables serve as (1, n).
int ntt_fwd(const uint32_t* x, uint32_t* y, const uint32_t* roots,
            const uint32_t* precon, const uint32_t* qs, long long batch,
            int logn, void* stream) {
  return ntt_fwd_rns(x, y, roots, precon, qs, 1, batch, logn, stream);
}

int ntt_inv(const uint32_t* x, uint32_t* y, const uint32_t* iroots,
            const uint32_t* iprecon, const uint32_t* qs,
            const uint32_t* scales, long long batch, int logn, void* stream) {
  return ntt_inv_rns(x, y, iroots, iprecon, qs, scales, 1, batch, logn,
                     stream);
}

// K12 (dit_inv_cluster_kernel) on K1's launch at one channel: x (B, n)
// already bit-reversed, any words below 4q, -> y in [0, q); roots, precon:
// the cyclic tables of omega = psi^-2; rows: the (4, n) scale rows; q by
// value.  The output gather follows outside (ops/dit_inv.py).
int ntt_dit_inv(const uint32_t* x, uint32_t* y, const uint32_t* roots,
                const uint32_t* precon, const uint32_t* rows,
                long long batch, int logn, uint32_t q, void* stream) {
  RnsLaunch d;
  cudaError_t err = rns_launch(kRnsDit, 1, batch, logn, &d);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch launch(d.clusters, d.sh.logc, 1 << kRnsLogThreads, d.bytes,
                       stream);
  err = cudaLaunchKernelEx(&launch.cfg, dit_inv_cluster_kernel, x, y, roots,
                           precon, rows, batch, q, d.sh);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The launch of kernel `which` (0 K4a, 1 K4b, 2 K12) for (channels, batch,
// n = 2^logn), K1's and K2's at channels = 1:
// info = {log2 of the CTAs a polynomial (the cluster), log2 of the
// polynomials a CTA, shared memory bytes a CTA, threads a CTA, registers a
// thread, CTAs an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the
// most such clusters the card runs at once, the clusters a channel
// launched}.
int ntt_rns_launch_info(int which, int logn, int channels, long long batch,
                        int* info) {
  for (int i = 0; i < 8; ++i) info[i] = 0;
  RnsLaunch d;
  cudaError_t err = rns_launch(which, channels, batch, logn, &d);
  if (err != cudaSuccess) return (int)err;
  info[0] = d.sh.logc;
  info[1] = d.sh.logp;
  info[2] = (int)d.bytes;
  info[3] = 1 << kRnsLogThreads;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, rns_kernel(which));
  if (err != cudaSuccess) return (int)err;
  info[4] = attr.numRegs;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[5], rns_kernel(which), info[3], d.bytes);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch launch(1, d.sh.logc, info[3], d.bytes, nullptr);
  err = cudaOccupancyMaxActiveClusters(&info[6], rns_kernel(which),
                                       &launch.cfg);
  if (err != cudaSuccess) return (int)err;
  info[7] = (int)d.clusters;
  return (int)cudaSuccess;
}

// K5/K6b (and K3/K6a, ntt_polydot): one launch for every channel, no
// scratch.
int ntt_polydot_rns(const uint32_t* a, const uint32_t* b, uint32_t* out,
                    const uint32_t* roots, const uint32_t* precon,
                    const uint32_t* iroots, const uint32_t* iprecon,
                    const uint32_t* qs, const uint32_t* qinvs,
                    const uint32_t* scales, int channels, long long batch,
                    int k, int logn, void* stream) {
  DotLaunch d;
  cudaError_t err = dot_launch(channels, batch, k, logn, &d);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch launch(d.clusters, d.sh.logc, 1 << kDotLogThreads, d.bytes,
                       stream, (unsigned)channels);
  err = cudaLaunchKernelEx(&launch.cfg, polydot_rns_cluster_kernel, a, b, out,
                           roots, precon, iroots, iprecon, qs, qinvs, scales,
                           batch, k, d.sh);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K3/K6a: K5/K6b's kernel at one channel.  consts: device memory holding
// (q, -q^-1 mod 2^32, su, su', sv, sv') of the polymul scale, read as the
// kernel's (1,) qs, (1,) qinvs and (1, 4) scales; the (n,) twiddle tables
// serve as its (1, n) tables.  No scratch at any n.
int ntt_polydot(const uint32_t* a, const uint32_t* b, uint32_t* out,
                const uint32_t* roots, const uint32_t* precon,
                const uint32_t* iroots, const uint32_t* iprecon,
                const uint32_t* consts, long long batch, int k, int logn,
                void* stream) {
  return ntt_polydot_rns(a, b, out, roots, precon, iroots, iprecon, consts,
                         consts + 1, consts + 2, 1, batch, k, logn, stream);
}

// K5/K6b's (and K3/K6a's) launch at n = 2^logn with k terms: info = {log2
// of the CTAs a polynomial (the cluster), log2 of the polynomials a CTA,
// shared memory bytes a CTA, threads a CTA, CTAs an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the most such clusters
// the card runs at once (cudaOccupancyMaxActiveClusters)}.
int ntt_polydot_rns_launch_info(int logn, int k, int* info) {
  for (int i = 0; i < 6; ++i) info[i] = 0;
  DotLaunch d;
  cudaError_t err = dot_launch(1, 1, k, logn, &d);
  if (err != cudaSuccess) return (int)err;
  info[0] = d.sh.logc;
  info[1] = d.sh.logp;
  info[2] = (int)d.bytes;
  info[3] = 1 << kDotLogThreads;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[4], polydot_rns_cluster_kernel, info[3], d.bytes);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch launch(1, d.sh.logc, info[3], d.bytes, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(
      &info[5], (const void*)polydot_rns_cluster_kernel, &launch.cfg);
}

// -- four-step (K7a, K7b, K8, K9a, K9b) ----------------------------------------
//
// tabs: host arrays of six device pointers, in Tabs4's order; row_scale and
// col_scale: host arrays of the four words (su, su', sv, sv') of the row and
// column inverses' last stages.  Operands are (batch, n1, n2), contiguous.

// log2 of the cluster that holds `mats` (n1, n2) matrices (1: K7a and
// K7b, 2: K8), or -1: the walking kernel.
int ntt_fourstep_cluster_log(int mats, int logn1, int logn2) {
  if (!shape4_ok(logn1, logn2, 1) || mats < 1 || mats > 2) return -1;
  return cluster_shape(mats, logn1, logn2).logc;
}

// The launch of kernel `which` (Kernel4: 0 K7a, 1 K7b, 2 K8, 3 K9a, 4 K9b)
// at this shape: info = {log2 of the cluster's CTAs, or for K9a and K9b of
// the slabs a polynomial (-1: the walking kernel), shared memory bytes a
// CTA, threads a CTA, CTAs an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the most such clusters
// the card runs at once (cudaOccupancyMaxActiveClusters; 0 for K9a and
// K9b, which have none)}.
int ntt_fourstep_launch_info(int which, int logn1, int logn2, int* info) {
  info[0] = -1;
  info[1] = info[2] = info[3] = info[4] = 0;
  if (!shape4_ok(logn1, logn2, 1) || which < kFwd4 || which > kColInv4)
    return (int)cudaErrorInvalidValue;
  const ClusterShape c = kernel_shape(which, logn1, logn2);
  if (c.logc < 0) return 0;
  info[0] = c.logc;
  info[1] = (int)c.bytes;
  info[2] = c.threads;
  const void* kernel = shaped_kernel(which, c.small);
  cudaError_t err = is_slab_kernel(which)
                        ? allow_smem(kernel, c.bytes)
                        : allow_cluster(kernel, c.logc, c.bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], kernel,
                                                        c.threads, c.bytes);
  if (err != cudaSuccess || is_slab_kernel(which)) return (int)err;
  ClusterLaunch launch(1, c.logc, c.threads, c.bytes, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(&info[4], kernel, &launch.cfg);
}

int ntt_fwd4(const uint32_t* x, uint32_t* y, const void* const* tabs,
             long long batch, int logn1, int logn2, uint32_t q, void* stream) {
  if (!shape4_ok(logn1, logn2, batch)) return (int)cudaErrorInvalidValue;
  const ClusterShape c = cluster_shape(1, logn1, logn2);
  if (c.logc >= 0) {
    if (!cluster_grid_ok(batch, c.logc)) return (int)cudaErrorInvalidValue;
    const Tabs4 t = tabs4(tabs);
    const Slab4 sl = make_slab4(logn1, logn2, c.logc);
    return (int)(c.small
                     ? launch_cluster(
                           fwd4_cluster_kernel<k4SmallThreads, k4SmallCtas>, c,
                           batch, stream, x, y, t, sl, q)
                     : launch_cluster(fwd4_cluster_kernel<k4LargeThreads, 1>,
                                      c, batch, stream, x, y, t, sl, q));
  }
  const Shape4 s = make_shape4(logn1, logn2);
  const size_t bytes = smem4_bytes(s, true);
  cudaError_t err = allow_smem((const void*)fwd4_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  fwd4_kernel<<<(unsigned)batch, k4Threads, bytes, (cudaStream_t)stream>>>(
      x, y, tabs4(tabs), s, q);
  return (int)cudaGetLastError();
}

int ntt_inv4(const uint32_t* x, uint32_t* y, const void* const* tabs,
             const uint32_t* row_scale, const uint32_t* col_scale,
             long long batch, int logn1, int logn2, uint32_t q, void* stream) {
  if (!shape4_ok(logn1, logn2, batch)) return (int)cudaErrorInvalidValue;
  const ClusterShape c = cluster_shape(1, logn1, logn2);
  if (c.logc >= 0) {
    if (!cluster_grid_ok(batch, c.logc)) return (int)cudaErrorInvalidValue;
    const Tabs4 t = tabs4(tabs);
    const Slab4 sl = make_slab4(logn1, logn2, c.logc);
    const Scale4 rs = scale4(row_scale), cs = scale4(col_scale);
    return (int)(c.small
                     ? launch_cluster(
                           inv4_cluster_kernel<k4SmallThreads, k4SmallCtas>, c,
                           batch, stream, x, y, t, sl, rs, cs, q)
                     : launch_cluster(inv4_cluster_kernel<k4LargeThreads, 1>,
                                      c, batch, stream, x, y, t, sl, rs, cs,
                                      q));
  }
  const Shape4 s = make_shape4(logn1, logn2);
  const size_t bytes = smem4_bytes(s, true);
  cudaError_t err = allow_smem((const void*)inv4_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  inv4_kernel<<<(unsigned)batch, k4Threads, bytes, (cudaStream_t)stream>>>(
      x, y, tabs4(tabs), s, scale4(row_scale), scale4(col_scale), q);
  return (int)cudaGetLastError();
}

// scratch: batch * n words of device memory for the first operand's
// transform, for the walking kernel only (ntt_fourstep_cluster_log(2, ...)
// < 0); the cluster kernel takes none (null).
int ntt_polymul4(const uint32_t* a, const uint32_t* b, uint32_t* out,
                 uint32_t* scratch, const void* const* fwd_tabs,
                 const void* const* inv_tabs, const uint32_t* row_scale,
                 const uint32_t* col_scale, long long batch, int logn1,
                 int logn2, uint32_t q, uint32_t qinv_neg, void* stream) {
  if (!shape4_ok(logn1, logn2, batch)) return (int)cudaErrorInvalidValue;
  const ClusterShape c = cluster_shape(2, logn1, logn2);
  if (c.logc >= 0) {
    if (!cluster_grid_ok(batch, c.logc)) return (int)cudaErrorInvalidValue;
    const Tabs4 f = tabs4(fwd_tabs), i = tabs4(inv_tabs);
    const Slab4 sl = make_slab4(logn1, logn2, c.logc);
    const Scale4 rs = scale4(row_scale), cs = scale4(col_scale);
    return (int)(c.small
                     ? launch_cluster(
                           polymul4_cluster_kernel<k4SmallThreads, k4SmallCtas>,
                           c, batch, stream, a, b, out, f, i, sl, rs, cs, q,
                           qinv_neg)
                     : launch_cluster(
                           polymul4_cluster_kernel<k4LargeThreads, 1>, c,
                           batch, stream, a, b, out, f, i, sl, rs, cs, q,
                           qinv_neg));
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const Shape4 s = make_shape4(logn1, logn2);
  const size_t bytes = smem4_bytes(s, true);
  cudaError_t err = allow_smem((const void*)polymul4_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  polymul4_kernel<<<(unsigned)batch, k4Threads, bytes,
                    (cudaStream_t)stream>>>(
      a, b, out, scratch, tabs4(fwd_tabs), tabs4(inv_tabs), s,
      scale4(row_scale), scale4(col_scale), q, qinv_neg);
  return (int)cudaGetLastError();
}

int ntt_col_fwd4(const uint32_t* x, uint32_t* y, const void* const* tabs,
                 long long batch, int logn1, int logn2, uint32_t q,
                 void* stream) {
  if (!shape4_ok(logn1, logn2, batch)) return (int)cudaErrorInvalidValue;
  const ClusterShape c = slab_shape(logn1, logn2);
  if (c.logc >= 0) {
    const Tabs4 t = tabs4(tabs);
    const Slab4 sl = make_slab4(logn1, logn2, c.logc);
    return (int)(c.small
                     ? launch_slabs(
                           col_fwd4_slab_kernel<k4SmallThreads, k4SmallCtas>,
                           c, batch, stream, x, y, t, sl, q)
                     : launch_slabs(col_fwd4_slab_kernel<k4LargeThreads, 1>,
                                    c, batch, stream, x, y, t, sl, q));
  }
  const Shape4 s = make_shape4(logn1, logn2);
  const size_t bytes = smem4_bytes(s, false);
  cudaError_t err = allow_smem((const void*)col_fwd4_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)batch, 1u << (logn2 - s.logtc));
  col_fwd4_kernel<<<grid, k4Threads, bytes, (cudaStream_t)stream>>>(
      x, y, tabs4(tabs), s, q);
  return (int)cudaGetLastError();
}

int ntt_col_inv4(const uint32_t* x, uint32_t* y, const void* const* tabs,
                 const uint32_t* col_scale, long long batch, int logn1,
                 int logn2, uint32_t q, void* stream) {
  if (!shape4_ok(logn1, logn2, batch)) return (int)cudaErrorInvalidValue;
  const ClusterShape c = slab_shape(logn1, logn2);
  if (c.logc >= 0) {
    const Tabs4 t = tabs4(tabs);
    const Slab4 sl = make_slab4(logn1, logn2, c.logc);
    const Scale4 cs = scale4(col_scale);
    return (int)(c.small
                     ? launch_slabs(
                           col_inv4_slab_kernel<k4SmallThreads, k4SmallCtas>,
                           c, batch, stream, x, y, t, sl, cs, q)
                     : launch_slabs(col_inv4_slab_kernel<k4LargeThreads, 1>,
                                    c, batch, stream, x, y, t, sl, cs, q));
  }
  const Shape4 s = make_shape4(logn1, logn2);
  const size_t bytes = smem4_bytes(s, false);
  cudaError_t err = allow_smem((const void*)col_inv4_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)batch, 1u << (logn2 - s.logtc));
  col_inv4_kernel<<<grid, k4Threads, bytes, (cudaStream_t)stream>>>(
      x, y, tabs4(tabs), s, scale4(col_scale), q);
  return (int)cudaGetLastError();
}

// -- cross-device stage (K11) ------------------------------------------------

// One cross stage over `count` entries: table holds, for each, six device
// addresses (u, v, out_u, out_v, w, wp; a null out is not written); every
// u, v and out is (rows, width) words, 16-byte aligned, width % 4 == 0,
// and w, wp are (width,) rows.  An input may live on a peer card
// (ntt_enable_peer first).  One launch a kXchgMaxEntries entries;
// *launches says how many.
int ntt_xchg_group(const uint64_t* table, int count, long long rows,
                   int width, uint32_t q, int fwd, int last, uint32_t s,
                   uint32_t sp, void* stream, int* launches) {
  *launches = 0;
  if (count < 1 || rows < 1 || width < 4 || width % 4)
    return (int)cudaErrorInvalidValue;
  XchgStage st;
  st.width4 = width / 4;
  st.quads = rows * st.width4;
  st.q = q;
  st.s = s;
  st.sp = sp;
  st.last = last != 0;
  long long blocks = (st.quads + kXchgThreads - 1) / kXchgThreads;
  if (blocks > kXchgMaxBlocks) blocks = kXchgMaxBlocks;
  for (int first = 0; first < count; first += kXchgMaxEntries) {
    const int m = count - first < kXchgMaxEntries ? count - first
                                                  : kXchgMaxEntries;
    for (int i = 0; i < m; ++i) {
      const uint64_t* t = table + 6 * (first + i);
      st.e[i] = XchgEntry{(const uint32_t*)t[0], (const uint32_t*)t[1],
                          (uint32_t*)t[2],       (uint32_t*)t[3],
                          (const uint32_t*)t[4], (const uint32_t*)t[5]};
    }
    const dim3 grid((unsigned)blocks, (unsigned)m);
    if (fwd) {
      xchg_group_kernel<true>
          <<<grid, kXchgThreads, 0, (cudaStream_t)stream>>>(st);
    } else {
      xchg_group_kernel<false>
          <<<grid, kXchgThreads, 0, (cudaStream_t)stream>>>(st);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launches;
  }
  return (int)cudaSuccess;
}

// Let `device` read `peer`'s memory (NVLink or PCIe P2P).  Returns 0, or
// cudaErrorPeerAccessUnsupported when the two cards cannot reach each other.
int ntt_enable_peer(int device, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  int prev = 0;
  err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  cudaSetDevice(prev);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // not sticky: clear it
    return 0;
  }
  return (int)err;
}

// The wide ring's transforms on (B, n) lo and hi uint32 words: x in
// [0, 4q) -> y in [0, q) forward; [0, 2q) -> [0, q) inverse, scaled by
// (sc, scp) = (s, floor(s 2^64 / q)) mod 2^64.  roots/precon (iroots/
// iprecon): the u64 [n] tables.  One cluster launch up to n = 2^16; above,
// the forward first runs passes in device memory until the independent
// blocks fit a cluster, then the cluster body on each block (the inverse:
// the body, then the passes, the last one scaled); `launches` gets the
// number of kernel launches.
int ntt_wide_fwd(const uint32_t* xlo, const uint32_t* xhi, uint32_t* ylo,
                 uint32_t* yhi, const uint64_t* roots, const uint64_t* precon,
                 uint64_t q, long long batch, int logn, void* stream,
                 int* launches) {
  *launches = 0;
  WideShape sh;
  cudaError_t err = wide_launch(0, logn, batch, q, &sh);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint32_t *src_lo = xlo, *src_hi = xhi;
  err = wide_passes(sh, false, [&](int s0, int k) {
    const long long groups = batch << (logn - k);
    wide_fwd_pass_kernel<<<wide_grid(groups), kWideThreads, 0, st>>>(
        src_lo, src_hi, ylo, yhi, roots, precon, q, logn, s0, k, groups);
    src_lo = ylo;
    src_hi = yhi;
    ++*launches;
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch launch(wide_units(sh), sh.logc, kWideThreads,
                       wide_smem_bytes(sh), stream);
  err = cudaLaunchKernelEx(&launch.cfg, wide_fwd_cluster_kernel, src_lo,
                           src_hi, ylo, yhi, roots, precon, sh);
  if (err != cudaSuccess) return (int)err;
  ++*launches;
  return (int)cudaGetLastError();
}

int ntt_wide_inv(const uint32_t* xlo, const uint32_t* xhi, uint32_t* ylo,
                 uint32_t* yhi, const uint64_t* iroots,
                 const uint64_t* iprecon, uint64_t q, uint64_t sc,
                 uint64_t scp, long long batch, int logn, void* stream,
                 int* launches) {
  *launches = 0;
  WideShape sh;
  cudaError_t err = wide_launch(1, logn, batch, q, &sh);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch launch(wide_units(sh), sh.logc, kWideThreads,
                       wide_smem_bytes(sh), stream);
  err = cudaLaunchKernelEx(&launch.cfg, wide_inv_cluster_kernel, xlo, xhi,
                           ylo, yhi, iroots, iprecon, sh, sc, scp);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++*launches;
  const cudaStream_t st = (cudaStream_t)stream;
  err = wide_passes(sh, true, [&](int s0, int k) {
    const long long groups = batch << (logn - k);
    wide_inv_pass_kernel<<<wide_grid(groups), kWideThreads, 0, st>>>(
        ylo, yhi, ylo, yhi, iroots, iprecon, q, logn, s0, k, groups, sc, scp);
    ++*launches;
    return cudaGetLastError();
  });
  return (int)err;
}

// The launch of a wide transform's cluster kernel (0 forward, 1 inverse) at
// (B, 2^logn): info = {log2 of the CTAs a block (the cluster), log2 of the
// blocks a CTA, shared memory bytes a CTA, threads a CTA, registers a
// thread, CTAs an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the
// most such clusters the card runs at once, the clusters launched, the
// passes in device memory, log2 of the block's words}.
int ntt_wide_launch_info(int which, int logn, long long batch, int* info) {
  for (int i = 0; i < 10; ++i) info[i] = 0;
  WideShape sh;
  cudaError_t err = wide_launch(which, logn, batch, 1, &sh);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = wide_smem_bytes(sh);
  info[0] = sh.logc;
  info[1] = sh.logp;
  info[2] = (int)bytes;
  info[3] = kWideThreads;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, wide_kernel(which));
  if (err != cudaSuccess) return (int)err;
  info[4] = attr.numRegs;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[5], wide_kernel(which), kWideThreads, bytes);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch launch(1, sh.logc, kWideThreads, bytes, nullptr);
  err = cudaOccupancyMaxActiveClusters(&info[6], wide_kernel(which),
                                       &launch.cfg);
  if (err != cudaSuccess) return (int)err;
  info[7] = (int)wide_units(sh);
  wide_passes(sh, which == 1, [&](int, int) {
    ++info[8];
    return cudaSuccess;
  });
  info[9] = sh.logl;
  return (int)cudaSuccess;
}

// WideRing's elementwise calls on `count` words (WideMode: 0 the polymul's
// Montgomery product, 1 pointwise_mul, 2 add, 3 sub): one launch.
int ntt_wide_pointwise(const uint32_t* alo, const uint32_t* ahi,
                       const uint32_t* blo, const uint32_t* bhi,
                       uint32_t* ylo, uint32_t* yhi, long long count,
                       int mode, uint64_t q, uint64_t qinv_neg, uint64_t r2,
                       void* stream, int* launches) {
  *launches = 0;
  if (count < 1 || mode < kWideMont || mode > kWideSub)
    return (int)cudaErrorInvalidValue;
  wide_pointwise_kernel<<<wide_grid(count), kWideThreads, 0,
                          (cudaStream_t)stream>>>(alo, ahi, blo, bhi, ylo,
                                                  yhi, count, mode, q,
                                                  qinv_neg, r2);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) *launches = 1;
  return (int)err;
}

// M1: one pass of the matrix-product four-step transform on (B, 2^logn1,
// 2^logn2) words, x -> y.  Column pass (row = 0): x in [0, 4q), y = D x
// mod q; row pass (row = 1): x in [0, q), y = (T x) R^T mod q, with the
// (n1, n2) twiddles tw and their Shoup words twp.  mat: the pass's int8
// digit blocks (ops/mxu_ntt.py _kernel_tiles).  y in [0, q).
int ntt_mxu_pass(const uint32_t* x, uint32_t* y, const int8_t* mat,
                 const uint32_t* tw, const uint32_t* twp, long long batch,
                 int logn1, int logn2, int row, uint32_t q, void* stream) {
  MxuShape sh;
  long long blocks = 0;
  int per_sm = 0;
  const cudaError_t err = mxu_launch(row, logn1, logn2, batch, q, &sh,
                                     &blocks, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t bytes = mxu_smem_bytes(row);
  const cuuint64_t n1 = 1ull << logn1, n2 = 1ull << logn2;
  CUtensorMap mx, mtw, mtwp;
  cudaError_t e;
  if (row) {
    const cuuint64_t dx[2] = {n2, (cuuint64_t)batch * n1}, dt[2] = {n2, n1};
    const cuuint64_t s[1] = {4 * n2};
    const cuuint32_t box[2] = {kMxuTileK, kMxuTileN};
    e = mxu_map(&mx, x, 2, dx, s, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e == cudaSuccess)
      e = mxu_map(&mtw, tw, 2, dt, s, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e == cudaSuccess)
      e = mxu_map(&mtwp, twp, 2, dt, s, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e != cudaSuccess) return (int)e;
    mxu_row_kernel<<<(unsigned)blocks, kMxuThreads, bytes, st>>>(
        mx, mtw, mtwp, y, mat, sh);
  } else {
    const cuuint64_t d[3] = {n2, n1, (cuuint64_t)batch};
    const cuuint64_t s[2] = {4 * n2, 4 * n1 * n2};
    const cuuint32_t box[3] = {kMxuTileN, kMxuTileK, 1};
    e = mxu_map(&mx, x, 3, d, s, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e != cudaSuccess) return (int)e;
    mxu_col_kernel<<<(unsigned)blocks, kMxuThreads, bytes, st>>>(mx, y, mat,
                                                                sh);
  }
  return (int)cudaGetLastError();
}

// The launch of an M1 pass: info = {tile M, tile N, tile K, threads a CTA,
// shared memory bytes a CTA, registers a thread, local memory bytes a
// thread (spills), CTAs an SM, CTAs launched, converter threads, consumer
// threads, stages, raw stages, tiles}.
int ntt_mxu_launch_info(int row, int logn1, int logn2, long long batch,
                        int* info) {
  for (int i = 0; i < 14; ++i) info[i] = 0;
  MxuShape sh;
  long long blocks = 0;
  int per_sm = 0;
  cudaError_t err =
      mxu_launch(row, logn1, logn2, batch, 3, &sh, &blocks, &per_sm);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, mxu_kernel(row));
  if (err != cudaSuccess) return (int)err;
  info[0] = sh.consumers * kMxuBlockRows;
  info[1] = kMxuTileN;
  info[2] = kMxuTileK;
  info[3] = kMxuThreads;
  info[4] = (int)mxu_smem_bytes(row);
  info[5] = attr.numRegs;
  info[6] = (int)attr.localSizeBytes;
  info[7] = per_sm;
  info[8] = (int)blocks;
  info[9] = 128 * kMxuConverters;
  info[10] = 128 * sh.consumers;
  info[11] = kMxuStages;
  info[12] = row ? kMxuRawStages<true> : kMxuRawStages<false>;
  info[13] = (int)(sh.tiles < 0x7fffffffLL ? sh.tiles : 0x7fffffffLL);
  return (int)cudaSuccess;
}

#ifdef NTT_MXU_CLOCKS
// The role counters of CTA 0's last M1 launch (ntt_mxu.cuh MxuClock):
// clear them, or copy the kMxuClockSlots counters out.
int ntt_mxu_clocks(long long* out, int clear) {
  if (clear) {
    const long long zero[kMxuClockSlots] = {};
    return (int)cudaMemcpyToSymbol(g_mxu_clocks, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(out, g_mxu_clocks,
                                   sizeof(long long) * kMxuClockSlots);
}
#endif

}  // extern "C"
