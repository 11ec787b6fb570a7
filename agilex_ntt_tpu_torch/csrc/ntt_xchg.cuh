// The cross-device butterfly stage (K11, the kernel in _xchg_call of
// agilex_ntt_tpu/parallel/overlap.py) for a group of butterfly pairs in one
// launch.
//
// One stage whose partner lives on another shard: the u-half of a pair
// (u, v) becomes step(u, v) and the v-half step(v, u), word by word, with
// one twiddle row for the pair (ntt_xchg_fwd, ntt_xchg_inv).  The TPU
// kernel pulls the partner's rows into VMEM by remote DMA, one semaphore a
// batch chunk, and computes chunk c while later chunks fly.  Here the
// partner is a device pointer: a buffer on the same card, or on a peer card
// with P2P access enabled, read directly.
//
// A launch takes a table of entries by value in the kernel's parameters
// (XchgStage, __grid_constant__), each a pair's two input shards u and v,
// its output halves out_u and out_v (either may be null: that half is not
// written) and its positional twiddle rows w, w'; the stage holds q,
// `last` and the final scale s (Shoup constant s') for them all.
//   * On one card every shard of an sp group and its partner sit in one
//     memory: one entry a pair reads u and v once and writes both halves,
//     8 bytes a word of the stage, and the host launches once a stage and
//     group (parallel/overlap.py).
//   * Where a shard computes its own half from a partner that was copied
//     to it (comm="ppermute") or that sits on a peer card, its entry writes
//     that half only: 12 bytes a word.
// Out of place: every entry reads its words from before the stage, so no
// output may alias an input.  Bound by bytes; w, w' are one row a pair and
// stay in L1/L2.
//
// Layout: blockIdx.y picks the entry; a thread owns one quad (4 consecutive
// words, 16-byte loads and stores; consecutive threads on consecutive
// quads), its column's w, w' through the read-only cache, striding over the
// entry's quads when they outnumber the grid.  One quad a thread keeps four
// independent 16-byte loads in flight (u, v, w, w') and as many blocks as
// quads / 256: a thread that took four rows at a time ran the single-half
// entry 9% slower on the H100 (PERF.md).
//
// The body is plain C++ over (entry, quad), so that
// tests/test_torch_arith_host.py runs it on the host.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include "ntt_arith.cuh"

// Entries a launch takes: 64 entries of 48 bytes keep the parameters under
// the 4 KiB every launch accepts; a larger group takes one launch a 64.
constexpr int kXchgMaxEntries = 64;
// Threads a block, and the most blocks an entry takes.
constexpr int kXchgThreads = 256;
constexpr long long kXchgMaxBlocks = 1LL << 20;

struct XchgEntry {
  const uint32_t* u;
  const uint32_t* v;
  uint32_t* out_u;
  uint32_t* out_v;
  const uint32_t* w;
  const uint32_t* wp;
};

struct XchgStage {
  XchgEntry e[kXchgMaxEntries];
  long long quads;  // quads of every shard
  int width4;       // quads a row
  uint32_t q;
  uint32_t s, sp;   // the last inverse stage's scale
  int last;
};

// 4 consecutive words at p (16-byte aligned), not written during the
// launch: one 16-byte load through the read-only cache on the card.
__host__ __device__ __forceinline__ void xchg_load_quad(uint32_t* v,
                                                        const uint32_t* p) {
#ifdef __CUDA_ARCH__
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
#else
  for (int j = 0; j < 4; ++j) v[j] = p[j];
#endif
}

__host__ __device__ __forceinline__ void xchg_store_quad(uint32_t* p,
                                                         const uint32_t* v) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
#else
  for (int j = 0; j < 4; ++j) p[j] = v[j];
#endif
}

// Entry `entry`'s quad i.  Both halves share the Shoup product (forward) or
// the difference (inverse); a single-half entry computes the other too and
// does not store it.
template <bool kFwd>
__host__ __device__ __forceinline__ void xchg_group_body(const XchgStage& st,
                                                         int entry,
                                                         long long i) {
  const XchgEntry& e = st.e[entry];
  const bool last = st.last != 0;
  const size_t off = 4 * (size_t)i;
  const size_t col = 4 * (size_t)(i % st.width4);
  uint32_t u[4], v[4], w[4], wp[4], ou[4], ov[4];
  xchg_load_quad(u, e.u + off);
  xchg_load_quad(v, e.v + off);
  xchg_load_quad(w, e.w + col);
  xchg_load_quad(wp, e.wp + col);
  NTT_UNROLL
  for (int j = 0; j < 4; ++j) {
    if (kFwd) {
      ou[j] = ntt_xchg_fwd(u[j], v[j], true, w[j], wp[j], st.q, last);
      ov[j] = ntt_xchg_fwd(v[j], u[j], false, w[j], wp[j], st.q, last);
    } else {
      ou[j] = ntt_xchg_inv(u[j], v[j], true, w[j], wp[j], st.q);
      ov[j] = ntt_xchg_inv(v[j], u[j], false, w[j], wp[j], st.q);
      if (last) {
        ou[j] = ntt_scale_reduce(ou[j], st.s, st.sp, st.q);
        ov[j] = ntt_scale_reduce(ov[j], st.s, st.sp, st.q);
      }
    }
  }
  if (e.out_u) xchg_store_quad(e.out_u + off, ou);
  if (e.out_v) xchg_store_quad(e.out_v + off, ov);
}
