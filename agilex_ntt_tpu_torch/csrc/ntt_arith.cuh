// Modular arithmetic of the NTT kernels, on 32-bit words.
//
// The same helpers as agilex_ntt_tpu/ops/modmul.py and the butterflies of
// agilex_ntt_tpu/ops/stage_math.py, written once for the device and the
// host: the CUDA kernels (ntt_kernels.cu) include this file, and
// tests/test_torch_arith_host.py builds it with a plain C++ compiler (with
// __host__/__device__/__forceinline__ defined away) and holds it bit for bit
// against the int64 helpers of ops/modmul.py.
//
// All moduli are below 2^30, so Harvey's lazy range [0, 4q) fits in a word.
// Every result below is the exact word the JAX helper returns.
#pragma once

#include <stdint.h>

#define NTT_HD __host__ __device__ __forceinline__
// Full unrolling of the radix groups' loops on the device, so that their
// word arrays stay in registers.
// NTT_NO_UNROLL keeps a loop rolled where unrolling would hold registers
// that a caller's live values need.
#ifdef __CUDA_ARCH__
#define NTT_UNROLL _Pragma("unroll")
#define NTT_NO_UNROLL _Pragma("unroll 1")
#else
#define NTT_UNROLL
#define NTT_NO_UNROLL
#endif

// High 32 bits of a 32x32-bit product.
NTT_HD uint32_t ntt_mulhi(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  return __umulhi(a, b);
#else
  return (uint32_t)(((uint64_t)a * b) >> 32);
#endif
}

// x - bound if x >= bound else x.  Unsigned compare: x may reach 4q - 1,
// above 2^31.
NTT_HD uint32_t ntt_cond_sub(uint32_t x, uint32_t bound) {
  return x >= bound ? x - bound : x;
}

// w * a mod q in [0, 2q) by Shoup's trick, for w < q,
// wp = floor(w * 2^32 / q) and any 32-bit a.  Both products wrap mod 2^32.
NTT_HD uint32_t ntt_shoup_lazy(uint32_t a, uint32_t w, uint32_t wp, uint32_t q) {
  return w * a - ntt_mulhi(a, wp) * q;
}

// Harvey's Cooley-Tukey butterfly: x, y in [0, 4q) -> (x + w y, x - w y),
// both in [0, 4q).
NTT_HD void ntt_ct_butterfly(uint32_t& x, uint32_t& y, uint32_t w, uint32_t wp,
                             uint32_t q) {
  const uint32_t two_q = 2u * q;
  const uint32_t tx = ntt_cond_sub(x, two_q);
  const uint32_t t = ntt_shoup_lazy(y, w, wp, q);
  x = tx + t;
  y = tx + two_q - t;
}

// Harvey's Gentleman-Sande butterfly: x, y in [0, 2q) -> (x + y, w (x - y)),
// both in [0, 2q).
NTT_HD void ntt_gs_butterfly(uint32_t& x, uint32_t& y, uint32_t w, uint32_t wp,
                             uint32_t q) {
  const uint32_t two_q = 2u * q;
  const uint32_t s = ntt_cond_sub(x + y, two_q);
  const uint32_t d = x + two_q - y;
  x = s;
  y = ntt_shoup_lazy(d, w, wp, q);
}

// The last inverse stage with the scale folded in (inv_stages' m = 1):
// x, y in [0, 2q) -> (su (x + y), sv (x - y)) in [0, q), where sv is the
// scale times inv_roots[1]; sup and svp are their Shoup precons.
NTT_HD void ntt_gs_scaled_butterfly(uint32_t& x, uint32_t& y, uint32_t su,
                                    uint32_t sup, uint32_t sv, uint32_t svp,
                                    uint32_t q) {
  const uint32_t sum = x + y;
  const uint32_t diff = x + 2u * q - y;
  x = ntt_cond_sub(ntt_shoup_lazy(sum, su, sup, q), q);
  y = ntt_cond_sub(ntt_shoup_lazy(diff, sv, svp, q), q);
}

// A lazy forward output [0, 4q) reduced to [0, q).
NTT_HD uint32_t ntt_reduce_4q(uint32_t x, uint32_t q) {
  return ntt_cond_sub(ntt_cond_sub(x, 2u * q), q);
}

// K consecutive forward stages on the 2^K words of a radix-2^K group, held
// by one thread: the words v[j] = x[p + j u] of a transform at stages
// [s, s + K) whose smallest stride is u.  Level l (stage s + l) pairs v[j]
// and v[j + 2^(K-1-l)] for j with that bit clear, with the twiddle
// w[2^l - 1 + (j >> (K - l))]: the 2^l twiddles of level l are
// roots[2^(s+l) + B 2^l + i], i < 2^l, for the group's block B (the
// caller loads them).  In [0, 4q), out [0, 4q).
template <int K>
NTT_HD void ntt_ct_radix(uint32_t* v, const uint32_t* w, const uint32_t* wp,
                         uint32_t q) {
  NTT_UNROLL
  for (int l = 0; l < K; ++l) {
    const int half = 1 << (K - 1 - l);
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) {
      if (j & half) continue;
      const int i = (1 << l) - 1 + (j >> (K - l));
      ntt_ct_butterfly(v[j], v[j + half], w[i], wp[i], q);
    }
  }
}

// The inverse (Gentleman-Sande) stages of the same group, level K - 1
// (stride u) first, on the inverse twiddles in the same places.  With
// `scale` (su, su', sv, sv': the group holds the transform's last stage,
// s = 0) level 0 is ntt_gs_scaled_butterfly.  In [0, 2q), out [0, 2q), or
// [0, q) scaled.
template <int K>
NTT_HD void ntt_gs_radix(uint32_t* v, const uint32_t* w, const uint32_t* wp,
                         uint32_t q, const uint32_t* scale) {
  NTT_UNROLL
  for (int l = K - 1; l >= 0; --l) {
    const int half = 1 << (K - 1 - l);
    NTT_UNROLL
    for (int j = 0; j < (1 << K); ++j) {
      if (j & half) continue;
      if (l == 0 && scale != nullptr) {
        ntt_gs_scaled_butterfly(v[j], v[j + half], scale[0], scale[1],
                                scale[2], scale[3], q);
      } else {
        const int i = (1 << l) - 1 + (j >> (K - l));
        ntt_gs_butterfly(v[j], v[j + half], w[i], wp[i], q);
      }
    }
  }
}

// Montgomery REDC with R = 2^32: a * b * 2^-32 mod q in [0, 2q) for
// a * b < 2^32 q.  (a b + m q) / R = hi(a b) + hi(m q) + carry, where the
// low words cancel and carry out exactly when lo(a b) != 0.
NTT_HD uint32_t ntt_mont_lazy(uint32_t a, uint32_t b, uint32_t q,
                              uint32_t qinv_neg) {
  const uint32_t lo = a * b;
  const uint32_t m = lo * qinv_neg;
  return ntt_mulhi(a, b) + ntt_mulhi(m, q) + (lo != 0u ? 1u : 0u);
}

// Shoup product by a scale constant, then one conditional subtraction:
// s * x mod q in [0, q) for any 32-bit x (the fused n^-1 scaling of the
// stage-sharded inverse, and the post row of the DIT inverse).
NTT_HD uint32_t ntt_scale_reduce(uint32_t x, uint32_t s, uint32_t sp,
                                 uint32_t q) {
  return ntt_cond_sub(ntt_shoup_lazy(x, s, sp, q), q);
}

// One cross-device forward stage at one word (agilex_ntt_tpu/ops/
// stage_math.py::fwd_stage_step): this shard holds the u-half (is_u) or
// the v-half of every butterfly it shares with its partner's shard.  x and
// partner in [0, 4q); out in [0, 4q), or [0, q) when `last`.
NTT_HD uint32_t ntt_xchg_fwd(uint32_t x, uint32_t partner, bool is_u,
                             uint32_t w, uint32_t wp, uint32_t q, bool last) {
  const uint32_t two_q = 2u * q;
  const uint32_t tx = ntt_cond_sub(is_u ? x : partner, two_q);
  const uint32_t t = ntt_shoup_lazy(is_u ? partner : x, w, wp, q);
  const uint32_t out = is_u ? tx + t : tx + two_q - t;
  return last ? ntt_cond_sub(ntt_cond_sub(out, two_q), q) : out;
}

// One cross-device inverse (Gentleman-Sande) stage at one word
// (stage_math.py::inv_stage_step): the u-half keeps the sum, the v-half
// the twiddled difference partner - x (the partner holds the u-value).
// x and partner in [0, 2q); out in [0, 2q).
NTT_HD uint32_t ntt_xchg_inv(uint32_t x, uint32_t partner, bool is_u,
                             uint32_t w, uint32_t wp, uint32_t q) {
  const uint32_t two_q = 2u * q;
  return is_u ? ntt_cond_sub(x + partner, two_q)
              : ntt_shoup_lazy(partner - x + two_q, w, wp, q);
}
