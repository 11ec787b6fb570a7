"""The CUDA kernels' arithmetic, compiled for the host and held bit for bit
against the port's int64 helpers (``ops/modmul.py``) and the plain versions
of the cross-device stage K11 (also its group body, ``csrc/ntt_xchg.cuh``,
over tables of 2, 4 and 8 butterfly pairs and halves), the DIT inverse's scale rows (K12) and the
radix-4 and radix-8 groups of the four-step cluster kernels (K7a, K8:
against the int64 butterflies stage by stage, and as whole size-4 and
size-8 transforms against ``ops/plain_ntt.py``).  The bodies of the
cluster kernels K7a, K7b, K8, of K9a's and K9b's slab kernels
(``csrc/ntt_fourstep_cluster.cuh``), of the polydot K5/K6b, and K3/K6a
at one channel (``csrc/ntt_polydot_cluster.cuh``), and of the transforms
K4a/K4b, K1/K2 and K12 (``csrc/ntt_rns_transform.cuh``) run here too
(and the matrix-product pass M1's int64 epilogue, digit packing and
converter, ``csrc/ntt_mxu.cuh``, against Python integers and the plain
version): one host thread a GPU
thread, four a CTA (the polydot: a sixteenth of its words), ``std::barrier``
for ``__syncthreads`` and for the cluster's barrier, each CTA's slab a host
array that the others reach as through ``map_shared_rank``, in a spawned
child process (the pytest worker loads no threaded library); their output
is held against the plain versions at clusters of 1 to 16 CTAs.

``csrc/ntt_arith.cuh`` is written once for the device and the host.  Here it
is built with plain ``g++`` (``__host__``/``__device__`` defined away, no
PyTorch headers, so the build takes about a second) into a small shared
library, loaded with ctypes, and fed 10**5 random operands plus the edge
values 0, q-1, 2q-1 and 4q-1 of each lazy range.
"""

import ctypes
import multiprocessing
import shutil
import subprocess
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from agilex_ntt_tpu_torch.ops import modmul as mm
from agilex_ntt_tpu_torch.ops import mxu_ntt
from agilex_ntt_tpu_torch.ops import plain_ntt as P
from agilex_ntt_tpu_torch.params import find_primes, make_params

CSRC = Path(__file__).resolve().parents[1] / "agilex_ntt_tpu_torch" / "csrc"
COUNT = 100_000
# a 30-bit prime (n = 4096) and a small one (12289, n <= 4096)
PRIMES = (find_primes(4096, 1)[0], 12289)

SHIM = r"""
#define __host__
#define __device__
#define __forceinline__ inline
#include "ntt_arith.cuh"
#include "ntt_mxu.cuh"
#include "ntt_xchg.cuh"

extern "C" {
// M1's epilogue over n rows of four partials, its digit planes over n
// groups of four words, and its converter on a stage of 64 rows x 32 words
// below q (v[row][k]) into the stage's 16 planes
void h_mxu_reduce(const int32_t* p, uint32_t q, uint32_t* out, long n) {
  const MxuConsts k = make_mxu_consts(q);
  for (long i = 0; i < n; ++i) out[i] = mxu_reduce(p + kMxuParts * i, k);
}
void h_mxu_pack(const uint32_t* v, uint32_t* w, long n) {
  for (long i = 0; i < n; ++i) mxu_pack_digits(v + 4 * i, w + 4 * i);
}
void h_mxu_convert(const uint32_t* v, uint32_t q, uint8_t* planes) {
  const MxuConsts k = make_mxu_consts(q);
  for (int row = 0; row < kMxuBlockRows; ++row)
    for (int half = 0; half < kMxuTileK / 16; ++half)
      mxu_convert16(v + row * kMxuTileK + 16 * half, planes, row, half, k);
}
int h_mxu_powers() { return kMxuPowers; }
void h_cond_sub(const uint32_t* x, uint32_t bound, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i) out[i] = ntt_cond_sub(x[i], bound);
}
void h_shoup(const uint32_t* a, const uint32_t* w, const uint32_t* wp,
             uint32_t q, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i) out[i] = ntt_shoup_lazy(a[i], w[i], wp[i], q);
}
void h_ct(const uint32_t* x, const uint32_t* y, const uint32_t* w,
          const uint32_t* wp, uint32_t q, uint32_t* ox, uint32_t* oy, long n) {
  for (long i = 0; i < n; ++i) {
    uint32_t u = x[i], v = y[i];
    ntt_ct_butterfly(u, v, w[i], wp[i], q);
    ox[i] = u;
    oy[i] = v;
  }
}
void h_gs(const uint32_t* x, const uint32_t* y, const uint32_t* w,
          const uint32_t* wp, uint32_t q, uint32_t* ox, uint32_t* oy, long n) {
  for (long i = 0; i < n; ++i) {
    uint32_t u = x[i], v = y[i];
    ntt_gs_butterfly(u, v, w[i], wp[i], q);
    ox[i] = u;
    oy[i] = v;
  }
}
void h_mont(const uint32_t* a, const uint32_t* b, uint32_t q, uint32_t qinv,
            uint32_t* out, long n) {
  for (long i = 0; i < n; ++i) out[i] = ntt_mont_lazy(a[i], b[i], q, qinv);
}
void h_scale_reduce(const uint32_t* x, const uint32_t* s, const uint32_t* sp,
                    uint32_t q, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i) out[i] = ntt_scale_reduce(x[i], s[i], sp[i], q);
}
void h_xchg_fwd(const uint32_t* x, const uint32_t* p, int is_u,
                const uint32_t* w, const uint32_t* wp, uint32_t q, int last,
                uint32_t* out, long n) {
  for (long i = 0; i < n; ++i)
    out[i] = ntt_xchg_fwd(x[i], p[i], is_u != 0, w[i], wp[i], q, last != 0);
}
void h_reduce_4q(const uint32_t* x, uint32_t q, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i) out[i] = ntt_reduce_4q(x[i], q);
}
// radix-2^k groups in place: v holds `groups` groups of 2^k words, w and wp
// 2^k - 1 twiddles a group; scale (4 words) or null
void h_ct_radix(int k, uint32_t* v, const uint32_t* w, const uint32_t* wp,
                uint32_t q, long groups) {
  for (long g = 0; g < groups; ++g) {
    uint32_t* x = v + (g << k);
    const long t = g * ((1 << k) - 1);
    if (k == 2) ntt_ct_radix<2>(x, w + t, wp + t, q);
    else ntt_ct_radix<3>(x, w + t, wp + t, q);
  }
}
void h_gs_radix(int k, uint32_t* v, const uint32_t* w, const uint32_t* wp,
                uint32_t q, const uint32_t* scale, long groups) {
  for (long g = 0; g < groups; ++g) {
    uint32_t* x = v + (g << k);
    const long t = g * ((1 << k) - 1);
    if (k == 2) ntt_gs_radix<2>(x, w + t, wp + t, q, scale);
    else ntt_gs_radix<3>(x, w + t, wp + t, q, scale);
  }
}
void h_xchg_inv(const uint32_t* x, const uint32_t* p, int is_u,
                const uint32_t* w, const uint32_t* wp, uint32_t q,
                uint32_t* out, long n) {
  for (long i = 0; i < n; ++i)
    out[i] = ntt_xchg_inv(x[i], p[i], is_u != 0, w[i], wp[i], q);
}
// K11's group body over `count` entries (six words each: u, v, out_u,
// out_v, w, wp; a null out is not written) of (rows, width) shards, every
// (entry, quad) the launch has
void h_xchg_group(int fwd, const uint64_t* table, int count, long long rows,
                  int width, uint32_t q, int last, uint32_t s, uint32_t sp) {
  XchgStage st;
  st.width4 = width / 4;
  st.quads = rows * st.width4;
  st.q = q;
  st.s = s;
  st.sp = sp;
  st.last = last;
  for (int i = 0; i < count; ++i) {
    const uint64_t* t = table + 6 * i;
    st.e[i] = XchgEntry{(const uint32_t*)t[0], (const uint32_t*)t[1],
                        (uint32_t*)t[2],       (uint32_t*)t[3],
                        (const uint32_t*)t[4], (const uint32_t*)t[5]};
  }
  for (int i = 0; i < count; ++i)
    for (long long k = 0; k < st.quads; ++k) {
      if (fwd) xchg_group_body<true>(st, i, k);
      else xchg_group_body<false>(st, i, k);
    }
}
}
"""


# The cluster kernels' bodies on host threads (one a GPU thread).
CLUSTER_SHIM = r"""
#include <barrier>
#include <thread>
#include <vector>
#define __host__
#define __device__
#define __forceinline__ inline
struct Dim { unsigned x; };
static thread_local Dim threadIdx = {0};
static Dim blockDim = {4};
static thread_local std::barrier<>* cta_barrier = nullptr;
inline void __syncthreads() { cta_barrier->arrive_and_wait(); }
template <class T> inline T __ldg(const T* p) { return *p; }
#include "ntt_rns_transform.cuh"

struct HostCluster {
  std::barrier<>* all;
  std::vector<std::vector<uint32_t>>* slabs;
  int rank;
  unsigned block_rank() const { return rank; }
  void sync() { all->arrive_and_wait(); }
  template <class T> T* map_shared_rank(T* p, unsigned r) const {
    return (T*)((*slabs)[r].data() + ((uint32_t*)p - (*slabs)[rank].data()));
  }
};

static Tabs4 tabs(const void* const* p) {
  return Tabs4{(const uint32_t*)p[0], (const uint32_t*)p[1],
               (const uint32_t*)p[2], (const uint32_t*)p[3],
               (const uint32_t*)p[4], (const uint32_t*)p[5]};
}

// `clusters` clusters of 2^logc CTAs of `words` words of shared memory,
// one after another: body(cluster, slab, cluster index).
template <class Body>
static void run_clusters(long long clusters, int logc, size_t words,
                         Body body) {
  const int ctas = 1 << logc;
  for (long long p = 0; p < clusters; ++p) {
    std::barrier<> all(ctas * blockDim.x);
    std::vector<std::barrier<>*> cta;
    for (int r = 0; r < ctas; ++r) cta.push_back(new std::barrier<>(blockDim.x));
    std::vector<std::vector<uint32_t>> slabs(ctas, std::vector<uint32_t>(words));
    std::vector<std::thread> threads;
    for (int r = 0; r < ctas; ++r)
      for (unsigned tid = 0; tid < blockDim.x; ++tid)
        threads.emplace_back([&, r, tid] {
          threadIdx.x = tid;
          cta_barrier = cta[r];
          HostCluster cl{&all, &slabs, r};
          body(cl, slabs[r].data(), p);
        });
    for (auto& t : threads) t.join();
    for (auto* b : cta) delete b;
  }
}

// One cluster of 2^logc CTAs a polynomial (`mats` matrices): body(cluster,
// slab, the polynomial's first word).
template <class Body>
static void run(int mats, long long batch, int logn1, int logn2, int logc,
                Body body) {
  run_clusters(batch, logc, cluster_smem_bytes(mats, logn1, logn2, logc) / 4,
               [&](HostCluster& cl, uint32_t* s, long long p) {
                 body(cl, s, (size_t)p << (logn1 + logn2));
               });
}

extern "C" {
void h_fwd4(const uint32_t* x, uint32_t* y, const void* const* t,
            long long batch, int logn1, int logn2, int logc, uint32_t q) {
  const Slab4 sl = make_slab4(logn1, logn2, logc);
  const Tabs4 tb = tabs(t);
  run(1, batch, logn1, logn2, logc, [&](HostCluster& cl, uint32_t* s, size_t o) {
    fwd4_cluster_body(cl, s, x + o, y + o, tb, sl, q);
  });
}
void h_polymul4(const uint32_t* a, const uint32_t* b, uint32_t* out,
                const void* const* f, const void* const* i,
                const uint32_t* rs, const uint32_t* cs, long long batch,
                int logn1, int logn2, int logc, uint32_t q, uint32_t qinv) {
  const Slab4 sl = make_slab4(logn1, logn2, logc);
  const Tabs4 tf = tabs(f), ti = tabs(i);
  run(2, batch, logn1, logn2, logc, [&](HostCluster& cl, uint32_t* s, size_t o) {
    polymul4_cluster_body(cl, s, a + o, b + o, out + o, tf, ti, sl, rs, cs, q,
                          qinv);
  });
}
void h_inv4(const uint32_t* x, uint32_t* y, const void* const* t,
            const uint32_t* rs, const uint32_t* cs, long long batch,
            int logn1, int logn2, int logc, uint32_t q) {
  const Slab4 sl = make_slab4(logn1, logn2, logc);
  const Tabs4 tb = tabs(t);
  run(1, batch, logn1, logn2, logc, [&](HostCluster& cl, uint32_t* s, size_t o) {
    inv4_cluster_body(cl, s, x + o, y + o, tb, sl, rs, cs, q);
  });
}
// K9a's slabs of 2^logw columns, each CTA on its own (the cluster unused)
void h_col_fwd4(const uint32_t* x, uint32_t* y, const void* const* t,
                long long batch, int logn1, int logn2, int logw, uint32_t q) {
  const Slab4 sl = make_slab4(logn1, logn2, logn2 - logw);
  const Tabs4 tb = tabs(t);
  run(1, batch, logn1, logn2, sl.logc,
      [&](HostCluster& cl, uint32_t* s, size_t o) {
        col_fwd_slab_body(s, x + o, y + o, tb, sl, cl.rank, q);
      });
}
// K9b's slabs of 2^logw columns
void h_col_inv4(const uint32_t* x, uint32_t* y, const void* const* t,
                const uint32_t* cs, long long batch, int logn1, int logn2,
                int logw, uint32_t q) {
  const Slab4 sl = make_slab4(logn1, logn2, logn2 - logw);
  const Tabs4 tb = tabs(t);
  run(1, batch, logn1, logn2, sl.logc,
      [&](HostCluster& cl, uint32_t* s, size_t o) {
        col_inv_slab_body(s, x + o, y + o, tb, sl, cl.rank, cs, q);
      });
}
// K5/K6b over `channels` channels of (batch, k, 2^logn) operands, CTAs of
// 2^logthreads threads (each holding 16 words a thread of an operand);
// tables (L, n), qs, qinvs (L,), scales (L, 4)
void h_polydot_rns(const uint32_t* a, const uint32_t* b, uint32_t* out,
                   const uint32_t* roots, const uint32_t* precon,
                   const uint32_t* iroots, const uint32_t* iprecon,
                   const uint32_t* qs, const uint32_t* qinvs,
                   const uint32_t* scales, int channels, long long batch,
                   int k, int logn, int logthreads) {
  const DotShape sh = make_dot_shape(logn, logthreads);
  const unsigned saved = blockDim.x;
  blockDim.x = 1u << logthreads;
  const long long clusters = (batch + (1LL << sh.logp) - 1) >> sh.logp;
  for (int l = 0; l < channels; ++l) {
    const size_t data = ((size_t)l * batch) << logn, tab = (size_t)l << logn;
    run_clusters(clusters, sh.logc, dot_smem_bytes(sh, k) / 4,
                 [&](HostCluster& cl, uint32_t* s, long long c) {
                   polydot_rns_body(cl, s, a + data * k, b + data * k,
                                    out + data, roots + tab, precon + tab,
                                    iroots + tab, iprecon + tab, batch, k, sh,
                                    cl.rank, c << sh.logp, qs[l], qinvs[l],
                                    scales + 4 * l);
                 });
  }
  blockDim.x = saved;
}
// K4a (inv = 0) or K4b over `channels` channels of (batch, 2^logn), CTAs of
// 2^logthreads threads (16 words a thread), one cluster a unit as the
// launcher runs them; tables (L, n), qs (L,), scales (L, 4)
void h_rns(int inv, const uint32_t* x, uint32_t* y, const uint32_t* roots,
           const uint32_t* precon, const uint32_t* qs, const uint32_t* scales,
           int channels, long long batch, int logn, int logthreads) {
  const DotShape sh = make_dot_shape(logn, logthreads);
  const unsigned saved = blockDim.x;
  blockDim.x = 1u << logthreads;
  for (int l = 0; l < channels; ++l) {
    const size_t data = ((size_t)l * batch) << logn, tab = (size_t)l << logn;
    run_clusters(rns_units(sh, batch), sh.logc, rns_smem_bytes(sh) / 4,
                 [&](HostCluster& cl, uint32_t* s, long long u) {
                   if (inv)
                     inv_rns_body(cl, s, x + data, y + data, roots + tab,
                                  precon + tab, batch, sh, cl.rank, u, qs[l],
                                  scales + 4 * l);
                   else
                     fwd_rns_body(cl, s, x + data, y + data, roots + tab,
                                  precon + tab, batch, sh, cl.rank, u, qs[l]);
                 });
  }
  blockDim.x = saved;
}
// K12 over (batch, 2^logn) z, CTAs of 2^logthreads threads, one cluster a
// unit as the launcher runs them; roots, precon: DitTables.cyclic's; rows:
// the (4, n) scale rows
void h_dit(const uint32_t* x, uint32_t* y, const uint32_t* roots,
           const uint32_t* precon, const uint32_t* rows, long long batch,
           int logn, int logthreads, uint32_t q) {
  const DotShape sh = make_dot_shape(logn, logthreads);
  const unsigned saved = blockDim.x;
  blockDim.x = 1u << logthreads;
  const size_t n = (size_t)1 << logn;
  run_clusters(rns_units(sh, batch), sh.logc, rns_smem_bytes(sh) / 4,
               [&](HostCluster& cl, uint32_t* s, long long u) {
                 dit_inv_rns_body(cl, s, x, y, roots, precon, rows + 2 * n,
                                  rows + 3 * n, batch, sh, cl.rank, u, q);
               });
  blockDim.x = saved;
}
// K5/K6b's shape: {logc, logp, logw, logr, shared bytes with k = 1, k = 2}
void h_dot_shape(int logn, int logthreads, long long* out) {
  const DotShape s = make_dot_shape(logn, logthreads);
  const long long v[6] = {s.logc, s.logp, s.logw, s.logr,
                          (long long)dot_smem_bytes(s, 1),
                          (long long)dot_smem_bytes(s, 2)};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
}
int h_cluster_logc(int mats, int logn1, int logn2, long long max_bytes) {
  return cluster_logc(mats, logn1, logn2, (size_t)max_bytes);
}
int h_slab_logw(int logn1, int logn2, long long max_bytes) {
  return slab_logw(logn1, logn2, (size_t)max_bytes);
}
}
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def build_host(tmp_path_factory, name: str, source: str, *flags) -> Path:
    """``source`` (C++ that includes headers of ``csrc/``) built with g++
    into a shared library in a fresh temporary directory; skips the test
    where g++ is missing."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp(name)
    src = out / f"{name}.cpp"
    src.write_text(source)
    so = out / f"lib{name}.so"
    subprocess.run(
        [gxx, "-x", "c++", *flags, "-shared", "-fPIC", f"-I{CSRC}",
         "-o", str(so), str(src)],
        check=True, capture_output=True,
    )
    return so


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    h = ctypes.CDLL(str(build_host(tmp_path_factory, "arith_host", SHIM,
                                   "-O2")))
    P, U, L = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_long
    h.h_cond_sub.argtypes = [P, U, P, L]
    h.h_shoup.argtypes = [P, P, P, U, P, L]
    h.h_ct.argtypes = [P, P, P, P, U, P, P, L]
    h.h_gs.argtypes = [P, P, P, P, U, P, P, L]
    h.h_mont.argtypes = [P, P, U, U, P, L]
    I = ctypes.c_int
    h.h_scale_reduce.argtypes = [P, P, P, U, P, L]
    h.h_xchg_fwd.argtypes = [P, P, I, P, P, U, I, P, L]
    h.h_xchg_inv.argtypes = [P, P, I, P, P, U, P, L]
    h.h_reduce_4q.argtypes = [P, U, P, L]
    h.h_xchg_group.argtypes = [I, P, I, ctypes.c_longlong, I, U, I, U, U]
    h.h_ct_radix.argtypes = [I, P, P, P, U, L]
    h.h_gs_radix.argtypes = [I, P, P, P, U, P, L]
    h.h_mxu_reduce.argtypes = [P, U, P, L]
    h.h_mxu_pack.argtypes = [P, P, L]
    h.h_mxu_convert.argtypes = [P, U, P]
    h.h_mxu_powers.restype = ctypes.c_int
    return h


@pytest.fixture(scope="module")
def cluster_so(tmp_path_factory):
    """The cluster bodies built for the host (loaded only by a child)."""
    return str(build_host(tmp_path_factory, "cluster_host", CLUSTER_SHIM,
                          "-std=c++20", "-O1", "-pthread"))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _operands(q: int, bound: int, seed: int) -> np.ndarray:
    """COUNT uint32 values in [0, bound), led by the edge values below it."""
    rng = np.random.default_rng(seed)
    edges = [v for v in (0, 1, q - 1, q, 2 * q - 1, 2 * q, 4 * q - 1, bound - 1)
             if v < bound]
    x = rng.integers(0, bound, size=COUNT, dtype=np.uint64)
    x[: len(edges)] = edges
    return x.astype(np.uint32)


def _twiddles(q: int, seed: int):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, q, size=COUNT, dtype=np.uint64)
    w[:3] = [0, 1, q - 1]
    wp = (w << np.uint64(32)) // np.uint64(q)
    return w.astype(np.uint32), wp.astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64))


def _host(fn, *args, outs=1):
    res = [np.empty(COUNT, dtype=np.uint32) for _ in range(outs)]
    ptrs = [_ptr(a) if isinstance(a, np.ndarray) else a for a in args]
    fn(*ptrs, *(_ptr(r) for r in res), COUNT)
    return res


# K11's group launches: entries a table, and (rows, width) of a shard
XCHG_GROUPS, XCHG_SHAPE = (2, 4, 8), (9, 24)


# what an entry writes: both halves of its pair, or one of them
XCHG_HALVES = ("uv", "u", "v")
UNWRITTEN = np.uint32(0xFFFFFFFF)


def _xchg_group(lib, fwd, u, v, w, wp, halves, q, last, scale):
    """K11's group body over P entries on the host: u, v (P, rows, width),
    w, wp (P, width), halves (P,) from XCHG_HALVES; the two output arrays
    (P, rows, width), UNWRITTEN where an entry writes no half."""
    out_u = np.full_like(u, UNWRITTEN)
    out_v = np.full_like(u, UNWRITTEN)
    table = np.array([(a.ctypes.data, b.ctypes.data,
                       ou.ctypes.data if "u" in h else 0,
                       ov.ctypes.data if "v" in h else 0,
                       c.ctypes.data, d.ctypes.data)
                      for a, b, ou, ov, c, d, h
                      in zip(u, v, out_u, out_v, w, wp, halves)],
                     dtype=np.uint64)
    s = scale % q
    lib.h_xchg_group(int(fwd), _ptr(table), len(u), u.shape[1], u.shape[2],
                     q, int(last), s, (s << 32) // q)
    return out_u, out_v


def _xchg_groups_match_plain(lib, q, fwd, bound, seed):
    """The group body at P = 2, 4 and 8 entries, halves mixed (entry d
    writes XCHG_HALVES[d % 3]), with and without ``last`` (the inverse's
    with a scale), against the plain step of each half: the u-half of pair
    (u, v) is step(u, v, u-role), the v-half step(v, u, v-role).  A half
    that an entry does not write stays untouched."""
    rng = np.random.default_rng(seed)
    scale = int(rng.integers(1, q))
    for P_ in XCHG_GROUPS:
        shape = (P_,) + XCHG_SHAPE
        u = rng.integers(0, bound, size=shape).astype(np.uint32)
        v = rng.integers(0, bound, size=shape).astype(np.uint32)
        u[0, 0, :4], v[-1, -1, -4:] = bound - 1, 0
        w = rng.integers(0, q, size=(P_, XCHG_SHAPE[1])).astype(np.uint64)
        wp = ((w << np.uint64(32)) // np.uint64(q)).astype(np.uint32)
        w = w.astype(np.uint32)
        halves = [XCHG_HALVES[d % 3] for d in range(P_)]
        for last in (False, True):
            got = _xchg_group(lib, fwd, u, v, w, wp, halves, q, last, scale)
            for d in range(P_):
                for half, mine, other, out in (("u", u, v, got[0]),
                                               ("v", v, u, got[1])):
                    if half not in halves[d]:
                        assert (out[d] == UNWRITTEN).all(), (P_, d, half)
                        continue
                    args = (_t(mine[d]), _t(other[d]), half == "u",
                            _t(w[d]), _t(wp[d]), q)
                    want = (P.fwd_stage_step_plain(*args, last) if fwd else
                            P.inv_stage_step_plain(
                                *args, (scale, (scale << 32) // q) if last
                                else None))
                    assert np.array_equal(out[d], want.numpy()), (
                        P_, d, half, last)


@pytest.mark.parametrize("q", PRIMES)
def test_cond_sub(lib, q):
    x = _operands(q, 4 * q, 1)
    for bound in (q, 2 * q):
        (got,) = _host(lib.h_cond_sub, x, bound)
        assert np.array_equal(got, mm.cond_sub(_t(x), bound).numpy())
    # the last forward stage's reduction of the cluster kernels
    (got,) = _host(lib.h_reduce_4q, x, q)
    want = mm.cond_sub(mm.cond_sub(_t(x), 2 * q), q).numpy()
    assert np.array_equal(got, want) and int(got.max()) < q


def _radix(lib, fn, k, v, w, wp, q, *scale):
    """fn (h_ct_radix or h_gs_radix) on a copy of the (groups, 2^k) words."""
    out = np.ascontiguousarray(v, dtype=np.uint32).copy()
    fn(k, _ptr(out), _ptr(np.ascontiguousarray(w)), _ptr(np.ascontiguousarray(wp)),
       q, *scale, out.shape[0])
    return out


def _radix_twiddles(k, w, wp):
    """(groups, 2^k - 1) twiddles from the COUNT-long rows w, wp."""
    groups = COUNT >> k
    m = (1 << k) - 1
    return (w[: groups * m].reshape(groups, m), wp[: groups * m].reshape(groups, m))


def _group_plain(k, v, w, wp, butterfly, order, scale=None):
    """The radix-2^k group stage by stage on the int64 butterflies: level l
    pairs j, j + 2^(k-1-l) with twiddle 2^l - 1 + (j >> (k - l)); the
    scaled butterfly (int64 Shoup products) at level 0 when given."""
    v = [_t(v[:, j]) for j in range(1 << k)]
    for lev in order:
        half = 1 << (k - 1 - lev)
        for j in range(1 << k):
            if j & half:
                continue
            i = (1 << lev) - 1 + (j >> (k - lev))
            if scale is not None and lev == 0:
                su, sup, sv, svp, q = scale
                x, y = v[j], v[j + half]
                v[j] = mm.cond_sub(mm.shoup_mulmod_lazy(x + y, su, sup, q), q)
                v[j + half] = mm.cond_sub(
                    mm.shoup_mulmod_lazy(x + 2 * q - y, sv, svp, q), q)
            else:
                v[j], v[j + half] = butterfly(v[j], v[j + half], _t(w[:, i]),
                                              _t(wp[:, i]))
    return np.stack([x.numpy() for x in v], axis=1)


@pytest.mark.parametrize("q", PRIMES)
def test_shoup_lazy(lib, q):
    # any 32-bit a: the last inverse stage feeds sums up to 4q - 1
    a = _operands(q, 1 << 32, 2)
    w, wp = _twiddles(q, 3)
    (got,) = _host(lib.h_shoup, a, w, wp, q)
    want = mm.shoup_mulmod_lazy(_t(a), _t(w), _t(wp), q).numpy()
    assert np.array_equal(got, want)
    assert int(got.max()) < 2 * q
    exact = (a.astype(object) * w.astype(object)) % q
    assert np.array_equal(got.astype(object) % q, exact)
    # K12's post row and K11's last inverse scale: the product reduced
    (got,) = _host(lib.h_scale_reduce, a, w, wp, q)
    assert np.array_equal(got, mm.cond_sub(_t(want), q).numpy())
    assert np.array_equal(got.astype(object), exact)


def _cluster_bodies_match_plain(so):
    """K7a's, K7b's and K8's cluster bodies on host threads against the
    plain four-step versions, at clusters of 1 to 16 CTAs (any size may take
    any cluster here), with K8's first operands at the edge words q - 1 and
    0 and K7b's first input at 2q - 1, q - 1 and 0 (the top of its lazy
    range and below); K9a's and K9b's slab bodies at slabs of 2, 8 and n2
    columns, K9b on any words (2^32 - 1, 4q - 1, 2q - 1, q - 1 and 0
    included) with both scales; the cluster each balanced size takes at a
    block's 227 KiB, and K9a's slab width at a third of an SM's shared
    memory and at a block's.  Then K5/K6b's polydot body at n = 256 and
    1024, L = 2, k = 1 and 3, on clusters of 1, 2 and 4 CTAs and with 4
    polynomials a CTA (a ragged last one), and at n = 8 and 4 (the turn pass
    holding every stage; rows of 4 words), its operands at q - 1 on half of
    the words and 0 on a quarter, against ``polydot_rns_plain``; the same
    body at one channel as K3 and K6a launch it, on single-prime negacyclic
    and cyclic ``RingTables`` at n = 2, 4, 8, 256 and 1024, k = 1 and 3, on
    inputs over [0, 4q) and [0, q) (their tops and 0 included), against
    ``polymul_plain``/``polydot_plain``; K4a's and
    K4b's bodies on the same layouts and at n = 8 and 4, one cluster a
    unit as the launcher runs them, with ragged last units, on inputs over [0, 4q) and [0, 2q) (their tops included),
    K4b with the default and the polymul scale, against
    ``fwd_ntt_rns_plain``/``inv_ntt_rns_plain``; the same bodies at one
    channel as K1 and K2 launch them, on single-prime negacyclic, cyclic,
    stage-shard and four-step row and column tables with their callers'
    scales, and on BGV's and BFV's plaintext rings (q = 65537 and 40961),
    against ``fwd_ntt_plain``/``inv_ntt_plain``; K12's body on
    ``make_dit_tables``' cyclic tables and post row at n = 8, 256 and 1024,
    one CTA a polynomial, clusters of 2 and 4 and several polynomials a
    CTA, ragged last units, inputs at 2q - 1, 0 and random on quarters,
    against ``dit_inv_core_plain``; and the polydot's launch
    shape (cluster, polynomials a CTA, shared memory) at 256 threads a CTA.
    Runs in a child process: ``so`` is the library's path."""
    from agilex_ntt_tpu_torch.ops import fourstep as FS
    from agilex_ntt_tpu_torch.ops import ntt_kernel as K
    from agilex_ntt_tpu_torch.params import find_psi

    h = ctypes.CDLL(so)
    P_, I, U, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_longlong
    h.h_fwd4.argtypes = [P_, P_, P_, LL, I, I, I, U]
    h.h_polymul4.argtypes = [P_, P_, P_, P_, P_, P_, P_, LL, I, I, I, U, U]
    h.h_inv4.argtypes = [P_, P_, P_, P_, P_, LL, I, I, I, U]
    h.h_col_fwd4.argtypes = [P_, P_, P_, LL, I, I, I, U]
    h.h_col_inv4.argtypes = [P_, P_, P_, P_, LL, I, I, I, U]
    h.h_polydot_rns.argtypes = [P_] * 10 + [I, LL, I, I, I]
    h.h_rns.argtypes = [I] + [P_] * 6 + [I, LL, I, I]
    h.h_dit.argtypes = [P_] * 5 + [LL, I, I, U]
    h.h_dot_shape.argtypes = [I, I, P_]
    h.h_cluster_logc.argtypes = [I, I, I, LL]
    h.h_slab_logw.argtypes = [I, I, LL]

    # (n, n1, batch, cyclic, log2 of the cluster's CTAs)
    for n, n1, batch, cyclic, logc in ((256, None, 2, False, 1),
                                       (4096, 128, 1, False, 2),
                                       (1024, 16, 1, False, 4),
                                       (512, 256, 1, False, 0),
                                       (4096, None, 1, True, 3)):
        qn = find_primes(n, 1)[0]
        if cyclic:
            plan = FS.make_cyclic_plan(n, qn, pow(find_psi(n, qn), 2, qn), n1)
        else:
            plan = FS.make_plan(n, qn, None, n1)
        ft = P.make_fourstep_tables(plan, "cpu")
        rng = np.random.default_rng(n + logc)
        shape = (batch, ft.n1, ft.n2)
        x = rng.integers(0, 4 * qn, size=shape, dtype=np.int64)
        xi = rng.integers(0, 2 * qn, size=shape, dtype=np.int64)
        a = rng.integers(0, qn, size=shape, dtype=np.int64)
        b = rng.integers(0, qn, size=shape, dtype=np.int64)
        a[0].reshape(-1)[: n // 2] = qn - 1
        b[0].reshape(-1)[: n // 4] = qn - 1
        b[0].reshape(-1)[n // 2:] = 0
        xi[0].reshape(-1)[: n // 4] = 2 * qn - 1
        xi[0].reshape(-1)[n // 4: n // 2] = qn - 1
        xi[0].reshape(-1)[n // 2: 3 * n // 4] = 0
        x32, xi32, a32, b32 = (v.astype(np.uint32) for v in (x, xi, a, b))
        y, out = np.empty_like(x32), np.empty_like(x32)
        logs = (ft.n1.bit_length() - 1, ft.n2.bit_length() - 1)
        h.h_fwd4(_ptr(x32), _ptr(y), K._fwd_tabs(ft), batch, *logs, logc, qn)
        want = P.fwd_ntt_fourstep_plain(_t(x), ft).numpy()
        assert np.array_equal(y, want), ("fwd4", n, logc)
        for sc in (None, ft.polymul_scale):
            h.h_inv4(_ptr(xi32), _ptr(y), K._inv_tabs(ft), K._row_scale(ft),
                     K._col_scale(ft, sc), batch, *logs, logc, qn)
            want = P.inv_ntt_fourstep_plain(_t(xi), ft, sc).numpy()
            assert np.array_equal(y, want), ("inv4", n, logc, sc)
        want = P.fwd_col_fourstep_plain(_t(x), ft).numpy()
        for logw in sorted({min(1, logs[1]), min(3, logs[1]), logs[1]}):
            y[:] = 0
            h.h_col_fwd4(_ptr(x32), _ptr(y), K._fwd_tabs(ft), batch, *logs,
                         logw, qn)
            assert np.array_equal(y, want), ("col_fwd4", n, logw)
        # K9b takes any words: the edges of every lazy range, then random
        xw = rng.integers(0, 1 << 32, size=shape, dtype=np.int64)
        edges = (2**32 - 1, 4 * qn - 1, 2 * qn - 1, qn - 1, 0)
        for i, v in enumerate(edges):
            xw[0].reshape(-1)[i * n // 8: (i + 1) * n // 8] = v
        xw32 = xw.astype(np.uint32)
        for sc in (None, ft.polymul_scale):
            want = P.inv_col_fourstep_plain(_t(xw), ft, sc).numpy()
            for logw in sorted({min(1, logs[1]), min(3, logs[1]), logs[1]}):
                y[:] = 0
                h.h_col_inv4(_ptr(xw32), _ptr(y), K._inv_tabs(ft),
                             K._col_scale(ft, sc), batch, *logs, logw, qn)
                assert np.array_equal(y, want), ("col_inv4", n, logw, sc)
        h.h_polymul4(_ptr(a32), _ptr(b32), _ptr(out), K._fwd_tabs(ft),
                     K._inv_tabs(ft), K._row_scale(ft),
                     K._col_scale(ft, ft.polymul_scale), batch, *logs, logc,
                     qn, ft.qinv_neg)
        want = P.polymul_fourstep_plain(_t(a), _t(b), ft).numpy()
        assert np.array_equal(out, want), ("polymul4", n, logc)
    got = [(h.h_cluster_logc(1, (lg + 1) // 2, lg // 2, 232448),
            h.h_cluster_logc(2, (lg + 1) // 2, lg // 2, 232448))
           for lg in (15, 16, 17, 18, 19, 20)]
    assert got == [(0, 1), (1, 2), (2, 3), (3, 4), (4, -1), (-1, -1)]
    # K9a's slab width (log2) at the balanced splits 2^16..2^21 in 75 KiB,
    # then n1 = 2^12..2^15 (n2 = 2^7) in 75 KiB and in 227 KiB
    got = [h.h_slab_logw((lg + 1) // 2, lg // 2, 76800) for lg in range(16, 22)]
    assert got == [6, 5, 5, 4, 4, 3]
    got = [(h.h_slab_logw(lg, 7, 76800), h.h_slab_logw(lg, 7, 232448))
           for lg in range(12, 16)]
    assert got == [(1, 3), (-1, 2), (-1, 1), (-1, -1)]

    # K5/K6b: (n, log2 of the threads a CTA, batch); a CTA holds 16 words a
    # thread, so at n = 256 4, 8 and 16 threads make clusters of 4, 2 and 1
    # CTAs and 64 threads 4 polynomials a CTA; at n = 1024 16, 32, 64; at
    # n = 8 the turn pass holds every stage, at n = 4 rows of 4 words
    for n, logt, batch in ((256, 2, 2), (256, 3, 2), (256, 4, 2), (256, 6, 5),
                           (1024, 4, 1), (1024, 5, 1), (1024, 6, 2),
                           (8, 0, 3), (4, 1, 7)):
        tabs = P.make_rns_tables([P.make_tables(make_params(n, q), "cpu")
                                  for q in find_primes(n, 2)])
        rng = np.random.default_rng(n + logt)
        for k in (1, 3):
            shape = (batch, k, n)
            a = np.stack([rng.integers(0, q, size=shape) for q in tabs.qs])
            b = np.stack([rng.integers(0, q, size=shape) for q in tabs.qs])
            for l, q in enumerate(tabs.qs):
                a[l].reshape(-1)[: a[l].size // 2] = q - 1
                b[l].reshape(-1)[: b[l].size // 4] = q - 1
                b[l].reshape(-1)[b[l].size // 2: 3 * b[l].size // 4] = 0
                a[l].reshape(-1)[3 * a[l].size // 4:] = 0
            a32, b32 = a.astype(np.uint32), b.astype(np.uint32)
            out = np.zeros((2, batch, n), dtype=np.uint32)
            h.h_polydot_rns(
                _ptr(a32), _ptr(b32), _ptr(out),
                *(t.data_ptr() for t in (
                    tabs.roots, tabs.precon, tabs.inv_roots, tabs.inv_precon,
                    tabs.q_words, tabs.qinv_words,
                    tabs.scale_words(tabs.polymul_scale))),
                2, batch, k, n.bit_length() - 1, logt)
            want = P.polydot_rns_plain(_t(a), _t(b), tabs).numpy()
            assert np.array_equal(out, want), ("polydot_rns", n, logt, k)

    # K3/K6a: the same body at one channel on one prime's RingTables,
    # negacyclic and cyclic, its constants ``dot_words`` read at the offsets
    # the launcher passes (q, -q^-1, the four scale words) and the (n,)
    # tables as (1, n); (n, log2 of the threads a CTA, batch): at n = 2 rows
    # of 2 words, 8 and 32 polynomials a CTA; n = 4, 8 several a CTA; at
    # n = 256 a cluster of 2 and 4 polynomials a CTA, at n = 1024 a cluster
    # of 4 and one polynomial a CTA; ragged last CTAs.  a over K3's lazy
    # [0, 4q) (4q - 1 and 0 on quarters), b over [0, q) (q - 1 and 0)
    from agilex_ntt_tpu_torch import CyclicRing

    for n, logt, batch in ((2, 0, 5), (2, 2, 3), (4, 1, 7), (8, 0, 3),
                           (256, 3, 2), (256, 6, 5), (1024, 4, 1),
                           (1024, 6, 2)):
        q = find_primes(n, 1)[0]
        for cyclic in (False, True):
            rt = (CyclicRing(n, q, device="cpu").tables if cyclic
                  else P.make_tables(make_params(n, q), "cpu"))
            rng = np.random.default_rng(3 * n + logt + cyclic)
            base = rt.dot_words.data_ptr()
            for k in (1, 3):
                a = rng.integers(0, 4 * q, size=(batch, k, n))
                b = rng.integers(0, q, size=(batch, k, n))
                m = a.size // 4
                a.reshape(-1)[:m], a.reshape(-1)[3 * m:] = 4 * q - 1, 0
                b.reshape(-1)[:m], b.reshape(-1)[2 * m: 3 * m] = q - 1, 0
                a32, b32 = a.astype(np.uint32), b.astype(np.uint32)
                out = np.zeros((batch, n), dtype=np.uint32)
                h.h_polydot_rns(
                    _ptr(a32), _ptr(b32), _ptr(out),
                    *(t.data_ptr() for t in (
                        rt.roots, rt.precon, rt.inv_roots, rt.inv_precon)),
                    base, base + 4, base + 8, 1, batch, k, n.bit_length() - 1,
                    logt)
                want = (P.polymul_plain(_t(a[:, 0]), _t(b[:, 0]), rt) if k == 1
                        else P.polydot_plain(_t(a), _t(b), rt)).numpy()
                assert np.array_equal(out, want), ("polydot", n, logt, k,
                                                   cyclic)

    # K4a/K4b on the same layout: (n, log2 of the threads a CTA, batch); at
    # n = 256 clusters of 4, 2 and 1 CTAs and 4 polynomials a CTA, at
    # n = 1024 of 4, 2 and 1, at n = 8 2 and 16 polynomials a CTA, at n = 4
    # 8 (rows of 4 words); ragged last units
    for n, logt, batch in ((256, 2, 3), (256, 3, 3), (256, 4, 2), (256, 6, 9),
                           (1024, 4, 2), (1024, 5, 3), (1024, 6, 5), (8, 0, 7),
                           (8, 3, 40), (4, 1, 19)):
        tabs = P.make_rns_tables([P.make_tables(make_params(n, q), "cpu")
                                  for q in find_primes(n, 2)])
        rng = np.random.default_rng(n + logt + 7)
        x = np.stack([rng.integers(0, 4 * q, size=(batch, n)) for q in tabs.qs])
        xi = np.stack([rng.integers(0, 2 * q, size=(batch, n))
                       for q in tabs.qs])
        for l, q in enumerate(tabs.qs):  # the top of each lazy range
            x[l].reshape(-1)[: x[l].size // 4] = 4 * q - 1
            xi[l].reshape(-1)[: xi[l].size // 4] = 2 * q - 1
            xi[l].reshape(-1)[xi[l].size // 4: xi[l].size // 2] = 0
        got = np.zeros((2, batch, n), dtype=np.uint32)
        unused = tabs.scale_words()
        for inv, v, tw, scales, want in (
                (0, x, (tabs.roots, tabs.precon), unused,
                 P.fwd_ntt_rns_plain(_t(x), tabs)),
                (1, xi, (tabs.inv_roots, tabs.inv_precon), unused,
                 P.inv_ntt_rns_plain(_t(xi), tabs)),
                (1, xi, (tabs.inv_roots, tabs.inv_precon),
                 tabs.scale_words(tabs.polymul_scale),
                 P.inv_ntt_rns_plain(_t(xi), tabs, tabs.polymul_scale))):
            v32 = v.astype(np.uint32)
            got[:] = 0
            h.h_rns(inv, _ptr(v32), _ptr(got), tw[0].data_ptr(),
                    tw[1].data_ptr(), tabs.q_words.data_ptr(),
                    scales.data_ptr(), 2, batch, n.bit_length() - 1, logt)
            assert np.array_equal(got, want.numpy()), ("rns", inv, n, logt)

    # K1/K2: the same bodies at one channel on single-prime RingTables, as
    # ntt_fwd/ntt_inv launch them: q from ``dot_words`` word 0, the scale's
    # words from ``scale_words``, the (n,) tables as (1, n).  The callers'
    # tables: negacyclic and CyclicRing's (n = 2 rows of 2 words with 8 and
    # 32 polynomials a CTA, 4, 8, 256 and 1024 on clusters and several a
    # CTA), a Ring(1024)'s stage-shard tables over 4 shards (every d), a
    # four-step ring's row and column tables; each with its callers'
    # scales.  Inputs over [0, 4q) and [0, 2q) with their tops and 0 on
    # quarters, ragged last units.
    from agilex_ntt_tpu_torch.parallel import stage_shard as SS

    one = []  # (what, RingTables, logt, batch, inverse scales)
    for n, logts, batch in ((2, (0, 2), 37), (4, (1,), 19), (8, (0, 3), 7),
                            (256, (2, 4, 6), 5), (1024, (4, 6, 7), 3)):
        q = find_primes(n, 1)[0]
        for cyclic in (False, True):
            rt = (CyclicRing(n, q, device="cpu").tables if cyclic
                  else P.make_tables(make_params(n, q), "cpu"))
            for logt in logts:
                one.append((("cyclic" if cyclic else "ring", n), rt, logt,
                            batch, (None, rt.polymul_scale, 1)))
    # BGV's and BFV's plaintext rings, Ring(n, q=t): t = 65537 (the n = 16384
    # chain's) and 40961 (the n = 4096 chain's), far below the 30-bit primes
    for n, logts, batch in ((8, (0, 3), 7), (256, (2, 6), 5), (1024, (4, 7), 3)):
        for q in (65537, 40961):
            rt = P.make_tables(make_params(n, q), "cpu")
            for logt in logts:
                one.append((("plaintext ring", n, q), rt, logt, batch,
                            (None, rt.polymul_scale, 1)))
    params = make_params(1024, find_primes(1024, 1)[0])
    for d in range(4):
        st = SS._shard_tables(params, 4, d, torch.device("cpu"))
        assert st is SS._shard_tables(params, 4, d, torch.device("cpu"))
        one.append((("shard", d), st, 2, 3, (1, None)))
    for n, n1 in ((1024, 32), (4096, 256)):
        ft = P.make_fourstep_tables(
            FS.make_plan(n, find_primes(n, 1)[0], None, n1), "cpu")
        one.append((("row", n), ft.row, 0, 9, (None,)))
        one.append((("col", n), ft.col, 2, 3,
                    (ft.col_scale(), ft.col_scale(ft.polymul_scale))))
    for what, rt, logt, batch, scales in one:
        q, n = rt.q, rt.n
        rng = np.random.default_rng(n + logt + batch)
        x = rng.integers(0, 4 * q, size=(batch, n))
        xi = rng.integers(0, 2 * q, size=(batch, n))
        m = x.size // 4
        x.reshape(-1)[:m], x.reshape(-1)[2 * m: 3 * m] = 4 * q - 1, 0
        xi.reshape(-1)[:m], xi.reshape(-1)[2 * m: 3 * m] = 2 * q - 1, 0
        got = np.zeros((batch, n), dtype=np.uint32)
        runs = [(0, x, rt.roots, rt.precon, None)]
        runs += [(1, xi, rt.inv_roots, rt.inv_precon, sc) for sc in scales]
        for inv, v, w, wp, sc in runs:
            v32 = v.astype(np.uint32)
            got[:] = 0
            h.h_rns(inv, _ptr(v32), _ptr(got), w.data_ptr(), wp.data_ptr(),
                    rt.dot_words.data_ptr(), rt.scale_words(sc).data_ptr(), 1,
                    batch, n.bit_length() - 1, logt)
            want = (P.inv_ntt_plain(_t(v), rt, sc) if inv
                    else P.fwd_ntt_plain(_t(v), rt))
            assert np.array_equal(got, want.numpy()), (what, inv, logt, sc)
    # K12's body as its launcher runs it, on make_dit_tables' cyclic tables
    # of psi^-2 and post row: (n, log2 of the threads a CTA, batch); at
    # n = 8 2 and 16 polynomials a CTA, at n = 256 and 1024 one CTA a
    # polynomial, clusters of 2 and 4 and several polynomials a CTA; ragged
    # last units.  Inputs over [0, 2q) with 2q - 1 and 0 on quarters
    for n, logt, batch in ((8, 0, 7), (8, 3, 37), (256, 4, 3), (256, 3, 2),
                           (256, 2, 2), (256, 6, 9), (1024, 6, 2),
                           (1024, 5, 2), (1024, 4, 1), (1024, 7, 5)):
        q = find_primes(n, 1)[0]
        dt = P.make_dit_tables(make_params(n, q), "cpu")
        rng = np.random.default_rng(5 * n + logt)
        z = rng.integers(0, 2 * q, size=(batch, n))
        m = z.size // 4
        z.reshape(-1)[:m], z.reshape(-1)[2 * m: 3 * m] = 2 * q - 1, 0
        z32 = z.astype(np.uint32)
        got = np.zeros((batch, n), dtype=np.uint32)
        h.h_dit(_ptr(z32), _ptr(got), dt.cyclic.roots.data_ptr(),
                dt.cyclic.precon.data_ptr(), dt.rows.data_ptr(), batch,
                n.bit_length() - 1, logt, q)
        want = P.dit_inv_core_plain(_t(z), dt).numpy()
        assert np.array_equal(got, want), ("dit_inv", n, logt)
    # its shape at 256 threads: (cluster log, polynomials log, row log, rows
    # log, bytes at k = 1 and k > 1) at the key switch's 16384, K5's 4096,
    # 32768 and 256
    shp = (ctypes.c_longlong * 6)()
    got = []
    for lg in (14, 12, 15, 8):
        h.h_dot_shape(lg, 8, shp)
        got.append(tuple(shp))
    assert got == [(2, 0, 3, 9, 36864, 73728), (0, 0, 3, 9, 36864, 73728),
                   (3, 0, 3, 9, 36864, 73728), (0, 4, 3, 5, 36864, 73728)]


@pytest.mark.parametrize("q", PRIMES)
def test_ct_butterfly(lib, cluster_so, q):
    x, y = _operands(q, 4 * q, 4), _operands(q, 4 * q, 5)[::-1].copy()
    w, wp = _twiddles(q, 6)
    gx, gy = _host(lib.h_ct, x, y, w, wp, q, outs=2)
    wx, wy = mm.ct_butterfly(_t(x), _t(y), _t(w), _t(wp), q)
    assert np.array_equal(gx, wx.numpy()) and np.array_equal(gy, wy.numpy())
    assert int(gx.max()) < 4 * q and int(gy.max()) < 4 * q
    # K11's forward step: the u-half gives the butterfly's x, the v-half y
    for is_u in (1, 0):
        for last in (0, 1):
            (got,) = _host(lib.h_xchg_fwd, x, y, is_u, w, wp, q, last)
            want = P.fwd_stage_step_plain(_t(x), _t(y), bool(is_u), _t(w),
                                          _t(wp), q, bool(last))
            assert np.array_equal(got, want.numpy())
            if not last:  # the partner of a u-half x is y, of a v-half x
                assert np.array_equal(got, gx if is_u else
                                      _host(lib.h_ct, y, x, w, wp, q, outs=2)[1])
            else:
                assert int(got.max()) < q
    # the group launch: several butterfly pairs and halves a table
    _xchg_groups_match_plain(lib, q, True, 4 * q, 12)
    # the cluster kernels' radix-4 and radix-8 groups against the int64
    # butterflies stage by stage, then, on the ring's own twiddles (block 0,
    # stages 0..k-1), against the whole size-2^k transform
    for k in (2, 3):
        v = x[: COUNT].reshape(-1, 1 << k)
        tw, twp = _radix_twiddles(k, w, wp)
        got = _radix(lib, lib.h_ct_radix, k, v, tw, twp, q)
        want = _group_plain(k, v, tw, twp, lambda a, b, c, d: mm.ct_butterfly(
            a, b, c, d, q), range(k))
        assert np.array_equal(got, want) and int(got.max()) < 4 * q
        tabs = P.make_tables(make_params(1 << k, q), "cpu")
        roots = tabs.roots.numpy()[1:].astype(np.uint32)
        pre = tabs.precon.numpy()[1:].astype(np.uint32)
        groups = v.shape[0]
        got = _radix(lib, lib.h_ct_radix, k, v, np.tile(roots, (groups, 1)),
                     np.tile(pre, (groups, 1)), q)
        assert np.array_equal(got % np.uint32(q),
                              P.fwd_ntt_plain(_t(v), tabs).numpy())
    if q == PRIMES[0]:  # once: the bodies run on their rings' own primes
        with ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn")) as child:
            child.submit(_cluster_bodies_match_plain, cluster_so).result()


@pytest.mark.parametrize("q", PRIMES)
def test_gs_butterfly(lib, q):
    x, y = _operands(q, 2 * q, 7), _operands(q, 2 * q, 8)[::-1].copy()
    w, wp = _twiddles(q, 9)
    gx, gy = _host(lib.h_gs, x, y, w, wp, q, outs=2)
    wx, wy = mm.gs_butterfly(_t(x), _t(y), _t(w), _t(wp), q)
    assert np.array_equal(gx, wx.numpy()) and np.array_equal(gy, wy.numpy())
    assert int(gx.max()) < 2 * q and int(gy.max()) < 2 * q
    # K11's inverse step: the u-half keeps the sum, the v-half (x its own
    # word, y the partner's u-value) the twiddled difference
    (got_u,) = _host(lib.h_xchg_inv, x, y, 1, w, wp, q)
    (got_v,) = _host(lib.h_xchg_inv, x, y, 0, w, wp, q)
    for is_u, got in ((True, got_u), (False, got_v)):
        want = P.inv_stage_step_plain(_t(x), _t(y), is_u, _t(w), _t(wp), q)
        assert np.array_equal(got, want.numpy())
    assert np.array_equal(got_u, gx)
    assert np.array_equal(got_v, _host(lib.h_gs, y, x, w, wp, q, outs=2)[1])
    # the group launch: several butterfly pairs and halves a table, the
    # last stage scaled
    _xchg_groups_match_plain(lib, q, False, 2 * q, 13)
    # the cluster kernels' inverse radix-4 and radix-8 groups, level k - 1
    # first, with and without the scaled last stage; then the whole
    # size-2^k inverse (scale n^-1) against the plain version
    for k in (2, 3):
        v = x[: COUNT].reshape(-1, 1 << k)
        tw, twp = _radix_twiddles(k, w, wp)
        gs = lambda a, b, c, d: mm.gs_butterfly(a, b, c, d, q)  # noqa: E731
        got = _radix(lib, lib.h_gs_radix, k, v, tw, twp, q, None)
        want = _group_plain(k, v, tw, twp, gs, range(k - 1, -1, -1))
        assert np.array_equal(got, want) and int(got.max()) < 2 * q
        sc = np.array([w[7], wp[7], w[8], wp[8]], dtype=np.uint32)
        got = _radix(lib, lib.h_gs_radix, k, v, tw, twp, q, _ptr(sc))
        want = _group_plain(k, v, tw, twp, gs, range(k - 1, -1, -1),
                            scale=tuple(int(c) for c in sc) + (q,))
        assert np.array_equal(got, want) and int(got.max()) < q
        tabs = P.make_tables(make_params(1 << k, q), "cpu")
        inv = tabs.inv_roots.numpy()[1:].astype(np.uint32)
        ipre = tabs.inv_precon.numpy()[1:].astype(np.uint32)
        sc = np.array(P.inv_scale_words(tabs, None), dtype=np.uint32)
        groups = v.shape[0]
        got = _radix(lib, lib.h_gs_radix, k, v, np.tile(inv, (groups, 1)),
                     np.tile(ipre, (groups, 1)), q, _ptr(sc))
        assert np.array_equal(got, P.inv_ntt_plain(_t(v), tabs).numpy())


@pytest.mark.parametrize("q", PRIMES)
def test_montgomery_redc(lib, q):
    qinv = mm.mont_qinv_neg(q)
    # any 32-bit operands, as the JAX helper takes them
    a = _operands(q, 1 << 32, 10)
    b = _operands(q, 1 << 32, 11)[::-1].copy()
    (got,) = _host(lib.h_mont, a, b, q, qinv)
    want = mm.mont_mul_lazy(_t(a), _t(b), q, qinv).numpy()
    assert np.array_equal(got, want)
    # on the fused kernels' operands, [0, q), the result is a*b/R in [0, 2q)
    a, b = a % np.uint32(q), b % np.uint32(q)
    (got,) = _host(lib.h_mont, a, b, q, qinv)
    r_inv = pow(1 << 32, -1, q)
    exact = a.astype(object) * b.astype(object) * r_inv % q
    assert int(got.max()) < 2 * q
    assert np.array_equal(got.astype(object) % q, exact)


@pytest.mark.parametrize("q", PRIMES)
def test_mxu_epilogue_and_digits(lib, q):
    """M1's arithmetic (``csrc/ntt_mxu.cuh``): the int64 epilogue
    ``mxu_reduce`` of its 4 / P + 3 partials (P the data's powers) against
    Python integers and the plain version's Horner reconstruction (the JAX
    package's words), on partials over the bound +-4 * 2048 * 2^14 = +-2^27
    with its edges; the packed digit planes of ``mxu_pack_digits`` against
    the plain ``_balanced_digits``; the converter ``mxu_convert16`` on a
    stage of 64 rows x 32 words (with the edges 0 and q - 1) against the
    digits of 256^(4 p / P) v mod q by
    ``_balanced_digits``, laid out by ``_kernel_tiles``, the order of A's
    tables."""
    powers = lib.h_mxu_powers()
    parts = 4 // powers + 3
    bound = 1 << 27
    rng = np.random.default_rng(q)
    p = rng.integers(-bound, bound + 1, size=(COUNT, parts)).astype(np.int32)
    p[0], p[1], p[2] = bound, -bound, 0
    p[3, ::2], p[3, 1::2] = bound, -bound
    p[4, :3], p[5, :3] = bound, -bound
    out = np.empty(COUNT, dtype=np.uint32)
    lib.h_mxu_reduce(_ptr(p), q, _ptr(out), COUNT)
    exact = sum(p[:, s].astype(object) * 256 ** s for s in range(parts)) % q
    assert np.array_equal(out.astype(object), exact)
    zero = torch.zeros(COUNT, dtype=torch.int64)
    plain = mxu_ntt._reconstruct_mod(
        [torch.from_numpy(p[:, s].astype(np.int64)) for s in range(parts)]
        + [zero] * (7 - parts), q)
    assert np.array_equal(out, plain.numpy())
    # byte j of word i of a group is digit i of the group's word j, for
    # words up to 2^30 - 1 (the top digit's bound)
    v = _operands(q, 1 << 30, 14)
    v[-1] = (1 << 30) - 1
    w = np.empty_like(v)
    lib.h_mxu_pack(_ptr(v), _ptr(w), COUNT // 4)
    digits = mxu_ntt._balanced_digits(torch.from_numpy(v.astype(np.int64)))
    want = np.stack([d.numpy().view(np.uint8).reshape(-1, 4) for d in digits],
                    axis=1)
    assert np.array_equal(w.view(np.uint8).reshape(-1, 4, 4), want)
    # the converter: plane 4 p + j of a stage holds digit j of
    # 256^(4 p / P) v mod q
    v = rng.integers(0, q, size=(64, 32), dtype=np.uint32)
    v[0, 0], v[0, 17], v[63, 31] = 0, q - 1, q - 1
    planes = np.zeros((4 * powers, 64 * 32), dtype=np.uint8)
    lib.h_mxu_convert(_ptr(v), q, _ptr(planes))
    for i in range(powers):
        vi = (v.astype(np.int64) * pow(256, 4 // powers * i, q)) % q
        digits = torch.stack(mxu_ntt._balanced_digits(torch.from_numpy(vi)))
        tiles = mxu_ntt._kernel_tiles(digits)
        assert tuple(tiles.shape[:3]) == (1, 1, 4)
        for j in range(4):
            assert np.array_equal(planes[4 * i + j],
                                  tiles[0, 0, j].numpy().view(np.uint8)
                                  .reshape(-1)), (i, j)
