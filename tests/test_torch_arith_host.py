"""The CUDA kernels' arithmetic, compiled for the host and held bit for bit
against the port's int64 helpers (``ops/modmul.py``) and the plain versions
of the cross-device stage K11 and the DIT inverse's scale rows (K12,
``ops/plain_ntt.py``).

``csrc/ntt_arith.cuh`` is written once for the device and the host.  Here it
is built with plain ``g++`` (``__host__``/``__device__`` defined away, no
PyTorch headers, so the build takes about a second) into a small shared
library, loaded with ctypes, and fed 10**5 random operands plus the edge
values 0, q-1, 2q-1 and 4q-1 of each lazy range.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from agilex_ntt_tpu_torch.ops import modmul as mm
from agilex_ntt_tpu_torch.ops import plain_ntt as P
from agilex_ntt_tpu_torch.params import find_primes

CSRC = Path(__file__).resolve().parents[1] / "agilex_ntt_tpu_torch" / "csrc"
COUNT = 100_000
# a 30-bit prime (n = 4096) and a small one (12289, n <= 4096)
PRIMES = (find_primes(4096, 1)[0], 12289)

SHIM = r"""
#define __host__
#define __device__
#define __forceinline__ inline
#include "ntt_arith.cuh"

extern "C" {
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
void h_xchg_inv(const uint32_t* x, const uint32_t* p, int is_u,
                const uint32_t* w, const uint32_t* wp, uint32_t q,
                uint32_t* out, long n) {
  for (long i = 0; i < n; ++i)
    out[i] = ntt_xchg_inv(x[i], p[i], is_u != 0, w[i], wp[i], q);
}
}
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("arith_host")
    src = out / "shim.cpp"
    src.write_text(SHIM)
    so = out / "libarith_host.so"
    subprocess.run(
        [gxx, "-x", "c++", "-O2", "-shared", "-fPIC", f"-I{CSRC}",
         "-o", str(so), str(src)],
        check=True, capture_output=True,
    )
    h = ctypes.CDLL(str(so))
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
    return h


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


@pytest.mark.parametrize("q", PRIMES)
def test_cond_sub(lib, q):
    x = _operands(q, 4 * q, 1)
    for bound in (q, 2 * q):
        (got,) = _host(lib.h_cond_sub, x, bound)
        assert np.array_equal(got, mm.cond_sub(_t(x), bound).numpy())


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


@pytest.mark.parametrize("q", PRIMES)
def test_ct_butterfly(lib, q):
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
