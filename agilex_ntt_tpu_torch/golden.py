"""Golden models of the negacyclic NTT (host side, numpy / Python int).

A numpy-only copy of the models in ``agilex_ntt_tpu/golden.py``, kept here so
the command-line check and ``chip_smoke.py`` have an oracle that shares no
code with the torch paths or the CUDA kernels:

  * ``fwd_ntt_u64`` / ``inv_ntt_u64``: Harvey lazy butterflies in [0, 4q)
    with 64-bit Shoup products synthesized from 32x32 partials;
  * ``fwd_ntt_u32`` / ``inv_ntt_u32``: the 32-bit word scheme (q < 2**30,
    precon = floor(W * 2**32 / q));
  * ``negacyclic_convolution``: the O(n^2) schoolbook product.

All outputs are reduced to [0, q).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .params import NTTParams

_U64 = np.uint64
_U32 = np.uint32


def _err():
    # integer wraparound mod 2^64 / 2^32 is intended throughout
    return np.errstate(over="ignore")


def _mulhi64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """High 64 bits of a 64x64 product from four 32x32 partials."""
    mask = _U64(0xFFFFFFFF)
    a0 = a & mask
    a1 = a >> _U64(32)
    b0 = b & mask
    b1 = b >> _U64(32)
    with _err():
        a0b0 = a0 * b0
        a0b1 = a0 * b1
        a1b0 = a1 * b0
        a1b1 = a1 * b1
        mid = (a0b0 >> _U64(32)) + (a1b0 & mask) + (a0b1 & mask)
        hi = a1b1 + (a1b0 >> _U64(32)) + (a0b1 >> _U64(32)) + (mid >> _U64(32))
    return hi


def _mulhi32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """High 32 bits of a 32x32 product (widened to 64 bits on the host)."""
    return ((a.astype(_U64) * b.astype(_U64)) >> _U64(32)).astype(_U32)


def _fwd(a, params, q, two_q, roots, precon, mulhi):
    n = params.n
    t = n // 2
    m = 1
    while m < n:
        last = m == n // 2
        v = a.reshape(a.shape[:-1] + (m, 2, t))
        tx = v[..., 0, :]
        ay = v[..., 1, :]
        W = roots[m : 2 * m].reshape((m, 1))
        Wp = precon[m : 2 * m].reshape((m, 1))
        tx = np.where(tx >= two_q, tx - two_q, tx)
        hi = mulhi(ay, Wp)
        with _err():
            Q = W * ay - hi * q
            u = tx + Q
            w = tx + two_q - Q
        if last:
            for z in (u, w):
                np.subtract(z, two_q, out=z, where=z >= two_q)
                np.subtract(z, q, out=z, where=z >= q)
        v[..., 0, :] = u
        v[..., 1, :] = w
        t //= 2
        m *= 2
    return a


def _inv(a, params, q, two_q, iroots, iprecon, mulhi, n_inv, n_inv_precon):
    n = params.n
    m = n // 2
    t = 1
    while m >= 1:
        v = a.reshape(a.shape[:-1] + (m, 2, t))
        xx = v[..., 0, :].copy()
        yy = v[..., 1, :].copy()
        W = iroots[m : 2 * m].reshape((m, 1))
        Wp = iprecon[m : 2 * m].reshape((m, 1))
        with _err():
            s = xx + yy
        s = np.where(s >= two_q, s - two_q, s)
        with _err():
            d = xx + two_q - yy
            hi = mulhi(d, Wp)
            Q = W * d - hi * q
        v[..., 0, :] = s
        v[..., 1, :] = Q
        m //= 2
        t *= 2
    hi = mulhi(a, np.broadcast_to(n_inv_precon, a.shape))
    with _err():
        a = n_inv * a - hi * q
    return np.where(a >= q, a - q, a)


def fwd_ntt_u64(x: np.ndarray, params: NTTParams) -> np.ndarray:
    """Forward negacyclic NTT, uint64 Harvey-lazy, output in [0, q)."""
    a = np.asarray(x, dtype=_U64).copy()
    if a.shape[-1] != params.n:
        raise ValueError(f"last dim must be n={params.n}, got {a.shape}")
    return _fwd(a, params, _U64(params.q), _U64(2 * params.q),
                params.roots, params.precon64, _mulhi64)


def inv_ntt_u64(x: np.ndarray, params: NTTParams) -> np.ndarray:
    """Inverse negacyclic NTT (Gentleman-Sande, stages reversed), then n^-1;
    output in [0, q)."""
    a = np.asarray(x, dtype=_U64).copy()
    if a.shape[-1] != params.n:
        raise ValueError(f"last dim must be n={params.n}, got {a.shape}")
    return _inv(a, params, _U64(params.q), _U64(2 * params.q),
                params.inv_roots, params.inv_precon64, _mulhi64,
                _U64(params.n_inv), _U64((params.n_inv << 64) // params.q))


def fwd_ntt_u32(x: np.ndarray, params: NTTParams) -> np.ndarray:
    """Forward NTT in the 32-bit word scheme (q < 2**30, lazy [0, 4q))."""
    a = np.asarray(x, dtype=_U32).copy()
    if a.shape[-1] != params.n:
        raise ValueError(f"last dim must be n={params.n}, got {a.shape}")
    return _fwd(a, params, _U32(params.q), _U32(2 * params.q),
                params.roots32, params.precon32, _mulhi32)


def inv_ntt_u32(x: np.ndarray, params: NTTParams) -> np.ndarray:
    """Inverse NTT in the 32-bit word scheme, output in [0, q)."""
    a = np.asarray(x, dtype=_U32).copy()
    if a.shape[-1] != params.n:
        raise ValueError(f"last dim must be n={params.n}, got {a.shape}")
    return _inv(a, params, _U32(params.q), _U32(2 * params.q),
                params.inv_roots32, params.inv_precon32, _mulhi32,
                _U32(params.n_inv), _U32((params.n_inv << 32) // params.q))


def negacyclic_convolution(a: Sequence[int], b: Sequence[int], q: int) -> list:
    """Schoolbook product in Z_q[X]/(X^n + 1) (independent polymul oracle)."""
    n = len(a)
    out = [0] * n
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            k = i + j
            if k < n:
                out[k] = (out[k] + int(ai) * int(bj)) % q
            else:
                out[k - n] = (out[k - n] - int(ai) * int(bj)) % q
    return [v % q for v in out]
