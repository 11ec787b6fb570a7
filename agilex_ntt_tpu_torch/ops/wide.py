"""64-bit-word modular arithmetic and NTT stages on 32-bit limb pairs.

Counterpart of ``agilex_ntt_tpu/ops/wide.py``, with its names and its
semantics.  A 64-bit word is a ``(lo, hi)`` pair of int64 tensors holding
32-bit limbs; every result is the exact pair of words the JAX helper
returns, wrapping mod 2**64 as the reference's u64 words do.  int64 cannot
hold the lazy range [0, 4q) for q near 2**62, and PyTorch on the CPU has no
uint64 arithmetic, hence the limbs: 64-bit products are built from 16x16-bit
partial products (``mul128``) and 32-bit ones from ``modmul``'s split
products, so no partial leaves int64.

This is the plain version of the wide ring (``api.py::WideRing``): what the
CPU runs, what the tests hold against the JAX package, and what
``chip_smoke.py`` holds the CUDA kernels of ``csrc/ntt_wide.cuh`` against on
the card (``ops/wide_kernel.py``).  The kernels work on native u64 words and
nothing on the card's main path runs this module.

Constants (``u64c``) are pairs of Python ints, which broadcast against
tensors on any device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .modmul import MASK32, mulhi_u32, mullo_u32

_M16 = 0xFFFF

# A 64-bit value: (low 32 bits, high 32 bits), int64 tensors or Python ints.
Limbs = Tuple[torch.Tensor, torch.Tensor]


def u64c(v: int) -> Limbs:
    """A (broadcastable) constant limb pair from a Python int, mod 2**64."""
    return (v & MASK32, (v >> 32) & MASK32)


def split_u64_np(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side numpy uint64 -> (lo32, hi32) uint32 arrays."""
    x = np.asarray(x, dtype=np.uint64)
    return (
        (x & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        (x >> np.uint64(32)).astype(np.uint32),
    )


def join_u64_np(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Host-side (lo32, hi32) -> numpy uint64."""
    return (
        np.asarray(lo, dtype=np.uint64)
        | (np.asarray(hi, dtype=np.uint64) << np.uint64(32))
    )


# ---------------------------------------------------------------------------
# add / sub / compare (mod 2**64, like the reference's u64 words)
# ---------------------------------------------------------------------------


def add64(a: Limbs, b: Limbs) -> Limbs:
    lo = a[0] + b[0]
    return lo & MASK32, (a[1] + b[1] + (lo >> 32)) & MASK32


def sub64(a: Limbs, b: Limbs) -> Limbs:
    lo = a[0] - b[0]  # lo >> 32 is -1 (arithmetic shift) on a borrow
    return lo & MASK32, (a[1] - b[1] + (lo >> 32)) & MASK32


def ge64(a: Limbs, b: Limbs) -> torch.Tensor:
    return (a[1] > b[1]) | ((a[1] == b[1]) & (a[0] >= b[0]))


def select64(cond: torch.Tensor, a: Limbs, b: Limbs) -> Limbs:
    return torch.where(cond, a[0], b[0]), torch.where(cond, a[1], b[1])


def cond_sub64(x: Limbs, bound: Limbs) -> Limbs:
    """x - bound if x >= bound else x (the reference's lazy reduction,
    ntt.cpp:331-332, at full width)."""
    return select64(ge64(x, bound), sub64(x, bound), x)


def eq0_64(a: Limbs) -> torch.Tensor:
    return (a[0] | a[1]) == 0


# ---------------------------------------------------------------------------
# multiplication (16-bit-limb schoolbook; every partial fits int64)
# ---------------------------------------------------------------------------


def _limbs4(a: Limbs):
    """Four 16-bit limbs of a 64-bit value, little-endian."""
    lo, hi = a
    return lo & _M16, lo >> 16, hi & _M16, hi >> 16


def mullo64(a: Limbs, b: Limbs) -> Limbs:
    """Low 64 bits of a*b (the reference's wrapping u64 multiply):
    lo32 = a0*b0, hi32 = mulhi32(a0, b0) + a0*b1 + a1*b0, all mod 2**32."""
    lo = mullo_u32(a[0], b[0])
    hi = mulhi_u32(a[0], b[0]) + mullo_u32(a[0], b[1]) + mullo_u32(a[1], b[0])
    return lo, hi & MASK32


def mul128(a: Limbs, b: Limbs) -> Tuple[Limbs, Limbs]:
    """Full 128-bit product as (lo64, hi64) limb pairs: 16 16x16 partials
    summed in 16-bit columns, then one carry sweep (the reference's
    partial-product ladder, ntt.cpp:346-363, one level further down)."""
    al = _limbs4(a)
    bl = _limbs4(b)
    cols = [0] * 8
    for i in range(4):
        for j in range(4):
            p = al[i] * bl[j]
            cols[i + j] = cols[i + j] + (p & _M16)
            cols[i + j + 1] = cols[i + j + 1] + (p >> 16)
    r = []
    carry = 0
    for k in range(8):
        s = cols[k] + carry
        r.append(s & _M16)
        carry = s >> 16
    lo = (r[0] | (r[1] << 16), r[2] | (r[3] << 16))
    hi = (r[4] | (r[5] << 16), r[6] | (r[7] << 16))
    return lo, hi


def mulhi64(a: Limbs, b: Limbs) -> Limbs:
    """High 64 bits of a*b (the reference's mulhi, ntt.cpp:43-45 analog)."""
    return mul128(a, b)[1]


# ---------------------------------------------------------------------------
# Shoup / Montgomery modular multiplication at full width
# ---------------------------------------------------------------------------


def shoup_mulmod_lazy64(a: Limbs, w: Limbs, wp: Limbs, q: Limbs) -> Limbs:
    """W * a mod q via Shoup's trick, result in [0, 2q): W*a - mulhi(a, W')*q
    mod 2**64 with W' = floor(W * 2**64 / q); w < q, a < 4q, q < 2**62."""
    hi = mulhi64(a, wp)
    return sub64(mullo64(w, a), mullo64(hi, q))


def mont_qinv_neg64(q: int) -> int:
    """-q^{-1} mod 2**64 (host precomputation for mont_mul_lazy64)."""
    return (-pow(q, -1, 1 << 64)) % (1 << 64)


def mont_mul_lazy64(a: Limbs, b: Limbs, q: Limbs, qinv_neg: Limbs) -> Limbs:
    """a * b * 2**-64 mod q in [0, 2q), for a*b < 2**64 * q: REDC with
    R = 2**64, the quotient hi(a*b) + hi(m*q) + (lo(a*b) != 0)."""
    lo, hi = mul128(a, b)
    m = mullo64(lo, qinv_neg)
    mq_hi = mulhi64(m, q)
    carry = ((lo[0] | lo[1]) != 0).to(torch.int64)
    return add64(add64(hi, mq_hi), (carry, 0))


# ---------------------------------------------------------------------------
# NTT stage chains (golden.fwd_ntt_u64 / inv_ntt_u64 on limb pairs)
# ---------------------------------------------------------------------------


def _table(t, device) -> torch.Tensor:
    """A table row as int64 on ``device`` (a tensor, or numpy uint32)."""
    if isinstance(t, torch.Tensor):
        return t.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(t).astype(np.int64)).to(device)


def _stage_tables(tables, m: int, device):
    """Stage-m twiddle rows [(m, 1), broadcast over t] as limb pairs."""
    w_lo, w_hi, p_lo, p_hi = (
        _table(t, device)[m : 2 * m].reshape(m, 1) for t in tables
    )
    return (w_lo, w_hi), (p_lo, p_hi)


def fwd_stages64(x: Limbs, tables, n: int, q: int) -> Limbs:
    """Forward negacyclic Harvey stages on (..., n) limb pairs.

    tables = (w_lo, w_hi, p_lo, p_hi) [n] (int64 tensors or numpy uint32)
    in the reference consumption order (roots[m + i], ntt.cpp:298-300).
    Values stay in [0, 4q); the output is reduced to [0, q) (final-stage
    correction, ntt.cpp:377-394)."""
    qq = u64c(q)
    two_q = u64c(2 * q)
    lo, hi = x
    lead = tuple(lo.shape[:-1])
    t = n // 2
    m = 1
    while m < n:
        last = m == n // 2
        shape = lead + (m, 2, t)
        vlo = lo.reshape(shape)
        vhi = hi.reshape(shape)
        tx = (vlo[..., 0, :], vhi[..., 0, :])
        ay = (vlo[..., 1, :], vhi[..., 1, :])
        W, Wp = _stage_tables(tables, m, lo.device)
        tx = cond_sub64(tx, two_q)
        Q = shoup_mulmod_lazy64(ay, W, Wp, qq)
        u = add64(tx, Q)
        w = add64(sub64(tx, Q), two_q)
        if last:
            u = cond_sub64(cond_sub64(u, two_q), qq)
            w = cond_sub64(cond_sub64(w, two_q), qq)
        lo = torch.stack([u[0], w[0]], dim=-2).reshape(lead + (n,))
        hi = torch.stack([u[1], w[1]], dim=-2).reshape(lead + (n,))
        t //= 2
        m *= 2
    return lo, hi


def inv_stages64(x: Limbs, tables, n: int, q: int, scale: int) -> Limbs:
    """Inverse (Gentleman-Sande) stages, then a Shoup scale; output [0, q).

    The input may be lazy in [0, 2q), and [0, 2q) holds throughout
    (4q < 2**64).  ``scale`` is usually n^-1 mod q; the polymul folds the
    Montgomery R^-1 into it (``WideRing.polymul``)."""
    qq = u64c(q)
    two_q = u64c(2 * q)
    lo, hi = x
    lead = tuple(lo.shape[:-1])
    m = n // 2
    t = 1
    while m >= 1:
        shape = lead + (m, 2, t)
        vlo = lo.reshape(shape)
        vhi = hi.reshape(shape)
        xx = (vlo[..., 0, :], vhi[..., 0, :])
        yy = (vlo[..., 1, :], vhi[..., 1, :])
        W, Wp = _stage_tables(tables, m, lo.device)
        s = cond_sub64(add64(xx, yy), two_q)
        d = add64(sub64(xx, yy), two_q)
        Q = shoup_mulmod_lazy64(d, W, Wp, qq)
        lo = torch.stack([s[0], Q[0]], dim=-2).reshape(lead + (n,))
        hi = torch.stack([s[1], Q[1]], dim=-2).reshape(lead + (n,))
        m //= 2
        t *= 2
    sc = u64c(scale)
    scp = u64c((scale << 64) // q)
    out = shoup_mulmod_lazy64((lo, hi), sc, scp, qq)
    return cond_sub64(out, qq)
