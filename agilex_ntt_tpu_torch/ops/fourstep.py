"""Four-step (Bailey) decomposition of the NTT for n > 32768.

Counterpart of ``agilex_ntt_tpu/ops/fourstep.py``.  With n = n1 * n2 and the
coefficients viewed as an (n1, n2) matrix (row r, column c holds x[r n2 +
c]), the negacyclic transform is

1. a size-n1 negacyclic NTT down each column (psi1 = psi^n2);
2. a Shoup multiply by the twiddle T[r1, c] = psi^((2 bitrev(r1) + 1) c);
3. a size-n2 cyclic NTT along each row (omega = psi^(2 n1)),

and its output is bit-identical to the radix-2 transform's, in the same
HEXL order, with no reordering pass.  The inverse mirrors it: the row
inverse with n2^-1, the inverse twiddle, the column inverse with
``col_scale = scale * n2``.  ``make_cyclic_plan`` gives the all-cyclic plan
of ``CyclicRing``.

On the card (B, n) and (B, n1, n2) are the same bytes, so the flat and the
tiled layouts run the same kernels (``Ring(..., fourstep_kernel="flat")``
exists for the JAX package's API; it has no kernel of its own here).  The
dispatch has the JAX package's shape, with caps measured on the H100: one
fused kernel while the matrix is at most ``FULL_FUSE_BYTES`` (K7a/K7b),
else the column kernel (K9a/K9b) and the row pass on the transform kernels
(K1/K2) with the cyclic row tables; the fused polymul (K8) while the matrix
is at most ``POLYMUL_FUSE_BYTES``, else two forward transforms, the
Montgomery product and a scaled inverse.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..params import (
    CyclicParams,
    NTTParams,
    bit_reverse_array,
    find_psi,
    fourstep_split,
    is_prime,
    log2_exact,
    make_cyclic_params,
    make_params,
)
from . import modmul as mm
from . import ntt_kernel as K
from .plain_ntt import FourStepTables

# Caps on the (n1, n2) matrix of one polynomial, in bytes, set from this
# card's crossovers (chip_smoke.py phase 4, NVIDIA H100 80GB HBM3 at
# 700.00 W, 128 MiB an operand; PERF.md section 5).  The fused transforms
# K7a + K7b, both on thread-block clusters up to 2^19, beat the two-kernel
# route (K9a + K1 rows, K2 rows + K9b, K1 and K2 on the register-radix
# transform kernels) up to 2^17 (512 KiB: 0.34 + 0.36 against 0.37 + 0.37
# ms at B=256) and lose from 2^18 on (1 MiB: 0.40 + 0.43 against 0.37 +
# 0.37 at B=128; 2^19: 0.62 + 0.65 against 0.41 + 0.41).  The fused
# polymul K8 beats the composed polymul (two transforms, the int64
# Montgomery product, the scaled inverse) up to 2^19 (2 MiB; K8 on the
# walking kernel there: 5.41 against 6.40 ms) and loses at 2^20 (10.93
# against 5.89).  Every route is bit-exact, so the caps move only time.
FULL_FUSE_BYTES = 512 << 10
POLYMUL_FUSE_BYTES = 2 << 20


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: interned by
# make_plan's lru_cache, as NTTParams is
class FourStepPlan:
    """The decomposition of one ring into n1 x n2 passes (host side).

    ``tw``/``itw`` are the inter-pass twiddles T[r1, c] and their inverses,
    (n1, n2) uint32, with their full 32-bit Shoup precons
    ``floor(w * 2**32 / q)`` (the JAX package stores each precon split into
    16-bit halves ``tp0``/``tp1`` for the TPU: precon = tp1 << 16 | tp0).
    """

    n: int
    q: int
    psi: int            # 0 for a cyclic plan
    n1: int
    n2: int
    col: Union[NTTParams, CyclicParams]  # size-n1 column transform
    row: CyclicParams                    # size-n2 cyclic row transform
    tw: np.ndarray
    tw_precon: np.ndarray
    itw: np.ndarray
    itw_precon: np.ndarray
    n_inv: int

    @property
    def log_n(self) -> int:
        return log2_exact(self.n)


def _check_modulus(q: int) -> None:
    if q >= (1 << 30):
        raise ValueError(f"q must be < 2**30 for uint32 lazy arithmetic, got {q}")
    if not is_prime(q):
        raise ValueError(f"q={q} is not prime")


def _split(n: int, n1: Optional[int]):
    if n1 is None:
        return fourstep_split(n)
    n2 = n // n1
    if n1 * n2 != n or n1 < 2 or n2 < 2:
        raise ValueError(f"bad split {n} = {n1} * {n2}")
    return n1, n2


def _powers(root: int, count: int, q: int) -> np.ndarray:
    """root^e mod q for e in [0, count), uint64: count = s * s' powers as
    the outer product of s' giant steps and s baby steps (two Python loops
    of about sqrt(count) products, then one vectorised product mod q)."""
    s = 1 << ((count.bit_length()) // 2)
    baby = [1] * s
    for i in range(1, s):
        baby[i] = baby[i - 1] * root % q
    step = baby[-1] * root % q
    giant = [1] * -(-count // s)
    for i in range(1, len(giant)):
        giant[i] = giant[i - 1] * step % q
    out = (np.array(giant, dtype=np.uint64)[:, None]
           * np.array(baby, dtype=np.uint64)[None, :]) % np.uint64(q)
    return out.reshape(-1)[:count]


def _with_precon(w: np.ndarray, q: int):
    """(w, floor(w * 2**32 / q)) as uint32: w < 2**30, so w << 32 fits."""
    p = (w.astype(np.uint64) << np.uint64(32)) // np.uint64(q)
    return w.astype(np.uint32), p.astype(np.uint32)


def make_plan(
    n: int, q: int, psi: Optional[int] = None, n1: Optional[int] = None
) -> FourStepPlan:
    """The four-step plan of Z_q[X]/(X^n + 1); O(n) vectorised host work and
    O(sqrt n) Python products, so n = 2^21 builds in well under a second.
    Cached: psi and the split are resolved first, so every call for one
    ring returns one plan object."""
    if q % (2 * n) != 1:
        raise ValueError(f"q ≡ 1 (mod 2n) required: q={q} n={n}")
    _check_modulus(q)
    if psi is None:
        psi = find_psi(n, q)
    elif pow(psi, n, q) != q - 1:
        raise ValueError("provided psi is not a primitive 2n-th root")
    return _make_plan_cached(n, q, psi, *_split(n, n1))


@functools.lru_cache(maxsize=32)
def _make_plan_cached(n: int, q: int, psi: int, n1: int, n2: int) -> FourStepPlan:
    col = make_params(n1, q, pow(psi, n2, q))
    row = make_cyclic_params(n2, q, pow(psi, 2 * n1, q))
    # T[r1, c] = psi^e, e = (2 bitrev(r1) + 1) c mod 2n
    pows = _powers(psi, 2 * n, q)
    k1 = bit_reverse_array(n1)
    e = ((2 * k1[:, None] + 1) * np.arange(n2, dtype=np.int64)[None, :]) % (2 * n)
    tw, twp = _with_precon(pows[e], q)
    itw, itwp = _with_precon(pows[(-e) % (2 * n)], q)
    return FourStepPlan(
        n=n, q=q, psi=psi, n1=n1, n2=n2, col=col, row=row,
        tw=tw, tw_precon=twp, itw=itw, itw_precon=itwp,
        n_inv=pow(n, q - 2, q),
    )


def make_cyclic_plan(
    n: int, q: int, omega: int, n1: Optional[int] = None
) -> FourStepPlan:
    """Four-step plan of the size-n *cyclic* NTT (root omega of order n):
    both passes cyclic (omega^n2 down the columns, omega^n1 along the rows),
    twiddle T[r1, c] = omega^(bitrev(r1) c); output order as the radix-2
    cyclic transform's.  Cached as ``make_plan`` is."""
    _check_modulus(q)
    if pow(omega, n, q) != 1 or (n > 1 and pow(omega, n // 2, q) == 1):
        raise ValueError("omega is not a primitive n-th root")
    return _make_cyclic_plan_cached(n, q, omega, *_split(n, n1))


@functools.lru_cache(maxsize=32)
def _make_cyclic_plan_cached(
    n: int, q: int, omega: int, n1: int, n2: int
) -> FourStepPlan:
    col = make_cyclic_params(n1, q, pow(omega, n2, q))
    row = make_cyclic_params(n2, q, pow(omega, n1, q))
    pows = _powers(omega, n, q)
    e = (bit_reverse_array(n1)[:, None] * np.arange(n2, dtype=np.int64)[None, :]) % n
    tw, twp = _with_precon(pows[e], q)
    itw, itwp = _with_precon(pows[(-e) % n], q)
    return FourStepPlan(
        n=n, q=q, psi=0, n1=n1, n2=n2, col=col, row=row,
        tw=tw, tw_precon=twp, itw=itw, itw_precon=itwp,
        n_inv=pow(n, q - 2, q),
    )


def plan_from_numpy(
    n: int,
    q: int,
    psi: int,
    n1: int,
    tw,
    tp0,
    tp1,
    itw,
    itp0,
    itp1,
    col: Optional[Sequence] = None,
    row: Optional[Sequence] = None,
) -> FourStepPlan:
    """Carry a four-step plan across from numpy arrays (for example those of
    the JAX package's ``FourStepPlan``, whose precons are 16-bit halves) and
    return this package's plan.

    The twiddles, and the column and row tables when given as
    ``(roots32, precon32, inv_roots32, inv_precon32)``, must equal what
    ``make_plan(n, q, psi, n1)`` builds; the first mismatch raises
    ``ValueError``.
    """
    plan = make_plan(int(n), int(q), int(psi), int(n1))

    def joined(lo, hi):
        return (np.asarray(hi, dtype=np.uint64) << np.uint64(16)) | np.asarray(
            lo, dtype=np.uint64
        )

    given = {
        "tw": np.asarray(tw), "tw_precon": joined(tp0, tp1),
        "itw": np.asarray(itw), "itw_precon": joined(itp0, itp1),
    }
    for side, tables in (("col", col), ("row", row)):
        if tables is not None:
            for name, arr in zip(
                ("roots32", "precon32", "inv_roots32", "inv_precon32"), tables
            ):
                given[f"{side}.{name}"] = np.asarray(arr)
    for name, arr in given.items():
        side, _, attr = name.rpartition(".")
        want = getattr(getattr(plan, side) if side else plan, attr)
        if arr.shape != want.shape:
            raise ValueError(f"{name}: shape {arr.shape}, expected {want.shape}")
        bad = np.flatnonzero(arr.astype(np.uint64) != want.astype(np.uint64))
        if bad.size:
            i = tuple(int(k) for k in np.unravel_index(int(bad[0]), want.shape))
            raise ValueError(
                f"{name}{list(i)} = {int(arr[i])}, expected {int(want[i])} "
                f"for n={n}, q={q}, psi={psi}, n1={n1}"
            )
    return plan


# -- dispatch on (B, n1, n2) tensors -------------------------------------------


def use_full_fuse(ft: FourStepTables) -> bool:
    return 4 * ft.n <= FULL_FUSE_BYTES


def use_polymul_fuse(ft: FourStepTables) -> bool:
    return 4 * ft.n <= POLYMUL_FUSE_BYTES


def fwd_ntt_fourstep_tiled(x3: torch.Tensor, ft: FourStepTables) -> torch.Tensor:
    """Forward NTT of (B, n1, n2) uint32 in [0, 4q) -> [0, q), bit-identical
    to the radix-2 transform of the flat rows."""
    if use_full_fuse(ft):
        return K.fwd_ntt_fourstep(x3, ft)
    b = x3.shape[0]
    m = K.fwd_col_fourstep(x3, ft)  # columns and twiddle, lazy [0, 2q)
    return K.fwd_ntt(m.view(b * ft.n1, ft.n2), ft.row).view(x3.shape)


def inv_ntt_fourstep_tiled(
    x3: torch.Tensor, ft: FourStepTables, *, scale: Optional[int] = None
) -> torch.Tensor:
    """Inverse NTT of (B, n1, n2) uint32 in [0, 2q) -> [0, q); ``scale``
    replaces the overall n^-1 (row pass n2^-1, column pass scale * n2)."""
    if use_full_fuse(ft):
        return K.inv_ntt_fourstep(x3, ft, scale=scale)
    b = x3.shape[0]
    r = K.inv_ntt(x3.view(b * ft.n1, ft.n2), ft.row)  # row n2^-1
    return K.inv_col_fourstep(r.view(x3.shape), ft, scale=scale)


def polymul_fourstep_tiled(
    a3: torch.Tensor, b3: torch.Tensor, ft: FourStepTables
) -> torch.Tensor:
    """a * b mod (X^n +- 1, q) of (B, n1, n2) operands in [0, q)."""
    if use_polymul_fuse(ft):
        return K.polymul_fourstep_fused(a3, b3, ft)
    fa = fwd_ntt_fourstep_tiled(a3, ft).to(torch.int64)
    fb = fwd_ntt_fourstep_tiled(b3, ft).to(torch.int64)
    prod = mm.mont_mul_lazy(fa, fb, ft.q, ft.qinv_neg)  # [0, 2q), one R^-1
    return inv_ntt_fourstep_tiled(
        prod.to(torch.uint32), ft, scale=ft.polymul_scale
    )
