"""Plain PyTorch versions of the four kernels, and the tables they share.

Counterpart of ``agilex_ntt_tpu/ops/stage_tables.py``, ``stage_math.py`` and
``xla_ntt.py``, rewritten for PyTorch: no positional (log n, n) tables and no
roll-and-select butterflies (those exist for the TPU's 128-lane vector unit).
Each stage views the batch as ``(B, m, 2, t)`` and runs every butterfly once
with the compact HEXL twiddles ``roots[m + i]``, in exact ``% q`` arithmetic
on int64: q < 2**30 keeps every product below 2**62.

Inputs may be lazy ([0, 4q) forward, [0, 2q) inverse); outputs are reduced
to [0, q), so they equal the JAX package's lazy-Harvey outputs bit for bit.

These run on the CPU (the tests, and the wrappers in ``ntt_kernel.py`` when
given a CPU tensor) and on the card only in ``chip_smoke.py``, which holds
each CUDA kernel against them.  They are never the main path on a card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..params import NTTParams
from .modmul import mont_qinv_neg


@dataclasses.dataclass(frozen=True)
class RingTables:
    """One ring's constants, with its twiddle tables on one device.

    ``roots``/``precon``/``inv_roots``/``inv_precon`` are the params' uint32
    tables as ``torch.uint32`` tensors of shape (n,).  ``polymul_scale``
    folds n^-1 and the Montgomery R = 2**32 that the fused kernels' pointwise
    product leaves behind; ``inv_root1`` is the last inverse stage's twiddle.
    """

    n: int
    log_n: int
    q: int
    n_inv: int
    qinv_neg: int
    polymul_scale: int
    inv_root1: int
    roots: torch.Tensor
    precon: torch.Tensor
    inv_roots: torch.Tensor
    inv_precon: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.roots.device


def make_tables(params: NTTParams, device) -> RingTables:
    def u32(a):
        return torch.from_numpy(a.copy()).to(device)

    q = params.q
    return RingTables(
        n=params.n,
        log_n=params.log_n,
        q=q,
        n_inv=params.n_inv,
        qinv_neg=mont_qinv_neg(q),
        polymul_scale=params.n_inv * ((1 << 32) % q) % q,
        inv_root1=int(params.inv_roots32[1]),
        roots=u32(params.roots32),
        precon=u32(params.precon32),
        inv_roots=u32(params.inv_roots32),
        inv_precon=u32(params.inv_precon32),
    )


def fwd_ntt_plain(x: torch.Tensor, tables: RingTables) -> torch.Tensor:
    """Forward negacyclic NTT of int64 (B, n), values >= 0, -> [0, q), in
    HEXL order out[k] = A(psi^(2*bitrev(k)+1))."""
    q, n = tables.q, tables.n
    roots = tables.roots.to(torch.int64)
    b = x.shape[0]
    x = x % q
    m, t = 1, n // 2
    while m < n:
        v = x.view(b, m, 2, t)
        u = v[:, :, 0, :]
        wy = v[:, :, 1, :] * roots[m : 2 * m].view(1, m, 1) % q
        x = torch.stack(((u + wy) % q, (u - wy) % q), dim=2).view(b, n)
        m, t = 2 * m, t // 2
    return x


def inv_ntt_plain(
    x: torch.Tensor, tables: RingTables, scale: Optional[int] = None
) -> torch.Tensor:
    """Inverse negacyclic NTT of int64 (B, n), values >= 0, -> [0, q).

    The result is multiplied by ``scale`` (default n^-1 mod q)."""
    q, n = tables.q, tables.n
    if scale is None:
        scale = tables.n_inv
    inv_roots = tables.inv_roots.to(torch.int64)
    b = x.shape[0]
    x = x % q
    m, t = n // 2, 1
    while m >= 1:
        v = x.view(b, m, 2, t)
        u, w = v[:, :, 0, :], v[:, :, 1, :]
        d = (u - w) % q * inv_roots[m : 2 * m].view(1, m, 1) % q
        x = torch.stack(((u + w) % q, d), dim=2).view(b, n)
        m, t = m // 2, 2 * t
    return x * (scale % q) % q


def polymul_plain(a: torch.Tensor, b: torch.Tensor, tables: RingTables) -> torch.Tensor:
    """a * b mod (X^n + 1, q) for int64 (B, n) operands, -> [0, q)."""
    q = tables.q
    prod = fwd_ntt_plain(a, tables) * fwd_ntt_plain(b, tables) % q
    return inv_ntt_plain(prod, tables)


def polydot_plain(a: torch.Tensor, b: torch.Tensor, tables: RingTables) -> torch.Tensor:
    """sum_i a_i * b_i mod (X^n + 1, q) for int64 (B, k, n) operands,
    -> (B, n) in [0, q)."""
    q, n = tables.q, tables.n
    bb, k, _ = a.shape
    fa = fwd_ntt_plain(a.reshape(bb * k, n), tables).view(bb, k, n)
    fb = fwd_ntt_plain(b.reshape(bb * k, n), tables).view(bb, k, n)
    acc = (fa * fb % q).sum(dim=1) % q
    return inv_ntt_plain(acc, tables)
