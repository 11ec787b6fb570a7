"""Descending-stride (DIT-form) inverse NTT.

Counterpart of ``agilex_ntt_tpu/ops/dit_inv.py``: the inverse transform run
as the forward network on psi^-1 tables, between two bit-reversal
permutations.  With ``X`` in HEXL order (``X[k] = A(psi^(2 br(k) + 1))``)
and ``F`` the forward network on the tables of psi' = psi^-1,

    x[j] = n^-1 psi^-j F(z)[br(j)],   z[k] = X[br(k)] psi^k,

so the TPU kernel multiplies the bit-reversed input by the pre row psi^k,
runs the forward stages on ``inv_roots`` without a final reduction, and
multiplies by the post row n^-1 inv_roots[m] (the post row is applied
before the output gather, so it lands as n^-1 psi^-j after it), with one
conditional subtraction to [0, q).  The pre row and that network together
are the cyclic forward transform of omega = psi^-2, so the Hopper kernel
(K12, ``dit_inv_core``) runs the forward transform's register-radix passes
on the cyclic tables of omega (``DitTables.cyclic``) with no pre row, and
folds the post row into its store.  The two bit-reversals stay PyTorch
gathers (``index_select``) outside the kernel, as they are XLA gathers
outside the Pallas kernel in the JAX package.

Nothing dispatches to it: ``Ring.intt`` runs the Gentleman-Sande inverse
(K2), as the JAX package's does.  On the TPU the descending form was an
experiment against a GS inverse 11% slower than the forward transform; on
the H100 K2 is already faster than K1 (PERF.md), and ``chip_smoke.py`` times
the two side by side.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..params import NTTParams, bit_reverse_array
from . import ntt_kernel
from .plain_ntt import DitTables, make_dit_tables


@functools.lru_cache(maxsize=32)
def _br_perm(n: int) -> np.ndarray:
    return bit_reverse_array(n).astype(np.int64)


@functools.lru_cache(maxsize=64)
def _br_index(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_br_perm(n)).to(device)


def bitrev_permute(x: torch.Tensor, *, factored: bool = False) -> torch.Tensor:
    """Bit-reversal permutation along the last axis (an involution).

    factored=False: one gather of width n.
    factored=True (even log n only): br_n = (br_m x br_m) o transpose with
    m = sqrt(n): two width-m gathers on the split axes and one (m, m)
    transpose.
    """
    n = x.shape[-1]
    # the gathers move 32-bit words: an int32 view of the uint32 data
    words = x.view(torch.int32) if x.dtype == torch.uint32 else x
    if not factored:
        out = words.index_select(-1, _br_index(n, x.device))
    else:
        logn = n.bit_length() - 1
        if logn % 2:
            raise ValueError("factored bitrev needs even log2(n)")
        m = 1 << (logn // 2)
        p = _br_index(m, x.device)
        t = words.reshape(x.shape[:-1] + (m, m))
        t = t.index_select(-1, p).index_select(-2, p)
        out = t.transpose(-1, -2).reshape(x.shape)
    return out.view(torch.uint32) if x.dtype == torch.uint32 else out


@functools.lru_cache(maxsize=32)
def _dit_tables(params: NTTParams, device: torch.device) -> DitTables:
    """The forward-order stage tables of ``inv_roots`` and the two scale rows
    with their Shoup precons, on ``device`` (cached per params and device)."""
    return make_dit_tables(params, device)


def inv_ntt_dit(
    x: torch.Tensor, params: NTTParams, *, factored: bool = False
) -> torch.Tensor:
    """Inverse NTT through the descending-stride forward network.

    Takes (batch, n) ``torch.uint32`` in [0, 2q) (the contract of
    ``inv_ntt``) on a CUDA device or the CPU; returns [0, q) on the same
    device, bit-identical to ``golden.inv_ntt_u32``.  ``factored`` selects
    the bit-reversal's factored form (even log n).
    """
    if x.dim() != 2 or x.shape[-1] != params.n:
        raise ValueError(f"expected (batch, n={params.n}), got {tuple(x.shape)}")
    dt = _dit_tables(params, x.device)
    z = bitrev_permute(x, factored=factored).contiguous()
    return bitrev_permute(ntt_kernel.dit_inv_core(z, dt), factored=factored)
