"""Wrappers of the four Hopper kernels of the single-prime ring.

Counterpart of the single-prime entry points of
``agilex_ntt_tpu/ops/ntt_kernel.py`` (``fwd_ntt``, ``inv_ntt``,
``polymul_fused``, ``polydot_fused``).  The kernels are hand-written CUDA in
``csrc/ntt_kernels.cu``, built for ``sm_90a`` at first use (``_build.py``).

Every wrapper takes contiguous ``torch.uint32`` tensors on the device of the
ring's tables and returns a new ``torch.uint32`` tensor reduced to [0, q):

  * on a CUDA tensor it launches its kernel on the current stream, raises if
    the launch returns a CUDA error, and adds one to ``LAUNCHES[name]``;
  * on a CPU tensor it computes the plain version (``plain_ntt.py``).

There is no fallback: a CUDA tensor is never handed to the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from . import plain_ntt as plain
from .plain_ntt import RingTables

# Kernel launches per wrapper since the count was last set to 0.
LAUNCHES = {"fwd": 0, "inv": 0, "polymul": 0, "polydot": 0}


def _check(x: torch.Tensor, tables: RingTables, name: str, ndim: int) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(x).__name__}")
    if x.dtype != torch.uint32:
        raise TypeError(f"{name}: expected torch.uint32, got {x.dtype}")
    if x.device != tables.device:
        raise ValueError(
            f"{name}: tensor on {x.device}, ring tables on {tables.device}"
        )
    if x.dim() != ndim or x.shape[-1] != tables.n:
        raise ValueError(
            f"{name}: expected {ndim} dims ending in n={tables.n}, got "
            f"{tuple(x.shape)}"
        )
    if x.shape[0] == 0:
        raise ValueError(f"{name}: empty batch")
    if not x.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _inv_scale_args(tables: RingTables, scale: Optional[int]):
    """(su, su', sv, sv'): the last inverse stage's two Shoup constants,
    scale and scale * inv_roots[1], with their precons."""
    q = tables.q
    su = (tables.n_inv if scale is None else scale) % q
    sv = su * tables.inv_root1 % q
    return su, (su << 32) // q, sv, (sv << 32) // q


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.uint32)


def fwd_ntt(x: torch.Tensor, tables: RingTables) -> torch.Tensor:
    """Forward negacyclic NTT of (B, n) in [0, 4q) -> [0, q), HEXL order."""
    _check(x, tables, "fwd_ntt", 2)
    if x.device.type == "cpu":
        return _u32(plain.fwd_ntt_plain(x.to(torch.int64), tables))
    y = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.ntt_fwd(
            x.data_ptr(), y.data_ptr(),
            tables.roots.data_ptr(), tables.precon.data_ptr(),
            x.shape[0], tables.log_n, tables.q, _stream(x),
        )
    _build.check(lib, rc, "fwd_ntt")
    LAUNCHES["fwd"] += 1
    return y


def inv_ntt(
    x: torch.Tensor, tables: RingTables, *, scale: Optional[int] = None
) -> torch.Tensor:
    """Inverse negacyclic NTT of (B, n) in [0, 2q) -> [0, q).  ``scale``
    replaces the final n^-1 (for example n^-1 * 2**32 to absorb a Montgomery
    factor); it is folded into the last stage."""
    _check(x, tables, "inv_ntt", 2)
    if x.device.type == "cpu":
        return _u32(plain.inv_ntt_plain(x.to(torch.int64), tables, scale))
    y = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.ntt_inv(
            x.data_ptr(), y.data_ptr(),
            tables.inv_roots.data_ptr(), tables.inv_precon.data_ptr(),
            x.shape[0], tables.log_n, tables.q,
            *_inv_scale_args(tables, scale), _stream(x),
        )
    _build.check(lib, rc, "inv_ntt")
    LAUNCHES["inv"] += 1
    return y


def _polydot_launch(a, b, tables: RingTables, what: str) -> torch.Tensor:
    """One launch of the fused kernel on (B, k, n) operands -> (B, n)."""
    batch, k, n = a.shape
    out = torch.empty((batch, n), dtype=torch.uint32, device=a.device)
    lib = _build.load()
    words = lib.ntt_polydot_scratch_words(batch, k, tables.log_n)
    scratch = (
        torch.empty(words, dtype=torch.uint32, device=a.device) if words else None
    )
    with torch.cuda.device(a.device):
        rc = lib.ntt_polydot(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            tables.roots.data_ptr(), tables.precon.data_ptr(),
            tables.inv_roots.data_ptr(), tables.inv_precon.data_ptr(),
            batch, k, tables.log_n, tables.q, tables.qinv_neg,
            *_inv_scale_args(tables, tables.polymul_scale), _stream(a),
        )
    _build.check(lib, rc, what)
    return out


def polymul_fused(a: torch.Tensor, b: torch.Tensor, tables: RingTables) -> torch.Tensor:
    """Negacyclic a * b mod (X^n + 1, q) of (B, n) operands in one kernel:
    two forward transforms, the Montgomery product, the scaled inverse."""
    _check(a, tables, "polymul_fused", 2)
    _check(b, tables, "polymul_fused", 2)
    if a.shape != b.shape:
        raise ValueError(f"polymul_fused: shapes {a.shape} and {b.shape} differ")
    if a.device.type == "cpu":
        return _u32(
            plain.polymul_plain(a.to(torch.int64), b.to(torch.int64), tables)
        )
    out = _polydot_launch(a.unsqueeze(1), b.unsqueeze(1), tables, "polymul_fused")
    LAUNCHES["polymul"] += 1
    return out


def polydot_fused(a: torch.Tensor, b: torch.Tensor, tables: RingTables) -> torch.Tensor:
    """sum_i a_i * b_i mod (X^n + 1, q) of (B, k, n) operands -> (B, n) in
    one kernel: 2k forward transforms, lazy accumulation, one inverse."""
    _check(a, tables, "polydot_fused", 3)
    _check(b, tables, "polydot_fused", 3)
    if a.shape != b.shape:
        raise ValueError(f"polydot_fused: shapes {a.shape} and {b.shape} differ")
    if a.shape[1] == 0:
        raise ValueError("polydot_fused: k must be at least 1")
    if a.device.type == "cpu":
        return _u32(
            plain.polydot_plain(a.to(torch.int64), b.to(torch.int64), tables)
        )
    out = _polydot_launch(a, b, tables, "polydot_fused")
    LAUNCHES["polydot"] += 1
    return out
