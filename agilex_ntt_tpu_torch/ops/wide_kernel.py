"""Wrappers of the wide ring's Hopper kernels (``csrc/ntt_wide.cuh``).

``wide_fwd``, ``wide_inv`` and ``wide_pointwise`` take and return 64-bit
words as ``(lo, hi)`` pairs of contiguous ``torch.uint32`` tensors of one
shape, on the device of the ring's ``WideTables``:

  * on a CUDA tensor a wrapper launches its kernels on the current stream,
    raises if a launch returns a CUDA error, and adds its kernel launches to
    ``ntt_kernel.LAUNCHES`` (``"wide_fwd"``, ``"wide_inv"``,
    ``"wide_pointwise"``): a transform is one cluster launch up to n =
    65536, and above it one pass in device memory more for every three
    doublings or fewer (``wide_launch_info``);
  * on a CPU tensor it computes the plain version (``ops/wide.py``).

There is no fallback: a CUDA tensor is never handed to the plain version.
The ``*_plain`` functions are those plain versions on int64 limb pairs, on
any device (``chip_smoke.py`` runs them on the card as the oracle).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from . import _build
from . import wide
from .ntt_kernel import LAUNCHES, _stream
from ..params import NTTParams

Pair = Tuple[torch.Tensor, torch.Tensor]
MASK64 = (1 << 64) - 1
# ntt_wide.cuh WideMode
MODES = {"mont": 0, "exact": 1, "add": 2, "sub": 3}


@dataclasses.dataclass(frozen=True, eq=False)
class WideTables:
    """One wide ring's constants on one device.

    ``fwd`` and ``inv``: (w_lo, w_hi, p_lo, p_hi) int64 tensors [n], the
    twiddles and their Shoup words as limbs (the plain version's);
    ``words``: the same four u64 tables (roots, precon64, inv_roots,
    inv_precon64) as the bits of an int64 tensor [4, n] (the kernels')."""

    n: int
    log_n: int
    q: int
    qinv_neg: int  # -q^-1 mod 2**64
    r2: int  # 2**128 mod q
    fwd: Tuple[torch.Tensor, ...]
    inv: Tuple[torch.Tensor, ...]
    words: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.words.device


def make_wide_tables(params: NTTParams, device) -> WideTables:
    def limbs(*tables):
        return tuple(
            torch.from_numpy(part.astype(np.int64)).to(device)
            for t in tables for part in wide.split_u64_np(t)
        )

    w_lo, w_hi, p_lo, p_hi = limbs(params.roots, params.precon64)
    words = np.stack([params.roots, params.precon64, params.inv_roots,
                      params.inv_precon64]).view(np.int64)
    return WideTables(
        n=params.n, log_n=params.log_n, q=params.q,
        qinv_neg=wide.mont_qinv_neg64(params.q),
        r2=pow(1 << 64, 2, params.q),
        fwd=(w_lo, w_hi, p_lo, p_hi),
        inv=limbs(params.inv_roots, params.inv_precon64),
        words=torch.from_numpy(np.ascontiguousarray(words)).to(device),
    )


# -- plain versions (int64 limb pairs, any device) ----------------------------


def wide_fwd_plain(x: Pair, tables: WideTables) -> Pair:
    return wide.fwd_stages64(x, tables.fwd, tables.n, tables.q)


def wide_inv_plain(x: Pair, tables: WideTables, scale: int) -> Pair:
    return wide.inv_stages64(x, tables.inv, tables.n, tables.q, scale)


def wide_pointwise_plain(a: Pair, b: Pair, tables: WideTables,
                         mode: str) -> Pair:
    q = wide.u64c(tables.q)
    if mode == "mont":
        return wide.mont_mul_lazy64(a, b, q, wide.u64c(tables.qinv_neg))
    if mode == "exact":
        qinv = wide.u64c(tables.qinv_neg)
        t = wide.mont_mul_lazy64(a, b, q, qinv)
        t = wide.mont_mul_lazy64(t, wide.u64c(tables.r2), q, qinv)
        return wide.cond_sub64(t, q)
    if mode == "add":
        return wide.cond_sub64(wide.add64(a, b), q)
    if mode == "sub":
        return wide.cond_sub64(wide.add64(wide.sub64(a, b), q), q)
    raise ValueError(f"unknown mode {mode!r}; expected one of {tuple(MODES)}")


# -- wrappers -----------------------------------------------------------------


def _check(x: Pair, tables: WideTables, name: str, ndim=None) -> None:
    """Raise unless x is a pair of contiguous uint32 tensors of one shape on
    the tables' device, ending in n (``ndim`` dims, if given), with a
    non-empty batch."""
    if not (isinstance(x, tuple) and len(x) == 2
            and all(isinstance(t, torch.Tensor) for t in x)):
        raise TypeError(f"{name}: expected a (lo, hi) pair of tensors")
    lo, hi = x
    for t in x:
        if t.dtype != torch.uint32:
            raise TypeError(f"{name}: expected torch.uint32, got {t.dtype}")
        if t.device != tables.device:
            raise ValueError(
                f"{name}: tensor on {t.device}, ring tables on {tables.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor must be contiguous")
    if lo.shape != hi.shape:
        raise ValueError(f"{name}: lo {tuple(lo.shape)} and hi "
                         f"{tuple(hi.shape)} differ")
    if lo.dim() == 0 or lo.shape[-1] != tables.n or (
            ndim is not None and lo.dim() != ndim):
        raise ValueError(f"{name}: expected {ndim or 'some'} dims ending in "
                         f"n={tables.n}, got {tuple(lo.shape)}")
    if lo.numel() == 0:
        raise ValueError(f"{name}: empty batch")


def _i64(x: Pair) -> Pair:
    return tuple(t.to(torch.int64) for t in x)


def _u32(x: Pair) -> Pair:
    return tuple(t.to(torch.uint32) for t in x)


def _aligned(x: Pair) -> Pair:
    """x with each tensor on a 16-byte boundary (the kernels' vector loads
    and stores): a view that is not is copied."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in x)


def _launch(x: Pair, name: str, launch) -> Pair:
    """Allocate outputs shaped as x and call ``launch(lib, out, launches)``
    on x's device; raise on a CUDA error, count its kernel launches."""
    out = (torch.empty_like(x[0]), torch.empty_like(x[1]))
    launches = ctypes.c_int(0)
    lib = _build.load()
    with torch.cuda.device(x[0].device):
        rc = launch(lib, out, ctypes.byref(launches))
    _build.check(lib, rc, name)
    LAUNCHES[name] += launches.value
    return out


def wide_fwd(x: Pair, tables: WideTables) -> Pair:
    """Forward negacyclic NTT of (B, n) words in [0, 4q) -> [0, q), HEXL
    order (``ops/wide.py::fwd_stages64``)."""
    _check(x, tables, "wide_fwd", 2)
    if x[0].device.type == "cpu":
        return _u32(wide_fwd_plain(_i64(x), tables))
    x = _aligned(x)
    words = tables.words
    return _launch(x, "wide_fwd", lambda lib, y, count: (
        lib.ntt_wide_fwd(
            x[0].data_ptr(), x[1].data_ptr(), y[0].data_ptr(),
            y[1].data_ptr(), words[0].data_ptr(), words[1].data_ptr(),
            tables.q, x[0].shape[0], tables.log_n, _stream(x[0]), count)))


def wide_inv(x: Pair, tables: WideTables, scale: int) -> Pair:
    """Inverse NTT of (B, n) words in [0, 2q) -> [0, q), times ``scale``
    (``ops/wide.py::inv_stages64``; scale and floor(scale 2**64 / q) taken
    mod 2**64, as its limb pairs take them)."""
    _check(x, tables, "wide_inv", 2)
    if x[0].device.type == "cpu":
        return _u32(wide_inv_plain(_i64(x), tables, scale))
    x = _aligned(x)
    words = tables.words
    sc, scp = scale & MASK64, ((scale << 64) // tables.q) & MASK64
    return _launch(x, "wide_inv", lambda lib, y, count: (
        lib.ntt_wide_inv(
            x[0].data_ptr(), x[1].data_ptr(), y[0].data_ptr(),
            y[1].data_ptr(), words[2].data_ptr(), words[3].data_ptr(),
            tables.q, sc, scp, x[0].shape[0], tables.log_n, _stream(x[0]),
            count)))


def wide_pointwise(a: Pair, b: Pair, tables: WideTables, mode: str) -> Pair:
    """Elementwise on (..., n) words of one shape: ``"mont"`` the polymul's
    Montgomery product a b 2**-64 (lazy [0, 2q)), ``"exact"``
    ``pointwise_mul``'s a b mod q, ``"add"``, ``"sub"``."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of "
                         f"{tuple(MODES)}")
    _check(a, tables, "wide_pointwise")
    _check(b, tables, "wide_pointwise")
    if a[0].shape != b[0].shape:
        raise ValueError(f"wide_pointwise: shapes {tuple(a[0].shape)} and "
                         f"{tuple(b[0].shape)} differ")
    if a[0].device.type == "cpu":
        return _u32(wide_pointwise_plain(_i64(a), _i64(b), tables, mode))
    return _launch(a, "wide_pointwise", lambda lib, y, count: (
        lib.ntt_wide_pointwise(
            a[0].data_ptr(), a[1].data_ptr(), b[0].data_ptr(),
            b[1].data_ptr(), y[0].data_ptr(), y[1].data_ptr(), a[0].numel(),
            MODES[mode], tables.q, tables.qinv_neg, tables.r2, _stream(a[0]),
            count)))


_WIDE_KERNEL = {"wide_fwd": 0, "wide_inv": 1}


def wide_launch_info(tables: WideTables, which: str = "wide_fwd",
                     batch: int = 1) -> dict:
    """The cluster launch of ``which`` transform (``"wide_fwd"`` or
    ``"wide_inv"``) at (batch, n), as ``ntt_wide_launch_info`` reports it on
    the tables' card: ``ctas`` a block (the cluster), ``blocks`` a CTA,
    ``smem_bytes`` and ``threads`` a CTA, ``registers`` a thread,
    ``ctas_per_sm``, ``max_active_clusters``, ``clusters`` launched,
    ``passes`` in device memory and ``block`` (the words a cluster
    transforms)."""
    if which not in _WIDE_KERNEL:
        raise ValueError(f"wide_launch_info: unknown kernel {which!r}")
    if tables.device.type != "cuda":
        raise ValueError("wide_launch_info: the tables are not on a card")
    lib = _build.load()
    info = (ctypes.c_int * 10)()
    with torch.cuda.device(tables.device):
        rc = lib.ntt_wide_launch_info(_WIDE_KERNEL[which], tables.log_n, batch,
                                      info)
    _build.check(lib, rc, "wide_launch_info")
    keys = ("ctas", "blocks", "smem_bytes", "threads", "registers",
            "ctas_per_sm", "max_active_clusters", "clusters", "passes",
            "block")
    out = dict(zip(keys, info))
    for key in ("ctas", "blocks", "block"):
        out[key] = 1 << out[key]
    return out
