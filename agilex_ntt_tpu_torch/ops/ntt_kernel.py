"""Wrappers of the Hopper kernels of the single- and multi-prime rings.

Counterpart of the entry points of ``agilex_ntt_tpu/ops/ntt_kernel.py``:
``fwd_ntt``, ``inv_ntt``, ``polymul_fused`` and ``polydot_fused`` on (B, n)
and (B, k, n) operands of one prime, and ``fwd_ntt_rns``, ``inv_ntt_rns``,
``polymul_rns_fused`` and ``polydot_rns_fused`` on (L, B, n) and
(L, B, k, n) operands of L primes, one launch for all channels; and of the
four-step kernels of ``agilex_ntt_tpu/ops/fourstep.py`` on (B, n1, n2)
operands: ``fwd_ntt_fourstep``, ``inv_ntt_fourstep`` and
``polymul_fourstep_fused`` (the whole transform in one kernel; K7a, K7b
and K8 hold the matrix in a thread-block cluster's shared memory where it
fits, ``fourstep_cluster``) and
``fwd_col_fourstep``/``inv_col_fourstep`` (the column pass and the twiddle
alone; ``ops/fourstep.py`` runs the row pass on ``fwd_ntt``/``inv_ntt``);
``dit_inv_core``, the DIT inverse of ``agilex_ntt_tpu/ops/dit_inv.py``
between its two bit-reversals (``ops/dit_inv.py``); and ``xchg_group``, one
cross-device butterfly stage of ``agilex_ntt_tpu/parallel/overlap.py`` over
a group of butterfly pairs in one launch, into outputs the caller gives,
with ``xchg_step`` one shard's half (``parallel/``).
The kernels are hand-written CUDA in ``csrc/ntt_kernels.cu``, built for
``sm_90a`` at first use (``_build.py``).

Every wrapper takes contiguous ``torch.uint32`` tensors on the device of the
ring's tables and returns a new ``torch.uint32`` tensor reduced to [0, q)
(to [0, q_l) in channel l; ``fwd_col_fourstep`` leaves its words lazy in
[0, 2q), as the TPU kernel does):

  * on a CUDA tensor it launches its kernel on the current stream, raises if
    the launch returns a CUDA error, and adds one to ``LAUNCHES[name]``;
  * on a CPU tensor it computes the plain version (``plain_ntt.py``).

There is no fallback: a CUDA tensor is never handed to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import _build
from . import plain_ntt as plain
from .plain_ntt import (
    DitTables,
    FourStepTables,
    RingTables,
    RNSTables,
    inv_scale_words,
)

# Kernel launches per wrapper since the count was last set to 0.
LAUNCHES = {
    "fwd": 0, "inv": 0, "polymul": 0, "polydot": 0,
    "fwd_rns": 0, "inv_rns": 0, "polymul_rns": 0, "polydot_rns": 0,
    "fwd4": 0, "inv4": 0, "polymul4": 0, "col_fwd": 0, "col_inv": 0,
    "dit_inv": 0, "xchg_fwd": 0, "xchg_inv": 0,
    # the wide ring's kernels (ops/wide_kernel.py)
    "wide_fwd": 0, "wide_inv": 0, "wide_pointwise": 0,
    # the matrix-product four-step pass (ops/mxu_ntt.py)
    "mxu": 0,
}


def _check(x: torch.Tensor, tables, name: str, ndim: int) -> None:
    """Raise unless x is what the kernel takes: a contiguous uint32 tensor
    of ``ndim`` dims on the tables' device, ending in n, with a non-empty
    batch (and, for multi-prime tables, L channels first)."""
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
    rns = isinstance(tables, RNSTables)
    if rns and x.shape[0] != tables.L:
        raise ValueError(
            f"{name}: expected L={tables.L} channels first, got {tuple(x.shape)}"
        )
    if x.shape[int(rns)] == 0:
        raise ValueError(f"{name}: empty batch")
    if not x.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _check_pair(a, b, tables, name: str, ndim: int) -> None:
    _check(a, tables, name, ndim)
    _check(b, tables, name, ndim)
    if a.shape != b.shape:
        raise ValueError(f"{name}: shapes {a.shape} and {b.shape} differ")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.uint32)


def fwd_ntt(x: torch.Tensor, tables: RingTables) -> torch.Tensor:
    """Forward NTT of (B, n) in [0, 4q) -> [0, q), HEXL order: negacyclic,
    or cyclic on cyclic tables (a ``CyclicRing``'s, the four-step row
    pass's).

    On the card the multi-prime transform kernel at one channel
    (``launch_info``): a CTA holds 4096 words, a polynomial of n > 4096
    words on a cluster of n / 4096 CTAs, smaller ones several to a CTA; q
    is ``tables.dot_words`` word 0."""
    _check(x, tables, "fwd_ntt", 2)
    if x.device.type == "cpu":
        return _u32(plain.fwd_ntt_plain(x.to(torch.int64), tables))
    y = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.ntt_fwd(
            x.data_ptr(), y.data_ptr(),
            tables.roots.data_ptr(), tables.precon.data_ptr(),
            tables.dot_words.data_ptr(), x.shape[0], tables.log_n, _stream(x),
        )
    _build.check(lib, rc, "fwd_ntt")
    LAUNCHES["fwd"] += 1
    return y


def inv_ntt(
    x: torch.Tensor, tables: RingTables, *, scale: Optional[int] = None
) -> torch.Tensor:
    """Inverse NTT of (B, n) in [0, 2q) -> [0, q).  ``scale`` replaces the
    final n^-1 (for example n^-1 * 2**32 to absorb a Montgomery factor); it
    is folded into the last stage.  On the card ``fwd_ntt``'s launch, the
    passes in the mirror order; the scale's four words come from
    ``tables.scale_words`` (uploaded at a scale's first use only)."""
    _check(x, tables, "inv_ntt", 2)
    if x.device.type == "cpu":
        return _u32(plain.inv_ntt_plain(x.to(torch.int64), tables, scale))
    words = tables.scale_words(scale)
    y = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.ntt_inv(
            x.data_ptr(), y.data_ptr(),
            tables.inv_roots.data_ptr(), tables.inv_precon.data_ptr(),
            tables.dot_words.data_ptr(), words.data_ptr(), x.shape[0],
            tables.log_n, _stream(x),
        )
    _build.check(lib, rc, "inv_ntt")
    LAUNCHES["inv"] += 1
    return y


# the transform kernels by launch (ntt_kernels.cu RnsKernel)
_RNS_KERNEL = {"fwd": 0, "inv": 1, "dit_inv": 2}


def launch_info(tables: RingTables, which: str = "fwd", batch: int = 1) -> dict:
    """The launch of ``fwd_ntt`` (``which`` = ``"fwd"``: K1), ``inv_ntt``
    (``"inv"``: K2) or ``dit_inv_core`` (``"dit_inv"``: K12, on K1's
    launch) on (``batch``, n) at ``tables``' n: the multi-prime transform
    kernel's ``rns_launch_info`` at one channel."""
    if which not in _RNS_KERNEL:
        raise ValueError(f"launch_info: unknown kernel {which!r}")
    return _rns_info(_RNS_KERNEL[which], tables.log_n, 1, batch, "launch_info")


def _polydot_launch(a, b, tables: RingTables, what: str) -> torch.Tensor:
    """One launch of the fused kernel on (B, k, n) operands -> (B, n): the
    multi-prime polydot kernel at one channel, its constants
    ``tables.dot_words``."""
    batch, k, n = a.shape
    out = torch.empty((batch, n), dtype=torch.uint32, device=a.device)
    lib = _build.load()
    with torch.cuda.device(a.device):
        rc = lib.ntt_polydot(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            tables.roots.data_ptr(), tables.precon.data_ptr(),
            tables.inv_roots.data_ptr(), tables.inv_precon.data_ptr(),
            tables.dot_words.data_ptr(), batch, k, tables.log_n, _stream(a),
        )
    _build.check(lib, rc, what)
    return out


def _dot_launch_info(log_n: int, k: int, what: str) -> dict:
    lib = _build.load()
    info = (ctypes.c_int * 6)()
    _build.check(lib, lib.ntt_polydot_rns_launch_info(log_n, k, info), what)
    return {"ctas": 1 << info[0], "polys": 1 << info[1],
            "smem_bytes": info[2], "threads": info[3],
            "ctas_per_sm": info[4], "max_active_clusters": info[5]}


def polydot_launch_info(tables: RingTables, k: int = 2) -> dict:
    """The launch of the single-prime fused kernel (K3 with ``k`` = 1, K6a)
    at ``tables``' n, as ``polydot_rns_launch_info``: ``ctas`` a polynomial
    (the cluster; 1: no cluster), ``polys`` a CTA, shared memory and threads
    a CTA, CTAs an SM and the most such clusters the card runs at once."""
    return _dot_launch_info(tables.log_n, k, "polydot_launch_info")


def polymul_fused(a: torch.Tensor, b: torch.Tensor, tables: RingTables) -> torch.Tensor:
    """Negacyclic a * b mod (X^n + 1, q) of (B, n) operands in [0, 4q) in
    one kernel: two forward transforms, the Montgomery product, the scaled
    inverse (cyclic mod X^n - 1 on a ``CyclicRing``'s tables).

    On the card the multi-prime polydot kernel at one channel and k = 1
    (``polydot_launch_info``): a CTA holds 4096 words of each operand, a
    polynomial of n > 4096 words on a cluster of n / 4096 CTAs, smaller
    ones several to a CTA; no scratch at any n.  A launch the card refuses
    raises."""
    _check_pair(a, b, tables, "polymul_fused", 2)
    if a.device.type == "cpu":
        return _u32(
            plain.polymul_plain(a.to(torch.int64), b.to(torch.int64), tables)
        )
    out = _polydot_launch(a.unsqueeze(1), b.unsqueeze(1), tables, "polymul_fused")
    LAUNCHES["polymul"] += 1
    return out


def polydot_fused(a: torch.Tensor, b: torch.Tensor, tables: RingTables) -> torch.Tensor:
    """sum_i a_i * b_i mod (X^n + 1, q) of (B, k, n) operands in [0, 4q)
    -> (B, n) in one kernel: 2k forward transforms, lazy accumulation, one
    inverse.

    On the card ``polymul_fused``'s kernel with k terms: register-radix
    passes, the sum in registers, the next term's pair loaded by
    ``cp.async`` while the current one is transformed."""
    _check_pair(a, b, tables, "polydot_fused", 3)
    if a.shape[1] == 0:
        raise ValueError("polydot_fused: k must be at least 1")
    if a.device.type == "cpu":
        return _u32(
            plain.polydot_plain(a.to(torch.int64), b.to(torch.int64), tables)
        )
    out = _polydot_launch(a, b, tables, "polydot_fused")
    LAUNCHES["polydot"] += 1
    return out


# -- L primes: one launch for every channel -----------------------------------


def fwd_ntt_rns(x: torch.Tensor, tables: RNSTables) -> torch.Tensor:
    """Forward NTT of (L, B, n), channel l in [0, 4 q_l) -> [0, q_l).

    On the card the polydot's register-radix passes with one operand: a CTA
    holds 4096 words (a polynomial of n > 4096 words on a cluster of
    n / 4096 CTAs, smaller ones several to a CTA; ``rns_launch_info``)."""
    _check(x, tables, "fwd_ntt_rns", 3)
    if x.device.type == "cpu":
        return _u32(plain.fwd_ntt_rns_plain(x.to(torch.int64), tables))
    y = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.ntt_fwd_rns(
            x.data_ptr(), y.data_ptr(),
            tables.roots.data_ptr(), tables.precon.data_ptr(),
            tables.q_words.data_ptr(), tables.L, x.shape[1], tables.log_n,
            _stream(x),
        )
    _build.check(lib, rc, "fwd_ntt_rns")
    LAUNCHES["fwd_rns"] += 1
    return y


def inv_ntt_rns(
    x: torch.Tensor, tables: RNSTables, *, scales: Optional[Sequence[int]] = None
) -> torch.Tensor:
    """Inverse NTT of (L, B, n), channel l in [0, 2 q_l) -> [0, q_l).
    ``scales[l]`` replaces channel l's final n^-1 (for example
    ``tables.polymul_scale`` to absorb a Montgomery factor).  On the card
    ``fwd_ntt_rns``'s launch shape, the passes in the mirror order."""
    _check(x, tables, "inv_ntt_rns", 3)
    if x.device.type == "cpu":
        return _u32(plain.inv_ntt_rns_plain(x.to(torch.int64), tables, scales))
    words = tables.scale_words(scales)
    y = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.ntt_inv_rns(
            x.data_ptr(), y.data_ptr(),
            tables.inv_roots.data_ptr(), tables.inv_precon.data_ptr(),
            tables.q_words.data_ptr(), words.data_ptr(), tables.L, x.shape[1],
            tables.log_n, _stream(x),
        )
    _build.check(lib, rc, "inv_ntt_rns")
    LAUNCHES["inv_rns"] += 1
    return y


def rns_launch_info(tables: RNSTables, which: str = "fwd_rns",
                    batch: int = 1) -> dict:
    """The launch of the multi-prime transform kernel ``which``
    (``"fwd_rns"``: K4a, ``"inv_rns"``: K4b) on (L, ``batch``, n) at
    ``tables``' L and n: ``ctas`` a polynomial (the cluster; 1: no
    cluster), ``polys`` a CTA, shared memory and threads a CTA,
    ``registers`` a thread, CTAs an SM, the most such clusters the card runs
    at once and ``clusters`` launched a channel (one a unit of ``polys``
    polynomials, or one polynomial on a cluster)."""
    if which not in ("fwd_rns", "inv_rns"):
        raise ValueError(f"rns_launch_info: unknown kernel {which!r}")
    return _rns_info(int(which == "inv_rns"), tables.log_n, tables.L, batch,
                     "rns_launch_info")


def _rns_info(which: int, log_n: int, channels: int, batch: int,
              what: str) -> dict:
    lib = _build.load()
    info = (ctypes.c_int * 8)()
    _build.check(lib, lib.ntt_rns_launch_info(which, log_n, channels, batch,
                                              info), what)
    return {"ctas": 1 << info[0], "polys": 1 << info[1],
            "smem_bytes": info[2], "threads": info[3],
            "registers": info[4], "ctas_per_sm": info[5],
            "max_active_clusters": info[6], "clusters": info[7]}


def _polydot_rns_launch(a, b, tables: RNSTables, what: str) -> torch.Tensor:
    """One launch of the multi-prime fused kernel, (L, B, k, n) -> (L, B, n)."""
    L, batch, k, n = a.shape
    out = torch.empty((L, batch, n), dtype=torch.uint32, device=a.device)
    words = tables.scale_words(tables.polymul_scale)
    lib = _build.load()
    with torch.cuda.device(a.device):
        rc = lib.ntt_polydot_rns(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            tables.roots.data_ptr(), tables.precon.data_ptr(),
            tables.inv_roots.data_ptr(), tables.inv_precon.data_ptr(),
            tables.q_words.data_ptr(), tables.qinv_words.data_ptr(),
            words.data_ptr(), L, batch, k, tables.log_n, _stream(a),
        )
    _build.check(lib, rc, what)
    return out


def polydot_rns_launch_info(tables: RNSTables, k: int = 2) -> dict:
    """The launch of the multi-prime polydot kernel (K5 with ``k`` = 1, K6b)
    at ``tables``' n: ``ctas`` a polynomial (the cluster; 1: no cluster),
    ``polys`` a CTA, shared memory and threads a CTA, CTAs an SM and the
    most such clusters the card runs at once."""
    return _dot_launch_info(tables.log_n, k, "polydot_rns_launch_info")


def polymul_rns_fused(a: torch.Tensor, b: torch.Tensor, tables: RNSTables) -> torch.Tensor:
    """Negacyclic a * b mod (X^n + 1, q_l) of (L, B, n) operands in one
    launch: per channel two forward transforms, the Montgomery product and
    the inverse scaled by that channel's ``polymul_scale`` (on the card the
    polydot kernel with k = 1, ``polydot_rns_launch_info``)."""
    _check_pair(a, b, tables, "polymul_rns_fused", 3)
    if a.device.type == "cpu":
        return _u32(
            plain.polymul_rns_plain(a.to(torch.int64), b.to(torch.int64), tables)
        )
    out = _polydot_rns_launch(
        a.unsqueeze(2), b.unsqueeze(2), tables, "polymul_rns_fused"
    )
    LAUNCHES["polymul_rns"] += 1
    return out


def polydot_rns_fused(a: torch.Tensor, b: torch.Tensor, tables: RNSTables) -> torch.Tensor:
    """sum_i a_i * b_i mod (X^n + 1, q_l) of (L, B, k, n) operands ->
    (L, B, n) in one launch: 2k forward transforms, lazy accumulation and
    one scaled inverse per polynomial of every channel.

    On the card a CTA holds 4096 words of each operand: a polynomial of
    n > 4096 words on a cluster of n / 4096 CTAs, smaller ones several to a
    CTA (``polydot_rns_launch_info``); register-radix passes, the sum in
    registers.  A launch the card refuses raises."""
    _check_pair(a, b, tables, "polydot_rns_fused", 4)
    if a.shape[2] == 0:
        raise ValueError("polydot_rns_fused: k must be at least 1")
    if a.device.type == "cpu":
        return _u32(
            plain.polydot_rns_plain(a.to(torch.int64), b.to(torch.int64), tables)
        )
    out = _polydot_rns_launch(a, b, tables, "polydot_rns_fused")
    LAUNCHES["polydot_rns"] += 1
    return out


# -- four-step: (B, n1, n2) operands, n = n1 * n2 ------------------------------


def _check4(x, ft: FourStepTables, name: str) -> None:
    """Raise unless x is a contiguous uint32 (B, n1, n2) tensor, B >= 1, on
    the tables' device."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(x).__name__}")
    if x.dtype != torch.uint32:
        raise TypeError(f"{name}: expected torch.uint32, got {x.dtype}")
    if x.device != ft.device:
        raise ValueError(
            f"{name}: tensor on {x.device}, ring tables on {ft.device}"
        )
    if x.dim() != 3 or tuple(x.shape[1:]) != (ft.n1, ft.n2) or x.shape[0] == 0:
        raise ValueError(
            f"{name}: expected (B >= 1, n1={ft.n1}, n2={ft.n2}), got "
            f"{tuple(x.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _ptrs(*tensors: torch.Tensor):
    """A host array of the tensors' device pointers (the kernels' Tabs4)."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _fwd_tabs(ft: FourStepTables):
    return _ptrs(ft.col.roots, ft.col.precon, ft.row.roots, ft.row.precon,
                 ft.tw, ft.tw_precon)


def _inv_tabs(ft: FourStepTables):
    return _ptrs(ft.col.inv_roots, ft.col.inv_precon, ft.row.inv_roots,
                 ft.row.inv_precon, ft.itw, ft.itw_precon)


def _words(values) -> ctypes.Array:
    return (ctypes.c_uint32 * 4)(*values)


def _row_scale(ft: FourStepTables):
    """The row inverse's last-stage words: n2^-1 (inv_roots[1] of a cyclic
    table is 1)."""
    return _words(inv_scale_words(ft.row, None))


def _col_scale(ft: FourStepTables, scale: Optional[int]):
    return _words(inv_scale_words(ft.col, ft.col_scale(scale)))


def _logs(ft: FourStepTables):
    return ft.n1.bit_length() - 1, ft.n2.bit_length() - 1


def fourstep_cluster(ft: FourStepTables, mats: int) -> int:
    """log2 of the CTAs of the cluster whose shared memory holds ``mats``
    (n1, n2) matrices (1: ``fwd_ntt_fourstep`` and ``inv_ntt_fourstep``, 2:
    ``polymul_fourstep_fused``), or -1 where none does and the wrapper
    launches the walking kernel."""
    return _build.load().ntt_fourstep_cluster_log(mats, *_logs(ft))


# the four-step kernels that fourstep_launch_info describes
LAUNCH_INFO_KERNELS = ("fwd4", "inv4", "polymul4", "col_fwd", "col_inv")
SLAB_KERNELS = ("col_fwd", "col_inv")


def fourstep_launch_info(ft: FourStepTables, kernel: str) -> dict:
    """The launch of the cluster or slab kernel behind the wrapper counted as
    ``kernel`` (one of ``LAUNCH_INFO_KERNELS``) at this shape: ``ctas`` a
    cluster (0: the walking kernel), or for ``"col_fwd"`` and ``"col_inv"``
    the slab width ``width`` and the slabs a polynomial ``ctas`` (0: the
    walking kernel);
    shared memory and threads a CTA, CTAs an SM, and for the cluster
    kernels the most such clusters the card runs at once
    (``cudaOccupancyMaxActiveClusters``)."""
    lib = _build.load()
    info = (ctypes.c_int * 5)()
    which = LAUNCH_INFO_KERNELS.index(kernel)
    _build.check(lib, lib.ntt_fourstep_launch_info(which, *_logs(ft), info),
                 "fourstep_launch_info")
    ctas = 1 << info[0] if info[0] >= 0 else 0
    return {"ctas": ctas,
            "width": ft.n2 // ctas if kernel in SLAB_KERNELS and ctas else 0,
            "smem_bytes": info[1], "threads": info[2],
            "ctas_per_sm": info[3], "max_active_clusters": info[4]}


def fwd_ntt_fourstep(x: torch.Tensor, ft: FourStepTables) -> torch.Tensor:
    """Forward four-step NTT of (B, n1, n2) in [0, 4q) -> [0, q) in one
    kernel (K7a): the column pass, the twiddle and the row pass.

    On the card, by shape: where the matrix fits in the shared memory of a
    cluster of at most 16 CTAs (n <= 2^19 with the balanced split) the
    cluster kernel keeps it on chip from load to store; above that the
    walking kernel passes it through device memory between its passes.
    Both are hand-written CUDA; a cluster launch the card refuses raises."""
    _check4(x, ft, "fwd_ntt_fourstep")
    if x.device.type == "cpu":
        return _u32(plain.fwd_ntt_fourstep_plain(x.to(torch.int64), ft))
    y = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.ntt_fwd4(
            x.data_ptr(), y.data_ptr(), _fwd_tabs(ft), x.shape[0], *_logs(ft),
            ft.q, _stream(x),
        )
    _build.check(lib, rc, "fwd_ntt_fourstep")
    LAUNCHES["fwd4"] += 1
    return y


def inv_ntt_fourstep(
    x: torch.Tensor, ft: FourStepTables, *, scale: Optional[int] = None
) -> torch.Tensor:
    """Inverse four-step NTT of (B, n1, n2) in [0, 2q) -> [0, q) in one
    kernel (K7b).  ``scale`` replaces the overall n^-1: the row pass scales
    by n2^-1, the column pass by scale * n2.

    On the card, by shape as ``fwd_ntt_fourstep``: the cluster kernel where
    the matrix fits in a cluster's shared memory, else the walking
    kernel; a cluster launch the card refuses raises."""
    _check4(x, ft, "inv_ntt_fourstep")
    if x.device.type == "cpu":
        return _u32(plain.inv_ntt_fourstep_plain(x.to(torch.int64), ft, scale))
    y = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.ntt_inv4(
            x.data_ptr(), y.data_ptr(), _inv_tabs(ft), _row_scale(ft),
            _col_scale(ft, scale), x.shape[0], *_logs(ft), ft.q, _stream(x),
        )
    _build.check(lib, rc, "inv_ntt_fourstep")
    LAUNCHES["inv4"] += 1
    return y


def polymul_fourstep_fused(
    a: torch.Tensor, b: torch.Tensor, ft: FourStepTables
) -> torch.Tensor:
    """a * b of (B, n1, n2) operands in [0, q) in one kernel (K8): two
    forward transforms, the Montgomery product, the inverse scaled by
    ``ft.polymul_scale``.

    On the card, by shape as ``fwd_ntt_fourstep``: the cluster kernel where
    both matrices fit in a cluster's shared memory (n <= 2^18 with the
    balanced split), with no scratch; above that the walking kernel, with a
    scratch buffer of B n words for the first operand's transform."""
    _check4(a, ft, "polymul_fourstep_fused")
    _check4(b, ft, "polymul_fourstep_fused")
    if a.shape != b.shape:
        raise ValueError(
            f"polymul_fourstep_fused: shapes {a.shape} and {b.shape} differ"
        )
    if a.device.type == "cpu":
        return _u32(plain.polymul_fourstep_plain(
            a.to(torch.int64), b.to(torch.int64), ft))
    out = torch.empty_like(a)
    # the walking kernel's first operand's transform
    scratch = torch.empty_like(a) if fourstep_cluster(ft, 2) < 0 else None
    lib = _build.load()
    with torch.cuda.device(a.device):
        rc = lib.ntt_polymul4(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            _fwd_tabs(ft), _inv_tabs(ft), _row_scale(ft),
            _col_scale(ft, ft.polymul_scale), a.shape[0], *_logs(ft), ft.q,
            ft.qinv_neg, _stream(a),
        )
    _build.check(lib, rc, "polymul_fourstep_fused")
    LAUNCHES["polymul4"] += 1
    return out


def fwd_col_fourstep(x: torch.Tensor, ft: FourStepTables) -> torch.Tensor:
    """The column pass of (B, n1, n2) in [0, 4q) (K9a): the size-n1 NTT of
    every column, then the twiddle T; out lazy in [0, 2q).

    On the card one CTA takes a slab of consecutive columns in shared
    memory (``fourstep_launch_info(ft, "col_fwd")``) wherever a slab of two
    fits a block (n1 <= 2^14); at n1 = 2^15 the walking column-tile
    kernel."""
    _check4(x, ft, "fwd_col_fourstep")
    if x.device.type == "cpu":
        return _u32(plain.fwd_col_fourstep_plain(x.to(torch.int64), ft))
    y = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.ntt_col_fwd4(
            x.data_ptr(), y.data_ptr(), _fwd_tabs(ft), x.shape[0], *_logs(ft),
            ft.q, _stream(x),
        )
    _build.check(lib, rc, "fwd_col_fourstep")
    LAUNCHES["col_fwd"] += 1
    return y


def inv_col_fourstep(
    x: torch.Tensor, ft: FourStepTables, *, scale: Optional[int] = None
) -> torch.Tensor:
    """The column inverse of (B, n1, n2), any words (K9b): the product with
    T^-1, then the size-n1 inverse of every column scaled by scale * n2
    (default n^-1 n2 = n1^-1); out [0, q).

    On the card as ``fwd_col_fourstep``: slabs of columns
    (``fourstep_launch_info(ft, "col_inv")``) wherever a slab of two fits a
    block, the walking column-tile kernel at n1 = 2^15."""
    _check4(x, ft, "inv_col_fourstep")
    if x.device.type == "cpu":
        return _u32(plain.inv_col_fourstep_plain(x.to(torch.int64), ft, scale))
    y = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.ntt_col_inv4(
            x.data_ptr(), y.data_ptr(), _inv_tabs(ft), _col_scale(ft, scale),
            x.shape[0], *_logs(ft), ft.q, _stream(x),
        )
    _build.check(lib, rc, "inv_col_fourstep")
    LAUNCHES["col_inv"] += 1
    return y


# -- the DIT inverse (K12) and the cross-device stage (K11) ---------------------


def dit_inv_core(x: torch.Tensor, dt: DitTables) -> torch.Tensor:
    """The DIT inverse between its bit-reversals (K12): (B, n) already
    bit-reversed, in [0, 2q) -> [0, q): the pre row psi^k, the forward
    stages on the psi^-1 tables, the post row n^-1 inv_roots[m].

    On the card ``fwd_ntt``'s launch (``launch_info(dt.ring, "dit_inv")``)
    of its own kernel: the forward passes on ``dt.cyclic``, the cyclic
    tables of psi^-2 (that network with the pre row folded in), the post row
    folded into the store."""
    _check(x, dt.ring, "dit_inv_core", 2)
    if x.device.type == "cpu":
        return _u32(plain.dit_inv_core_plain(x.to(torch.int64), dt))
    y = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.ntt_dit_inv(
            x.data_ptr(), y.data_ptr(), dt.cyclic.roots.data_ptr(),
            dt.cyclic.precon.data_ptr(), dt.rows.data_ptr(), x.shape[0],
            dt.ring.log_n, dt.ring.q, _stream(x),
        )
    _build.check(lib, rc, "dit_inv_core")
    LAUNCHES["dit_inv"] += 1
    return y


# (device, peer) index pairs whose P2P access is on; peer access is a state
# of the process's CUDA context, so one record serves every caller.
_PEERS_ENABLED = set()


def enable_peer(device: torch.device, peer: torch.device) -> None:
    """Let kernels on ``device`` read ``peer``'s memory; raise if the two
    cards cannot reach each other (no copy is made in its place)."""
    key = (device.index, peer.index)
    if key in _PEERS_ENABLED:
        return
    lib = _build.load()
    _build.check(lib, lib.ntt_enable_peer(*key), f"P2P access {device} -> {peer}")
    _PEERS_ENABLED.add(key)


def _check_xchg(entry, shape, device) -> None:
    u, v, w, wp, out_u, out_v = entry
    for name, t in (("u", u), ("v", v), ("w", w), ("wp", wp),
                    ("out_u", out_u), ("out_v", out_v)):
        if t is None and name.startswith("out"):
            continue
        if not isinstance(t, torch.Tensor) or t.dtype != torch.uint32:
            raise TypeError(f"xchg_group: {name} must be a torch.uint32 tensor")
        if not t.is_contiguous():
            raise ValueError(f"xchg_group: {name} must be contiguous")
    if out_u is None and out_v is None:
        raise ValueError("xchg_group: an entry writes out_u, out_v or both")
    for name, t in (("u", u), ("v", v), ("out_u", out_u), ("out_v", out_v)):
        if t is not None and t.shape != shape:
            raise ValueError(f"xchg_group: every shard must be one "
                             f"{tuple(shape)} shape, got {name} "
                             f"{tuple(t.shape)}")
    for name, t in (("out_u", out_u), ("out_v", out_v), ("w", w), ("wp", wp)):
        if t is not None and t.device != device:
            raise ValueError(f"xchg_group: {name} on {t.device}, the "
                             f"launch on {device}")
    for name, t in (("u", u), ("v", v)):
        if t.device.type != device.type:
            raise ValueError(f"xchg_group: {name} on {t.device}, the "
                             f"launch on {device}")
    if w.shape != (shape[1],) or wp.shape != w.shape:
        raise ValueError(f"xchg_group: w and wp must be ({shape[1]},) rows")


def xchg_group(
    entries: Sequence[tuple],
    *,
    q: int,
    fwd: bool,
    last: bool = False,
    scale: Optional[int] = None,
) -> None:
    """One cross-device butterfly stage (K11) over a group of butterfly
    pairs of (B, S) shards, one launch on the card.  Each entry is
    ``(u, v, w, wp, out_u, out_v)``: the pair's u-half and v-half shards
    (on the launch's device or a peer card, read in place), the (S,)
    positional twiddle row and its Shoup precon, and the tensors that take
    the new u-half and v-half, either of them None when that half is not
    wanted.  The outputs and rows of every entry sit on one device, the
    launch's.

    Forward: u, v in [0, 4q) -> [0, 4q), or [0, q) when ``last``.
    Inverse: u, v in [0, 2q) -> [0, 2q); with ``last`` the result is
    multiplied by ``scale`` and reduced to [0, q) (the final n^-1).  No
    output may alias an input: every entry reads its words from before the
    stage.

    On the card one launch of ``xchg_group_kernel`` a 64 entries (one
    ``LAUNCHES["xchg_fwd"|"xchg_inv"]`` each); on the CPU the plain version,
    half by half."""
    if not entries:
        raise ValueError("xchg_group: no entries")
    u0, _, _, _, out_u0, out_v0 = entries[0]
    shape = u0.shape
    if len(shape) != 2 or shape[0] == 0:
        raise ValueError(f"xchg_group: shards must be (B >= 1, S), got "
                         f"{tuple(shape)}")
    device = (out_u0 if out_u0 is not None else out_v0).device
    for entry in entries:
        _check_xchg(entry, shape, device)
    if last and not fwd and scale is None:
        raise ValueError("xchg_group: the last inverse stage needs its scale")
    s = 0 if scale is None else scale % q
    sp = (s << 32) // q
    if device.type == "cpu":
        for u, v, w, wp, out_u, out_v in entries:
            for is_u, out in ((True, out_u), (False, out_v)):
                if out is not None:
                    out.copy_(_xchg_plain(u if is_u else v, v if is_u else u,
                                          w, wp, is_u, q, fwd, last, s, sp))
        return
    table = []
    for u, v, w, wp, out_u, out_v in entries:
        for t in (u, v):
            if t.device != device:
                enable_peer(device, t.device)
        ptrs = tuple(0 if t is None else t.data_ptr()
                     for t in (u, v, out_u, out_v, w, wp))
        if shape[1] % 4 or any(p % 16 for p in ptrs):
            raise ValueError("xchg_group: the kernel takes 16-byte aligned "
                             "rows of a multiple of 4 words")
        table += ptrs
    words = (ctypes.c_uint64 * len(table))(*table)
    launched = ctypes.c_int(0)
    lib = _build.load()
    with torch.cuda.device(device):
        rc = lib.ntt_xchg_group(
            words, len(entries), shape[0], shape[1], q, int(fwd), int(last),
            s, sp, torch.cuda.current_stream(device).cuda_stream,
            ctypes.byref(launched),
        )
    LAUNCHES["xchg_fwd" if fwd else "xchg_inv"] += launched.value
    _build.check(lib, rc, "xchg_group")


def _xchg_plain(x, partner, w, wp, is_u, q, fwd, last, s, sp):
    """One half of a pair's stage (the plain version), as int64."""
    wi, wpi = w.to(torch.int64), wp.to(torch.int64)
    xi, pi = x.to(torch.int64), partner.to(torch.int64)
    if fwd:
        return plain.fwd_stage_step_plain(xi, pi, is_u, wi, wpi, q, last)
    return plain.inv_stage_step_plain(
        xi, pi, is_u, wi, wpi, q, (s, sp) if last else None
    )


def half_entry(x, partner, w, wp, is_u: bool, out) -> tuple:
    """The ``xchg_group`` entry that writes shard ``x``'s own half into
    ``out`` from ``x`` and its partner's shard ``partner``."""
    if is_u:
        return (x, partner, w, wp, out, None)
    return (partner, x, w, wp, None, out)


def xchg_step(
    x: torch.Tensor,
    partner: torch.Tensor,
    w: torch.Tensor,
    wp: torch.Tensor,
    *,
    q: int,
    fwd: bool,
    is_u: bool,
    last: bool = False,
    scale: Optional[int] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``xchg_group`` of one shard's half: this shard ``x``, its partner's
    ``partner``, the twiddle rows ``w``, ``wp`` and the role ``is_u``;
    writes ``out`` when given, else a new tensor, and returns it."""
    if out is None:
        out = torch.empty_like(x)
    xchg_group([half_entry(x, partner, w, wp, is_u, out)], q=q, fwd=fwd,
               last=last, scale=scale)
    return out
