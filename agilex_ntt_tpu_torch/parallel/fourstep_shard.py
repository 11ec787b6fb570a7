"""Distributed four-step NTT: local small transforms and two retiles.

Counterpart of ``agilex_ntt_tpu/parallel/fourstep_shard.py``.  A shard's
contiguous n/P coefficients are n1/P whole rows of the (n1, n2) four-step
matrix.  The forward transform retiles rows -> columns (each shard then
holds all n1 rows of n2/P columns), runs the size-n1 column transforms (K1
on the plan's column tables), multiplies by its column slice of the
inter-pass twiddle (the lazy Shoup product, PyTorch on int64 as JAX leaves
it to XLA), retiles columns -> rows and runs the size-n2 row transforms
(K1 on the cyclic row tables).  The inverse runs the same steps backwards
on K2.  Where the JAX package's all-to-all moves blocks over ICI, the port
copies the column and row blocks between the shards' devices.  Outputs are
bit-identical to the single-device transforms.

``comm="overlap"`` keeps the JAX package's chunking: the local batch is
split into up to ``_OVERLAP_CHUNKS`` independent chains.

On a mesh of several processes (``multihost.pod_mesh``) ``fwd_grid`` and
``inv_grid`` take the sp group of this process (``line``) and run SPMD on
its one shard: the column pass (K1 on the column tables), its slice of the
twiddle and the row pass as above, the two retiles an ``all_to_all`` each
over the sp group (``comm.all_to_all``).  With ``"overlap"`` the chunks'
retiles are posted ahead: every chunk's first retile at once, then each
chunk's second as soon as its column pass is done, so that a chunk's
retile is on the wire while the next chunk computes.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..ops import modmul as mm
from ..ops import ntt_kernel as K
from ..ops.fourstep import FourStepPlan
from ..ops.plain_ntt import FourStepTables, make_fourstep_tables
from . import comm as transport
from . import shards

COMMS = ("ppermute", "overlap")
_OVERLAP_CHUNKS = 4


def _check(plan: FourStepPlan, num_devices: int):
    if plan.n1 % num_devices or plan.n2 % num_devices:
        raise ValueError(
            f"four-step sharding needs P | n1 and P | n2: "
            f"P={num_devices}, n1={plan.n1}, n2={plan.n2}"
        )


@functools.lru_cache(maxsize=64)
def _tables(plan: FourStepPlan, device) -> FourStepTables:
    return make_fourstep_tables(plan, device)


@functools.lru_cache(maxsize=256)
def _twiddle_cols(plan: FourStepPlan, num_devices: int, d: int, inverse: bool,
                  device):
    """Shard d's (n1, n2/P) slice of T (or T^-1) and its precon, int64."""
    ft = _tables(plan, device)
    w, p = (ft.itw, ft.itw_precon) if inverse else (ft.tw, ft.tw_precon)
    n2p = plan.n2 // num_devices
    cols = slice(d * n2p, (d + 1) * n2p)
    return (w[:, cols].to(torch.int64).contiguous(),
            p[:, cols].to(torch.int64).contiguous())


def _twiddle(m: torch.Tensor, plan, P, d, inverse) -> torch.Tensor:
    """The lazy Shoup product of (B, n1, n2/P) words with shard d's slice
    of T (T^-1), [0, 2q)."""
    w, p = _twiddle_cols(plan, P, d, inverse, m.device)
    return mm.shoup_mulmod_lazy(m.to(torch.int64), w, p, plan.q).to(torch.uint32)


def _rows_to_cols(ms, d: int, n2p: int) -> torch.Tensor:
    """Shard d's columns from every shard's (B, n1/P, n2) rows block:
    (B, n1, n2/P) on shard d's device."""
    dev = ms[d].device
    return shards.u32(torch.cat(
        [shards.words(m)[:, :, d * n2p:(d + 1) * n2p].to(dev) for m in ms],
        dim=1,
    ))


def _cols_to_rows(ms, d: int, n1p: int) -> torch.Tensor:
    """Shard d's rows from every shard's (B, n1, n2/P) columns block:
    (B, n1/P, n2) on shard d's device."""
    dev = ms[d].device
    return shards.u32(torch.cat(
        [shards.words(m)[:, d * n1p:(d + 1) * n1p, :].to(dev) for m in ms],
        dim=2,
    ))


def _columns(m: torch.Tensor) -> torch.Tensor:
    """(B, n1, c) -> (B c, n1): each column as a contiguous row."""
    b, n1, c = m.shape
    return shards.u32(shards.words(m).transpose(1, 2).reshape(b * c, n1).contiguous())


def _uncolumns(y: torch.Tensor, b: int, c: int) -> torch.Tensor:
    """(B c, n1) -> (B, n1, c)."""
    return shards.u32(shards.words(y).view(b, c, -1).transpose(1, 2))


def _fwd_body(xs, plan: FourStepPlan):
    P = len(xs)
    b = xs[0].shape[0]
    n1, n2 = plan.n1, plan.n2
    n1p, n2p = n1 // P, n2 // P
    ms = [x.view(b, n1p, n2) for x in xs]
    mids = []
    for d in range(P):
        ft = _tables(plan, xs[d].device)
        yc = K.fwd_ntt(_columns(_rows_to_cols(ms, d, n2p)), ft.col)
        mids.append(_twiddle(_uncolumns(yc, b, n2p), plan, P, d, False))
    outs = []
    for d in range(P):
        ft = _tables(plan, xs[d].device)
        rows = _cols_to_rows(mids, d, n1p).reshape(b * n1p, n2)
        outs.append(K.fwd_ntt(rows, ft.row).view(b, n1p * n2))
    return outs


def _inv_body(ys, plan: FourStepPlan, scale: int):
    P = len(ys)
    b = ys[0].shape[0]
    n1, n2 = plan.n1, plan.n2
    n1p, n2p = n1 // P, n2 // P
    ms = []
    for y in ys:
        ft = _tables(plan, y.device)
        ms.append(K.inv_ntt(y.view(b * n1p, n2), ft.row).view(b, n1p, n2))
    cms = []
    for d in range(P):
        ft = _tables(plan, ys[d].device)
        mu = _twiddle(_rows_to_cols(ms, d, n2p), plan, P, d, True)
        c = K.inv_ntt(_columns(mu), ft.col, scale=ft.col_scale(scale))
        cms.append(_uncolumns(c, b, n2p))
    return [_cols_to_rows(cms, d, n1p).reshape(b, n1p * n2) for d in range(P)]


def _num_chunks(b: int) -> int:
    nch = _OVERLAP_CHUNKS
    while nch > 1 and b % nch:
        nch //= 2
    return nch


def _chunked(body, xs, *args):
    """``body`` on up to ``_OVERLAP_CHUNKS`` independent batch chunks of the
    shards, joined back per shard."""
    b = xs[0].shape[0]
    nch = _num_chunks(b)
    if nch == 1:
        return body(xs, *args)
    step = b // nch
    outs = [body([x[c * step:(c + 1) * step] for x in xs], *args)
            for c in range(nch)]
    return [
        shards.u32(torch.cat([shards.words(o[d]) for o in outs], dim=0))
        for d in range(len(xs))
    ]


def _row_chunks(b: int, comm: str):
    """The batch rows of each chunk: one chunk for "ppermute", the
    ``_chunked`` count for "overlap"."""
    step = b // (_num_chunks(b) if comm == "overlap" else 1)
    return [slice(r, r + step) for r in range(0, b, step)]


def _stacked(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The (P, ...) blocks of an ``all_to_all``, joined in order along
    ``dim`` of a block."""
    return shards.u32(torch.cat(list(shards.words(t).unbind(0)), dim=dim))


def _rows_out(outs) -> torch.Tensor:
    if len(outs) == 1:
        return outs[0]
    return shards.u32(torch.cat([shards.words(o) for o in outs], dim=0))


def _fwd_line(x, line, plan: FourStepPlan, comm: str):
    """``fwd_group`` of this process's shard ``x``, shard ``line.index`` of
    the sp group ``line`` whose other shards are in other processes."""
    P, d = line.size, line.index
    n1, n2 = plan.n1, plan.n2
    n1p, n2p = n1 // P, n2 // P
    ft = _tables(plan, x.device)
    m = x.view(x.shape[0], n1p, n2)
    chunks = _row_chunks(x.shape[0], comm)
    to_cols = [transport.all_to_all(
        [m[c, :, e * n2p:(e + 1) * n2p] for e in range(P)], line)
        for c in chunks]
    to_rows = []
    for c, pending in zip(chunks, to_cols):
        b = c.stop - c.start
        yc = K.fwd_ntt(_columns(_stacked(pending.wait(), 1)), ft.col)
        mid = _twiddle(_uncolumns(yc, b, n2p), plan, P, d, False)
        to_rows.append(transport.all_to_all(
            [mid[:, e * n1p:(e + 1) * n1p] for e in range(P)], line))
    outs = []
    for c, pending in zip(chunks, to_rows):
        b = c.stop - c.start
        rows = _stacked(pending.wait(), 2).reshape(b * n1p, n2)
        outs.append(K.fwd_ntt(rows, ft.row).view(b, n1p * n2))
    return _rows_out(outs)


def _inv_line(y, line, plan: FourStepPlan, scale: int, comm: str):
    """``inv_group`` of this process's shard ``y`` (as ``_fwd_line``)."""
    P, d = line.size, line.index
    n1, n2 = plan.n1, plan.n2
    n1p, n2p = n1 // P, n2 // P
    ft = _tables(plan, y.device)
    chunks = _row_chunks(y.shape[0], comm)
    to_cols = []
    for c in chunks:
        b = c.stop - c.start
        m = K.inv_ntt(y[c].view(b * n1p, n2), ft.row).view(b, n1p, n2)
        to_cols.append(transport.all_to_all(
            [m[:, :, e * n2p:(e + 1) * n2p] for e in range(P)], line))
    to_rows = []
    for c, pending in zip(chunks, to_cols):
        b = c.stop - c.start
        mu = _twiddle(_stacked(pending.wait(), 1), plan, P, d, True)
        cm = _uncolumns(K.inv_ntt(_columns(mu), ft.col,
                                  scale=ft.col_scale(scale)), b, n2p)
        to_rows.append(transport.all_to_all(
            [cm[:, e * n1p:(e + 1) * n1p] for e in range(P)], line))
    return _rows_out([
        _stacked(pending.wait(), 2).reshape(c.stop - c.start, n1p * n2)
        for c, pending in zip(chunks, to_rows)])


def fwd_group(xs, plan: FourStepPlan, comm: str = "ppermute"):
    """Forward four-step NTT of the P coefficient shards ``xs`` of one sp
    group, each (B, n/P) uint32 in [0, 4q) on its device -> [0, q)."""
    if comm == "overlap":
        return _chunked(_fwd_body, xs, plan)
    return _fwd_body(xs, plan)


def inv_group(xs, plan: FourStepPlan, scale: int, comm: str = "ppermute"):
    """Inverse four-step NTT of the P shards ``xs`` (each in [0, 2q)) times
    ``scale`` -> [0, q)."""
    if comm == "overlap":
        return _chunked(_inv_body, xs, plan, scale)
    return _inv_body(xs, plan, scale)


def _check_call(plan: FourStepPlan, num_devices: int, comm: str) -> None:
    _check(plan, num_devices)
    if comm not in COMMS:
        raise ValueError(f"unknown comm {comm!r}")


def fwd_grid(grid, plan: FourStepPlan, comm: str = "ppermute", line=None):
    """``fwd_group`` on every sp group (dp row) of a grid; with ``line``
    (a grid of one shard a process) on this process's shard."""
    _check_call(plan, len(grid[0]), comm)
    if line is not None:
        return shards.map_grid(lambda x: _fwd_line(x, line, plan, comm), grid)
    return [fwd_group(row, plan, comm) for row in grid]


def inv_grid(grid, plan: FourStepPlan, scale: Optional[int] = None,
             comm: str = "ppermute", line=None):
    """``inv_group`` on every sp group of a grid; scale defaults to n^-1.
    ``line`` as in :func:`fwd_grid`."""
    _check_call(plan, len(grid[0]), comm)
    scale = plan.n_inv if scale is None else scale
    if line is not None:
        return shards.map_grid(
            lambda y: _inv_line(y, line, plan, scale, comm), grid)
    return [inv_group(row, plan, scale, comm) for row in grid]


def _run(x, plan, mesh, axis, dp_axis, comm, body):
    _check_call(plan, mesh.shape[axis], comm)
    devices = shards.grid_devices(mesh, dp_axis, axis)
    x = shards.as_u32(x, devices[0][0])
    if x.dim() != 2 or x.shape[-1] != plan.n:
        raise ValueError(f"expected (B, n={plan.n}), got {tuple(x.shape)}")
    shards.check_batch(x, len(devices), "four-step sharded transform")
    return shards.join(body(shards.split(x, devices)), devices[0][0])


def fourstep_sharded_fwd(
    x,
    plan: FourStepPlan,
    mesh,
    *,
    axis: str = "sp",
    dp_axis: Optional[str] = None,
    comm: str = "ppermute",
) -> torch.Tensor:
    """Forward four-step NTT, coefficients sharded over ``axis`` (and the
    batch optionally over ``dp_axis``).  x: (B, n) uint32 in [0, 4q);
    output [0, q) on the mesh's first device, bit-identical to the
    single-device transform.  comm="overlap" runs independent batch chunks
    (``_chunked``)."""
    return _run(x, plan, mesh, axis, dp_axis, comm,
                lambda grid: fwd_grid(grid, plan, comm))


def fourstep_sharded_inv(
    x,
    plan: FourStepPlan,
    mesh,
    *,
    axis: str = "sp",
    dp_axis: Optional[str] = None,
    scale: Optional[int] = None,
    comm: str = "ppermute",
) -> torch.Tensor:
    """Inverse four-step NTT (sharding as in ``fourstep_sharded_fwd``).
    x: (B, n) uint32 in [0, 2q); output [0, q) times ``scale`` (default
    n^-1).  ``comm`` as in :func:`fourstep_sharded_fwd`."""
    return _run(x, plan, mesh, axis, dp_axis, comm,
                lambda grid: inv_grid(grid, plan, scale, comm))
