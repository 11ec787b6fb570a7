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

On a mesh of several processes ``fwd_grid`` and ``inv_grid`` take the
grid's ``shards.Layout`` and run SPMD on this process's shards, each sp
group by ``Layout.mover``.  A group whose shards are all in this process
runs as above.  In a group of one shard a process: the column pass (K1 on
the column tables), its slice of the twiddle and the row pass as above,
the two retiles an ``all_to_all`` each over the sp group
(``comm.all_to_all``); with ``"overlap"`` the chunks' retiles are posted
ahead: every chunk's first retile at once, then each chunk's second as
soon as its column pass is done, so that a chunk's retile is on the wire
while the next chunk computes.  Otherwise the bodies run on this
process's shards, each retile's parts read here or brought by
``shards.Fetch`` (whole batch, no chunks).
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


def _parts(ms, cut, fetch=None):
    """The parts of a retile of the shards ``ms`` of one sp group (None
    where another process holds the shard): ``parts(d)`` lists
    ``cut(m_e, d)`` for every shard e, in order, on shard d's device.
    Without ``fetch`` every shard is here and each part is cut when asked
    for; with a ``shards.Fetch`` every part of this process's shards moves
    at once."""
    if fetch is None:
        return lambda d: [shards.words(cut(m, d)).to(ms[d].device) for m in ms]
    return fetch(ms, lambda d: range(len(ms)), cut).__getitem__


def _joined(parts, dim: int) -> torch.Tensor:
    """A retile's parts joined along ``dim``."""
    return shards.u32(torch.cat([shards.words(t) for t in parts], dim=dim))


def _rows_to_cols(ms, n2p: int, fetch=None):
    """Each shard's columns from every shard's (B, n1/P, n2) rows block:
    (B, n1, n2/P) on the shard's device, by shard."""
    parts = _parts(ms, lambda m, d: m[..., d * n2p:(d + 1) * n2p], fetch)
    return lambda d: _joined(parts(d), -2)


def _cols_to_rows(ms, n1p: int, fetch=None):
    """Each shard's rows from every shard's (B, n1, n2/P) columns block:
    (B, n1/P, n2) on the shard's device, by shard."""
    parts = _parts(ms, lambda m, d: m[..., d * n1p:(d + 1) * n1p, :], fetch)
    return lambda d: _joined(parts(d), -1)


def _columns(m: torch.Tensor) -> torch.Tensor:
    """(B, n1, c) -> (B c, n1): each column as a contiguous row."""
    b, n1, c = m.shape
    return shards.u32(shards.words(m).transpose(1, 2).reshape(b * c, n1).contiguous())


def _uncolumns(y: torch.Tensor, b: int, c: int) -> torch.Tensor:
    """(B c, n1) -> (B, n1, c)."""
    return shards.u32(shards.words(y).view(b, c, -1).transpose(1, 2))


def _fwd_body(xs, plan: FourStepPlan, fetch=None):
    """The forward transform of one sp group's shards ``xs``; with a
    ``shards.Fetch`` of the shards here (the others None)."""
    P = len(xs)
    here = [d for d, x in enumerate(xs) if x is not None]
    b = xs[here[0]].shape[0]
    n1, n2 = plan.n1, plan.n2
    n1p, n2p = n1 // P, n2 // P
    cols = _rows_to_cols([None if x is None else x.view(b, n1p, n2)
                          for x in xs], n2p, fetch)
    mids = [None] * P
    for d in here:
        ft = _tables(plan, xs[d].device)
        yc = K.fwd_ntt(_columns(cols(d)), ft.col)
        mids[d] = _twiddle(_uncolumns(yc, b, n2p), plan, P, d, False)
    rows = _cols_to_rows(mids, n1p, fetch)
    outs = [None] * P
    for d in here:
        ft = _tables(plan, xs[d].device)
        outs[d] = K.fwd_ntt(rows(d).reshape(b * n1p, n2), ft.row
                            ).view(b, n1p * n2)
    return outs


def _inv_body(ys, plan: FourStepPlan, scale: int, fetch=None):
    """The inverse of ``_fwd_body`` times ``scale``."""
    P = len(ys)
    here = [d for d, y in enumerate(ys) if y is not None]
    b = ys[here[0]].shape[0]
    n1, n2 = plan.n1, plan.n2
    n1p, n2p = n1 // P, n2 // P
    ms = [None] * P
    for d in here:
        ft = _tables(plan, ys[d].device)
        ms[d] = K.inv_ntt(ys[d].view(b * n1p, n2), ft.row).view(b, n1p, n2)
    cols = _rows_to_cols(ms, n2p, fetch)
    cms = [None] * P
    for d in here:
        ft = _tables(plan, ys[d].device)
        mu = _twiddle(cols(d), plan, P, d, True)
        c = K.inv_ntt(_columns(mu), ft.col, scale=ft.col_scale(scale))
        cms[d] = _uncolumns(c, b, n2p)
    rows = _cols_to_rows(cms, n1p, fetch)
    return [None if ys[d] is None else rows(d).reshape(b, n1p * n2)
            for d in range(P)]


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


def _by_row(grid, layout, local, line, fetched):
    """Each sp group (dp row) of a grid by its ``Layout.mover``:
    ``local(row)`` when every shard is here (always without a ``layout``),
    ``line(x, line)`` on this process's shard of a row of one shard a
    process, ``fetched(row, fetch)`` otherwise."""
    out = []
    for i, row in enumerate(grid):
        how = None if layout is None else layout.mover((i,))
        if how == "skip":
            out.append(row)
        elif how is None:
            out.append(local(row))
        elif isinstance(how, transport.Line):
            out.append([None if x is None else line(x, how) for x in row])
        else:
            out.append(fetched(row, how))
    return out


def fwd_grid(grid, plan: FourStepPlan, comm: str = "ppermute", layout=None):
    """``fwd_group`` on every sp group (dp row) of a grid; ``layout``: the
    grid's ``shards.Layout`` on a mesh of several processes."""
    _check_call(plan, len(grid[0]), comm)
    return _by_row(grid, layout, lambda r: fwd_group(r, plan, comm),
                   lambda x, line: _fwd_line(x, line, plan, comm),
                   lambda r, fetch: _fwd_body(r, plan, fetch))


def inv_grid(grid, plan: FourStepPlan, scale: Optional[int] = None,
             comm: str = "ppermute", layout=None):
    """``inv_group`` on every sp group of a grid; scale defaults to n^-1.
    ``layout`` as in :func:`fwd_grid`."""
    _check_call(plan, len(grid[0]), comm)
    scale = plan.n_inv if scale is None else scale
    return _by_row(grid, layout, lambda r: inv_group(r, plan, scale, comm),
                   lambda y, line: _inv_line(y, line, plan, scale, comm),
                   lambda r, fetch: _inv_body(r, plan, scale, fetch))


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
