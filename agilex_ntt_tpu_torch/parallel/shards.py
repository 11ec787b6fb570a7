"""Shard layout of a (B, n) tensor over the dp and sp axes of a mesh.

The JAX package's mesh is single-controller: one process sees every device,
and a shard is a block of one global ``jax.Array``.  The port keeps that
model: a global (B, n) tensor is cut into a grid of blocks, ``grid[i][d]``
holding rows block i (the dp axis) and coefficient block d (the sp axis) on
the mesh device at dp = i, sp = d (every other mesh axis at 0).  An absent
axis counts as size 1.  The sharded transforms take and return such grids,
so a composition (``ShardedRing.polymul``) keeps each block on its device
between steps; ``split`` and ``join`` are the only moves to and from the
global tensor.

The residues (L, B, ..., n) of a sharded RNS ring add the channel axis
(ch): a channel grid ``grid[c][i][d]`` holds channel block c, rows block i
and coefficient block d on the mesh device at ch = c, dp = i, sp = d
(``split_channels``, ``join_channels``).

On a mesh of several processes (``make_mesh`` or ``multihost.pod_mesh`` in
a world of processes) each process holds the blocks of the positions it
owns (``Layout``): one or several, and, where the mesh has axes the grid
does not name, blocks that other processes hold too (the grid is
replicated over those axes, as JAX's ``shard_map`` replicates).  ``split``
and ``split_channels`` on the layout's ``devices`` cut those blocks and
leave the others None, the transforms run on them (SPMD: a row whose
shards are all in this process on the single-process route, the moves
between processes in ``comm.py``), and ``join`` and ``join_channels``
gather every block (``Layout.gather``), so that each process gets the
global tensor.

Data movement runs on int32 views of the uint32 words: PyTorch's CUDA
copies, ``cat`` and gathers cover int32 everywhere, and gloo refuses
``torch.uint32``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from . import comm

Grid = List[List[Optional[torch.Tensor]]]


def axis_size(mesh, axis: Optional[str]) -> int:
    return 1 if axis is None else mesh.shape[axis]


def grid_devices(mesh, dp_axis: Optional[str], sp_axis: Optional[str]):
    """devices[i][d]: the mesh device at dp = i, sp = d."""
    return [
        [
            mesh.device(**{a: c for a, c in ((dp_axis, i), (sp_axis, d)) if a})
            for d in range(axis_size(mesh, sp_axis))
        ]
        for i in range(axis_size(mesh, dp_axis))
    ]


def _nest(shape, fn, key=()):
    """Nested lists of ``fn(key)`` over every key of ``shape``."""
    if not shape:
        return fn(key)
    return [_nest(shape[1:], fn, key + (i,)) for i in range(shape[0])]


def _block(grid, key):
    """The block of a nested grid at ``key``."""
    for i in key:
        grid = grid[i]
    return grid


class Layout:
    """Where a grid's blocks live on a mesh of several processes.

    A block's key is its coordinates on the grid's axes ``axes`` (an axis
    None has size 1); the mesh's other axes replicate it, so that several
    positions, and several processes, may hold one block.  A process holds
    the block of every position it owns, once: ``held[r]`` maps each key
    rank r holds to its first position of that block (mesh coordinates),
    ``primary[key]`` is the owner of the block's first position, and
    ``devices`` is the grid of this process's devices (None where it holds
    nothing).  The last axis is the sp axis: a row is the blocks that
    differ only there, and ``mover(row)`` says how this process's shards of
    it meet the others."""

    def __init__(self, mesh, axes):
        self.mesh = mesh
        self.axes = tuple(axes)
        self.shape = tuple(axis_size(mesh, a) for a in self.axes)
        self.rank = mesh.rank
        self.group = mesh.process_group
        self.home = mesh.home
        names = mesh.axis_names
        self.index = tuple(None if a is None else names.index(a)
                           for a in self.axes)
        self.held = tuple({} for _ in range(int(mesh.owners.max()) + 1))
        self.primary = {}
        for pos in np.ndindex(*mesh.owners.shape):
            key = self.key_of(pos)
            owner = int(mesh.owners[pos])
            self.held[owner].setdefault(key, pos)
            self.primary.setdefault(key, owner)
        mine = self.held[self.rank]
        self.devices = _nest(self.shape, lambda k: (
            mesh.devices[mine[k]] if k in mine else None))
        # one position a process: every sp line's shards in distinct ranks
        self.one_each = mesh.owners.size == len(self.held)

    def key_of(self, pos) -> tuple:
        return tuple(0 if i is None else pos[i] for i in self.index)

    def row_holders(self, row: tuple) -> dict:
        """Every rank that holds a shard of ``row``: the shards it holds."""
        out = {}
        for r, mine in enumerate(self.held):
            got = sorted(k[-1] for k in mine if k[:-1] == row)
            if got:
                out[r] = got
        return out

    def mover(self, row: tuple, lines: bool = True):
        """How this process's shards of ``row`` meet the others: "skip"
        when it holds none, None when every process that holds a shard of
        the row holds all of them (the single-process route), a
        ``comm.Line`` when every shard is in a process of its own (one
        position a process; with ``lines``), else a ``Fetch``."""
        holders = self.row_holders(row)
        if self.rank not in holders:
            return "skip"
        size = self.shape[-1]
        if all(len(got) == size for got in holders.values()):
            return None
        if lines and self.one_each:
            (d,) = holders[self.rank]
            pos = self.held[self.rank][row + (d,)]
            sp = self.index[-1]
            ranks = tuple(int(self.mesh.owners[pos[:sp] + (e,) + pos[sp + 1:]])
                          for e in range(size))
            axis = self.axes[-1]
            return comm.Line(ranks, self.mesh.axis_groups[axis][ranks], d)
        return Fetch(self, row)

    def gather(self, grid) -> dict:
        """Every block of the grid by key, on ``home``: this process's held
        blocks, stacked, to every process by ``comm.all_gather`` (the
        stacks padded to the largest count), each block taken from its
        ``primary`` owner's stack."""
        keys = [sorted(mine) for mine in self.held]
        count = max(len(k) for k in keys)
        mine = [words(_block(grid, k)).to(self.home) for k in keys[self.rank]]
        mine += [torch.zeros_like(mine[0])] * (count - len(mine))
        stack = mine[0][None] if count == 1 else torch.stack(mine)
        got = comm.all_gather(u32(stack), self.group)
        return {key: got[r][keys[r].index(key)]
                for key, r in self.primary.items()}


class Fetch:
    """The moves of one sp row between processes that hold several of its
    shards, or hold them at different replicas: ``fetch(xs, want,
    payload)`` gives, for each shard d of ``xs`` this process holds, the
    list ``payload(x_e, d)`` for e in ``want(d)`` on d's device.  A shard
    e that d's process holds is read here; else it comes from the owner of
    the position that differs from d's only in its sp coordinate, e.
    Every process of the row computes the same list of moves, in one
    order, so the two ends of each agree (``comm.transfer``)."""

    def __init__(self, layout: Layout, row: tuple):
        self.layout = layout
        self.row = row

    def __call__(self, xs, want, payload) -> dict:
        lay = self.layout
        me, sp = lay.rank, lay.index[-1]
        moves = []
        for r, got in lay.row_holders(self.row).items():
            for d in got:
                pos = lay.held[r][self.row + (d,)]
                for e in want(d):
                    if e not in got:
                        src = pos[:sp] + (e,) + pos[sp + 1:]
                        moves.append((d, e, r, int(lay.mesh.owners[src])))
        moves.sort()
        sends = [(payload(xs[e], d), r, tag)
                 for tag, (d, e, r, s) in enumerate(moves) if s == me]
        recvs = [(tag, d, e, s) for tag, (d, e, r, s) in enumerate(moves)
                 if r == me]
        got = comm.transfer(sends,
                            [(payload(xs[d], d), s, tag)
                             for tag, d, e, s in recvs],
                            lay.group, lay.home)
        arrived = {(d, e): t for (_, d, e, _), t in zip(recvs, got)}

        def part(d, e):
            t = arrived.get((d, e))
            t = payload(xs[e], d) if t is None else t
            return u32(words(t).to(xs[d].device))

        return {d: [part(d, e) for e in want(d)]
                for d, x in enumerate(xs) if x is not None}


def layout(mesh, *axes) -> Optional[Layout]:
    """The ``Layout`` of the grid over ``axes`` (dp, sp; or ch, dp, sp)
    on ``mesh``; None on a single-process mesh."""
    return Layout(mesh, axes) if mesh.multiprocess else None


def words(x: torch.Tensor) -> torch.Tensor:
    """An int32 view of uint32 words (the same bytes)."""
    return x.view(torch.int32)


def u32(x: torch.Tensor) -> torch.Tensor:
    """A uint32 view of int32 words."""
    return x.view(torch.uint32)


def as_u32(x, device: torch.device, axis: int = 0) -> torch.Tensor:
    """x as a ``torch.uint32`` tensor on ``device``: a tensor, a numpy array,
    or a sequence of row blocks (``dp_shard_batch``), joined in order along
    the batch axis ``axis`` (1 for (L, B, n) residues)."""
    if isinstance(x, (list, tuple)):
        return u32(torch.cat([words(as_u32(b, device)) for b in x], dim=axis))
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.uint32, copy=True))
    return x.to(device=device, dtype=torch.uint32)


def pad_rows(x: torch.Tensor, multiple: int, axis: int = 0) -> torch.Tensor:
    """x with zero rows appended along ``axis`` (the batch axis: 0 for
    (B, n), 1 for (L, B, n)) up to a multiple of ``multiple`` rows."""
    pad = (-x.shape[axis]) % multiple
    if not pad:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    zeros = torch.zeros(shape, dtype=torch.int32, device=x.device)
    return u32(torch.cat([words(x), zeros], dim=axis))


def split(x: torch.Tensor, devices) -> Grid:
    """Cut (B, ..., n) into the grid of ``devices``: B must divide by the dp
    size, n by the sp size; each block contiguous on its device.  A device
    None (another process's block, ``Layout.devices``) leaves its block
    None."""
    rows = x.shape[0] // len(devices)
    cols = x.shape[-1] // len(devices[0])
    w = words(x)
    return [
        [
            None if dev is None else
            u32(w[i * rows:(i + 1) * rows, ..., d * cols:(d + 1) * cols]
                .to(dev).contiguous())
            for d, dev in enumerate(row)
        ]
        for i, row in enumerate(devices)
    ]


def join(grid: Grid, device: torch.device, rows: Optional[int] = None,
         layout: Optional[Layout] = None) -> torch.Tensor:
    """The global tensor of a grid on ``device``, its first ``rows`` rows
    (all by default).  With a ``layout`` every block arrives by
    ``Layout.gather``, and every process gets the global tensor."""
    if layout is not None:
        blocks = layout.gather(grid)
        grid = _nest(layout.shape, blocks.__getitem__)
    full = torch.cat(
        [torch.cat([words(b).to(device) for b in row], dim=-1) for row in grid],
        dim=0,
    )
    return u32(full if rows is None else full[:rows])


def channel_devices(mesh, ch_axis: Optional[str], dp_axis: Optional[str],
                    sp_axis: Optional[str]):
    """devices[c][i][d]: the mesh device at ch = c, dp = i, sp = d."""
    return [
        [
            [
                mesh.device(**{a: v for a, v in
                               ((ch_axis, c), (dp_axis, i), (sp_axis, d)) if a})
                for d in range(axis_size(mesh, sp_axis))
            ]
            for i in range(axis_size(mesh, dp_axis))
        ]
        for c in range(axis_size(mesh, ch_axis))
    ]


def split_channels(x: torch.Tensor, devices) -> List[Grid]:
    """Cut (L, B, ..., n) into the channel grid of ``devices``
    (``channel_devices``): block [c][i][d] holds channel block c, rows
    block i and coefficient block d, contiguous on its device.  L must
    divide by the ch size, B by the dp size, n by the sp size.  A device
    None (``Layout.devices``) leaves its block None."""
    chans = x.shape[0] // len(devices)
    rows = x.shape[1] // len(devices[0])
    cols = x.shape[-1] // len(devices[0][0])
    w = words(x)
    return [
        [
            [
                None if dev is None else
                u32(w[c * chans:(c + 1) * chans, i * rows:(i + 1) * rows, ...,
                      d * cols:(d + 1) * cols].to(dev).contiguous())
                for d, dev in enumerate(row)
            ]
            for i, row in enumerate(plane)
        ]
        for c, plane in enumerate(devices)
    ]


def join_channels(grid, device: torch.device, rows: Optional[int] = None,
                  layout: Optional[Layout] = None) -> torch.Tensor:
    """The global (L, B, ..., n) tensor of a channel grid on ``device``, its
    first ``rows`` rows (all by default).  With a ``layout`` every block
    arrives by ``Layout.gather``, and every process gets the global
    tensor: the blocks are of one shape (the batch padded to the dp size
    before the split; a mixing op's output channels are the same count in
    every block)."""
    if layout is not None:
        blocks = layout.gather(grid)
        grid = _nest(layout.shape, blocks.__getitem__)
    full = torch.cat([
        torch.cat([
            torch.cat([words(b).to(device) for b in row], dim=-1)
            for row in plane
        ], dim=1)
        for plane in grid
    ], dim=0)
    return u32(full if rows is None else full[:, :rows])


def map_channels(fn, *grids):
    """fn(c, *blocks) block by block over equally laid-out channel grids, c
    the channel block's index; a block that another process owns (None)
    stays None."""
    return [
        [[None if blocks[0] is None else fn(c, *blocks)
          for blocks in zip(*rows)] for rows in zip(*planes)]
        for c, planes in enumerate(zip(*grids))
    ]


def map_grid(fn, *grids: Grid) -> Grid:
    """fn applied block by block to equally laid-out grids; a block that
    another process owns (None) stays None."""
    return [[None if blocks[0] is None else fn(*blocks)
             for blocks in zip(*rows)] for rows in zip(*grids)]


def tables_on(tables, device: torch.device):
    """A table bundle (``RingTables``, ``FourStepTables``) with every
    tensor copied to ``device``."""
    if isinstance(tables, torch.Tensor):
        return tables.to(device)
    if dataclasses.is_dataclass(tables):
        return dataclasses.replace(tables, **{
            f.name: tables_on(getattr(tables, f.name), device)
            for f in dataclasses.fields(tables) if f.init
        })
    return tables


def check_divides(shape, dim: int, size: int, axis: str) -> None:
    """Raise as a placement on a mesh does when ``size`` (the ``axis`` axis)
    does not divide dimension ``dim`` of ``shape``."""
    if shape[dim] % size:
        raise ValueError(
            f"shard: the global size of dimension {dim} should be divisible "
            f"by {size} (the {axis!r} axis), but it is equal to {shape[dim]} "
            f"(full shape: {tuple(shape)})"
        )


def check_batch(x: torch.Tensor, dp: int, what: str) -> None:
    if x.shape[0] % dp:
        raise ValueError(
            f"{what}: batch {x.shape[0]} does not divide over {dp} dp shards"
        )

