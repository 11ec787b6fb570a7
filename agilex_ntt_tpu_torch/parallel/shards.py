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

On a mesh of several processes (``multihost.pod_mesh``) each process owns
one block of a grid (``Layout``; ``channel_layout`` for a channel grid,
whose channel axis is then whole): ``split`` and ``split_channels`` keep
that block and leave the others None, the transforms run on it alone
(SPMD, the moves in ``comm.py``), and ``join`` and ``join_channels``
gather every process's block, so that each process gets the global
tensor.

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


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a grid's blocks live on a mesh of several processes:
    ``owners[i][d]`` is the rank that owns block [i][d], ``position`` the
    block of this process, ``group`` the group of every process, and
    ``line`` the sp group of this process's dp row (``comm.Line``; None
    without an sp axis)."""

    owners: tuple
    position: tuple
    group: object
    line: Optional[comm.Line]


def grid_layout(mesh, dp_axis: Optional[str],
                sp_axis: Optional[str]) -> Optional[Layout]:
    """The ``Layout`` of the grid of ``grid_devices(mesh, dp_axis,
    sp_axis)``; None on a single-process mesh.  Each process must own
    exactly one block of the grid (the axes span every process)."""
    if not mesh.multiprocess:
        return None
    owners = tuple(
        tuple(int(mesh.owners[tuple({dp_axis: i, sp_axis: d}.get(a, 0)
                                    for a in mesh.axis_names)])
              for d in range(axis_size(mesh, sp_axis)))
        for i in range(axis_size(mesh, dp_axis)))
    flat = sorted(r for row in owners for r in row)
    if flat != list(range(mesh.owners.size)):
        several = sorted({r for r in flat if flat.count(r) > 1})
        raise ValueError(
            f"on a mesh of {mesh.owners.size} positions the sharded axes "
            f"({dp_axis!r}, {sp_axis!r}) must give each process one block; "
            f"they give the ranks {flat}"
            + (f" (ranks {several} own several positions)" if several
               else ""))
    i, d = next((i, row.index(mesh.rank)) for i, row in enumerate(owners)
                if mesh.rank in row)
    line = None
    if sp_axis is not None:
        line = comm.Line(owners[i], mesh.axis_groups[sp_axis][owners[i]], d)
    return Layout(owners, (i, d), mesh.process_group, line)


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


def split(x: torch.Tensor, devices,
          layout: Optional[Layout] = None) -> Grid:
    """Cut (B, ..., n) into the grid of ``devices``: B must divide by the dp
    size, n by the sp size; each block contiguous on its device.  With a
    ``layout`` only this process's block is cut, the others are None."""
    rows = x.shape[0] // len(devices)
    cols = x.shape[-1] // len(devices[0])
    w = words(x)
    return [
        [
            u32(w[i * rows:(i + 1) * rows, ..., d * cols:(d + 1) * cols]
                .to(dev).contiguous())
            if layout is None or layout.position == (i, d) else None
            for d, dev in enumerate(row)
        ]
        for i, row in enumerate(devices)
    ]


def join(grid: Grid, device: torch.device, rows: Optional[int] = None,
         layout: Optional[Layout] = None) -> torch.Tensor:
    """The global tensor of a grid on ``device``, its first ``rows`` rows
    (all by default).  With a ``layout`` every process's block arrives by
    ``comm.all_gather``, and every process gets the global tensor."""
    if layout is not None:
        i, d = layout.position
        got = comm.all_gather(grid[i][d], layout.group)
        grid = [[got[r] for r in row] for row in layout.owners]
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


def channel_layout(mesh, dp_axis: Optional[str],
                   sp_axis: Optional[str]) -> Optional[Layout]:
    """The ``Layout`` of a channel grid ``channel_devices(mesh, None,
    dp_axis, sp_axis)`` (one channel block, c = 0): ``owners[0][i][d]``,
    ``position`` (0, i, d).  None on a single-process mesh; as
    ``grid_layout``, each process must own exactly one block."""
    layout = grid_layout(mesh, dp_axis, sp_axis)
    if layout is None:
        return None
    return Layout((layout.owners,), (0,) + layout.position, layout.group,
                  layout.line)


def split_channels(x: torch.Tensor, devices,
                   layout: Optional[Layout] = None) -> List[Grid]:
    """Cut (L, B, ..., n) into the channel grid of ``devices``
    (``channel_devices``): block [c][i][d] holds channel block c, rows
    block i and coefficient block d, contiguous on its device.  L must
    divide by the ch size, B by the dp size, n by the sp size.  With a
    ``layout`` (``channel_layout``) only this process's block is cut, the
    others are None."""
    chans = x.shape[0] // len(devices)
    rows = x.shape[1] // len(devices[0])
    cols = x.shape[-1] // len(devices[0][0])
    w = words(x)
    return [
        [
            [
                u32(w[c * chans:(c + 1) * chans, i * rows:(i + 1) * rows, ...,
                      d * cols:(d + 1) * cols].to(dev).contiguous())
                if layout is None or layout.position == (c, i, d) else None
                for d, dev in enumerate(row)
            ]
            for i, row in enumerate(plane)
        ]
        for c, plane in enumerate(devices)
    ]


def join_channels(grid, device: torch.device, rows: Optional[int] = None,
                  layout: Optional[Layout] = None) -> torch.Tensor:
    """The global (L, B, ..., n) tensor of a channel grid on ``device``, its
    first ``rows`` rows (all by default).  With a ``layout`` every
    process's block arrives by ``comm.all_gather`` over the group of every
    process, and every process gets the global tensor: the blocks are of
    one shape (the batch padded to the dp size before the split; a mixing
    op's output channels are the same count in every block)."""
    if layout is not None:
        c, i, d = layout.position
        got = comm.all_gather(grid[c][i][d], layout.group)
        grid = [[[got[r] for r in row] for row in plane]
                for plane in layout.owners]
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

