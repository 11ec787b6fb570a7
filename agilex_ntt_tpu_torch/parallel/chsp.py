"""Channel x coefficient sharding: RNS four-step transforms on a (ch, sp[,
dp]) mesh, the L x large-n shape.

Counterpart of ``agilex_ntt_tpu/parallel/chsp.py``: ``fourstep_shard.py``'s
bodies rewritten over a block of prime channels.  Residues (L, B, n) are
cut into a channel grid (``shards.split_channels``): the device at ch = c,
dp = i, sp = d holds channels block c, rows block i and n/P contiguous
coefficients, which are n1/P whole rows of each channel's (n1, n2)
four-step matrix.  Per (c, i) sp group the forward transform

  * copies rows -> columns between the group's devices (the JAX package's
    all-to-all over sp; the channel axis never moves),
  * runs the size-n1 negacyclic column transforms of every channel of the
    block in one K4a launch on the stacked column tables,
  * multiplies by each channel's column slice of the inter-pass twiddle
    (the lazy Shoup product, int64 PyTorch as JAX leaves it to XLA),
  * copies columns -> rows back and runs the size-n2 cyclic row transforms
    in one K4a launch on the stacked row tables.

The inverse runs the same steps backwards on K4b: the row tables carry
n2^-1 and the column pass the rest of the scale, scale * n2 mod q (so a
polymul's Montgomery R folds into the column pass).  Outputs are
bit-identical to each channel's single-device four-step transform.

On a mesh of several processes ``fwd_grid``/``inv_grid`` take the channel
grid's ``shards.Layout``: each process runs the passes of the blocks it
holds, an sp group whose shards are all in this process as above, and
the retiles of any other group through ``shards.Fetch`` (the parts of
the group's other processes sent point to point, ``comm.transfer``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ..ops import modmul as mm
from ..ops import ntt_kernel as K
from ..ops.fourstep import FourStepPlan
from ..ops.plain_ntt import make_rns_tables
from . import fourstep_shard, shards

# the smallest n1 and n2 the JAX package's channel-grid pass kernels take
MIN_PASS_N = 128


def check_plans(plans: Tuple[FourStepPlan, ...], mesh, ch_axis: str,
                sp_axis: str) -> None:
    n1, n2 = plans[0].n1, plans[0].n2
    if any((p.n1, p.n2) != (n1, n2) for p in plans):
        raise ValueError("all channels must share the (n1, n2) split")
    Psp = mesh.shape[sp_axis]
    if n1 % Psp or n2 % Psp:
        raise ValueError(
            f"four-step sharding needs P | n1 and P | n2: "
            f"P={Psp}, n1={n1}, n2={n2}"
        )
    if len(plans) % mesh.shape[ch_axis]:
        raise ValueError(
            f"the ch axis size ({mesh.shape[ch_axis]}) must divide "
            f"L={len(plans)} (whole channels per device)"
        )
    if n1 < MIN_PASS_N or n2 < MIN_PASS_N:
        raise ValueError(
            f"channel-grid pass kernels need n1, n2 >= {MIN_PASS_N}; "
            f"got ({n1}, {n2})"
        )


# -- a channel block's tables on one device (cached) ---------------------------


@functools.lru_cache(maxsize=64)
def _tables(plans: Tuple[FourStepPlan, ...], device):
    """The block's column and row ``RNSTables`` (the stacked
    ``FourStepTables.col`` and ``.row`` of its channels) and its moduli as
    an int64 (Lc, 1, 1, 1) column, on ``device``."""
    fts = [fourstep_shard._tables(p, device) for p in plans]
    col = make_rns_tables([ft.col for ft in fts])
    row = make_rns_tables([ft.row for ft in fts])
    q = torch.tensor([p.q for p in plans], dtype=torch.int64,
                     device=device).view(-1, 1, 1, 1)
    return col, row, q


@functools.lru_cache(maxsize=256)
def _twiddle_cols(plans: Tuple[FourStepPlan, ...], num_devices: int, d: int,
                  inverse: bool, device):
    """Shard d's (Lc, 1, n1, n2/P) slices of every channel's T (or T^-1)
    and their precons, int64."""
    cols = [fourstep_shard._twiddle_cols(p, num_devices, d, inverse, device)
            for p in plans]
    w = torch.stack([c[0] for c in cols]).unsqueeze(1)
    p = torch.stack([c[1] for c in cols]).unsqueeze(1)
    return w, p


def _twiddle(m: torch.Tensor, plans, P: int, d: int, inverse: bool):
    """The lazy Shoup product of (Lc, B, n1, n2/P) words with shard d's
    slice of each channel's T (T^-1), [0, 2q)."""
    w, p = _twiddle_cols(plans, P, d, inverse, m.device)
    q = _tables(plans, m.device)[2]
    return mm.shoup_mulmod_lazy(m.to(torch.int64), w, p, q).to(torch.uint32)


def _columns(m: torch.Tensor) -> torch.Tensor:
    """(Lc, B, n1, c) -> (Lc, B c, n1): each column as a contiguous row."""
    lc, b, n1, c = m.shape
    return shards.u32(
        shards.words(m).transpose(2, 3).reshape(lc, b * c, n1).contiguous()
    )


def _uncolumns(y: torch.Tensor, b: int, c: int) -> torch.Tensor:
    """(Lc, B c, n1) -> (Lc, B, n1, c)."""
    lc = y.shape[0]
    return shards.u32(shards.words(y).view(lc, b, c, -1).transpose(2, 3))


# -- one sp group of a channel block ---------------------------------------------


def fwd_group(xs, plans: Tuple[FourStepPlan, ...], fetch=None):
    """Forward four-step NTT of the P coefficient shards ``xs`` of one sp
    group of a channel block, each (Lc, B, n/P) uint32, channel l in
    [0, 4 q_l), on its device -> [0, q_l).  With a ``shards.Fetch`` only
    this process's shards are here (the others None), and the retiles'
    parts of the others come through it."""
    P = len(xs)
    here = [d for d, x in enumerate(xs) if x is not None]
    lc, b, _ = xs[here[0]].shape
    n1, n2 = plans[0].n1, plans[0].n2
    n1p, n2p = n1 // P, n2 // P
    cols = fourstep_shard._rows_to_cols(
        [None if x is None else x.view(lc, b, n1p, n2) for x in xs], n2p,
        fetch)
    mids = [None] * P
    for d in here:
        col = _tables(plans, xs[d].device)[0]
        yc = K.fwd_ntt_rns(_columns(cols(d)), col)
        mids[d] = _twiddle(_uncolumns(yc, b, n2p), plans, P, d, False)
    rows = fourstep_shard._cols_to_rows(mids, n1p, fetch)
    outs = [None] * P
    for d in here:
        row = _tables(plans, xs[d].device)[1]
        outs[d] = K.fwd_ntt_rns(rows(d).reshape(lc, b * n1p, n2), row
                                ).view(lc, b, n1p * n2)
    return outs


def inv_group(ys, plans: Tuple[FourStepPlan, ...], scales: Tuple[int, ...],
              fetch=None):
    """Inverse four-step NTT of the P shards ``ys`` (channel l in
    [0, 2 q_l)), channel l times ``scales[l]`` -> [0, q_l).  ``fetch`` as
    in :func:`fwd_group`."""
    P = len(ys)
    here = [d for d, y in enumerate(ys) if y is not None]
    lc, b, _ = ys[here[0]].shape
    n1, n2 = plans[0].n1, plans[0].n2
    n1p, n2p = n1 // P, n2 // P
    # the row pass carries n2^-1 (its tables' own scale), the column pass
    # the rest: scale * n2
    col_scales = tuple(s * p.n2 % p.q for p, s in zip(plans, scales))
    ms = [None] * P
    for d in here:
        row = _tables(plans, ys[d].device)[1]
        ms[d] = K.inv_ntt_rns(ys[d].view(lc, b * n1p, n2), row
                              ).view(lc, b, n1p, n2)
    cols = fourstep_shard._rows_to_cols(ms, n2p, fetch)
    cms = [None] * P
    for d in here:
        col = _tables(plans, ys[d].device)[0]
        mu = _twiddle(cols(d), plans, P, d, True)
        c = K.inv_ntt_rns(_columns(mu), col, scales=col_scales)
        cms[d] = _uncolumns(c, b, n2p)
    rows = fourstep_shard._cols_to_rows(cms, n1p, fetch)
    return [None if ys[d] is None else rows(d).reshape(lc, b, n1p * n2)
            for d in range(P)]


def _block_plans(plans, num_blocks: int):
    """The plans of each channel block: whole channels a block, in order."""
    per = len(plans) // num_blocks
    return [tuple(plans[c * per:(c + 1) * per]) for c in range(num_blocks)]


def _groups(grid, layout, body):
    """``body(group, c, fetch)`` on every sp group ``grid[c][i]`` that this
    process holds a shard of; ``fetch``: None when every shard of the
    group is here, else its ``shards.Fetch`` (``Layout.mover``)."""
    out = []
    for c, plane in enumerate(grid):
        row = []
        for i, g in enumerate(plane):
            how = None if layout is None else layout.mover((c, i),
                                                           lines=False)
            row.append(g if how == "skip" else body(g, c, how))
        out.append(row)
    return out


def fwd_grid(grid, plans: Tuple[FourStepPlan, ...], layout=None):
    """``fwd_group`` on every sp group of a channel grid (``grid[c][i]`` is
    the sp group of channel block c, rows block i); ``layout``: the grid's
    ``shards.Layout`` on a mesh of several processes."""
    per = _block_plans(plans, len(grid))
    return _groups(grid, layout, lambda g, c, f: fwd_group(g, per[c], f))


def inv_grid(grid, plans: Tuple[FourStepPlan, ...],
             scales: Optional[Tuple[int, ...]] = None, layout=None):
    """``inv_group`` on every sp group of a channel grid; ``scales`` (one a
    channel of the whole ring) default to n^-1 mod q_l.  ``layout`` as in
    :func:`fwd_grid`."""
    if scales is None:
        scales = tuple(p.n_inv for p in plans)
    per = _block_plans(plans, len(grid))
    per_s = _block_plans(tuple(scales), len(grid))
    return _groups(grid, layout,
                   lambda g, c, f: inv_group(g, per[c], per_s[c], f))


# -- public entry points ---------------------------------------------------------


def _run(x, plans, mesh, ch_axis, sp_axis, dp_axis, body):
    check_plans(plans, mesh, ch_axis, sp_axis)
    devices = shards.channel_devices(mesh, ch_axis, dp_axis, sp_axis)
    x = shards.as_u32(x, devices[0][0][0])
    if x.dim() != 3 or x.shape[0] != len(plans) or x.shape[-1] != plans[0].n:
        raise ValueError(
            f"expected (L={len(plans)}, B, n={plans[0].n}), got "
            f"{tuple(x.shape)}"
        )
    if dp_axis is not None:
        shards.check_divides(x.shape, 1, len(devices[0]), dp_axis)
    out = body(shards.split_channels(x, devices))
    return shards.join_channels(out, devices[0][0][0])


def chsp_fwd(
    x,
    plans: Tuple[FourStepPlan, ...],
    mesh,
    *,
    ch_axis: str = "ch",
    sp_axis: str = "sp",
    dp_axis: Optional[str] = None,
) -> torch.Tensor:
    """Forward RNS four-step NTT, channels over ch_axis, coefficients over
    sp_axis, batch optionally over dp_axis.  x: (L, B, n) uint32 in
    [0, 4q_l) per channel; output [0, q_l) on the mesh's first device,
    bit-identical per channel to the single-device four-step transform."""
    plans = tuple(plans)
    return _run(x, plans, mesh, ch_axis, sp_axis, dp_axis,
                lambda grid: fwd_grid(grid, plans))


def chsp_inv(
    y,
    plans: Tuple[FourStepPlan, ...],
    mesh,
    *,
    ch_axis: str = "ch",
    sp_axis: str = "sp",
    dp_axis: Optional[str] = None,
    scales: Optional[Tuple[int, ...]] = None,
) -> torch.Tensor:
    """Inverse (sharding as chsp_fwd).  y: (L, B, n) in [0, 2q_l); output
    [0, q_l).  scales: per-channel overall multipliers (default n^-1 mod
    q_l; polymul folds the Montgomery R in)."""
    plans = tuple(plans)
    return _run(y, plans, mesh, ch_axis, sp_axis, dp_axis,
                lambda grid: inv_grid(grid, plans, scales))
