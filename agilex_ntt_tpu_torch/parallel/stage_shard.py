"""Stage-sharded (coefficient-parallel) NTT across a mesh axis.

Counterpart of ``agilex_ntt_tpu/parallel/stage_shard.py``.  The coefficient
axis is sharded over P = ``mesh.shape[axis]`` devices, S = n / P words a
shard.  Forward stages run in HEXL order, t = n/2 -> 1:

  * t >= S (the first log2 P stages): the butterfly partner of shard d lives
    on shard d XOR t/S.  Each shard computes its half of every butterfly
    from its own words and its partner's (K11, ``ntt_kernel.xchg_group``):
    the same math as one card, with the u/v role one scalar a shard and the
    twiddle one value a butterfly pair and stage.
  * t < S: purely local.  For shard d these are an S-point transform whose
    table is roots'[m' + i'] = roots[(P + d) m' + i'] (m' = 2^(s - log2 P)),
    so they run on the transform kernel K1 with derived per-shard tables
    (built once per shard and device: ``_shard_tables`` is cached).

The inverse mirrors this: local Gentleman-Sande stages first on K2 with the
per-shard inverse tables (K2's last stage is then scaled by 1 and
inv_roots[P + d]), then the log2 P cross stages on K11, the last of which
folds the final scale (default n^-1) and reduces to [0, q).  Outputs are
bit-identical to the single-device kernels: every stage computes the same
values mod q, and the last step reduces them to [0, q).

``comm="ppermute"`` copies the partner's whole shard to the shard's own
device (``copy_``, the collective) and then runs K11 on the copies, each
shard writing its own half, one launch a stage for the shards of each
device (the whole sp group when it sits on one card);
``comm="overlap"`` reads the partner's shard in place: on one card one
launch a stage, one entry a butterfly pair, across cards one launch a
card (``overlap.py``).

Every function here is single-controller, as the JAX package's: one process
drives every device of the mesh.  ``fwd_grid``/``inv_grid`` transform a
grid of shards (``shards.py``) and leave each block on its device;
``stage_sharded_fwd``/``stage_sharded_inv`` take and return the global
(B, n) tensor.  On a mesh of several processes ``fwd_grid``/``inv_grid``
take the grid's ``shards.Layout`` and run SPMD on this process's shards,
each sp group (dp row) by ``Layout.mover``: a row whose shards are all in
this process as above; a row of one shard a process, the partner's shard
arriving from its process (``comm.exchange``, then one K11 launch a
stage; with ``"overlap"`` chunk by chunk, ``overlap.xchg_remote``); else
each shard's partner read here or brought by ``shards.Fetch``, then one
K11 launch a stage for this process's shards of each card.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..ops import ntt_kernel as K
from ..ops.plain_ntt import RingTables, _u32_tensor
from ..ops.modmul import mont_qinv_neg
from . import comm as transport
from . import overlap, shards

COMMS = ("ppermute", "overlap")


def _log2(v: int) -> int:
    return v.bit_length() - 1


@functools.lru_cache(maxsize=256)
def _shard_tables(params, num_devices: int, d: int, device) -> RingTables:
    """The S-point tables of shard d's local stages (forward and inverse):
    roots'[m' + i'] = roots[(P + d) m' + i'], the same index for inv_roots."""
    n, q = params.n, params.q
    S = n // num_devices
    idx = np.zeros(S, dtype=np.int64)
    m = 1
    while m < S:
        idx[m:2 * m] = (num_devices + d) * m + np.arange(m)
        m *= 2
    return RingTables(
        n=S, log_n=_log2(S), q=q, n_inv=params.n_inv,
        qinv_neg=mont_qinv_neg(q),
        polymul_scale=params.n_inv * ((1 << 32) % q) % q,
        inv_root1=int(params.inv_roots32[idx[1]]) if S > 1 else 1,
        roots=_u32_tensor(params.roots32[idx], device),
        precon=_u32_tensor(params.precon32[idx], device),
        inv_roots=_u32_tensor(params.inv_roots32[idx], device),
        inv_precon=_u32_tensor(params.inv_precon32[idx], device),
    )


@functools.lru_cache(maxsize=1024)
def _cross_row(params, index: int, width: int, inverse: bool, device):
    """The positional twiddle row of a cross stage: one table entry, the
    same at every position of the shard, with its Shoup precon."""
    w = params.inv_roots32 if inverse else params.roots32
    p = params.inv_precon32 if inverse else params.precon32
    return (_u32_tensor(np.full(width, w[index]), device),
            _u32_tensor(np.full(width, p[index]), device))


def _check(params, num_devices: int, comm: str) -> None:
    if params.n % (128 * num_devices):
        raise ValueError(
            f"n={params.n} must give lane-aligned shards over {num_devices} devices"
        )
    if comm not in COMMS:
        raise ValueError(f"unknown comm {comm!r}")


def _cross_stage(xs, params, *, inverse, tdev, a_log, index_of, last, scale,
                 comm, line=None):
    """One cross stage over the P shards ``xs`` of one sp group; returns the
    new shards.  With ``line`` (a ``comm.Line``) only this process's shard
    is here (the others None) and its partner arrives from its process;
    with a ``shards.Fetch`` this process's shards are here and each
    partner is read here or fetched."""
    def row(d):
        return _cross_row(params, index_of(d), xs[d].shape[1], inverse,
                          xs[d].device)

    def role(d):
        return ((d >> a_log) & 1) == 0

    kw = dict(fwd=not inverse, q=params.q, last=last, scale=scale)
    if isinstance(line, shards.Fetch):
        here = [d for d, x in enumerate(xs) if x is not None]
        got = line(xs, lambda d: (d ^ tdev,), lambda x, d: x)
        new = overlap.launch_by_device(
            [xs[d] for d in here], [got[d][0] for d in here],
            [row(d) for d in here], [role(d) for d in here], **kw)
        out = [None] * len(xs)
        for d, y in zip(here, new):
            out[d] = y
        return out
    if line is not None:
        d = line.index
        out = [None] * len(xs)
        if comm == "overlap":
            out[d] = overlap.xchg_remote(xs[d], line, d ^ tdev, row(d),
                                         role(d), **kw)
        else:
            recv = transport.exchange(xs[d], d ^ tdev, line)
            out[d] = overlap.launch_by_device([xs[d]], [recv], [row(d)],
                                              [role(d)], **kw)[0]
        return out
    rows = [row(d) for d in range(len(xs))]
    roles = [role(d) for d in range(len(xs))]
    if comm == "overlap":
        return overlap.xchg_stage(xs, rows, roles, tdev=tdev, **kw)
    # last shard first: the launch takes its entries in order, so the first
    # entries find their copies still in L2
    recvs = [None] * len(xs)
    for d in reversed(range(len(xs))):
        recvs[d] = transport.exchange(xs[d], xs[d ^ tdev])
    return overlap.launch_by_device(xs, recvs, rows, roles, **kw)


def _local(xs, transform):
    """``transform(x, d)`` on every shard here; the others stay None."""
    return [None if x is None else transform(x, d) for d, x in enumerate(xs)]


def fwd_group(xs, params, comm: str = "ppermute", line=None):
    """Forward NTT of the P coefficient shards ``xs`` (each (B, S) uint32 in
    [0, 4q), shard d on its device) -> the P output shards in [0, q).
    With ``line`` (``Layout.mover``'s ``comm.Line`` or ``shards.Fetch``)
    only this process's shards are here (the others None) and the others
    are in other processes."""
    P = len(xs)
    n_cross = _log2(P)
    for s in range(n_cross):
        tdev = P >> (s + 1)  # t / S
        xs = _cross_stage(
            xs, params, inverse=False, tdev=tdev, a_log=_log2(tdev),
            index_of=lambda d, s=s: (1 << s) + (d >> (n_cross - s)),
            last=False, scale=None, comm=comm, line=line,
        )
    return _local(xs, lambda x, d: K.fwd_ntt(
        x, _shard_tables(params, P, d, x.device)))


def inv_group(xs, params, scale: int, comm: str = "ppermute", line=None):
    """Inverse NTT of the P shards ``xs`` (each (B, S) uint32 in [0, 2q))
    times ``scale`` -> [0, q).  ``line`` as in :func:`fwd_group`."""
    P = len(xs)
    n = params.n
    n_cross = _log2(P)
    n_local = _log2(n) - n_cross
    # K2's last stage carries the scale: 1 when a cross stage follows
    local_scale = 1 if n_cross else scale
    xs = _local(xs, lambda x, d: K.inv_ntt(
        x, _shard_tables(params, P, d, x.device), scale=local_scale))
    for s in range(n_local, n_local + n_cross):
        tdev = 1 << (s - n_local)  # t / S
        xs = _cross_stage(
            xs, params, inverse=True, tdev=tdev, a_log=_log2(tdev),
            index_of=lambda d, s=s: (n >> (s + 1)) + (d >> (s - n_local + 1)),
            last=s == n_local + n_cross - 1, scale=scale, comm=comm,
            line=line,
        )
    return xs


def _movers(grid, layout):
    """Each sp group's ``Layout.mover`` (None: every shard here)."""
    if layout is None:
        return [None] * len(grid)
    return [layout.mover((i,)) for i in range(len(grid))]


def fwd_grid(grid, params, comm: str = "ppermute", layout=None):
    """``fwd_group`` on every sp group (dp row) of a grid; ``layout``: the
    grid's ``shards.Layout`` on a mesh of several processes."""
    _check(params, len(grid[0]), comm)
    return [row if how == "skip" else fwd_group(row, params, comm, how)
            for row, how in zip(grid, _movers(grid, layout))]


def inv_grid(grid, params, scale: Optional[int] = None, comm: str = "ppermute",
             layout=None):
    """``inv_group`` on every sp group of a grid; scale defaults to n^-1.
    ``layout`` as in :func:`fwd_grid`."""
    _check(params, len(grid[0]), comm)
    scale = params.n_inv if scale is None else scale
    return [row if how == "skip" else inv_group(row, params, scale, comm, how)
            for row, how in zip(grid, _movers(grid, layout))]


def _run(x, params, mesh, axis, dp_axis, comm, body):
    P = mesh.shape[axis]
    _check(params, P, comm)
    devices = shards.grid_devices(mesh, dp_axis, axis)
    x = shards.as_u32(x, devices[0][0])
    if x.dim() != 2 or x.shape[-1] != params.n:
        raise ValueError(f"expected (B, n={params.n}), got {tuple(x.shape)}")
    shards.check_batch(x, len(devices), "stage-sharded transform")
    return shards.join(body(shards.split(x, devices)), devices[0][0])


def stage_sharded_fwd(
    x,
    params,
    mesh,
    *,
    axis: str = "sp",
    dp_axis: Optional[str] = None,
    comm: str = "ppermute",
) -> torch.Tensor:
    """Forward NTT with coefficients sharded over ``axis`` (and optionally
    the batch over ``dp_axis``).  x: (B, n) uint32 in [0, 4q); output
    [0, q) on the mesh's first device, bit-identical to the single-device
    kernel.

    comm: "ppermute" (whole-shard copy, then compute) or "overlap" (the
    partner's shard read in place: ``overlap.py``)."""
    return _run(x, params, mesh, axis, dp_axis, comm,
                lambda grid: fwd_grid(grid, params, comm))


def stage_sharded_inv(
    x,
    params,
    mesh,
    *,
    axis: str = "sp",
    dp_axis: Optional[str] = None,
    scale: Optional[int] = None,
    comm: str = "ppermute",
) -> torch.Tensor:
    """Inverse NTT with coefficients sharded over ``axis``.  x: (B, n) uint32
    in [0, 2q); output [0, q) times ``scale`` (default n^-1).  ``comm`` as
    in :func:`stage_sharded_fwd`."""
    return _run(x, params, mesh, axis, dp_axis, comm,
                lambda grid: inv_grid(grid, params, scale, comm))
