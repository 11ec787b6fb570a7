"""Device mesh and the sharded ring front end.

Counterpart of ``agilex_ntt_tpu/parallel/mesh.py`` (``make_mesh``,
``dp_shard_batch``, ``ShardedRing`` and ``ShardedRNSRing``).  The JAX mesh is single-controller:
one process sees every device and a shard is a block of one global array.
The port keeps that model: one process holds a ``Mesh`` of named axes over a
list of ``torch.device``s and drives each shard on its device
(``shards.py``).  A device may repeat in the list (``["cuda:0"] * 8`` or
``["cpu"] * 8``): that is the port's counterpart of the JAX tests' eight
virtual CPU devices, and how the sharded paths run on one card.

Data-parallel batch sharding (dp) runs the single-device kernels on each
rows block; coefficient sharding (sp) runs the stage-sharded transform
(``stage_shard.py``, cross stages on K11) or the four-step one
(``fourstep_shard.py``).  ``ShardedRNSRing`` adds the prime-channel axis
(ch): whole channels a device, on the multi-prime kernels, or with sp the
channel x coefficient four-step transform (``chsp.py``).  Results are
bit-identical to the single-device ring.

A mesh may also span several processes (``make_mesh`` in a world of
processes, ``multihost.pod_mesh``), one card each or several:
``ShardedRing`` and ``ShardedRNSRing`` then run SPMD, each process on the
blocks of its own positions (replicated over the mesh axes a ring does
not name), the blocks moving between processes in ``comm.py``, and every
process gets the global result.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..api import CyclicRing, Ring, RNSRing
from ..ops import basechange, fourstep, gadget
from ..ops import modmul as mm
from ..ops import ntt_kernel as K
from ..ops.plain_ntt import make_rns_tables
from . import chsp, comm, fourstep_shard, shards, stage_shard


class Mesh:
    """Named axes over a grid of devices (``make_mesh``, ``pod_mesh``).

    ``devices`` is a numpy object array of ``torch.device`` with one
    dimension per axis; ``shape`` maps each axis name to its size.

    A mesh of several processes (``multihost.pod_mesh``) also records
    ``owners``, the rank that owns each position (an int array shaped like
    ``devices``), this process's ``rank``, the group of every process
    (``process_group``) and, for each axis, the group of each line of
    positions along it (``axis_groups[axis][ranks]``).  A device of
    another rank is that rank's to address, not this process's.  In a
    single-process mesh ``owners`` is None and every position is local."""

    def __init__(self, devices: np.ndarray, axis_names, *, owners=None,
                 rank: int = 0, process_group=None, axis_groups=None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))
        self.owners = owners
        self.rank = rank
        self.process_group = process_group
        self.axis_groups = axis_groups or {}

    def device(self, **coords: int) -> torch.device:
        """The device at the given axis coordinates (others at 0)."""
        return self.devices[tuple(coords.get(a, 0) for a in self.axis_names)]

    @property
    def multiprocess(self) -> bool:
        return self.owners is not None

    @property
    def home(self) -> torch.device:
        """This process's device: its own position's in a mesh of several
        processes, the first device otherwise."""
        if self.owners is None:
            return self.devices.flat[0]
        return self.devices.flat[int(np.flatnonzero(self.owners == self.rank)[0])]

    def __repr__(self):
        return f"Mesh({self.shape}, devices={list(self.devices.flat)})"


def local_devices():
    """This process's devices in a world of several processes: its
    current card, the CPU without one."""
    if torch.cuda.is_available():
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cpu")]


def _world() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_mesh(*, devices=None, **axes: int) -> Mesh:
    """Build a named mesh, e.g. ``make_mesh(dp=4, sp=2)``.

    ``devices`` defaults to every visible CUDA device (none without a card);
    a caller may pass any list, a device repeating in it, such as
    ``["cuda:0"] * 8`` or ``["cpu"] * 8``.  The first prod(axes) devices
    fill the axes in row-major order.

    In a world of several processes (``torch.distributed`` initialised,
    ``multihost.init_distributed``) the mesh is global: ``devices`` names
    this process's devices (default ``local_devices()``, its current card
    or the CPU), every process names as many, and their devices fill the
    positions in rank order, so that each process's positions are
    consecutive in row-major order (the innermost axes stay inside a
    process).  prod(axes) must equal the devices of every process.  The
    mesh records ``owners``, ``rank``, the world group and a group for
    each line of every axis (``axis_groups``).  Under NCCL two processes
    may not share a card (``comm.check_cards``)."""
    names = tuple(axes.keys())
    shape = tuple(axes.values())
    want = int(np.prod(shape))
    if _world() > 1:
        return _world_mesh(names, shape, devices)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(have)]
    devices = [torch.device(d) for d in devices]
    have = len(devices)
    if want > have:
        raise ValueError(f"mesh needs {want} devices, only {have} available")
    for dev in devices[:want]:
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device is available for {dev}")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {dev}")
    grid = np.empty(want, dtype=object)
    grid[:] = devices[:want]
    return Mesh(grid.reshape(shape), names)


def _world_mesh(names, shape, devices) -> Mesh:
    """``make_mesh`` over every process's devices (see there)."""
    local = [torch.device(d) for d in (local_devices() if devices is None
                                       else devices)]
    for dev in local:
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {dev}")
    world, rank = dist.get_world_size(), dist.get_rank()
    placed = [None] * world
    dist.all_gather_object(placed, [(str(d), comm.card_id(d)) for d in local])
    counts = [len(p) for p in placed]
    if len(set(counts)) != 1:
        raise ValueError(f"every process of a mesh names as many devices; "
                         f"the ranks name {counts}")
    want, have = int(np.prod(shape)), sum(counts)
    if want != have:
        raise ValueError(
            f"mesh needs {want} devices, but the {world} processes have "
            f"{have} ({counts[0]} each) and a mesh of several processes "
            "takes them all")
    comm.check_cards(dist.get_backend(),
                     [[card for _, card in p] for p in placed])
    grid = np.empty(want, dtype=object)
    grid[:] = [torch.device(d) for p in placed for d, _ in p]
    owners = (np.arange(want) // counts[0]).reshape(shape)
    # a group for each line of every axis (its distinct ranks, ascending);
    # every rank creates every group, in one order
    axis_groups = {}
    for ax, name in enumerate(names):
        lines = np.moveaxis(owners, ax, -1).reshape(-1, shape[ax])
        groups = axis_groups[name] = {}
        for line in lines.tolist():
            ranks = tuple(sorted(set(line)))
            if ranks not in groups:
                groups[ranks] = dist.new_group(list(ranks))
    return Mesh(grid.reshape(shape), names, owners=owners, rank=rank,
                process_group=dist.group.WORLD, axis_groups=axis_groups)


def dp_shard_batch(x, mesh: Mesh, axis: str = "dp"):
    """Place (B, ..., n) with the batch sharded over ``axis``: a list of the
    rows blocks, block i on the mesh device at ``axis`` = i.  ShardedRing's
    methods take the list as they take the global tensor.  On a mesh of
    several processes every block stays on this process's device (the
    others' devices are theirs to address)."""
    P = mesh.shape[axis]
    x = shards.as_u32(x, mesh.home)
    shards.check_batch(x, P, "dp_shard_batch")
    rows = x.shape[0] // P
    return [
        shards.u32(shards.words(x[i * rows:(i + 1) * rows])
                   .to(mesh.home if mesh.multiprocess
                       else mesh.device(**{axis: i})).contiguous())
        for i in range(P)
    ]


class ShardedRing:
    """A Ring distributed over a device mesh.

    dp_axis: batch sharding (each rows block on its device).
    sp_axis: coefficient sharding.
    sp_method: how the coefficient-sharded transform communicates —
        "stage":    per-stage butterfly exchange over log2(P) cross stages
                    (``stage_shard.py``, K11);
        "fourstep": local column/row transforms with two retiles
                    (``fourstep_shard.py``); the default for four-step rings.
    sp_comm ("stage" only): "ppermute" copies the partner's whole shard
        before each cross stage; "overlap" reads it in place
        (``overlap.py``), or across processes takes it in chunks, each
        computed as it arrives.  Bit-identical.
    Either axis may be None.  Methods take the global (B, n) tensor (or the
    list ``dp_shard_batch`` gives) and return the global result on the
    mesh's first device; inside ``polymul`` and ``polydot`` the shards stay
    on their devices between steps.  All results are bit-identical to the
    single-device ring.

    On a mesh of several processes (``make_mesh``, ``multihost.pod_mesh``)
    every process calls each method with the same global tensor and
    transforms the blocks of its own positions (SPMD; ``shards.Layout``):
    one or several, and on a mesh axis the ring does not name, the same
    blocks as the other processes along it (replicated).  An sp group
    inside one process runs as on one process; the blocks move between
    processes through ``comm.py``, and every process gets the global
    result on its own device (``mesh.home``).
    """

    def __init__(
        self,
        ring,
        mesh: Mesh,
        *,
        dp_axis: Optional[str] = "dp",
        sp_axis: Optional[str] = None,
        sp_method: Optional[str] = None,
        sp_comm: str = "ppermute",
    ):
        if not isinstance(ring, (Ring, CyclicRing)):
            raise TypeError(
                f"ShardedRing wraps a Ring or CyclicRing; got "
                f"{type(ring).__name__}"
            )
        self.ring = ring
        self.mesh = mesh
        self.dp_axis = dp_axis
        self.sp_axis = sp_axis
        if dp_axis is None and sp_axis is None:
            raise ValueError("need at least one mesh axis")
        for ax in (dp_axis, sp_axis):
            if ax is not None and ax not in mesh.axis_names:
                raise ValueError(f"axis {ax!r} not in mesh {mesh.axis_names}")
        if sp_method is None:
            sp_method = "fourstep" if ring.method == "fourstep" else "stage"
        if sp_method not in ("stage", "fourstep"):
            raise ValueError(f"unknown sp_method {sp_method!r}")
        if sp_method == "stage" and ring.method == "fourstep":
            raise ValueError(
                "stage-sharded transform needs single-pass tables; "
                "use sp_method='fourstep' for four-step rings"
            )
        self.sp_method = sp_method
        if sp_comm not in ("ppermute", "overlap"):
            raise ValueError(f"unknown sp_comm {sp_comm!r}")
        self.sp_comm = sp_comm
        if sp_axis is not None and sp_method == "fourstep":
            if ring.plan is not None:
                self._plan = ring.plan
            elif isinstance(ring, CyclicRing):
                self._plan = fourstep.make_cyclic_plan(ring.n, ring.q, ring.omega)
            else:
                self._plan = fourstep.make_plan(ring.n, ring.q, ring._psi)
        else:
            self._plan = None
        self._devices = shards.grid_devices(mesh, dp_axis, sp_axis)
        self._dp = len(self._devices)
        self._tables = {}
        # where the blocks live across processes (None: all in this one)
        self._layout = shards.layout(mesh, dp_axis, sp_axis)

    # -- plumbing ------------------------------------------------------------

    @property
    def _first(self) -> torch.device:
        """Where the global tensors live: the mesh's first device, or this
        process's device on a mesh of several processes."""
        return self._devices[0][0] if self._layout is None else self.mesh.home

    def shard(self, x) -> torch.Tensor:
        """Place a (B, n) array with this ring's sharding: the global tensor
        on the mesh's first device, where the methods take it.  Raises, as
        a placement on the mesh does, when the dp size does not divide B or
        the sp size n (the methods themselves take remainder batches)."""
        x = self._global(x)
        for dim, ax in ((0, self.dp_axis), (1, self.sp_axis)):
            if ax is not None:
                shards.check_divides(x.shape, dim, self.mesh.shape[ax], ax)
        return x

    def _ring_tables(self, device: torch.device):
        """The ring's own tables (radix-2 or four-step) on ``device``."""
        hit = self._tables.get(device)
        if hit is None:
            own = self.ring.tables if self.ring.fourstep is None else self.ring.fourstep
            hit = own if device == own.device else shards.tables_on(own, device)
            self._tables[device] = hit
        return hit

    def _global(self, x, ndim: int = 2) -> torch.Tensor:
        x = shards.as_u32(x, self._first)
        if ndim == 2 and (x.dim() != 2 or x.shape[-1] != self.ring.n):
            raise ValueError(f"expected (B, n={self.ring.n}), got {tuple(x.shape)}")
        return x

    def _dp_pad(self, x: torch.Tensor):
        """Pad the batch with zero rows up to a multiple of the dp size (the
        reference's remainder frames; transforms are row-independent, so
        real rows are bit-exact).  Returns (padded, true batch)."""
        return shards.pad_rows(x, self._dp), x.shape[0]

    def _split(self, x: torch.Tensor):
        here = self._devices if self._layout is None else self._layout.devices
        return shards.split(x, here)

    def _true_rows(self, grid, b: int) -> torch.Tensor:
        """The global result of a grid, padded rows sliced off."""
        return shards.join(grid, self._first, b, self._layout)

    # -- transforms on grids (shards stay on their devices) -------------------

    def _ntt_grid(self, grid):
        if self.sp_axis is not None:
            if self.sp_method == "fourstep":
                return fourstep_shard.fwd_grid(grid, self._plan, self.sp_comm,
                                               self._layout)
            return stage_shard.fwd_grid(grid, self.ring.params, self.sp_comm,
                                        self._layout)
        return shards.map_grid(self._local_ntt, grid)

    def _intt_grid(self, grid, scale: Optional[int] = None):
        if self.sp_axis is not None:
            if self.sp_method == "fourstep":
                return fourstep_shard.inv_grid(grid, self._plan, scale,
                                               self.sp_comm, self._layout)
            return stage_shard.inv_grid(grid, self.ring.params, scale,
                                        self.sp_comm, self._layout)
        return shards.map_grid(lambda x: self._local_intt(x, scale), grid)

    def _local_ntt(self, x: torch.Tensor) -> torch.Tensor:
        t = self._ring_tables(x.device)
        if self.ring.fourstep is None:
            return K.fwd_ntt(x, t)
        return fourstep.fwd_ntt_fourstep_tiled(x.view(-1, t.n1, t.n2), t).view(x.shape)

    def _local_intt(self, x: torch.Tensor, scale: Optional[int]) -> torch.Tensor:
        t = self._ring_tables(x.device)
        if self.ring.fourstep is None:
            return K.inv_ntt(x, t, scale=scale)
        return fourstep.inv_ntt_fourstep_tiled(
            x.view(-1, t.n1, t.n2), t, scale=scale
        ).view(x.shape)

    def _mont(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The lazy Montgomery product of two shards, [0, 2q)."""
        out = mm.mont_mul_lazy(a.to(torch.int64), b.to(torch.int64),
                               self.ring.q, self.ring.qinv_neg)
        return out.to(torch.uint32)

    # -- transforms ----------------------------------------------------------

    def ntt(self, x) -> torch.Tensor:
        x, b = self._dp_pad(self._global(x))
        return self._true_rows(self._ntt_grid(self._split(x)), b)

    def intt(self, x, *, scale: Optional[int] = None) -> torch.Tensor:
        x, b = self._dp_pad(self._global(x))
        return self._true_rows(self._intt_grid(self._split(x), scale), b)

    def polymul(self, a, b) -> torch.Tensor:
        """Product in the ring: sharded forward transforms, the lazy
        pointwise product on each shard, one sharded inverse."""
        a, b = self._global(a), self._global(b)
        if a.shape != b.shape:
            raise ValueError(
                f"polymul expects matching (B, n) shapes, got "
                f"{tuple(a.shape)} and {tuple(b.shape)}"
            )
        (a, rows), (b, _) = self._dp_pad(a), self._dp_pad(b)
        fa = self._ntt_grid(self._split(a))
        fb = self._ntt_grid(self._split(b))
        prod = shards.map_grid(self._mont, fa, fb)
        return self._true_rows(
            self._intt_grid(prod, self.ring.polymul_scale), rows
        )

    def polydot(self, a, b) -> torch.Tensor:
        """Inner product sum_i a_i * b_i mod (X^n + 1, q) of (B, k, n)
        operands.  dp only on a radix-2 ring: the fused kernel (K6a) on each
        rows block.  Otherwise the composed form: 2k sharded transforms,
        lazy accumulation, one sharded inverse.  Bit-identical to
        ``Ring.polydot`` (same accumulation order)."""
        ring = self.ring
        a, b = self._global(a, 3), self._global(b, 3)
        if a.shape != b.shape or a.dim() != 3 or a.shape[-1] != ring.n:
            raise ValueError(
                f"polydot expects matching (B, k, n={ring.n}) shapes, got "
                f"{tuple(a.shape)} and {tuple(b.shape)}"
            )
        k = a.shape[1]
        (a, rows), (b, _) = self._dp_pad(a), self._dp_pad(b)
        if self.sp_axis is None and ring.fourstep is None:
            out = shards.map_grid(
                lambda x, y: K.polydot_fused(x, y, self._ring_tables(x.device)),
                self._split(a), self._split(b),
            )
            return self._true_rows(out, rows)
        two_q = 2 * ring.q
        acc = None
        for i in range(k):
            fa = self._ntt_grid(self._split(a[:, i].contiguous()))
            fb = self._ntt_grid(self._split(b[:, i].contiguous()))
            term = shards.map_grid(self._mont, fa, fb)
            acc = term if acc is None else shards.map_grid(
                lambda s, t: mm.cond_sub(
                    s.to(torch.int64) + t.to(torch.int64), two_q
                ).to(torch.uint32),
                acc, term,
            )
        return self._true_rows(self._intt_grid(acc, ring.polymul_scale), rows)

    # -- batch-elementwise ring ops --------------------------------------------

    def _on_shards(self, fn, *xs) -> torch.Tensor:
        """An elementwise op on every shard of equally shaped operands."""
        xs = [self._global(x) for x in xs]
        padded = [self._dp_pad(x)[0] for x in xs]
        grid = shards.map_grid(
            lambda *v: fn(*(t.to(torch.int64) for t in v)).to(torch.uint32),
            *(self._split(x) for x in padded),
        )
        return self._true_rows(grid, xs[0].shape[0])

    def _gathered(self, x, call) -> torch.Tensor:
        """A coefficient permutation (rotate, automorphism) of the global
        tensor: under sp it moves words across shards, so it runs on the
        gathered batch, as the JAX package's collective does."""
        return call(self._global(x)).to(self._first)

    def rotate(self, x, k: int) -> torch.Tensor:
        """Multiply by X^k on the mesh (see Ring.rotate)."""
        k = int(k) % (2 * self.ring.n)
        return self._gathered(x, lambda v: self.ring.rotate(v, k))

    def automorphism(self, x, k: int, *, domain: str = "coeff") -> torch.Tensor:
        """Galois automorphism tau_k on the mesh (see Ring.automorphism)."""
        return self._gathered(
            x, lambda v: self.ring.automorphism(v, k, domain=domain)
        )

    def add(self, a, b) -> torch.Tensor:
        q = self.ring.q
        return self._on_shards(lambda x, y: mm.add_mod(x, y, q), a, b)

    def sub(self, a, b) -> torch.Tensor:
        q = self.ring.q
        return self._on_shards(lambda x, y: mm.sub_mod(x, y, q), a, b)

    def neg(self, a) -> torch.Tensor:
        q = self.ring.q
        return self._on_shards(lambda x: mm.neg_mod(x, q), a)



# ShardedRNSRing.polydot's route rule, the JAX package's: its fused polydot
# takes n >= MIN_KERNEL_N and k n 4 <= POLYDOT_FUSE_WIDTH_BYTES
# (``agilex_ntt_tpu/ops/ntt_kernel.py``); a wider dp polydot runs the
# per-channel composition, a wider channel-parallel one raises
MIN_KERNEL_N = 128
POLYDOT_FUSE_WIDTH_BYTES = 1 << 19


def _prime_tuple(basis) -> tuple:
    """The primes of an RNSRing or of a sequence of primes."""
    if hasattr(basis, "qs"):
        return tuple(int(q) for q in basis.qs)
    return tuple(int(q) for q in basis)


class ShardedRNSRing:
    """An RNSRing distributed over a device mesh: L prime channels, each
    batch- and/or coefficient-sharded like ShardedRing.

    The production FHE deployment shape: residues (L, B, n) with B sharded
    over dp and, for large n, coefficients over sp; or the channel axis
    itself sharded over ch (whole channels a device, each with its own
    tables: the RNS analog of expert parallelism).  The layouts and what
    runs in each:

      * dp alone, radix-2 channels: each rows block one launch of K4a, K4b,
        K5 or K6b for all its channels (remainder batches padded to dp);
      * ch (x dp): each (ch, dp) block one such launch on its channels'
        tables, on its device;
      * ch x sp (x dp), four-step channels: ``chsp.py``, the column and row
        passes of a channel block on K4a/K4b with the inter-pass twiddle
        and the retiles between the sp devices;
      * otherwise (sp, dp x sp): one ``ShardedRing`` a channel, stacked.

    Methods take the global tensor (or its (L, B_i, ...) rows blocks, in
    order) and return the global result on the mesh's first device.  The
    elementwise ops run on the blocks; the permutations (``rotate``,
    ``automorphism``) on the gathered tensor; the channel-mixing ops (base
    conversion, rescaling, the gadget split, the HPS scale and return) on
    each dp/sp block with its channels gathered, the output channel axis
    whole.  ``sp_comm`` is passed to the stacked ``ShardedRing``s.
    Bit-identical to the single-device RNSRing.

    On a mesh of several processes (``make_mesh``, ``multihost.pod_mesh``;
    one card a process or several) every process calls each method with
    the same global tensor and gets the global result on its own device
    (``mesh.home``).  Each process runs the blocks of its positions
    (``shards.Layout``; replicated over the axes the ring does not name):
    under ch (x dp) the multi-prime kernel on each channel block it holds,
    on that block's tables built on its card; under ch x sp the ``chsp``
    passes, the retiles through each sp line; under dp, sp and dp x sp as
    on one process.  The mixing ops run on the dp/sp blocks this process
    holds with every channel (the channel axis replicated), the
    permutations on the global tensor every process holds, and the blocks
    meet by ``shards.join_channels``.  The key switch's extended-basis
    ring is built on the same mesh (on a ch mesh, replicated over ch).
    Every route is decided from the global shape and the configuration,
    so every process issues the same collectives in the same order.
    """

    def __init__(
        self,
        rns: RNSRing,
        mesh: Mesh,
        *,
        dp_axis: Optional[str] = "dp",
        sp_axis: Optional[str] = None,
        sp_method: Optional[str] = None,
        ch_axis: Optional[str] = None,
        sp_comm: str = "ppermute",
    ):
        if not isinstance(rns, RNSRing):
            raise TypeError(
                f"ShardedRNSRing wraps an RNSRing; got {type(rns).__name__}"
            )
        self.rns = rns
        self.mesh = mesh
        self.dp_axis = dp_axis
        self.sp_axis = sp_axis
        self.ch_axis = ch_axis
        self.sp_comm = sp_comm
        self._chsp_plans = None
        # extended-basis sharded rings built by the key switch, by primes
        self._ext_sharded: Dict[tuple, "ShardedRNSRing"] = {}
        if ch_axis is not None:
            for ax in (ch_axis, dp_axis, sp_axis):
                if ax is not None and ax not in mesh.axis_names:
                    raise ValueError(
                        f"axis {ax!r} not in mesh {mesh.axis_names}"
                    )
            if rns.L % mesh.shape[ch_axis]:
                raise ValueError(
                    f"the ch axis size ({mesh.shape[ch_axis]} devices) must "
                    f"divide L={rns.L} (whole channels per device)"
                )
            if sp_comm not in fourstep_shard.COMMS:
                raise ValueError(f"unknown sp_comm {sp_comm!r}")
            if sp_axis is not None:
                if not all(r.method == "fourstep" for r in rns.rings):
                    raise ValueError(
                        "ch_axis + sp_axis needs every channel on the "
                        "four-step Pallas path (large n); for radix-2 "
                        "rings shard channels or coefficients, not both"
                    )
                self._chsp_plans = tuple(r.plan for r in rns.rings)
                chsp.check_plans(self._chsp_plans, mesh, ch_axis, sp_axis)
            elif rns.tables is None:
                raise ValueError(
                    "ch_axis needs the uniform radix-2 Pallas configuration"
                )
        self.srs = [
            ShardedRing(r, mesh, dp_axis=dp_axis, sp_axis=sp_axis,
                        sp_method=sp_method, sp_comm=sp_comm)
            for r in rns.rings
        ] if ch_axis is None else []
        self._devices = shards.channel_devices(mesh, ch_axis, dp_axis, sp_axis)
        # the channel-mixing ops' blocks: every channel, dp x sp
        self._mix_devices = shards.channel_devices(mesh, None, dp_axis, sp_axis)
        self._dp = len(self._devices[0])
        self._tables: Dict[tuple, object] = {}
        self._consts: Dict[tuple, tuple] = {}
        # where the blocks live across processes (None: all in this one):
        # the ring's grid and the mixing ops' (the channel axis whole, so
        # replicated over ch)
        self._layout = shards.layout(mesh, ch_axis, dp_axis, sp_axis)
        self._mix_layout = (self._layout if ch_axis is None else
                            shards.layout(mesh, None, dp_axis, sp_axis))

    @property
    def L(self) -> int:
        return self.rns.L

    # -- plumbing ------------------------------------------------------------

    @property
    def _first(self) -> torch.device:
        """Where the global tensors live: the mesh's first device, or this
        process's device on a mesh of several processes."""
        if self._layout is None:
            return self._devices[0][0][0]
        return self.mesh.home

    def _global(self, x, ndim: int = 3) -> torch.Tensor:
        """x as the global uint32 tensor on the first device, checked: a
        tensor, a numpy array or a sequence of (L, B_i, ...) rows blocks."""
        x = shards.as_u32(x, self._first, axis=1)
        self.rns._check(x)
        if x.dim() != ndim:
            mid = "B, k" if ndim == 4 else "B"
            raise ValueError(
                f"expected (L={self.L}, {mid}, n={self.rns.n}), got "
                f"{tuple(x.shape)}"
            )
        return x

    def shard(self, x) -> torch.Tensor:
        """Place (L, B, ..., n) residues: channels over ch (if set), batch
        over dp, coefficients over sp.  The global tensor on the first
        device (this process's on a mesh of several processes); raises, as
        a placement on the mesh does, where an axis does not divide its
        dimension."""
        x = shards.as_u32(x, self._first, axis=1)
        self.rns._check(x)
        if x.dim() < 3:
            raise ValueError(
                f"shard expects (L, B, ..., n) residues, got {tuple(x.shape)}"
            )
        for dim, ax in ((0, self.ch_axis), (1, self.dp_axis),
                        (x.dim() - 1, self.sp_axis)):
            if ax is not None:
                shards.check_divides(x.shape, dim, self.mesh.shape[ax], ax)
        return x

    def _block_rings(self, c: int):
        per = self.L // len(self._devices)
        return self.rns.rings[c * per:(c + 1) * per]

    def _block_tables(self, c: int, device: torch.device):
        """Channel block c's ``RNSTables`` on ``device``, built once (only
        for a block this process owns, so only on its own device)."""
        key = (c, device)
        hit = self._tables.get(key)
        if hit is None:
            own = self.rns.tables
            if len(self._devices) == 1 and device == own.device:
                hit = own
            else:
                hit = make_rns_tables([
                    r.tables if r.tables.device == device
                    else shards.tables_on(r.tables, device)
                    for r in self._block_rings(c)
                ])
            self._tables[key] = hit
        return hit

    def _block_consts(self, c: int, device: torch.device):
        """Channel block c's q and -q^-1 mod 2^32 as int64 (Lc, 1, 1)
        columns on ``device``."""
        key = (c, device)
        hit = self._consts.get(key)
        if hit is None:
            rings = self._block_rings(c)
            hit = tuple(
                torch.tensor(v, dtype=torch.int64, device=device).view(-1, 1, 1)
                for v in ([r.q for r in rings], [r.qinv_neg for r in rings])
            )
            self._consts[key] = hit
        return hit

    def _grid_call(self, body, *xs, mixing: bool = False) -> torch.Tensor:
        """body(*grids) -> grid on the channel grids of the operands (the
        mixing ops' grid with ``mixing``), their batch padded to the dp
        size; the global result, padded rows sliced off."""
        layout = self._mix_layout if mixing else self._layout
        devices = (self._mix_devices if mixing else self._devices) \
            if layout is None else layout.devices
        b = xs[0].shape[1]
        grids = [shards.split_channels(shards.pad_rows(x, self._dp, axis=1),
                                       devices) for x in xs]
        return shards.join_channels(body(*grids), self._first, b, layout)

    def _launch(self, kernel, *grids):
        """One multi-prime kernel launch a block, on its channels' tables."""
        return shards.map_channels(
            lambda c, *v: kernel(*v, self._block_tables(c, v[0].device)),
            *grids,
        )

    def _mont(self, c: int, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """The lazy Montgomery product of two blocks of channel block c,
        [0, 2q)."""
        q, qinv = self._block_consts(c, u.device)
        return mm.mont_mul_lazy(u.to(torch.int64), v.to(torch.int64), q,
                                qinv).to(torch.uint32)

    def _stacked(self, per_channel, *xs) -> torch.Tensor:
        """One ShardedRing a channel, the outputs stacked."""
        return shards.u32(torch.stack([
            shards.words(per_channel(sr, *(x[l] for x in xs)))
            for l, sr in enumerate(self.srs)
        ]))

    def _use_dp_fused(self) -> bool:
        return (
            self.sp_axis is None
            and self.dp_axis is not None
            and self.ch_axis is None
            and self.rns.tables is not None
        )

    def _kernel_path(self) -> bool:
        """ch without sp, or dp alone on radix-2 channels: one multi-prime
        launch a block."""
        return (self.ch_axis is not None and self.sp_axis is None) or \
            self._use_dp_fused()

    def _chsp(self) -> bool:
        return self.ch_axis is not None and self.sp_axis is not None

    # -- transforms ----------------------------------------------------------

    def ntt(self, x) -> torch.Tensor:
        """Forward NTT of every channel: (L, B, n) in [0, 4 q_l) ->
        [0, q_l)."""
        x = self._global(x)
        if self._chsp():
            return self._grid_call(
                lambda g: chsp.fwd_grid(g, self._chsp_plans, self._layout), x)
        if self._kernel_path():
            return self._grid_call(lambda g: self._launch(K.fwd_ntt_rns, g), x)
        return self._stacked(lambda sr, xi: sr.ntt(xi), x)

    def intt(self, x) -> torch.Tensor:
        """Inverse NTT of every channel: (L, B, n) in [0, 2 q_l) ->
        [0, q_l)."""
        x = self._global(x)
        if self._chsp():
            return self._grid_call(
                lambda g: chsp.inv_grid(g, self._chsp_plans,
                                        layout=self._layout), x)
        if self._kernel_path():
            return self._grid_call(lambda g: self._launch(K.inv_ntt_rns, g), x)
        return self._stacked(lambda sr, xi: sr.intt(xi), x)

    def polymul(self, a, b) -> torch.Tensor:
        """Negacyclic product of every channel of (L, B, n) operands."""
        a, b = self._global(a), self._global(b)
        if a.shape != b.shape:
            raise ValueError(
                f"polymul expects matching shapes, got {tuple(a.shape)} and "
                f"{tuple(b.shape)}"
            )
        if self._chsp():
            return self._grid_call(self._chsp_polymul, a, b)
        if self._kernel_path():
            return self._grid_call(
                lambda ga, gb: self._launch(K.polymul_rns_fused, ga, gb), a, b)
        return self._stacked(lambda sr, ai, bi: sr.polymul(ai, bi), a, b)

    def _chsp_polymul(self, ga, gb):
        plans, lay = self._chsp_plans, self._layout
        fa, fb = chsp.fwd_grid(ga, plans, lay), chsp.fwd_grid(gb, plans, lay)
        prod = shards.map_channels(self._mont, fa, fb)
        return chsp.inv_grid(prod, plans, self.rns.polymul_scale, lay)

    def _chsp_polydot(self, ga, gb):
        """sum_i a_i b_i under ch x sp: per term two sharded forward
        transforms and the lazy Montgomery product, the sum kept below 2q
        (term order as the single-device polydot's), one scaled inverse."""
        plans, lay = self._chsp_plans, self._layout
        k = next(b for plane in ga for row in plane for b in row
                 if b is not None).shape[2]

        def term(grid, i):
            return shards.map_channels(
                lambda c, v: shards.u32(shards.words(v)[:, :, i].contiguous()),
                grid)

        def accumulate(c, s, t):
            two_q = 2 * self._block_consts(c, s.device)[0]
            return mm.cond_sub(s.to(torch.int64) + t.to(torch.int64),
                               two_q).to(torch.uint32)

        acc = None
        for i in range(k):
            fa = chsp.fwd_grid(term(ga, i), plans, lay)
            fb = chsp.fwd_grid(term(gb, i), plans, lay)
            t = shards.map_channels(self._mont, fa, fb)
            acc = t if acc is None else shards.map_channels(accumulate, acc, t)
        return chsp.inv_grid(acc, plans, self.rns.polymul_scale, lay)

    def polydot(self, a, b) -> torch.Tensor:
        """Inner product sum_i a_i * b_i per prime channel of (L, B, k, n)
        operands -> (L, B, n): the key-switch primitive on the mesh.

        ch: one K6b launch a (ch, dp) block on its channels' tables (ch x
        sp: the composed form on the sharded four-step transforms).  dp on
        radix-2 channels: one K6b launch a rows block.  Past the fused
        kernel's width (``POLYDOT_FUSE_WIDTH_BYTES``), or under sp: the
        per-channel ``ShardedRing.polydot``, stacked.  Bit-identical to
        ``RNSRing.polydot``."""
        a = shards.as_u32(a, self._first, axis=1)
        b = shards.as_u32(b, self._first, axis=1)
        n = self.rns.n
        if a.shape != b.shape or a.dim() != 4 or a.shape[0] != self.L or \
                a.shape[-1] != n:
            raise ValueError(
                f"polydot expects matching (L={self.L}, B, k, n={n}) "
                f"shapes, got {tuple(a.shape)} and {tuple(b.shape)}"
            )
        a, b = self._global(a, 4), self._global(b, 4)
        k = a.shape[2]
        fuse_ok = n >= MIN_KERNEL_N and k * n * 4 <= POLYDOT_FUSE_WIDTH_BYTES
        if self.ch_axis is not None:
            if self.sp_axis is not None:
                return self._grid_call(self._chsp_polydot, a, b)
            if not fuse_ok:
                raise ValueError(
                    f"channel-parallel polydot needs k*n*4 <= "
                    f"{POLYDOT_FUSE_WIDTH_BYTES} (resident operand tiles); "
                    f"got k={k}, n={n}"
                )
        if self._kernel_path() and fuse_ok:
            return self._grid_call(
                lambda ga, gb: self._launch(K.polydot_rns_fused, ga, gb), a, b)
        return self._stacked(lambda sr, ai, bi: sr.polydot(ai, bi), a, b)

    # -- batch-elementwise ring ops --------------------------------------------

    def _on_blocks(self, fn, *xs) -> torch.Tensor:
        """fn(*int64 blocks, q column) on every block of equally shaped
        (L, B, n) operands."""
        xs = [self._global(x) for x in xs]
        for x in xs[1:]:
            if x.shape != xs[0].shape:
                raise ValueError(
                    f"expected matching shapes, got {tuple(xs[0].shape)} and "
                    f"{tuple(x.shape)}"
                )

        def block(c, *v):
            q = self._block_consts(c, v[0].device)[0]
            return fn(*(t.to(torch.int64) for t in v), q).to(torch.uint32)

        return self._grid_call(
            lambda *grids: shards.map_channels(block, *grids), *xs)

    def add(self, a, b) -> torch.Tensor:
        return self._on_blocks(mm.add_mod, a, b)

    def sub(self, a, b) -> torch.Tensor:
        return self._on_blocks(mm.sub_mod, a, b)

    def neg(self, a) -> torch.Tensor:
        return self._on_blocks(mm.neg_mod, a)

    def _gathered(self, x, call) -> torch.Tensor:
        """A coefficient permutation of every channel on the gathered
        tensor (under sp it moves words across shards)."""
        return call(self._global(x)).to(self._first)

    def rotate(self, x, k: int) -> torch.Tensor:
        """Multiply every channel by X^k on the mesh (see RNSRing.rotate)."""
        return self._gathered(x, lambda v: self.rns.rotate(v, k))

    def automorphism(self, x, k: int, *, domain: str = "coeff") -> torch.Tensor:
        """Galois tau_k per channel on the mesh (see RNSRing.automorphism)."""
        return self._gathered(
            x, lambda v: self.rns.automorphism(v, k, domain=domain)
        )

    # -- channel-mixing ops ------------------------------------------------------

    def _mixing(self, fn, x: torch.Tensor) -> torch.Tensor:
        """A channel-mixing, coefficient-pointwise op on the mesh: fn on
        each dp/sp block of the int64 residues with every channel (under ch
        the channel blocks are gathered first), its output's batch on axis
        1.  The output channel axis is whole: its size and basis differ
        from this ring's."""
        return self._grid_call(
            lambda g: shards.map_channels(
                lambda c, v: fn(v.to(torch.int64)).to(torch.uint32), g),
            x, mixing=True,
        )

    def base_convert(self, x, dst, *, correction: str = "none") -> torch.Tensor:
        """Fast base conversion on the mesh (see RNSRing.base_convert)."""
        x, qs_dst = self._global(x), _prime_tuple(dst)
        return self._mixing(lambda v: basechange.base_convert(
            v, self.rns.qs, qs_dst, correction=correction), x)

    def rescale(self, x) -> torch.Tensor:
        """Divide and round by the last prime on the mesh (see
        RNSRing.rescale)."""
        return self._mixing(lambda v: basechange.rescale(v, self.rns.qs),
                            self._global(x))

    def mod_down(self, x, count: int = 1) -> torch.Tensor:
        """Iterated rescale on the mesh (see RNSRing.mod_down)."""
        x = self._global(x)
        c = self.rns._count(count)
        return self._mixing(
            lambda v: basechange.mod_down(v, self.rns.qs, c), x)

    def rescale_bgv(self, x, t: int) -> torch.Tensor:
        """BGV t-correcting modulus switch on the mesh (see
        RNSRing.rescale_bgv)."""
        return self._mixing(
            lambda v: basechange.rescale_bgv(v, self.rns.qs, int(t)),
            self._global(x))

    def mod_down_bgv(self, x, t: int, count: int = 1) -> torch.Tensor:
        """Iterated t-correcting divide on the mesh (see
        RNSRing.mod_down_bgv)."""
        x = self._global(x)
        c = self.rns._count(count)
        return self._mixing(
            lambda v: basechange.mod_down_bgv(v, self.rns.qs, int(t), c), x)

    def hps_scale_sk(self, d, qs, aux, t: int) -> torch.Tensor:
        """BFV HPS scale-and-round + Shenoy-Kumaresan exact return on the
        mesh: round(t*d/Q) converted exactly back to the Q basis.

        ``d``: (len(qs)+len(aux), B, n) residues of a big-base tensor part
        in the union basis qs (+) aux, where aux = B-primes + (m_sk,).
        Channel-mixing but coefficient-pointwise: each dp/sp block runs
        ``basechange.scale_round`` and ``base_convert_sk``."""
        qs = tuple(int(q) for q in qs)
        aux = tuple(int(q) for q in aux)
        d = shards.as_u32(d, self._first)
        if d.dim() != 3 or d.shape[0] != len(qs) + len(aux) or \
                d.shape[-1] != self.rns.n or d.numel() == 0:
            raise ValueError(
                f"hps_scale_sk expects (len(qs)+len(aux)={len(qs) + len(aux)}"
                f", B, n={self.rns.n}), got {tuple(d.shape)}"
            )
        lvl, bs, m_sk = len(qs), aux[:-1], aux[-1]

        def call(v):
            y = basechange.scale_round(v[:lvl], v[lvl:], qs, aux, int(t))
            return basechange.base_convert_sk(y[:-1], y[-1], bs, m_sk, qs)

        return self._mixing(call, d)

    def gadget_decompose(
        self, x, dst, dnum: int, *, correction: str = "float"
    ) -> torch.Tensor:
        """Hybrid gadget split on the mesh (see RNSRing.gadget_decompose):
        (L, B, n) -> (dnum, K, B, n), each dp/sp block split on its own."""
        x, qs_dst = self._global(x), _prime_tuple(dst)
        d, K, b = int(dnum), len(qs_dst), x.shape[1]

        def split(v):
            y = gadget.gadget_decompose(v, self.rns.qs, qs_dst, d,
                                        correction=correction)
            return y.reshape((d * K,) + tuple(v.shape[1:]))

        out = self._mixing(split, x)
        return shards.u32(shards.words(out).reshape(d, K, b, self.rns.n))

    # -- the key switch on the mesh ----------------------------------------------

    def _ext_primes(self, ext) -> tuple:
        qs_ext = _prime_tuple(ext)
        if qs_ext[:self.L] != tuple(self.rns.qs) or len(qs_ext) <= self.L:
            raise ValueError(
                "ext basis must extend this ring's primes by >= 1 special"
            )
        return qs_ext

    def _sharded_ext(self, qs_ext: tuple, ext):
        """The extended-basis ring, sharded like this one (dp/sp; the
        channel axis whole: K generally does not divide the ch axis, so on
        a ch mesh it is replicated over ch), cached per prime tuple (the
        ring itself in ``rns._ext_rings``).  With neither a dp nor an sp
        axis it is replicated whole: the ``RNSRing`` itself, on the first
        device (every process's own), where the JAX package's sharded ring
        refuses a ring with no axis."""
        if self.dp_axis is None and self.sp_axis is None:
            return self.rns._ext(ext)
        sext = self._ext_sharded.get(qs_ext)
        if sext is None:
            sext = ShardedRNSRing(
                self.rns._ext(ext), self.mesh, dp_axis=self.dp_axis,
                sp_axis=self.sp_axis, sp_comm=self.sp_comm,
            )
            self._ext_sharded[qs_ext] = sext
        return sext

    def _galois(self, ks) -> tuple:
        ks = tuple(int(k) % (2 * self.rns.n) for k in ks)
        for k in ks:
            if k % 2 == 0:
                raise ValueError(f"Galois exponents must be odd, got {k}")
        return ks

    def _down(self, sext, prod, count: int, plain_mod):
        if plain_mod is None:
            return sext.mod_down(prod, count=count)
        return sext.mod_down_bgv(prod, plain_mod, count=count)

    @staticmethod
    def _digit_steps(digits: torch.Tensor) -> torch.Tensor:
        """(dnum, K, B, n) digits -> (K, dnum B, n): every digit's batch
        as rows of one tensor, for one gathered automorphism a step."""
        d, K, b, n = digits.shape
        return shards.u32(
            shards.words(digits).movedim(0, 1).reshape(K, d * b, n))

    @staticmethod
    def _dot_operand(tau: torch.Tensor, dnum: int, b: int) -> torch.Tensor:
        """(K, dnum B, n) -> (K, B, dnum, n), the polydot's operand."""
        K, _, n = tau.shape
        return shards.u32(
            shards.words(tau).reshape(K, dnum, b, n).movedim(1, -2))

    @staticmethod
    def _key_operand(ksk: torch.Tensor, shape) -> torch.Tensor:
        """Shared (dnum, K, n) key material as the (K, B, dnum, n) operand
        of a polydot of ``shape``."""
        return shards.u32(
            shards.words(ksk).movedim(0, -2)[:, None].expand(shape))

    def hoisted_keyswitch(
        self, x, ksks, ks, ext, dnum: int, *, correction: str = "float",
        plain_mod: Optional[int] = None,
    ) -> torch.Tensor:
        """Hoisted rotation batch on the mesh (see
        RNSRing.hoisted_keyswitch): one sharded gadget decomposition (the
        ModUp base conversions) shared by every Galois step; each step then
        runs the digit automorphism, the sharded polydot of the permuted
        digits against its coefficient-domain key (the digits transformed
        again each step, where the single-device op transforms them once)
        and the sharded ModDown.  Bit-identical to the single-device op.

        x: (L, B, n); ksks: (nk, dnum, K, n) shared key material.  Returns
        (nk, L, B, n)."""
        x = self._global(x)
        ksks = shards.as_u32(ksks, self._first)
        ks = self._galois(ks)
        qs_ext = self._ext_primes(ext)
        L, K, n = self.L, len(qs_ext), self.rns.n
        if tuple(ksks.shape) != (len(ks), dnum, K, n):
            raise ValueError(
                f"ksks must be (nk={len(ks)}, dnum={dnum}, K={K}, n={n}), "
                f"got {tuple(ksks.shape)}"
            )
        sext = self._sharded_ext(qs_ext, ext)
        digits = self.gadget_decompose(x, qs_ext, dnum, correction=correction)
        b = x.shape[1]
        dig_flat = self._digit_steps(digits)
        outs = []
        for j, k in enumerate(ks):
            dig_k = self._dot_operand(sext.automorphism(dig_flat, k), dnum, b)
            prod = sext.polydot(dig_k, self._key_operand(ksks[j], dig_k.shape))
            outs.append(shards.words(self._down(sext, prod, K - L, plain_mod)))
        return shards.u32(torch.stack(outs))

    def hoisted_linear_sum(
        self, c0, c1, pts, ksks_b, ksks_a, ks, ext, dnum: int, *,
        correction: str = "float", plain_mod: Optional[int] = None,
    ):
        """BSGS linear transform on the mesh (see
        RNSRing.hoisted_linear_sum): sum_j pt_j (*) tau_{k_j}(ct) with one
        sharded gadget decomposition and one deferred ModDown per
        ciphertext part, built from the sharded ops (automorphism ->
        polydot -> polymul -> extended-basis accumulate), all coefficient
        domain; bit-identical to the single-device op.

        c0, c1: (L, B, n); pts: (nk, K, n) and ksks_b/ksks_a:
        (nk, dnum, K, n) shared material.  Returns (out0, out1), each
        (L, B, n)."""
        c0, c1 = self._global(c0), self._global(c1)
        pts = shards.as_u32(pts, self._first)
        ksks_b = shards.as_u32(ksks_b, self._first)
        ksks_a = shards.as_u32(ksks_a, self._first)
        ks = self._galois(ks)
        qs_ext = self._ext_primes(ext)
        L, K, n = self.L, len(qs_ext), self.rns.n
        nk = len(ks)
        for nm, arr in (("ksks_b", ksks_b), ("ksks_a", ksks_a)):
            if tuple(arr.shape) != (nk, dnum, K, n):
                raise ValueError(
                    f"{nm} must be (nk={nk}, dnum={dnum}, K={K}, n={n}), "
                    f"got {tuple(arr.shape)}"
                )
        if tuple(pts.shape) != (nk, K, n):
            raise ValueError(
                f"pts must be (nk={nk}, K={K}, n={n}), got {tuple(pts.shape)}"
            )
        sext = self._sharded_ext(qs_ext, ext)
        digits = self.gadget_decompose(c1, qs_ext, dnum, correction=correction)
        b = c1.shape[1]
        dig_flat = self._digit_steps(digits)
        ptw = shards.words(pts)
        acc_b = acc_a = c0sum = None
        for j, k in enumerate(ks):
            dig_k = self._dot_operand(sext.automorphism(dig_flat, k), dnum, b)
            pdb = sext.polydot(dig_k, self._key_operand(ksks_b[j], dig_k.shape))
            pda = sext.polydot(dig_k, self._key_operand(ksks_a[j], dig_k.shape))
            ptj = shards.u32(ptw[j][:, None].expand(K, b, n))
            tb, ta = sext.polymul(ptj, pdb), sext.polymul(ptj, pda)
            acc_b = tb if acc_b is None else sext.add(acc_b, tb)
            acc_a = ta if acc_a is None else sext.add(acc_a, ta)
            ptl = shards.u32(ptw[j][:L, None].expand(L, b, n))
            tc = self.polymul(ptl, self.automorphism(c0, k))
            c0sum = tc if c0sum is None else self.add(c0sum, tc)
        bdn = self._down(sext, acc_b, K - L, plain_mod)
        out1 = self._down(sext, acc_a, K - L, plain_mod)
        return self.add(c0sum, bdn), out1

    def keyswitch(
        self, x, ksk, ext, dnum: int, *, correction: str = "float",
        plain_mod: Optional[int] = None,
    ) -> torch.Tensor:
        """Hybrid key switch on the mesh (see RNSRing.keyswitch): sharded
        gadget digits -> sharded polydot in the extended basis -> sharded
        ModDown.  The extended-basis ring runs dp/sp-sharded with its
        channel axis whole.

        x: (L, B, n); ksk: (dnum, K, n) shared coefficient-domain key
        material or (dnum, K, B, n).  Returns (L, B, n)."""
        x = self._global(x)
        ksk = shards.as_u32(ksk, self._first)
        qs_ext = self._ext_primes(ext)
        L, K = self.L, len(qs_ext)
        sext = self._sharded_ext(qs_ext, ext)
        digits = self.gadget_decompose(x, qs_ext, dnum, correction=correction)
        dig = shards.u32(shards.words(digits).movedim(0, -2))  # (K, B, dnum, n)
        if ksk.dim() == 3:
            kb = self._key_operand(ksk, dig.shape)
        else:
            kb = shards.u32(shards.words(ksk).movedim(0, -2))
        return self._down(sext, sext.polydot(dig, kb), K - L, plain_mod)
