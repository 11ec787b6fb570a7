"""Device mesh and the sharded ring front end.

Counterpart of ``agilex_ntt_tpu/parallel/mesh.py`` (``make_mesh``,
``dp_shard_batch`` and ``ShardedRing``).  The JAX mesh is single-controller:
one process sees every device and a shard is a block of one global array.
The port keeps that model: one process holds a ``Mesh`` of named axes over a
list of ``torch.device``s and drives each shard on its device
(``shards.py``).  A device may repeat in the list (``["cuda:0"] * 8`` or
``["cpu"] * 8``): that is the port's counterpart of the JAX tests' eight
virtual CPU devices, and how the sharded paths run on one card.

Data-parallel batch sharding (dp) runs the single-device kernels on each
rows block; coefficient sharding (sp) runs the stage-sharded transform
(``stage_shard.py``, cross stages on K11) or the four-step one
(``fourstep_shard.py``).  Results are bit-identical to the single-device
ring.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..api import CyclicRing, Ring
from ..ops import fourstep
from ..ops import modmul as mm
from ..ops import ntt_kernel as K
from . import fourstep_shard, shards, stage_shard


class Mesh:
    """Named axes over a grid of devices (``make_mesh``).

    ``devices`` is a numpy object array of ``torch.device`` with one
    dimension per axis; ``shape`` maps each axis name to its size."""

    def __init__(self, devices: np.ndarray, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))

    def device(self, **coords: int) -> torch.device:
        """The device at the given axis coordinates (others at 0)."""
        return self.devices[tuple(coords.get(a, 0) for a in self.axis_names)]

    def __repr__(self):
        return f"Mesh({self.shape}, devices={list(self.devices.flat)})"


def make_mesh(*, devices=None, **axes: int) -> Mesh:
    """Build a named mesh, e.g. ``make_mesh(dp=4, sp=2)``.

    ``devices`` defaults to every visible CUDA device (none without a card);
    a caller may pass any list, a device repeating in it, such as
    ``["cuda:0"] * 8`` or ``["cpu"] * 8``.  The first prod(axes) devices
    fill the axes in row-major order."""
    names = tuple(axes.keys())
    shape = tuple(axes.values())
    want = int(np.prod(shape))
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


def dp_shard_batch(x, mesh: Mesh, axis: str = "dp"):
    """Place (B, ..., n) with the batch sharded over ``axis``: a list of the
    rows blocks, block i on the mesh device at ``axis`` = i.  ShardedRing's
    methods take the list as they take the global tensor."""
    P = mesh.shape[axis]
    x = shards.as_u32(x, mesh.device())
    shards.check_batch(x, P, "dp_shard_batch")
    rows = x.shape[0] // P
    return [
        shards.u32(shards.words(x[i * rows:(i + 1) * rows])
                   .to(mesh.device(**{axis: i})).contiguous())
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
        (``overlap.py``).  Bit-identical.
    Either axis may be None.  Methods take the global (B, n) tensor (or the
    list ``dp_shard_batch`` gives) and return the global result on the
    mesh's first device; inside ``polymul`` and ``polydot`` the shards stay
    on their devices between steps.  All results are bit-identical to the
    single-device ring.
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

    # -- plumbing ------------------------------------------------------------

    @property
    def _first(self) -> torch.device:
        return self._devices[0][0]

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
        return shards.split(x, self._devices)

    def _true_rows(self, grid, b: int) -> torch.Tensor:
        """The global result of a grid, padded rows sliced off."""
        return shards.join(grid, self._first, b)

    # -- transforms on grids (shards stay on their devices) -------------------

    def _ntt_grid(self, grid):
        if self.sp_axis is not None:
            if self.sp_method == "fourstep":
                return fourstep_shard.fwd_grid(grid, self._plan, self.sp_comm)
            return stage_shard.fwd_grid(grid, self.ring.params, self.sp_comm)
        return shards.map_grid(self._local_ntt, grid)

    def _intt_grid(self, grid, scale: Optional[int] = None):
        if self.sp_axis is not None:
            if self.sp_method == "fourstep":
                return fourstep_shard.inv_grid(grid, self._plan, scale, self.sp_comm)
            return stage_shard.inv_grid(grid, self.ring.params, scale, self.sp_comm)
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

