"""Plain PyTorch versions of the kernels, and the tables they share.

Counterpart of ``agilex_ntt_tpu/ops/stage_tables.py``, ``stage_math.py`` and
``xla_ntt.py``, rewritten for PyTorch: no positional (log n, n) tables and no
roll-and-select butterflies (those exist for the TPU's 128-lane vector unit).
Each stage views the batch as ``(B, m, 2, t)`` and runs every butterfly once
with the compact HEXL twiddles ``roots[m + i]``, in exact ``% q`` arithmetic
on int64: q < 2**30 keeps every product below 2**62.

Inputs may be lazy ([0, 4q) forward, [0, 2q) inverse); outputs are reduced
to [0, q), so they equal the JAX package's lazy-Harvey outputs bit for bit.

The multi-prime versions (``*_rns_plain``) loop over the channels of an
``RNSTables`` bundle and call the single-prime ones: they are the oracle of
the multi-prime kernels, not a path of their own.  The four-step versions
(``*_fourstep_plain``) run the same radix-2 transforms down the columns of
the (B, n1, n2) view (on its transpose) and along its rows, with the
inter-pass twiddle between them.

These run on the CPU (the tests, and the wrappers in ``ntt_kernel.py`` when
given a CPU tensor) and on the card only in ``chip_smoke.py``, which holds
each CUDA kernel against them.  They are never the main path on a card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..params import NTTParams, make_cyclic_params
from . import modmul as mm
from .modmul import mont_qinv_neg


@dataclasses.dataclass(frozen=True)
class RingTables:
    """One ring's constants, with its twiddle tables on one device.

    ``roots``/``precon``/``inv_roots``/``inv_precon`` are the params' uint32
    tables as ``torch.uint32`` tensors of shape (n,).  ``polymul_scale``
    folds n^-1 and the Montgomery R = 2**32 that the fused kernels' pointwise
    product leaves behind; ``inv_root1`` is the last inverse stage's twiddle.
    ``dot_words`` holds the fused kernels' constants on the tables' device,
    built once with the tables: (q, -q^-1 mod 2**32, su, su', sv, sv') of
    ``polymul_scale``, the (L,), (L,) and (L, 4) arrays of the multi-prime
    polydot kernel at L = 1; word 0 is also the transforms' (1,) q.
    ``scale_words(scale)`` gives the inverse's (4,) last-stage constants on
    the device, cached per scale: n^-1 built with the tables, any other
    uploaded at its first use.
    """

    n: int
    log_n: int
    q: int
    n_inv: int
    qinv_neg: int
    polymul_scale: int
    inv_root1: int
    roots: torch.Tensor
    precon: torch.Tensor
    inv_roots: torch.Tensor
    inv_precon: torch.Tensor
    dot_words: torch.Tensor = dataclasses.field(init=False, repr=False,
                                                compare=False)
    _scales: Dict[int, torch.Tensor] = dataclasses.field(
        init=False, repr=False, compare=False
    )

    def __post_init__(self):
        words = (self.q, self.qinv_neg) + inv_scale_words(self, self.polymul_scale)
        object.__setattr__(self, "dot_words", _u32_tensor(words, self.device))
        object.__setattr__(self, "_scales", {})
        self.scale_words()

    @property
    def device(self) -> torch.device:
        return self.roots.device

    def scale_words(self, scale: Optional[int] = None) -> torch.Tensor:
        """(4,) uint32 constants (su, su', sv, sv') of the last inverse
        stage for ``scale`` (default n^-1), on the tables' device."""
        key = (self.n_inv if scale is None else int(scale)) % self.q
        hit = self._scales.get(key)
        if hit is None:
            hit = _u32_tensor(inv_scale_words(self, key), self.device)
            self._scales[key] = hit
        return hit


def make_tables(params: NTTParams, device) -> RingTables:
    """The tables of ``params`` (an ``NTTParams``, or a ``CyclicParams``:
    the same layout with cyclic twiddles) on ``device``."""
    def u32(a):
        return _u32_tensor(a, device)

    q = params.q
    return RingTables(
        n=params.n,
        log_n=params.log_n,
        q=q,
        n_inv=params.n_inv,
        qinv_neg=mont_qinv_neg(q),
        polymul_scale=params.n_inv * ((1 << 32) % q) % q,
        inv_root1=int(params.inv_roots32[1]),
        roots=u32(params.roots32),
        precon=u32(params.precon32),
        inv_roots=u32(params.inv_roots32),
        inv_precon=u32(params.inv_precon32),
    )


def inv_scale_words(tables: RingTables, scale: Optional[int]) -> Tuple[int, ...]:
    """(su, su', sv, sv'): the last inverse stage's two Shoup constants,
    scale (default n^-1) and scale * inv_roots[1], with their precons."""
    q = tables.q
    su = (tables.n_inv if scale is None else scale) % q
    sv = su * tables.inv_root1 % q
    return su, (su << 32) // q, sv, (sv << 32) // q


@dataclasses.dataclass(frozen=True)
class RNSTables:
    """L rings of one n stacked for the multi-prime kernels, on one device.

    ``channels`` holds each prime's ``RingTables``; ``roots``/``precon``/
    ``inv_roots``/``inv_precon`` are their tables stacked to (L, n) and
    ``q_words``/``qinv_words`` the (L,) moduli and -q^-1 mod 2**32, all
    ``torch.uint32``.  ``scale_words(scales)`` gives the (L, 4) inverse-scale
    constants (``inv_scale_words`` per channel), cached per scales tuple.
    """

    n: int
    log_n: int
    channels: Tuple[RingTables, ...]
    q_words: torch.Tensor
    qinv_words: torch.Tensor
    roots: torch.Tensor
    precon: torch.Tensor
    inv_roots: torch.Tensor
    inv_precon: torch.Tensor
    _scales: Dict[tuple, torch.Tensor] = dataclasses.field(
        default_factory=dict, compare=False, repr=False
    )

    @property
    def L(self) -> int:
        return len(self.channels)

    @property
    def qs(self) -> Tuple[int, ...]:
        return tuple(t.q for t in self.channels)

    @property
    def n_inv(self) -> Tuple[int, ...]:
        return tuple(t.n_inv for t in self.channels)

    @property
    def polymul_scale(self) -> Tuple[int, ...]:
        return tuple(t.polymul_scale for t in self.channels)

    @property
    def device(self) -> torch.device:
        return self.roots.device

    def scale_words(self, scales: Optional[Sequence[int]] = None) -> torch.Tensor:
        """(L, 4) uint32 constants of the last inverse stage for per-channel
        ``scales`` (default n^-1 in every channel)."""
        key = self.n_inv if scales is None else tuple(int(s) for s in scales)
        if len(key) != self.L:
            raise ValueError(f"expected {self.L} scales, got {len(key)}")
        hit = self._scales.get(key)
        if hit is None:
            rows = [inv_scale_words(t, s) for t, s in zip(self.channels, key)]
            hit = _u32_tensor(rows, self.device)
            self._scales[key] = hit
        return hit


def _u32_tensor(values, device) -> torch.Tensor:
    """A torch.uint32 copy of ``values`` on ``device`` (never a view of a
    cached params table)."""
    return torch.from_numpy(np.array(values, dtype=np.uint32)).to(device)


def make_rns_tables(channels: Sequence[RingTables]) -> RNSTables:
    """Stack L single-prime table sets of one n and one device."""
    channels = tuple(channels)
    if not channels:
        raise ValueError("an RNS table bundle needs at least one prime")
    n, device = channels[0].n, channels[0].device
    for t in channels:
        if t.n != n or t.device != device:
            raise ValueError("all channels must share n and the device")
    return RNSTables(
        n=n,
        log_n=channels[0].log_n,
        channels=channels,
        q_words=_u32_tensor([t.q for t in channels], device),
        qinv_words=_u32_tensor([t.qinv_neg for t in channels], device),
        roots=torch.stack([t.roots for t in channels]),
        precon=torch.stack([t.precon for t in channels]),
        inv_roots=torch.stack([t.inv_roots for t in channels]),
        inv_precon=torch.stack([t.inv_precon for t in channels]),
    )


def fwd_ntt_plain(x: torch.Tensor, tables: RingTables) -> torch.Tensor:
    """Forward negacyclic NTT of int64 (B, n), values >= 0, -> [0, q), in
    HEXL order out[k] = A(psi^(2*bitrev(k)+1))."""
    q, n = tables.q, tables.n
    roots = tables.roots.to(torch.int64)
    b = x.shape[0]
    x = x % q
    m, t = 1, n // 2
    while m < n:
        v = x.view(b, m, 2, t)
        u = v[:, :, 0, :]
        wy = v[:, :, 1, :] * roots[m : 2 * m].view(1, m, 1) % q
        x = torch.stack(((u + wy) % q, (u - wy) % q), dim=2).view(b, n)
        m, t = 2 * m, t // 2
    return x


def inv_ntt_plain(
    x: torch.Tensor, tables: RingTables, scale: Optional[int] = None
) -> torch.Tensor:
    """Inverse negacyclic NTT of int64 (B, n), values >= 0, -> [0, q).

    The result is multiplied by ``scale`` (default n^-1 mod q)."""
    q, n = tables.q, tables.n
    if scale is None:
        scale = tables.n_inv
    inv_roots = tables.inv_roots.to(torch.int64)
    b = x.shape[0]
    x = x % q
    m, t = n // 2, 1
    while m >= 1:
        v = x.view(b, m, 2, t)
        u, w = v[:, :, 0, :], v[:, :, 1, :]
        d = (u - w) % q * inv_roots[m : 2 * m].view(1, m, 1) % q
        x = torch.stack(((u + w) % q, d), dim=2).view(b, n)
        m, t = m // 2, 2 * t
    return x * (scale % q) % q


def polymul_plain(a: torch.Tensor, b: torch.Tensor, tables: RingTables) -> torch.Tensor:
    """a * b mod (X^n + 1, q) for int64 (B, n) operands, -> [0, q)."""
    q = tables.q
    prod = fwd_ntt_plain(a, tables) * fwd_ntt_plain(b, tables) % q
    return inv_ntt_plain(prod, tables)


def polydot_plain(a: torch.Tensor, b: torch.Tensor, tables: RingTables) -> torch.Tensor:
    """sum_i a_i * b_i mod (X^n + 1, q) for int64 (B, k, n) operands,
    -> (B, n) in [0, q)."""
    q, n = tables.q, tables.n
    bb, k, _ = a.shape
    fa = fwd_ntt_plain(a.reshape(bb * k, n), tables).view(bb, k, n)
    fb = fwd_ntt_plain(b.reshape(bb * k, n), tables).view(bb, k, n)
    acc = (fa * fb % q).sum(dim=1) % q
    return inv_ntt_plain(acc, tables)


def fwd_ntt_rns_plain(x: torch.Tensor, tables: RNSTables) -> torch.Tensor:
    """Forward NTT of int64 (L, B, n), channel l mod q_l, -> [0, q_l)."""
    return torch.stack(
        [fwd_ntt_plain(x[l], t) for l, t in enumerate(tables.channels)]
    )


def inv_ntt_rns_plain(
    x: torch.Tensor, tables: RNSTables, scales: Optional[Sequence[int]] = None
) -> torch.Tensor:
    """Inverse NTT of int64 (L, B, n); channel l is multiplied by
    ``scales[l]`` (default n^-1 mod q_l)."""
    if scales is None:
        scales = tables.n_inv
    return torch.stack([
        inv_ntt_plain(x[l], t, s)
        for l, (t, s) in enumerate(zip(tables.channels, scales))
    ])


def polymul_rns_plain(a: torch.Tensor, b: torch.Tensor, tables: RNSTables) -> torch.Tensor:
    """a * b mod (X^n + 1, q_l) for int64 (L, B, n) operands."""
    return torch.stack(
        [polymul_plain(a[l], b[l], t) for l, t in enumerate(tables.channels)]
    )


def polydot_rns_plain(a: torch.Tensor, b: torch.Tensor, tables: RNSTables) -> torch.Tensor:
    """sum_i a_i * b_i mod (X^n + 1, q_l) for int64 (L, B, k, n) operands,
    -> (L, B, n)."""
    return torch.stack(
        [polydot_plain(a[l], b[l], t) for l, t in enumerate(tables.channels)]
    )


# -- four-step: n = n1 * n2 ------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FourStepTables:
    """A four-step plan's constants with its tables on one device.

    ``col`` holds the size-n1 column transform's tables (negacyclic, or
    cyclic for a cyclic ring), ``row`` the size-n2 cyclic row transform's;
    ``tw``/``tw_precon`` and ``itw``/``itw_precon`` are the (n1, n2)
    inter-pass twiddles and their inverses with 32-bit Shoup precons, all
    ``torch.uint32``.  ``polymul_scale`` folds n^-1 and the Montgomery
    R = 2**32 of the fused polymul's pointwise product.
    """

    n: int
    n1: int
    n2: int
    q: int
    n_inv: int
    qinv_neg: int
    polymul_scale: int
    col: RingTables
    row: RingTables
    tw: torch.Tensor
    tw_precon: torch.Tensor
    itw: torch.Tensor
    itw_precon: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.tw.device

    def col_scale(self, scale: Optional[int] = None) -> int:
        """The column inverse's scale: ``scale`` (default n^-1) times n2,
        since the row inverse already multiplied by n2^-1."""
        s = self.n_inv if scale is None else scale
        return s * self.n2 % self.q


def make_fourstep_tables(plan, device) -> FourStepTables:
    """The tables of a ``FourStepPlan`` (``ops/fourstep.py``) on ``device``."""
    q = plan.q
    return FourStepTables(
        n=plan.n, n1=plan.n1, n2=plan.n2, q=q, n_inv=plan.n_inv,
        qinv_neg=mont_qinv_neg(q),
        polymul_scale=plan.n_inv * ((1 << 32) % q) % q,
        col=make_tables(plan.col, device),
        row=make_tables(plan.row, device),
        tw=_u32_tensor(plan.tw, device),
        tw_precon=_u32_tensor(plan.tw_precon, device),
        itw=_u32_tensor(plan.itw, device),
        itw_precon=_u32_tensor(plan.itw_precon, device),
    )


def _columns(x3: torch.Tensor) -> torch.Tensor:
    """(B, n1, n2) -> (B n2, n1): each column as a row."""
    b, n1, n2 = x3.shape
    return x3.transpose(1, 2).reshape(b * n2, n1)


def _uncolumns(y: torch.Tensor, shape) -> torch.Tensor:
    b, n1, n2 = shape
    return y.view(b, n2, n1).transpose(1, 2).contiguous()


def fwd_col_fourstep_plain(x3: torch.Tensor, ft: FourStepTables) -> torch.Tensor:
    """The column pass of int64 (B, n1, n2), values >= 0: the size-n1 NTT
    of every column, then the Shoup product with T, as the kernel computes
    it: lazy, in [0, 2q)."""
    y = _uncolumns(fwd_ntt_plain(_columns(x3), ft.col), x3.shape)
    tw, twp = ft.tw.to(torch.int64), ft.tw_precon.to(torch.int64)
    return mm.shoup_mulmod_lazy(y, tw, twp, ft.q)


def inv_col_fourstep_plain(
    x3: torch.Tensor, ft: FourStepTables, scale: Optional[int] = None
) -> torch.Tensor:
    """The column inverse of int64 (B, n1, n2), values < 2**32: the product
    with T^-1, then the size-n1 inverse of every column scaled by
    ``ft.col_scale(scale)``; -> [0, q)."""
    m = x3 * ft.itw.to(torch.int64) % ft.q
    y = inv_ntt_plain(_columns(m), ft.col, ft.col_scale(scale))
    return _uncolumns(y, x3.shape)


def fwd_ntt_fourstep_plain(x3: torch.Tensor, ft: FourStepTables) -> torch.Tensor:
    """Forward four-step NTT of int64 (B, n1, n2) -> [0, q)."""
    m = fwd_col_fourstep_plain(x3, ft)
    return fwd_ntt_plain(m.view(-1, ft.n2), ft.row).view(x3.shape)


def inv_ntt_fourstep_plain(
    x3: torch.Tensor, ft: FourStepTables, scale: Optional[int] = None
) -> torch.Tensor:
    """Inverse four-step NTT of int64 (B, n1, n2) -> [0, q), multiplied by
    ``scale`` (default n^-1) in all."""
    r = inv_ntt_plain(x3.reshape(-1, ft.n2), ft.row).view(x3.shape)
    return inv_col_fourstep_plain(r, ft, scale)


def polymul_fourstep_plain(
    a3: torch.Tensor, b3: torch.Tensor, ft: FourStepTables
) -> torch.Tensor:
    """a * b of int64 (B, n1, n2) operands through the four-step
    transforms, -> [0, q)."""
    prod = fwd_ntt_fourstep_plain(a3, ft) * fwd_ntt_fourstep_plain(b3, ft) % ft.q
    return inv_ntt_fourstep_plain(prod, ft)


# -- the DIT inverse (K12) --------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DitTables:
    """The DIT inverse's constants on one device.

    ``ring`` is the ring's ``RingTables`` with the inverse roots in the
    forward slots (``roots``/``precon`` = ``inv_roots``/``inv_precon``): the
    forward network on psi^-1.  ``rows`` is the (4, n) ``torch.uint32``
    block of the two scale rows with their Shoup precons ``(v << 32) // q``:
    pre[k] = psi^k, pre', post[m] = n^-1 inv_roots[m], post'.  ``cyclic``
    holds the tables of the cyclic transform of omega = psi^-2, which is
    that network with the pre row folded in: the kernel's forward tables.
    """

    ring: RingTables
    rows: torch.Tensor
    cyclic: RingTables


def make_dit_tables(params: NTTParams, device) -> DitTables:
    """The DIT inverse's tables of ``params`` on ``device``
    (``agilex_ntt_tpu/ops/dit_inv.py::_dit_tables``, compact)."""
    from .fourstep import _powers

    q = params.q
    base = make_tables(params, device)
    ring = dataclasses.replace(base, roots=base.inv_roots, precon=base.inv_precon)
    pre = _powers(params.psi, params.n, q).astype(np.uint64)
    post = params.inv_roots.astype(np.uint64) * np.uint64(params.n_inv) % np.uint64(q)
    q64 = np.uint64(q)
    rows = [pre, (pre << np.uint64(32)) // q64, post, (post << np.uint64(32)) // q64]
    omega = pow(params.psi, -2, q)
    return DitTables(ring=ring, rows=_u32_tensor(np.stack(rows), device),
                     cyclic=make_tables(make_cyclic_params(params.n, q, omega),
                                        device))


def dit_inv_core_plain(x: torch.Tensor, dt: DitTables) -> torch.Tensor:
    """K12's plain version on int64 (B, n), already bit-reversed, values
    >= 0: the pre row, the forward stages on the psi^-1 tables, the post row,
    reduced to [0, q) (so every lazy range of the kernel gives these
    words)."""
    q = dt.ring.q
    rows = dt.rows.to(torch.int64)
    y = fwd_ntt_plain(x * rows[0] % q, dt.ring)
    return y * rows[2] % q


# -- one cross-device stage (K11) --------------------------------------------------


def fwd_stage_step_plain(
    x: torch.Tensor, partner: torch.Tensor, is_u: bool, w, wp, q: int,
    last: bool = False,
) -> torch.Tensor:
    """K11's forward plain version (``stage_math.py::fwd_stage_step``) on
    int64 words: x, partner in [0, 4q), the shard's u/v role ``is_u``, the
    positional twiddle row ``w`` with Shoup precon ``wp``.  Out [0, 4q), or
    [0, q) when ``last``."""
    two_q = 2 * q
    tx = mm.cond_sub(x if is_u else partner, two_q)
    t = mm.shoup_mulmod_lazy(partner if is_u else x, w, wp, q)
    out = (tx + t if is_u else tx + two_q - t) & mm.MASK32
    return mm.cond_sub(mm.cond_sub(out, two_q), q) if last else out


def inv_stage_step_plain(
    x: torch.Tensor, partner: torch.Tensor, is_u: bool, w, wp, q: int,
    scale: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """K11's inverse plain version (``stage_math.py::inv_stage_step``) on
    int64 words in [0, 2q): the sum at the u-half, the twiddled difference
    partner - x at the v-half; out [0, 2q).  ``scale`` = (s, s') applies
    the final Shoup product by s and one conditional subtraction, -> [0, q)
    (``stage_math.py::apply_scale``)."""
    two_q = 2 * q
    if is_u:
        out = mm.cond_sub((x + partner) & mm.MASK32, two_q)
    else:
        out = mm.shoup_mulmod_lazy((partner - x + two_q) & mm.MASK32, w, wp, q)
    if scale is not None:
        out = mm.cond_sub(mm.shoup_mulmod_lazy(out, scale[0], scale[1], q), q)
    return out
