"""Leveled RNS-BFV on the port's ring stack: scale-invariant exact
arithmetic on an NVIDIA GPU.

Counterpart of ``agilex_ntt_tpu/schemes/bfv.py``.  BFV stores the message
in the high bits, phase = Δ·m + e with Δ = floor(Q/t), so fresh noise is
not multiplied by t and ciphertexts at different moduli hold the same
message with no tracked factor.  What changes from ``BGVContext``:

- encode is Δ-scaled (per channel a host mulmod by [Δ]_{q_i}); decode is
  the exact big-integer rounding m = round(t·phase/Q) mod t;
- noise is plain e (``_noise_mul = 1``) and every key-switch ModDown is the
  plain divide and round (``_ks_plain_mod = None``);
- multiply is the HPS/BEHZ big-base pipeline: lift both ciphertexts from Q
  to the union basis Q ∪ B ∪ {m_sk} (float-corrected fast conversion),
  the tensor product there (``RNSRing.tensor``: K4a and K4b over all the
  union's channels), each part scaled by t/Q with the HPS rounding
  (``ops/basechange.scale_round``), back to Q exactly through the
  Shenoy-Kumaresan redundant modulus (``ops/basechange.base_convert_sk``),
  then relinearized.  The JAX package jits these into one dispatch; here
  they are composed eagerly, the conversions in int64 PyTorch;
- modulus switching is the plain divide and round ``rescale`` (Δ scales
  with Q, so ``scale`` stays 1); level alignment iterates it.

Rotations, the row swap, relinearization, the linear transforms and the
matvec are ``BGVContext``'s.  With ``mesh=`` the multiply is the JAX
package's sharded composition (``_multiply_mesh``): the lift, the union
basis's Karatsuba on ``ShardedRNSRing.polymul``, the scale and return
(``ShardedRNSRing.hps_scale_sk``) and the relinearization, each on the
mesh; word for word the single-device multiply.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..api import RNSRing
from ..ops import basechange
from ..parallel.mesh import ShardedRNSRing
from ..params import find_primes
from .bgv import BGVContext
from .ckks import Ciphertext, KeySet, Plaintext

__all__ = ["BFVContext"]


class BFVContext(BGVContext):
    """Leveled RNS-BFV over Z[X]/(X^n + 1): plaintexts in R_t, exact,
    scale-invariant (message in the high bits, Δ = floor(Q_level / t)).

    Slots: a (2, n/2) integer matrix mod t (BGV's slot structure).
    ``scale`` is always 1.  The arguments are ``BGVContext``'s.
    """

    def __init__(self, n: int, num_primes: int = 3, **kwargs):
        super().__init__(n, num_primes, **kwargs)
        # undo BGV's noise and key-switch hooks: BFV noise is plain e and
        # the key-switch ModDown is the plain divide and round
        self._noise_mul = 1
        self._ks_plain_mod = None
        self._bfv_aux: Dict[int, Tuple[Tuple[int, ...], RNSRing]] = {}

    # -- encoder ---------------------------------------------------------

    def delta_at(self, level: int) -> int:
        """Δ = floor(Q_level / t), the message scale at ``level``."""
        return self.q_at(level) // self.t

    def encode(self, mat, *, level: Optional[int] = None, scale=None
               ) -> Plaintext:
        """Slot matrix (..., 2, n/2) mod t -> Δ-scaled Plaintext (for
        encrypt and add_plain).  Plaintexts to multiply by take
        :meth:`encode_mul`: a Δ² product would overflow."""
        level = self.L if level is None else int(level)
        if scale is not None and Fraction(scale) != 1:
            raise ValueError("BFV is scale-invariant; scale must be 1")
        m = self._slots_to_coeffs(mat).astype(np.uint64)  # [0, t)
        delta = self.delta_at(level)
        rns = np.stack(
            [((delta % q) * m % q).astype(np.uint32)
             for q in self.qs[:level]]
        )
        return Plaintext(self._to_device(rns), level, Fraction(1))

    def encode_mul(self, mat, *, level: Optional[int] = None) -> Plaintext:
        """The raw (unscaled) encoding mod each prime, the mul_plain and
        weight form: phase Δ·m times raw w stays Δ·(m·w)."""
        return BGVContext.encode(self, mat, level=level)

    def decode(self, pt: Plaintext) -> np.ndarray:
        """Plaintext (a decrypted phase) -> (..., 2, n/2) slots, exact:
        m = round(t·phase / Q) mod t by host big-integer CRT."""
        if pt.scale != 1:
            raise ValueError(f"BFV plaintexts carry scale 1, got {pt.scale}")
        ring = self.base_ring(pt.level)
        big = ring.from_rns(pt.rns)  # object ints in [0, Q)
        q = ring.modulus
        m = ((2 * self.t * big + q) // (2 * q)) % self.t
        return self._coeffs_to_slots(m)

    # -- plaintext ops ------------------------------------------------------

    def add_plain(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        """Δ-encodings are level-specific (Δ depends on Q_level): unlike
        small-residue encodings they cannot be channel-sliced."""
        if pt.level != ct.level:
            raise ValueError(
                f"BFV add_plain needs the plaintext encoded at the "
                f"ciphertext's level ({ct.level}), got {pt.level}"
            )
        return super().add_plain(ct, pt)

    # -- modulus switching ----------------------------------------------------

    def rescale(self, ct: Ciphertext) -> Ciphertext:
        """BFV modulus switch: the plain divide and round by the level's
        last prime.  Δ scales with Q, so the message is untouched."""
        r = self.ring(ct.level)
        return Ciphertext(
            r.rescale(ct.c0), r.rescale(ct.c1), ct.level - 1, ct.scale
        )

    def mod_down_to(self, ct: Ciphertext, level: int) -> Ciphertext:
        """Align by iterated modulus switching (dropping limbs would destroy
        BFV's high-bit message)."""
        if level > ct.level:
            raise ValueError(f"cannot raise level {ct.level} -> {level}")
        self.base_ring(max(level, 1))  # validates the target level
        while ct.level > level:
            ct = self.rescale(ct)
        return ct

    # -- the HPS multiply ---------------------------------------------------

    def _aux(self, level: int) -> Tuple[Tuple[int, ...], RNSRing]:
        """The auxiliary basis B ∪ {m_sk} at ``level`` (m_sk last): primes
        disjoint from (Q, P, t) with B > 64·n·t·Q_level, since the tensor
        of two [0, 2Q) representatives scales to y = round(t·x/Q) <
        4·n·t·Q + 1 and Shenoy-Kumaresan needs y < B.  With it the union
        ring Q_level ∪ B ∪ {m_sk} on the context's device, whose kernels
        run the tensor.  Built once a level."""
        hit = self._bfv_aux.get(level)
        if hit is not None:
            return hit
        used = set(self.qs) | {self.p, self.t}
        bound = 64 * self.n * self.t * self.q_at(level)
        cands = [
            q for q in find_primes(self.n, self.L + 1 + level + 4)
            if q not in used
        ]
        bs, prod = [], 1
        for q in cands:
            if prod > bound:
                break
            bs.append(q)
            prod *= q
        if prod <= bound or len(cands) <= len(bs):
            raise ValueError(
                f"not enough auxiliary primes for level {level}"
            )
        aux = tuple(bs) + (cands[len(bs)],)   # last = m_sk
        rbig = RNSRing(self.n, qs=tuple(self.qs[:level]) + aux,
                       device=self.device, **self._ring_kwargs)
        self._bfv_aux[level] = (aux, rbig)
        return aux, rbig

    def _lift(self, c: torch.Tensor, level: int) -> torch.Tensor:
        """A part (level, ..., n) mod Q into the union basis: its residues,
        then the float-corrected fast conversion into B ∪ {m_sk}."""
        aux, _ = self._aux(level)
        ext = self.base_ring(level).base_convert(c, aux, correction="float")
        return torch.cat([c, ext])

    def _scale_down(self, d: torch.Tensor, level: int) -> torch.Tensor:
        """A tensor part (union basis) -> round(t·d/Q) mod Q: the HPS scale
        and round into B ∪ {m_sk}, then the exact Shenoy-Kumaresan return."""
        aux, _ = self._aux(level)
        qs = self.qs[:level]
        d = d.to(torch.int64)
        y = basechange.scale_round(d[:level], d[level:], qs, aux, self.t)
        return basechange.base_convert_sk(
            y[:-1], y[-1], aux[:-1], aux[-1], qs
        ).to(torch.uint32)

    def _big_sharded(self, level: int) -> ShardedRNSRing:
        """The union-basis ring Q_level ∪ B ∪ {m_sk} as a ShardedRNSRing
        placed like the context's rings (dp/sp; the channel axis whole)."""
        key = ("bfv_big", level)
        r = self._sharded.get(key)
        if r is None:
            _, rbig = self._aux(level)
            r = ShardedRNSRing(rbig, self.mesh, dp_axis=self.dp_axis,
                               sp_axis=self.sp_axis)
            self._sharded[key] = r
        return r

    def _multiply_mesh(self, a: Ciphertext, b: Optional[Ciphertext],
                       keys: KeySet) -> Ciphertext:
        """The HPS pipeline on the mesh, composed from the sharded ring ops:
        the float-corrected lift, the union basis's Karatsuba on three
        sharded polymuls (square: three products and a doubling), the HPS
        t/Q scale and exact return (``hps_scale_sk``), the hoisted
        relinearization.  Every stage is coefficient-pointwise or a
        sharded transform, so the dp/sp blocks exchange nothing else."""
        level = a.level
        rq = self.ring(level)
        aux, _ = self._aux(level)
        rbig = self._big_sharded(level)
        qs = tuple(self.qs[:level])

        def lift(c):
            ext = rq.base_convert(c, aux, correction="float")
            return rbig.shard(torch.cat([c.to(ext.device), ext]))

        a0, a1 = lift(a.c0), lift(a.c1)
        if b is None:
            d0 = rbig.polymul(a0, a0)
            d2 = rbig.polymul(a1, a1)
            x = rbig.polymul(a0, a1)
            d1 = rbig.add(x, x)
        else:
            b0, b1 = lift(b.c0), lift(b.c1)
            d0 = rbig.polymul(a0, b0)
            d2 = rbig.polymul(a1, b1)
            cross = rbig.polymul(rbig.add(a0, a1), rbig.add(b0, b1))
            d1 = rbig.sub(rbig.sub(cross, d0), d2)
        d0q, d1q, d2q = (rq.shard(rq.hps_scale_sk(d, qs, aux, self.t))
                         for d in (d0, d1, d2))
        hs = self._keyswitch_pair(d2q, self._key_pair(keys), level, 1)
        return Ciphertext(rq.add(d0q, hs[0]), rq.add(d1q, hs[1]), level,
                          Fraction(1))

    def _hps_multiply(self, a: Ciphertext, b: Optional[Ciphertext],
                      keys: KeySet) -> Ciphertext:
        """lift -> union-basis tensor (square when ``b`` is None) -> scale
        and return to Q -> relinearize (on a mesh ``_multiply_mesh``)."""
        if self.mesh is not None:
            return self._multiply_mesh(a, b, keys)
        level = a.level
        _, rbig = self._aux(level)
        if b is None:
            parts = rbig.tensor_square(self._lift(a.c0, level),
                                       self._lift(a.c1, level))
        else:
            parts = rbig.tensor(*(self._lift(c, level)
                                  for c in (a.c0, a.c1, b.c0, b.c1)))
        d0, d1, d2 = (self._scale_down(d, level) for d in parts)
        r = self.ring(level)
        hs = self._keyswitch_pair(d2, self._key_pair(keys), level, 1)
        return Ciphertext(r.add(d0, hs[0]), r.add(d1, hs[1]), level,
                          Fraction(1))

    def multiply(
        self, a: Ciphertext, b: Ciphertext, keys: KeySet
    ) -> Ciphertext:
        if a.level != b.level:
            raise ValueError(
                f"level mismatch {a.level} != {b.level}; mod_down_to first"
            )
        return self._hps_multiply(a, b, keys)

    def square(self, a: Ciphertext, keys: KeySet) -> Ciphertext:
        return self._hps_multiply(a, None, keys)
