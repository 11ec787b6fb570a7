"""Leveled RNS-BGV on the port's ring stack: exact integer arithmetic on an
NVIDIA GPU.

Counterpart of ``agilex_ntt_tpu/schemes/bgv.py``.  The ring, key and key
switch machinery is ``CKKSContext``'s; what changes is the plaintext
algebra:

- messages live in R_t for an NTT-friendly prime t ≡ 1 (mod 2n), so slot
  packing is the port's own transform: encode is ``Ring(n, q=t).intt`` of
  the slot matrix (K2 on the card), decode its ``ntt`` (K1);
- every sampled error is t·e (``_noise_mul = t``), so phases are
  m + t·(...) and decryption is exact: the centered phase mod t;
- the key-switch ModDown and the modulus switch use the t-multiple
  correction (``ops/basechange.rescale_bgv``): the subtracted correction is
  ≡ 0 mod t, so exactness survives the division by P or q_L;
- a modulus switch multiplies the message by q_L^-1 mod t; the
  ``Ciphertext.scale`` field tracks the accumulated factor f (message =
  [phase]_t · f mod t).

Slots form a (2, n/2) matrix: tau_5 rotates each row cyclically, tau_{2n-1}
swaps the rows.  ``rotate``, ``conjugate`` (the row swap), ``multiply`` and
``square`` with relinearization, ``mod_down_to`` and the key slicing by
level are ``CKKSContext``'s.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Optional

import numpy as np

from ..api import Ring
from ..params import find_primes
from .ckks import Ciphertext, CKKSContext, Plaintext

__all__ = ["BGVContext"]


class BGVContext(CKKSContext):
    """Leveled RNS-BGV over Z[X]/(X^n + 1): plaintexts in R_t, exact.

    t: NTT-friendly plaintext prime ≡ 1 (mod 2n); default the largest below
    2^t_bits (t_bits=16), disjoint from the 30-bit ciphertext chain.
    Slots: a (2, n/2) integer matrix mod t.  The other arguments are
    ``CKKSContext``'s (``device="cpu"`` for the plain versions).
    """

    def __init__(
        self,
        n: int,
        num_primes: int = 3,
        *,
        t: Optional[int] = None,
        t_bits: int = 16,
        **kwargs,
    ):
        super().__init__(n, num_primes, **kwargs)
        self.t = int(t) if t is not None else find_primes(n, 1, bits=t_bits)[0]
        if (self.t - 1) % (2 * n):
            raise ValueError(f"t={self.t} is not ≡ 1 mod 2n")
        if self.t in self.qs or self.t == self.p:
            raise ValueError("t must be disjoint from the ciphertext chain")
        self._noise_mul = self.t
        self._ks_plain_mod = self.t
        self.delta = 1  # BGV has no encoding scale; factors default to 1
        # the plaintext ring: slot packing by the port's own transforms
        self.tring = Ring(n, q=self.t, device=self.device)
        self._slot_pos = self._build_slot_positions()

    # -- slot structure ------------------------------------------------------

    def _build_slot_positions(self) -> np.ndarray:
        """(2, n/2) table: the output index of the plaintext ring's NTT that
        holds the evaluation at psi^(5^j) (row 0) and psi^(-5^j) (row 1).

        Derived: the NTT of the monomial X holds psi^{e_i} at position i, a
        discrete log over the odd exponents recovers e_i, and the rows are
        the two <5>-orbits of the odd residues mod 2n."""
        n, t = self.n, self.t
        x = np.zeros(n, dtype=np.uint32)
        x[1] = 1
        ev = self.tring.ntt(x).cpu().numpy()
        psi = self.tring._psi
        dlog = {}
        v = psi % t
        for k in range(1, 2 * n, 2):
            dlog[v] = k
            v = (v * psi * psi) % t
        e = np.array([dlog[int(w)] for w in ev])
        idx_of = {int(ex): i for i, ex in enumerate(e)}
        pos = np.empty((2, n // 2), dtype=np.int64)
        r = 1
        for j in range(n // 2):
            pos[0, j] = idx_of[r]
            pos[1, j] = idx_of[2 * n - r]
            r = (r * 5) % (2 * n)
        return pos

    # -- encoder ---------------------------------------------------------------

    def encode(self, mat, *, level: Optional[int] = None, scale=None
               ) -> Plaintext:
        """Slot matrix (..., 2, n/2) of ints mod t -> Plaintext.

        The coefficients (< t < q_l) serve every channel of the chain as
        they are.  ``scale`` is the BGV correction factor (default 1):
        encode at ``ct.scale`` to add or multiply into a modulus-switched
        ciphertext."""
        level = self.L if level is None else int(level)
        scale = Fraction(1) if scale is None else Fraction(scale)
        m = self._slots_to_coeffs(mat)
        rns = np.broadcast_to(m[None], (level,) + m.shape)
        return Plaintext(self._to_device(rns.copy()), level, scale)

    def _slots_to_coeffs(self, mat) -> np.ndarray:
        """Slot matrix (..., 2, n/2) -> coefficients (..., n) in [0, t), on
        the host."""
        mat = np.asarray(mat, dtype=np.int64) % self.t
        if mat.shape[-2:] != (2, self.n // 2):
            raise ValueError(
                f"expected slots (..., 2, {self.n // 2}), got {mat.shape}"
            )
        vals = np.zeros(mat.shape[:-2] + (self.n,), dtype=np.uint32)
        vals[..., self._slot_pos[0]] = mat[..., 0, :]
        vals[..., self._slot_pos[1]] = mat[..., 1, :]
        return self.tring.intt(vals).cpu().numpy()

    def _coeffs_to_slots(self, m: np.ndarray) -> np.ndarray:
        """Coefficients (..., n) in [0, t) -> slot matrix (..., 2, n/2)."""
        vals = self.tring.ntt(m.astype(np.uint32)).cpu().numpy()
        out = np.empty(m.shape[:-1] + (2, self.n // 2), dtype=np.int64)
        out[..., 0, :] = vals[..., self._slot_pos[0]]
        out[..., 1, :] = vals[..., self._slot_pos[1]]
        return out

    def decode(self, pt: Plaintext) -> np.ndarray:
        """Plaintext -> (..., 2, n/2) slot matrix mod t (exact)."""
        ring = self.base_ring(pt.level)
        big = ring.from_rns(pt.rns)
        q = ring.modulus
        centered = np.where(big > q // 2, big - q, big)
        m = (centered % self.t).astype(np.int64)  # object ints -> exact
        f = pt.scale
        if f != 1:
            fi = (int(f.numerator) * pow(int(f.denominator), -1, self.t)) \
                % self.t
            m = (m * fi) % self.t
        return self._coeffs_to_slots(m)

    # -- modulus switching -------------------------------------------------------

    def rescale(self, ct: Ciphertext) -> Ciphertext:
        """BGV modulus switch by the level's last prime: the noise divides
        by ~q_L, the message picks up the q_L factor tracked in ``scale``."""
        r = self.ring(ct.level)
        q_last = self.qs[ct.level - 1]
        return Ciphertext(
            r.rescale_bgv(ct.c0, self.t), r.rescale_bgv(ct.c1, self.t),
            ct.level - 1, ct.scale * q_last,
        )

    # -- the linear transform and matvec hooks -------------------------------
    # make_linear_op and apply_linear are CKKSContext's: the weights are slot
    # matrices packed by the plaintext ring, and _ks_plain_mod routes
    # hoisted_linear_sum through the t-correcting ModDown, so
    # sum_j w_j (*) rot_j(ct) stays exact mod t.

    def _encode_weights(self, w, scale, qs) -> np.ndarray:
        if scale != 1:
            raise ValueError(
                f"BGV weights carry no scale (factor must be 1), got {scale}"
            )
        m = self._slots_to_coeffs(w)
        return np.stack([(m % np.uint32(q)).astype(np.uint32) for q in qs])

    # The matrix is integer mod t and acts on each slot row: y_r = M @ z_r
    # (rotations shift each row cyclically, so the diagonals are row-wise).

    def _matvec_matrix(self, M) -> np.ndarray:
        S = self.n // 2
        M = np.asarray(M, dtype=np.int64) % self.t
        if M.shape != (S, S):
            raise ValueError(f"M must be ({S}, {S}) mod t, got {M.shape}")
        return M

    def _diag_slots(self, v) -> np.ndarray:
        # the same diagonal multiplies both rows
        return np.stack([v, v])

    # -- poly_eval hooks -------------------------------------------------------
    # poly_eval is CKKSContext's; these hooks swap the scale algebra: the BGV
    # "scale" is a mod-t correction factor (decode multiplies by it), so a
    # constant plaintext dictated to scale s carries c / s mod t, exactly.

    def _rescale_factor(self, level: int) -> Fraction:
        """A BGV modulus switch multiplies the factor by the dropped prime
        (see :meth:`rescale`)."""
        return Fraction(self.qs[level - 1])

    def _poly_eval_scale(self) -> Fraction:
        return Fraction(1)

    def _poly_eval_min_level(self) -> int:
        return 1  # exact mod t: any level decodes

    def _const_pt(self, c, level: int, scale: Fraction,
                  nbatch: int = 0) -> Plaintext:
        if c != int(c):
            raise ValueError(
                f"BGV coefficients must be integers mod t, got {c!r}"
            )
        s_mod_t = (scale.numerator
                   * pow(scale.denominator, -1, self.t)) % self.t
        f = (int(c) % self.t) * pow(s_mod_t, -1, self.t) % self.t
        mat = np.full((1,) * nbatch + (2, self.n // 2), f, dtype=np.int64)
        return self.encode(mat, level=level, scale=scale)
