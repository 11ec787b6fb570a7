"""RNS-CKKS on the port's ``RNSRing``: approximate arithmetic on encrypted
complex vectors, on an NVIDIA GPU.

Counterpart of ``agilex_ntt_tpu/schemes/ckks.py``: the canonical-embedding
encoder (host numpy, its own copy), key generation, public- and secret-key
encryption, and the evaluator (add, multiply and relinearize, rescale,
rotate, conjugate, plaintext ops, the hoisted BSGS linear transform, the
two-level BSGS matrix-vector product, polynomial evaluation in the power
and Chebyshev bases).  Residues are ``torch.uint32`` tensors (level, ...,
n) on the context's device; every ring operation goes through
``RNSRing``, so the transforms and products run the multi-prime kernels
(K4a, K4b, K5) on the card.

Every secret, error, mask and uniform draw comes from the context's numpy
Generator with the same calls in the same order as the JAX package's
context, so two contexts given ``np.random.default_rng(s)`` hold the same
keys and produce the same ciphertexts word for word.

Key material is generated once in the top basis Q·P and kept in the
evaluation domain (and in the coefficient domain beside it).  At level l
the same arrays serve, sliced to digit rows :l and channels (0..l-1, K-1):
the CRT idempotents satisfy g_d ≡ g_d^(l) (mod Q_l), and the gadget
identity only has to hold mod Q_l.

With ``mesh=`` the evaluator runs on ``parallel.ShardedRNSRing`` (batch
over ``dp_axis``, coefficients over ``sp_axis``), as the JAX package's
does: the key switches take the coefficient-domain keys
(``rlk_coeff``/``gk_coeff``) and each step's polydot transforms its digits
again; a ``LinearOp`` or ``MatVecOp`` is built in the coefficient domain.
The outputs equal the single-device context's word for word.  Parameter
selection, constant time and noise tracking are out of scope, as there.
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api import TPU_ONLY_ARGS, RNSRing, _refuse_unknown, _resolve_device
from ..parallel.mesh import ShardedRNSRing
from ..params import find_primes

__all__ = [
    "CKKSContext",
    "Ciphertext",
    "KeySet",
    "LinearOp",
    "MatVecOp",
    "Plaintext",
    "ciphertext_from_numpy",
    "decode_coeffs",
    "encode_coeffs",
    "keyset_from_numpy",
]


# ---------------------------------------------------------------------------
# canonical-embedding encoder (host numpy FFT)
# ---------------------------------------------------------------------------


def _rot_group(n: int) -> np.ndarray:
    """Slot evaluation order: 5^j mod 2n, j = 0..n/2-1 (tau_5 is then a
    cyclic slot shift)."""
    out = np.empty(n // 2, dtype=np.int64)
    r = 1
    for j in range(n // 2):
        out[j] = r
        r = (r * 5) % (2 * n)
    return out


def encode_coeffs(z, n: int, scale) -> np.ndarray:
    """Complex slots (..., n/2) -> signed integer coefficients (..., n):
    the conjugate-symmetric length-2n spectrum (slot j at 5^j mod 2n, its
    conjugate at the negated index), inverse FFT, the scaled real part of
    the first half rounded."""
    z = np.asarray(z, dtype=np.complex128)
    if z.shape[-1] != n // 2:
        raise ValueError(f"expected {n // 2} slots, got {z.shape[-1]}")
    m2 = 2 * n
    rg = _rot_group(n)
    spec = np.zeros(z.shape[:-1] + (m2,), dtype=np.complex128)
    spec[..., rg] = 2.0 * z
    spec[..., m2 - rg] = 2.0 * np.conj(z)
    m = np.real(np.fft.ifft(spec, axis=-1))[..., :n]
    return np.rint(m * float(scale)).astype(np.int64)


def decode_coeffs(m, n: int, scale) -> np.ndarray:
    """Signed coefficients (..., n) -> complex slots (..., n/2): the odd
    lines of a length-2n FFT in 5^j order, over the scale."""
    m = np.asarray(m, dtype=np.float64)
    if m.shape[-1] != n:
        raise ValueError(f"expected n={n} coefficients, got {m.shape[-1]}")
    spec = np.fft.fft(m, n=2 * n, axis=-1)
    return spec[..., _rot_group(n)] / float(scale)


# ---------------------------------------------------------------------------
# data types
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Plaintext:
    """Encoded message: residues (level, ..., n) at a scale."""

    rns: torch.Tensor
    level: int
    scale: Fraction


@dataclasses.dataclass
class Ciphertext:
    """Degree-1 RLWE ciphertext (c0, c1), each (level, ..., n)."""

    c0: torch.Tensor
    c1: torch.Tensor
    level: int
    scale: Fraction


@dataclasses.dataclass
class KeySet:
    """Everything keygen produces; the evaluator reads only ``rlk`` and
    ``gk`` (evaluation domain).  The coefficient-domain halves are kept
    beside them, as the JAX package keeps them for its sharded ops."""

    sk: np.ndarray                  # ternary secret, host (n,) int64
    sk_rns: torch.Tensor            # its residues in the ext basis (K, n)
    pk: Tuple[torch.Tensor, torch.Tensor]         # (p0, p1), each (L, n)
    rlk: Tuple[torch.Tensor, torch.Tensor]        # (dnum, K, n) x 2
    gk: Dict[int, Tuple[torch.Tensor, torch.Tensor]]  # Galois elt -> pair
    rlk_coeff: Tuple[torch.Tensor, torch.Tensor] = None
    gk_coeff: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = None


@dataclasses.dataclass
class MatVecOp:
    """A two-level BSGS matrix-vector product, built once: the baby steps'
    interleaved rotation keys for one hoisted call, the diagonals in the
    evaluation domain (level, g, b, n), and the giant steps' keys."""

    b: int                          # baby steps
    g: int                          # giant steps
    baby_gs: Tuple[int, ...]        # Galois elements for j = 1..b-1
    baby_ks: Tuple[int, ...]        # interleaved (g_j, g_j)
    baby_ksks: Optional[torch.Tensor]  # (2(b-1), dnum_l, K_l, n)
    pts: torch.Tensor               # diagonals: domain "ntt" (no mesh) =
                                    # (level, g, b, n) evaluation domain;
                                    # "coeff" (mesh) = (g, level, b, n)
    giants: Tuple[Tuple[int, torch.Tensor], ...]  # (elt, sliced key pair)
    level: int
    scale: Fraction
    domain: str = "ntt"


@dataclasses.dataclass
class LinearOp:
    """A hoisted BSGS linear transform, built once for one level: the
    weights in the extended basis (evaluation domain; coefficient domain
    on a mesh), and the keys."""

    gs: Tuple[int, ...]
    pts: torch.Tensor               # (nk, K_l, n), ext basis
    kb: torch.Tensor                # (nk, dnum_l, K_l, n)
    ka: torch.Tensor
    level: int
    scale: Fraction
    domain: str = "ntt"


def _field(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.uint32, copy=True)).to(device)


def keyset_from_numpy(keys, *, device=None) -> KeySet:
    """The port's ``KeySet`` from another key set's arrays: ``keys`` has
    ``sk``, ``sk_rns``, ``pk``, ``rlk``, ``gk`` and optionally ``rlk_coeff``
    and ``gk_coeff``, as attributes or mapping keys, holding anything numpy
    reads (a JAX ``KeySet``, or its arrays as numpy)."""
    dev = _resolve_device(device)

    def pair(p):
        return None if p is None else (_tensor(p[0], dev), _tensor(p[1], dev))

    def table(t):
        return None if t is None else {int(g): pair(p) for g, p in t.items()}

    def opt(name):
        try:
            return _field(keys, name)
        except (KeyError, AttributeError):
            return None

    return KeySet(
        sk=np.asarray(_field(keys, "sk"), dtype=np.int64),
        sk_rns=_tensor(_field(keys, "sk_rns"), dev),
        pk=pair(_field(keys, "pk")),
        rlk=pair(_field(keys, "rlk")),
        gk=table(_field(keys, "gk")),
        rlk_coeff=pair(opt("rlk_coeff")),
        gk_coeff=table(opt("gk_coeff")),
    )


def ciphertext_from_numpy(ct, *, device=None) -> Ciphertext:
    """The port's ``Ciphertext`` from ``c0``, ``c1``, ``level`` and
    ``scale``, as attributes or mapping keys (a JAX ``Ciphertext``, or its
    arrays as numpy)."""
    dev = _resolve_device(device)
    return Ciphertext(
        _tensor(_field(ct, "c0"), dev), _tensor(_field(ct, "c1"), dev),
        int(_field(ct, "level")), Fraction(_field(ct, "scale")),
    )


class CKKSContext:
    """Leveled RNS-CKKS over Z[X]/(X^n + 1) with an L-prime chain Q and one
    special prime P (hybrid key switching, one digit a prime).

    The base of the BGV context in the JAX package, through two hooks:
    ``_noise_mul`` (BGV noise is t*e) and ``_ks_plain_mod`` (BGV's ModDown
    keeps the phase mod t).

    Parameters
    ----------
    n:           ring degree (a power of two); n/2 complex slots.
    num_primes:  L, the chain length (levels L..1).
    delta:       encoding scale (default 2^(bits-1)).
    qs, p:       explicit chain and special prime (default: the largest
                 NTT-friendly prime below 2^bits is P, the next L are Q).
    rng:         numpy Generator for all sampling (keygen, encryption).
    error_std:   rounded-gaussian error width.
    mesh:        optional ``parallel.Mesh``: evaluator ops then run on
                 ``ShardedRNSRing`` (batch over ``dp_axis``, coefficients
                 over ``sp_axis``), word for word the single-device path.
                 Ciphertexts carry exactly one batch dim (level, B, n);
                 ``place`` puts them on the mesh.  Keygen, encode, encrypt
                 and decrypt stay on the base rings.  On a mesh of several
                 processes (``multihost.pod_mesh``) every process builds
                 the context with a Generator of the same seed and makes
                 the same calls: each draws the same keys, noise and masks
                 (no key is broadcast), runs its own block of each op and
                 gets the global ciphertext on its own card.
    device:      ``None`` for the current CUDA device (on a mesh of several
                 processes, this process's device ``mesh.home``), or
                 ``"cpu"`` for the plain versions.
    ring_kwargs: forwarded to every ``RNSRing`` (``method``, ``psi``,
                 ``fourstep_kernel``); the TPU-only ``backend``,
                 ``block_rows`` and ``interpret`` raise ``TypeError``.
    """

    _noise_mul: int = 1        # every sampled error is multiplied by this
    _ks_plain_mod: Optional[int] = None  # t-correcting ModDown when set

    def __init__(
        self,
        n: int,
        num_primes: int = 3,
        *,
        delta: Optional[int] = None,
        qs: Optional[Sequence[int]] = None,
        p: Optional[int] = None,
        bits: int = 30,
        rng: Optional[np.random.Generator] = None,
        error_std: float = 3.2,
        mesh=None,
        dp_axis: str = "dp",
        sp_axis: Optional[str] = None,
        device=None,
        **ring_kwargs,
    ):
        _refuse_unknown(
            "CKKSContext", [k for k in ring_kwargs if k in TPU_ONLY_ARGS]
        )
        if qs is None or p is None:
            primes = find_primes(n, num_primes + 1, bits=bits)
            if p is None:
                p = primes[0]          # the largest is the special prime
            if qs is None:
                qs = [q for q in primes if q != p][:num_primes]
        self.n = int(n)
        self.qs: Tuple[int, ...] = tuple(int(q) for q in qs)
        self.p = int(p)
        self.L = len(self.qs)
        self.delta = int(delta) if delta is not None else 1 << (bits - 1)
        self.error_std = float(error_std)
        self.rng = rng if rng is not None else np.random.default_rng(0)
        if device is None and mesh is not None and mesh.multiprocess:
            device = mesh.home  # never another rank's card
        self.device = _resolve_device(device)
        self.mesh = mesh
        self.dp_axis = dp_axis
        self.sp_axis = sp_axis
        self._ring_kwargs = ring_kwargs
        self._rings: Dict[int, RNSRing] = {}
        self._ext: Dict[int, RNSRing] = {}
        self._sharded: Dict[object, ShardedRNSRing] = {}
        self._key_slices: Dict[tuple, tuple] = {}

    # -- bases ------------------------------------------------------------

    def base_ring(self, level: int) -> RNSRing:
        """The ring at ``level`` (primes qs[:level])."""
        if not 1 <= level <= self.L:
            raise ValueError(f"level must be in [1, {self.L}], got {level}")
        r = self._rings.get(level)
        if r is None:
            r = RNSRing(self.n, qs=self.qs[:level], device=self.device,
                        **self._ring_kwargs)
            self._rings[level] = r
        return r

    def ring(self, level: int):
        """The ring the evaluator dispatches to: the base ring, or its
        ``ShardedRNSRing`` when the context has a mesh."""
        if self.mesh is None:
            return self.base_ring(level)
        r = self._sharded.get(level)
        if r is None:
            r = ShardedRNSRing(
                self.base_ring(level), self.mesh,
                dp_axis=self.dp_axis, sp_axis=self.sp_axis,
            )
            self._sharded[level] = r
        return r

    def place(self, ct: Ciphertext) -> Ciphertext:
        """The ciphertext's parts placed with the mesh sharding (no mesh:
        the ciphertext itself)."""
        if self.mesh is None:
            return ct
        r = self.ring(ct.level)
        return Ciphertext(r.shard(ct.c0), r.shard(ct.c1), ct.level, ct.scale)

    def ext_ring(self, level: int) -> RNSRing:
        """The extended ring at ``level`` (primes qs[:level] + (P,))."""
        r = self._ext.get(level)
        if r is None:
            r = RNSRing(self.n, qs=self.qs[:level] + (self.p,),
                        device=self.device, **self._ring_kwargs)
            self._ext[level] = r
        return r

    def q_at(self, level: int) -> int:
        out = 1
        for q in self.qs[:level]:
            out *= q
        return out

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # -- encoder ----------------------------------------------------------

    def encode(
        self, z, *, level: Optional[int] = None, scale=None
    ) -> Plaintext:
        """Complex slots (..., n/2) -> Plaintext residues (level, ..., n)."""
        level = self.L if level is None else int(level)
        scale = Fraction(self.delta) if scale is None else Fraction(scale)
        m = encode_coeffs(z, self.n, scale)
        rns = np.stack(
            [(m % q).astype(np.uint32) for q in self.qs[:level]], axis=0
        )
        return Plaintext(self._to_device(rns), level, scale)

    def decode(self, pt: Plaintext) -> np.ndarray:
        """Plaintext -> complex slots, by exact CRT and the centered lift."""
        ring = self.base_ring(pt.level)
        big = ring.from_rns(pt.rns)
        q = ring.modulus
        centered = np.where(big > q // 2, big - q, big).astype(np.float64)
        return decode_coeffs(centered, self.n, pt.scale)

    # -- sampling (host numpy; uniform per channel is uniform mod Q) ------

    def _uniform(self, qs: Sequence[int], shape) -> np.ndarray:
        return np.stack(
            [
                self.rng.integers(0, q, size=shape).astype(np.uint32)
                for q in qs
            ],
            axis=0,
        )

    def _gauss_rns(self, qs: Sequence[int], shape) -> np.ndarray:
        e = self._noise_mul * np.rint(
            self.rng.normal(0.0, self.error_std, shape)
        ).astype(np.int64)
        return np.stack([(e % q).astype(np.uint32) for q in qs], axis=0)

    def _ternary(self, shape) -> np.ndarray:
        return self.rng.integers(-1, 2, size=shape).astype(np.int64)

    # -- key generation -----------------------------------------------------

    def _pg_residues(self) -> np.ndarray:
        """(dnum=L, K): P * g_d mod each ext prime, g_d the CRT idempotent
        of q_d in Q (host big integers, once at keygen)."""
        Q = self.q_at(self.L)
        ext_qs = self.qs + (self.p,)
        out = np.empty((self.L, self.L + 1), dtype=np.uint32)
        for d, qd in enumerate(self.qs):
            qhat = Q // qd
            g = qhat * pow(qhat % qd, -1, qd)
            pg = self.p * g
            out[d] = [pg % q for q in ext_qs]
        return out

    def _make_ksk(self, target_ext: torch.Tensor, s_ext: torch.Tensor,
                  rqp: RNSRing):
        """Gadget-encrypt ``target`` (residues (K, n), e.g. of s^2 or
        tau_g(s)) under s: row d is (-(a_d s) + e_d + P g_d target, a_d).
        Returns the halves (dnum, K, n) in both domains: (b_ntt, a_ntt,
        b_coeff, a_coeff)."""
        K, n = self.L + 1, self.n
        ext_qs = np.array(self.qs + (self.p,), dtype=np.uint64)
        pg = self._pg_residues()
        tgt = target_ext.cpu().numpy().astype(np.uint64)
        a = self._uniform(self.qs + (self.p,), (self.L, n))  # (K, dnum, n)
        a_s = rqp.polymul(self._to_device(a), s_ext[:, None, :])
        a_s = np.moveaxis(a_s.cpu().numpy(), 0, 1).astype(np.uint64)
        a = np.moveaxis(a, 0, 1)                              # (dnum, K, n)
        b = np.empty((self.L, K, n), dtype=np.uint32)
        for d in range(self.L):
            e = self._gauss_rns(self.qs + (self.p,), (n,)).astype(np.uint64)
            pgt = (pg[d][:, None].astype(np.uint64) * tgt) % ext_qs[:, None]
            b[d] = ((pgt + e + ext_qs[:, None] - a_s[d]) % ext_qs[:, None]
                    ).astype(np.uint32)
        rq = self.base_ring(self.L)
        b, a = self._to_device(b), self._to_device(a)
        return (
            rq.ksk_to_ntt(b, rqp, ch_axis=1),
            rq.ksk_to_ntt(a, rqp, ch_axis=1),
            b,
            a,
        )

    def keygen(self, galois_steps: Sequence[int] = ()) -> KeySet:
        """A ternary secret, the public key, the relinearization key, and
        rotation keys for ``galois_steps`` (slot shifts), the conjugation
        key and the identity's (g = 1, so that a rotation by 0 takes the
        same path as any other term of a linear transform)."""
        n = self.n
        rq, rqp = self.base_ring(self.L), self.ext_ring(self.L)
        s = self._ternary((n,))
        ext_qs = self.qs + (self.p,)
        s_ext = self._to_device(
            np.stack([(s % q).astype(np.uint32) for q in ext_qs])
        )
        # the public key at the top level: (-(a s) + e, a)
        a = self._to_device(self._uniform(self.qs, (n,)))
        e = self._to_device(self._gauss_rns(self.qs, (n,)))
        p0 = rq.sub(e, rq.polymul(a, s_ext[: self.L]))
        # the relinearization key carries s^2
        s2_ext = rqp.polymul(s_ext, s_ext)
        rb, ra, rbc, rac = self._make_ksk(s2_ext, s_ext, rqp)
        # the rotation and conjugation keys carry tau_g(s)
        elts = {self.galois_element(int(t)) for t in galois_steps}
        elts.add(2 * n - 1)
        elts.add(1)
        gk: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        gk_coeff: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        for g in sorted(elts):
            gb, ga, gbc, gac = self._make_ksk(
                rqp.automorphism(s_ext, g), s_ext, rqp
            )
            gk[g] = (gb, ga)
            gk_coeff[g] = (gbc, gac)
        return KeySet(sk=s, sk_rns=s_ext, pk=(p0, a), rlk=(rb, ra), gk=gk,
                      rlk_coeff=(rbc, rac), gk_coeff=gk_coeff)

    def galois_element(self, t: int) -> int:
        """Slot rotation by ``t`` (left) as a Galois element 5^t mod 2n."""
        return pow(5, t % (self.n // 2), 2 * self.n)

    # -- encryption ---------------------------------------------------------

    def _residues(self, v: np.ndarray, level: int) -> torch.Tensor:
        return self._to_device(
            np.stack([(v % q).astype(np.uint32) for q in self.qs[:level]])
        )

    def encrypt(self, pt: Plaintext, keys: KeySet) -> Ciphertext:
        """Public-key encryption: (pk0 v + m + e0, pk1 v + e1)."""
        lvl = pt.level
        r = self.base_ring(lvl)
        shape = tuple(pt.rns.shape[1:])
        v_rns = self._residues(self._ternary(shape), lvl)
        e0 = self._to_device(self._gauss_rns(self.qs[:lvl], shape))
        e1 = self._to_device(self._gauss_rns(self.qs[:lvl], shape))
        pk0, pk1 = keys.pk
        pk0, pk1 = pk0[:lvl], pk1[:lvl]
        c0 = r.add(r.add(r.polymul(pk0, v_rns), pt.rns), e0)
        c1 = r.add(r.polymul(pk1, v_rns), e1)
        return Ciphertext(c0, c1, lvl, pt.scale)

    def encrypt_symmetric(self, pt: Plaintext, keys: KeySet) -> Ciphertext:
        """Secret-key encryption: (-(a s) + m + e, a)."""
        lvl = pt.level
        r = self.base_ring(lvl)
        shape = tuple(pt.rns.shape[1:])
        a = self._to_device(self._uniform(self.qs[:lvl], shape))
        e = self._to_device(self._gauss_rns(self.qs[:lvl], shape))
        c0 = r.sub(r.add(pt.rns, e), r.polymul(a, keys.sk_rns[:lvl]))
        return Ciphertext(c0, a, lvl, pt.scale)

    def decrypt(self, ct: Ciphertext, keys: KeySet) -> Plaintext:
        """The phase c0 + c1 s as a Plaintext (``decode`` gives the
        slots)."""
        r = self.base_ring(ct.level)
        ph = r.add(ct.c0, r.polymul(ct.c1, keys.sk_rns[: ct.level]))
        return Plaintext(ph, ct.level, ct.scale)

    # -- evaluator: linear ops ---------------------------------------------

    def _aligned(self, a: Ciphertext, b: Ciphertext) -> RNSRing:
        if a.level != b.level:
            raise ValueError(
                f"level mismatch {a.level} != {b.level}; mod_down_to first"
            )
        if a.scale != b.scale:
            raise ValueError(
                f"scale mismatch {a.scale} != {b.scale}; rescale/encode to "
                "matching scales"
            )
        return self.ring(a.level)

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        r = self._aligned(a, b)
        return Ciphertext(
            r.add(a.c0, b.c0), r.add(a.c1, b.c1), a.level, a.scale
        )

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        r = self._aligned(a, b)
        return Ciphertext(
            r.sub(a.c0, b.c0), r.sub(a.c1, b.c1), a.level, a.scale
        )

    def negate(self, a: Ciphertext) -> Ciphertext:
        r = self.ring(a.level)
        return Ciphertext(r.neg(a.c0), r.neg(a.c1), a.level, a.scale)

    def _pt_at(self, pt: Plaintext, level: int) -> torch.Tensor:
        """Plaintext residues restricted to ``level`` channels (encodings
        are residues of small signed integers, so dropping channels keeps
        the value)."""
        if pt.level < level:
            raise ValueError(
                f"plaintext at level {pt.level} < ciphertext {level}"
            )
        return pt.rns[:level]

    def add_plain(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        if pt.scale != ct.scale:
            raise ValueError(f"scale mismatch {pt.scale} != {ct.scale}")
        r = self.ring(ct.level)
        w = self._pt_at(pt, ct.level).expand(ct.c0.shape)
        return Ciphertext(r.add(ct.c0, w), ct.c1, ct.level, ct.scale)

    def mul_plain(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        r = self.ring(ct.level)
        w = self._pt_at(pt, ct.level).expand(ct.c0.shape)
        return Ciphertext(
            r.polymul(ct.c0, w), r.polymul(ct.c1, w),
            ct.level, ct.scale * pt.scale,
        )

    # -- evaluator: multiply / relinearize / rescale -------------------------

    def _sliced_keys(self, pair, level: int) -> torch.Tensor:
        """The (b, a) halves restricted to ``level`` and stacked: digit rows
        :level, channels (0..level-1, K-1).  Cached per key; the entry pins
        the parent tensors so that their id() cannot be reused by another
        key's."""
        ck = (id(pair[0]), id(pair[1]), level)
        hit = self._key_slices.get(ck)
        if hit is not None:
            return hit[1]
        idx = torch.tensor(list(range(level)) + [self.L],
                           device=pair[0].device)
        out = torch.stack(
            [pair[0][:level].index_select(1, idx),
             pair[1][:level].index_select(1, idx)]
        )
        self._key_slices[ck] = (pair, out)
        return out

    def _ksk_domain(self) -> dict:
        """The key domain of the active ring's key switches: evaluation
        domain on one device, coefficient domain (the sharded ops' only
        one) on a mesh."""
        return {} if self.mesh is not None else {"ksk_domain": "ntt"}

    def _keyswitch_pair(self, x: torch.Tensor, pair, level: int,
                        g: int) -> torch.Tensor:
        """keyswitch(tau_g(x)) against both key halves with one hoisted
        decomposition: (2, level, ..., n), the b-half's and the a-half's.
        ``pair`` is in the domain ``_key_pair`` picks."""
        return self.ring(level).hoisted_keyswitch(
            x, self._sliced_keys(pair, level), (g, g), self.ext_ring(level),
            level, plain_mod=self._ks_plain_mod, **self._ksk_domain(),
        )

    def _key_pair(self, keys: KeySet, g: Optional[int] = None):
        """The (b, a) halves in the domain the active ring needs (evaluation
        domain, coefficient domain on a mesh): the relinearization key when
        ``g`` is None, else the rotation key of ``g`` (None if absent)."""
        coeff = self.mesh is not None
        if g is None:
            return keys.rlk_coeff if coeff else keys.rlk
        table = keys.gk_coeff if coeff else keys.gk
        return (table or {}).get(g)

    def multiply(
        self, a: Ciphertext, b: Ciphertext, keys: KeySet
    ) -> Ciphertext:
        """Tensor product and relinearization: one forward launch of the four
        parts, Karatsuba on the transforms, one inverse launch, then the
        degree-2 part through one hoisted two-half key switch.  Scales
        multiply (they need not match)."""
        if a.level != b.level:
            raise ValueError(
                f"level mismatch {a.level} != {b.level}; mod_down_to first"
            )
        r = self.ring(a.level)
        if self.mesh is None:
            d0, d1, d2 = r.tensor(a.c0, a.c1, b.c0, b.c1)
        else:  # Karatsuba on the sharded polymuls
            d0 = r.polymul(a.c0, b.c0)
            d2 = r.polymul(a.c1, b.c1)
            cross = r.polymul(r.add(a.c0, a.c1), r.add(b.c0, b.c1))
            d1 = r.sub(r.sub(cross, d0), d2)
        hs = self._keyswitch_pair(d2, self._key_pair(keys), a.level, 1)
        return Ciphertext(
            r.add(d0, hs[0]), r.add(d1, hs[1]), a.level, a.scale * b.scale
        )

    def square(self, a: Ciphertext, keys: KeySet) -> Ciphertext:
        r = self.ring(a.level)
        if self.mesh is None:
            d0, d1, d2 = r.tensor_square(a.c0, a.c1)
        else:
            d0 = r.polymul(a.c0, a.c0)
            d2 = r.polymul(a.c1, a.c1)
            x = r.polymul(a.c0, a.c1)
            d1 = r.add(x, x)
        hs = self._keyswitch_pair(d2, self._key_pair(keys), a.level, 1)
        return Ciphertext(
            r.add(d0, hs[0]), r.add(d1, hs[1]), a.level, a.scale * a.scale
        )

    def rescale(self, ct: Ciphertext) -> Ciphertext:
        """Divide and round both parts by the level's last prime."""
        r = self.ring(ct.level)
        q_last = self.qs[ct.level - 1]
        return Ciphertext(
            r.rescale(ct.c0), r.rescale(ct.c1),
            ct.level - 1, ct.scale / q_last,
        )

    def mod_down_to(self, ct: Ciphertext, level: int) -> Ciphertext:
        """``ct`` at a lower level by dropping RNS limbs, at the same scale:
        the decryption congruence mod Q_l holds mod its divisor Q_level, and
        |Δm + e| << Q_level/2."""
        if level > ct.level:
            raise ValueError(f"cannot raise level {ct.level} -> {level}")
        if level == ct.level:
            return ct
        self.base_ring(level)  # validates the target level
        return self.place(Ciphertext(
            ct.c0[:level], ct.c1[:level], level, ct.scale
        ))

    # -- evaluator: rotations -------------------------------------------------

    def _apply_galois(
        self, ct: Ciphertext, g: int, keys: KeySet
    ) -> Ciphertext:
        if g == 1:
            return ct
        pair = self._key_pair(keys, g)
        if pair is None:
            raise KeyError(
                f"no rotation key for Galois element {g}; pass the step to "
                "keygen(galois_steps=...)"
            )
        r = self.ring(ct.level)
        hs = self._keyswitch_pair(ct.c1, pair, ct.level, g)
        return Ciphertext(
            r.add(r.automorphism(ct.c0, g), hs[0]), hs[1],
            ct.level, ct.scale,
        )

    def rotate(self, ct: Ciphertext, t: int, keys: KeySet) -> Ciphertext:
        """Rotate slots left by ``t`` (negative t rotates right)."""
        return self._apply_galois(ct, self.galois_element(t), keys)

    def conjugate(self, ct: Ciphertext, keys: KeySet) -> Ciphertext:
        return self._apply_galois(ct, 2 * self.n - 1, keys)

    # -- evaluator: hoisted BSGS linear transform -----------------------------

    def make_linear_op(
        self,
        terms: Sequence[Tuple[int, np.ndarray]],
        keys: KeySet,
        level: int,
        *,
        scale=None,
    ) -> LinearOp:
        """sum_j diag_j * rot_{t_j}(ct) as a LinearOp: the weights encoded
        into the extended basis and transformed once (kept in the
        coefficient domain on a mesh), the rotation keys sliced and stacked
        once; ``apply_linear`` is then one ``hoisted_linear_sum`` call."""
        scale = Fraction(self.delta) if scale is None else Fraction(scale)
        ext = self.ext_ring(level)
        domain = "coeff" if self.mesh is not None else "ntt"
        gs, pts, kbs, kas = [], [], [], []
        for t, w in terms:
            g = self.galois_element(int(t))
            pts.append(self._encode_weights(w, scale, ext.qs))
            pair = self._key_pair(keys, g)
            if pair is None:
                raise KeyError(
                    f"no rotation key for step {t} (element {g})"
                )
            sl = self._sliced_keys(pair, level)
            gs.append(g)
            kbs.append(sl[0])
            kas.append(sl[1])
        pts = self._to_device(np.stack(pts))
        if domain == "ntt":
            pts = self.base_ring(level).ksk_to_ntt(pts, ext, ch_axis=1)
        return LinearOp(
            gs=tuple(gs),
            pts=pts,
            kb=torch.stack(kbs),
            ka=torch.stack(kas),
            level=level,
            scale=scale,
            domain=domain,
        )

    def _encode_weights(self, w, scale, qs) -> np.ndarray:
        """One weight vector as residues (len(qs), n) (the scheme's half of
        make_linear_op and make_matvec)."""
        m = encode_coeffs(w, self.n, scale)
        return np.stack([(m % q).astype(np.uint32) for q in qs])

    def _matvec_matrix(self, M) -> np.ndarray:
        """A matvec matrix, checked: CKKS takes a complex (n/2, n/2) matrix
        acting on the slots."""
        S = self.n // 2
        M = np.asarray(M, dtype=np.complex128)
        if M.shape != (S, S):
            raise ValueError(f"M must be ({S}, {S}), got {M.shape}")
        return M

    def _diag_slots(self, v) -> np.ndarray:
        """A rotated diagonal as the slots ``_encode_weights`` takes (CKKS:
        the (n/2,) vector itself)."""
        return v

    def apply_linear(self, ct: Ciphertext, op: LinearOp) -> Ciphertext:
        """sum_j pt_j * rot_j(ct) in one ``hoisted_linear_sum`` call."""
        if ct.level != op.level:
            raise ValueError(
                f"ciphertext level {ct.level} != op level {op.level}"
            )
        want = "coeff" if self.mesh is not None else "ntt"
        if op.domain != want:
            raise ValueError(
                f"LinearOp baked for domain {op.domain!r}; this context "
                f"dispatches {want!r} — rebuild it with make_linear_op"
            )
        domains = {} if self.mesh is not None else {"pt_domain": "ntt"}
        o0, o1 = self.ring(ct.level).hoisted_linear_sum(
            ct.c0, ct.c1, op.pts, op.kb, op.ka, op.gs,
            self.ext_ring(ct.level), ct.level,
            plain_mod=self._ks_plain_mod, **self._ksk_domain(), **domains,
        )
        return Ciphertext(o0, o1, ct.level, ct.scale * op.scale)

    # -- evaluator: two-level BSGS matrix-vector product -----------------------

    def bsgs_split(self, count: int) -> Tuple[int, int]:
        """Default (baby, giant) factorization: b = ceil(sqrt(count))."""
        b = max(1, math.isqrt(count - 1) + 1) if count > 1 else 1
        g = -(-count // b)
        return b, g

    def bsgs_steps(self, count: Optional[int] = None,
                   bsgs: Optional[Tuple[int, int]] = None) -> Tuple[int, ...]:
        """The rotation steps keygen must cover for a BSGS matvec over
        ``count`` diagonals (default: all n/2)."""
        count = self.n // 2 if count is None else int(count)
        b, g = self.bsgs_split(count) if bsgs is None else bsgs
        return tuple(range(1, b)) + tuple(
            i * b for i in range(1, g)
        )

    def make_matvec(
        self,
        M: np.ndarray,
        keys: KeySet,
        level: int,
        *,
        bsgs: Optional[Tuple[int, int]] = None,
        scale=None,
    ) -> MatVecOp:
        """The slot product y = M @ z (M: (n/2, n/2) complex) as a MatVecOp,
        by the diagonal decomposition

            M z = sum_i rot_{i b}( sum_j rot_{i b}^{-1}(diag_{i b + j}) * rot_j(z) )

        An apply costs one hoisted key switch for the b - 1 baby rotations,
        one ``polydot_multi`` for all giant steps' inner sums (on a mesh a
        polydot pair a giant step, the diagonals in the coefficient
        domain), and g - 1 giant rotations."""
        S = self.n // 2
        M = self._matvec_matrix(M)
        scale = Fraction(self.delta) if scale is None else Fraction(scale)
        b, g = self.bsgs_split(S) if bsgs is None else bsgs
        if b * g < S:
            raise ValueError(f"bsgs {b}x{g} covers {b * g} < {S} diagonals")
        domain = "coeff" if self.mesh is not None else "ntt"
        # diag_d[l] = M[l, (l+d) mod S]; pre-rotated by +i*b for the giant fold
        pts = np.zeros((g, level, b, self.n), dtype=np.uint32)
        qs_l = self.qs[:level]
        for i in range(g):
            for j in range(b):
                d = i * b + j
                if d >= S:
                    continue
                diag = M[np.arange(S), (np.arange(S) + d) % S]
                pts[i, :, j] = self._encode_weights(
                    self._diag_slots(np.roll(diag, i * b)), scale, qs_l
                )
        baby_gs, ks, kb = [], [], []
        for j in range(1, b):
            gj = self.galois_element(j)
            pair = self._key_pair(keys, gj)
            if pair is None:
                raise KeyError(
                    f"no rotation key for baby step {j}; generate keys for "
                    f"bsgs_steps({S}, bsgs=({b}, {g}))"
                )
            sl = self._sliced_keys(pair, level)
            baby_gs.append(gj)
            ks.extend((gj, gj))
            kb.extend((sl[0], sl[1]))
        giants = []
        for i in range(1, g):
            gi = self.galois_element(i * b)
            pair = self._key_pair(keys, gi)
            if pair is None:
                raise KeyError(
                    f"no rotation key for giant step {i * b}; generate keys "
                    f"for bsgs_steps({S}, bsgs=({b}, {g}))"
                )
            giants.append((gi, self._sliced_keys(pair, level)))
        pts_dev = self._to_device(pts)
        if domain == "ntt":
            # the diagonals in the evaluation domain, transformed once here
            pts_dev = self.base_ring(level).ntt(pts_dev.movedim(0, 1))
        return MatVecOp(
            b=b, g=g, baby_gs=tuple(baby_gs), baby_ks=tuple(ks),
            baby_ksks=torch.stack(kb) if kb else None,
            pts=pts_dev, giants=tuple(giants),
            level=level, scale=scale, domain=domain,
        )

    def apply_matvec(self, ct: Ciphertext, op: MatVecOp) -> Ciphertext:
        """y = M @ z homomorphically (see make_matvec)."""
        if ct.level != op.level:
            raise ValueError(
                f"ciphertext level {ct.level} != op level {op.level}"
            )
        want = "coeff" if self.mesh is not None else "ntt"
        if op.domain != want:
            raise ValueError(
                f"MatVecOp baked for domain {op.domain!r}; this context "
                f"dispatches {want!r} — rebuild it with make_matvec"
            )
        r = self.ring(ct.level)
        lvl = ct.level
        # the baby rotations: one hoisted decomposition for all b - 1 steps
        c0s, c1s = [ct.c0], [ct.c1]
        if op.baby_ksks is not None:
            hs = r.hoisted_keyswitch(
                ct.c1, op.baby_ksks, op.baby_ks,
                self.ext_ring(lvl), lvl, plain_mod=self._ks_plain_mod,
                **self._ksk_domain(),
            )
            for t, gj in enumerate(op.baby_gs):
                c0s.append(r.add(r.automorphism(ct.c0, gj), hs[2 * t]))
                c1s.append(hs[2 * t + 1])
        C0 = torch.stack(c0s, dim=-2)  # (level, ..., b, n)
        C1 = torch.stack(c1s, dim=-2)
        if self.mesh is None:
            # both parts through one polydot_multi: the baby bundle is
            # transformed once for all giant steps
            inners = r.polydot_multi(torch.stack([C0, C1], dim=1), op.pts)
        mid = (1,) * (C0.dim() - 3)
        out = None
        for i in range(op.g):
            if self.mesh is None:
                inner = Ciphertext(
                    inners[i][:, 0], inners[i][:, 1], lvl, ct.scale * op.scale,
                )
            else:
                w = op.pts[i].reshape((lvl,) + mid + (op.b, self.n))
                w = w.expand(C0.shape)
                inner = Ciphertext(
                    r.polydot(C0, w), r.polydot(C1, w),
                    lvl, ct.scale * op.scale,
                )
            if i:
                gi, pair = op.giants[i - 1]
                hg = r.hoisted_keyswitch(
                    inner.c1, pair, (gi, gi), self.ext_ring(lvl), lvl,
                    plain_mod=self._ks_plain_mod, **self._ksk_domain(),
                )
                inner = Ciphertext(
                    r.add(r.automorphism(inner.c0, gi), hg[0]), hg[1],
                    lvl, inner.scale,
                )
            out = inner if out is None else self.add(out, inner)
        return out

    # -- evaluator: homomorphic polynomial evaluation -------------------------

    def _rescale_factor(self, level: int) -> Fraction:
        """The exact factor ``rescale`` applies to the scale at ``level``
        (CKKS divides by the dropped prime)."""
        return Fraction(1, self.qs[level - 1])

    def _poly_eval_scale(self) -> Fraction:
        """The output scale of ``poly_eval``: ~Delta^2, which keeps every
        leaf's plaintext encode scale near Delta."""
        return Fraction(self.delta) ** 2

    def _poly_eval_min_level(self) -> int:
        """The lowest level a ``poly_eval`` result may land on and still
        decode: the Delta^2 convention needs Q_level >> Delta^2, which one
        ~30-bit prime does not give and two do."""
        return 2

    def _const_pt(self, c, level: int, scale: Fraction,
                  nbatch: int = 0) -> Plaintext:
        """The constant ``c`` as a plaintext at a dictated exact (level,
        scale); ``nbatch`` singleton axes broadcast it against a batch."""
        z = np.full((1,) * nbatch + (self.n // 2,), complex(c))
        return self.encode(z, level=level, scale=scale)

    def _zero_ct(self, like: Ciphertext, level: int,
                 scale: Fraction) -> Ciphertext:
        """An encryption-free zero at (level, scale), shaped like ``like``."""
        low = self.mod_down_to(like, level)
        r = self.ring(level)
        return Ciphertext(
            r.sub(low.c0, low.c0), r.sub(low.c1, low.c1), level, scale
        )

    @staticmethod
    def _cheb_divmod(cs: List, s: int) -> Tuple[List, List]:
        """Exact division p = q * T_s + r in the Chebyshev basis, by
        2 T_{m-s} T_s = T_m + T_{2s-m} (s < m < 2s), on host coefficients
        in their own type (integers stay integers)."""
        assert s <= len(cs) - 1 < 2 * s, (
            f"_cheb_divmod contract: s <= deg < 2s, got deg={len(cs) - 1} "
            f"s={s}"
        )
        p = list(cs)
        q = [0] * (len(p) - s)
        for m in range(len(p) - 1, s - 1, -1):
            c = p[m]
            if c == 0:
                continue
            if m == s:
                q[0] = q[0] + c          # T_0 * T_s = T_s
            else:
                q[m - s] = q[m - s] + 2 * c
                p[2 * s - m] = p[2 * s - m] - c
            p[m] = 0
        return q, p[:s]

    def poly_eval_plan(self, level: int, coeffs: Sequence, *,
                       basis: str = "power"):
        """The node tree of ``poly_eval`` for ``coeffs`` on a ciphertext at
        ``level``, with its split and output level, before any ciphertext
        work: (cs, k, root, l_out), ``root`` None for a constant.  Raises
        ``ValueError`` as ``poly_eval`` does, also for a constant below the
        minimum level (where the JAX package returns a value that does not
        decode)."""
        if basis not in ("power", "chebyshev"):
            raise ValueError(f"unknown basis {basis!r}")
        cheb = basis == "chebyshev"

        def trim(sl: List):
            """Drop trailing zeros; None for the all-zero polynomial."""
            while len(sl) > 1 and sl[-1] == 0:
                sl.pop()
            return None if len(sl) == 1 and sl[0] == 0 else sl

        cs = trim(list(coeffs)) or [0]
        d = len(cs) - 1
        if not list(coeffs):
            raise ValueError("coeffs must be non-empty")
        l_min = self._poly_eval_min_level()
        if d == 0:
            if level < l_min:
                raise ValueError(
                    f"degree 0 at level {level} needs {l_min - level} more "
                    f"prime level(s) (basis={basis}, result must land at "
                    f"level >= {l_min}); increase num_primes"
                )
            return cs, 1, None, level

        # Nodes: ("leaf", cs) deg < k, a plaintext dot with the babies;
        # ("const", j, c, r) deg == k*2^j, c * g_j a plaintext multiply (r
        # may be None); ("mul", j, q, r) the full q * g_j + r node.
        k = 1 << max(1, math.ceil(math.log2(math.sqrt(d + 1))))
        kappa = k.bit_length() - 1

        def tree(sl: List):
            deg = len(sl) - 1
            if deg < k:
                return ("leaf", sl)
            j = (deg // k).bit_length() - 1
            s = k << j
            if cheb:
                q, r = self._cheb_divmod(sl, s)
            else:
                q, r = sl[s:], sl[:s]
            q, r = trim(list(q)), trim(list(r))
            if len(q) == 1:
                return ("const", j, q[0], tree(r) if r else None)
            return ("mul", j, tree(q), tree(r) if r else None)

        root = tree(cs)

        # the level plan from the depths the builders below reach: power
        # babies ceil(log2 i) below the input, Chebyshev even indices one
        # over their half and odd ones two; giants log2(k) + j below
        bd_memo: Dict[int, int] = {1: 0}

        def bdepth(i: int) -> int:
            hit = bd_memo.get(i)
            if hit is not None:
                return hit
            if not cheb:
                out = (i - 1).bit_length()
            elif i % 2 == 0:
                out = bdepth(i // 2) + 1
            else:
                out = max(bdepth((i + 1) // 2), bdepth(i // 2)) + 2
            bd_memo[i] = out
            return out

        ceilings: List[int] = []

        def plan(node, off: int) -> None:
            kind = node[0]
            if kind == "leaf":
                used = [i for i in range(1, len(node[1])) if node[1][i] != 0]
                if used:
                    ceilings.append(level - max(bdepth(i) for i in used) - off)
                return
            j = node[1]
            if kind == "const":
                ceilings.append(level - kappa - j - off)
                if node[3] is not None:
                    plan(node[3], off)
                return
            ceilings.append(level - kappa - j - 1 - off)
            plan(node[2], off + 1)   # the quotient branch, one level up
            if node[3] is not None:
                plan(node[3], off)

        plan(root, 0)
        l_out = min(ceilings)
        if l_out < l_min:
            raise ValueError(
                f"degree {d} at level {level} needs {l_min - l_out} "
                f"more prime level(s) (split k={k}, basis={basis}, "
                f"result must land at level >= {l_min}); increase "
                f"num_primes"
            )
        return cs, k, root, l_out

    def poly_eval(self, ct: Ciphertext, coeffs: Sequence,
                  keys: KeySet, *, basis: str = "power") -> Ciphertext:
        """A polynomial on the slots by BSGS Paterson-Stockmeyer with
        depth-optimal giant splitting: ``sum_i coeffs[i] * m**i``
        (``basis="power"``) or ``sum_i coeffs[i] * T_i(m)``
        (``basis="chebyshev"``, inputs in [-1, 1]).

        Baby powers by balanced products (Chebyshev: T_2m = 2 T_m^2 - 1,
        odd T_i = 2 T_a T_b - T_1), giants by squaring or doubling, then
        p = q * g + r with the split done exactly on host coefficients.
        Every node dictates its subtree's exact output scale; leaves meet
        it through their plaintexts' encode scales, so additions align.
        The result is at scale Delta^2 (rescale once for ~Delta).  Raises
        ``ValueError`` when the chain is too short for the degree or for
        the result's decode headroom (level >= 2), a constant included.
        """
        cs, k, root, l_out = self.poly_eval_plan(ct.level, coeffs,
                                                 basis=basis)
        cheb = basis == "chebyshev"
        S = self._poly_eval_scale()
        nb = ct.c0.dim() - 2  # singleton axes of a constant plaintext
        if root is None:
            out = self._zero_ct(ct, ct.level, S)
            if cs[0] != 0:
                out = self.add_plain(
                    out, self._const_pt(cs[0], out.level, S, nb)
                )
            return out

        used_babies: set = set()
        used_giants: set = set()

        def collect(node) -> None:
            if node[0] == "leaf":
                used_babies.update(
                    i for i in range(1, len(node[1])) if node[1][i] != 0
                )
                return
            used_giants.add(node[1])
            if node[0] == "mul":
                collect(node[2])
            if node[3] is not None:
                collect(node[3])

        collect(root)

        # -- the powers (the dependency closure of the used ones) ----------
        babies: Dict[int, Ciphertext] = {1: ct}

        def pw_power(i: int) -> Ciphertext:
            hit = babies.get(i)
            if hit is not None:
                return hit
            h = i // 2
            a, b = pw_power(i - h), pw_power(h)
            lvl = min(a.level, b.level)
            a, b = self.mod_down_to(a, lvl), self.mod_down_to(b, lvl)
            out = self.rescale(
                self.square(a, keys) if i - h == h
                else self.multiply(a, b, keys)
            )
            babies[i] = out
            return out

        def _cheb_double(x: Ciphertext) -> Ciphertext:
            # T_2m = 2 T_m^2 - 1: the halving constant aligns for free
            t = self.rescale(self.square(x, keys))
            t = self.add(t, t)
            return self.add_plain(
                t, self._const_pt(-1, t.level, t.scale, nb)
            )

        def pw_cheb(i: int) -> Ciphertext:
            hit = babies.get(i)
            if hit is not None:
                return hit
            if i % 2 == 0:
                t = _cheb_double(pw_cheb(i // 2))
            else:
                # T_i = 2 T_a T_b - T_1 (a - b = 1): both sides of the
                # subtraction pass through one exact plaintext ratio (~q/4)
                # to a common scale first
                a, b = (i + 1) // 2, i // 2
                xa, xb = pw_cheb(a), pw_cheb(b)
                lvl = min(xa.level, xb.level)
                xa = self.mod_down_to(xa, lvl)
                xb = self.mod_down_to(xb, lvl)
                t = self.rescale(self.multiply(xa, xb, keys))
                t = self.add(t, t)
                c1 = self.mod_down_to(ct, t.level)
                hi = max(t.scale, c1.scale)
                target = hi * Fraction(self.qs[t.level - 1], 4)
                t = self.mul_plain(
                    t, self._const_pt(1, t.level, target / t.scale, nb)
                )
                c1 = self.mul_plain(
                    c1, self._const_pt(1, t.level, target / c1.scale, nb)
                )
                t = self.rescale(self.sub(t, c1))
            babies[i] = t
            return t

        pw = pw_cheb if cheb else pw_power
        for i in sorted(used_babies):
            pw(i)
        giants: List[Ciphertext] = []
        if used_giants:
            giants.append(
                _cheb_double(pw(k // 2)) if cheb
                else self.rescale(self.square(pw(k // 2), keys))
            )
            while len(giants) <= max(used_giants):
                giants.append(
                    _cheb_double(giants[-1]) if cheb
                    else self.rescale(self.square(giants[-1], keys))
                )

        # -- the tree with dictated (level, scale) --------------------------
        def rec(node, level: int, scale: Fraction) -> Ciphertext:
            kind = node[0]
            if kind == "leaf":
                sl = node[1]
                acc = None
                for i in range(1, len(sl)):
                    if sl[i] == 0:
                        continue
                    p = self.mod_down_to(babies[i], level)
                    term = self.mul_plain(
                        p, self._const_pt(sl[i], level, scale / p.scale, nb)
                    )
                    acc = term if acc is None else self.add(acc, term)
                if acc is None:
                    acc = self._zero_ct(ct, level, scale)
                if sl[0] != 0:
                    acc = self.add_plain(
                        acc, self._const_pt(sl[0], level, scale, nb)
                    )
                return acc
            j = node[1]
            if kind == "const":
                g = self.mod_down_to(giants[j], level)
                prod = self.mul_plain(
                    g, self._const_pt(node[2], level, scale / g.scale, nb)
                )
            else:
                g = self.mod_down_to(giants[j], level + 1)
                sq = scale / (g.scale * self._rescale_factor(level + 1))
                q_ct = rec(node[2], level + 1, sq)
                prod = self.rescale(self.multiply(q_ct, g, keys))
            if prod.level != level or prod.scale != scale:
                raise AssertionError(
                    "poly_eval scale dictation broke: "
                    f"{prod.level}/{prod.scale} != {level}/{scale}"
                )
            if node[3] is None:
                return prod
            return self.add(prod, rec(node[3], level, scale))

        return rec(root, l_out, S)
