"""Toy leveled RNS scheme: the whole stack in about 150 lines.

Counterpart of ``examples/ckks_rns_toy.py``: every between-NTT primitive
of the port's ``RNSRing``, end to end, the way an RNS-CKKS/BGV evaluator
uses them:

    keygen      ternary secret in the RNS basis Q; relinearization key in
                the extended basis Q u P by the CRT-idempotent gadget
                (ksk_d encrypts P * g_d * s^2, g_d = 1 mod q_d, 0 mod q_l)
    encrypt     (c0, c1) = (-(a s) + Delta m + e, a)   residues mod Q
    multiply    tensor square (d0, d1, d2) = (c0 c0', c0 c1' + c1 c0', c1 c1')
    relinearize d2's s^2 term folded back to degree 1 with ONE CALL per key
                row: RNSRing.keyswitch (gadget digits -> extended-basis
                polydot -> ModDown by P)
    rescale     divide-and-round by the last prime: drop a level
    decrypt     round(centered(c0 + c1 s) / scale) mod t

THIS IS A PEDAGOGICAL TOY: parameters and noise handling are not a secure
or complete scheme; every step is checked against host big-int oracles and
message recovery is exact.  ``bsgs_matvec`` builds on ``Toy``.

Run: python -m agilex_ntt_tpu_torch.examples.ckks_rns_toy [--device cpu|cuda]
"""

import math
from fractions import Fraction

import numpy as np

from agilex_ntt_tpu_torch import RNSRing
from agilex_ntt_tpu_torch.examples._common import check, device_from, host
from agilex_ntt_tpu_torch.params import find_primes

N, T = 1024, 64                    # ring degree, plaintext modulus


def negmul(a, b):
    """Negacyclic product of big-int coefficient arrays (host oracle)."""
    conv = np.convolve(np.asarray(a, dtype=object), np.asarray(b, dtype=object))
    out = conv[:N].copy()
    out[: N - 1] -= conv[N:]
    return out


def tau_host(v, k):
    """tau_k on host ints (signed permutation); v object or int64."""
    idx = (np.arange(N) * k) % (2 * N)
    out = np.zeros(N, dtype=object)
    for i in range(N):
        j, wrap = idx[i] % N, idx[i] >= N
        out[j] += -v[i] if wrap else v[i]
    return out


class Toy:
    """The toy scheme's rings, constants and random stream on ``device``:
    a 3-prime ciphertext basis Q and a special prime P."""

    def __init__(self, device, seed: int = 11):
        qs = find_primes(N, 4)     # 3-prime ciphertext basis Q + special P
        self.rq = RNSRing(N, qs=qs[:3], device=device)
        self.rqp = RNSRing(N, qs=qs, device=device)
        self.P = qs[3]
        self.Q = self.rq.modulus
        # per-prime (GHS) digits: t_d < q_d keeps the keyswitch noise ~ |e|,
        # not Q_d |e| / P
        self.DNUM = self.rq.L
        # tensor products square the scale: Delta^2 * |m1*m2| must stay
        # < Q/2, and |negacyclic(m1, m2)| <= N*T^2 = 2^22 here
        self.DELTA = math.isqrt(self.Q >> 24)
        self.rng = np.random.default_rng(seed)

    def to_rns_centered(self, v):
        """Signed host ints (N,) -> residues (L, N) in basis Q."""
        return np.stack([(np.asarray(v, dtype=object) % q).astype(np.uint32)
                         for q in self.rq.qs])

    def small(self, bound):
        return self.rng.integers(-bound, bound + 1, size=N).astype(object)

    def uniform_big(self):
        out = np.zeros(N, dtype=object)
        for _ in range(4):
            out = out * (1 << 30) + self.rng.integers(
                0, 1 << 30, size=N).astype(object)
        return out % self.Q

    def _gadget_keys(self, s, target):
        """Key rows encrypting P * g_d * target under s, in Q u P."""
        kb, ka = [], []
        for d in range(self.DNUM):
            qd = self.rq.qs[d]
            qhat = self.Q // qd
            g_d = qhat * pow(qhat % qd, -1, qd)     # CRT idempotent of q_d
            a_d = self.uniform_big()
            e_d = self.small(2)
            b_d = -negmul(a_d, s) + e_d + self.P * g_d * target
            kb.append(np.stack([(b_d % p).astype(np.uint32)
                                for p in self.rqp.qs]))
            ka.append(np.stack([(a_d % p).astype(np.uint32)
                                for p in self.rqp.qs]))
        return np.stack(kb), np.stack(ka)

    def keygen(self):
        s = self.small(1)
        ksk_b, ksk_a = self._gadget_keys(s, negmul(s, s))
        return s, ksk_b, ksk_a

    def rot_keys(self, s, k):
        """Rotation key pair for tau_k: encrypts P * g_d * tau_k(s)."""
        return self._gadget_keys(s, tau_host(s, k))

    def encrypt(self, s, m):
        a = self.uniform_big()
        e = self.small(2)
        c0 = -negmul(a, s) + self.DELTA * np.asarray(m, dtype=object) + e
        return self.to_rns_centered(c0), self.to_rns_centered(a)

    def phase_centered(self, s, parts, ring):
        """Centered big-int sum_i c_i * s^i from RNS parts in ``ring``."""
        total = np.zeros(N, dtype=object)
        spow = np.zeros(N, dtype=object)
        spow[0] = 1
        for c in parts:
            total = total + negmul(ring.from_rns(c), spow)
            spow = negmul(spow, s)
        total = total % ring.modulus
        return np.where(total > ring.modulus // 2, total - ring.modulus, total)

    def decrypt(self, s, parts, scale, ring=None):
        """Exact big-int round(phase / scale) mod T (phases exceed float64)."""
        ph = self.phase_centered(s, parts, ring or self.rq)
        fr = Fraction(scale)
        num, den = fr.numerator, fr.denominator
        return np.array(
            [((2 * int(v) * den + num) // (2 * num)) % T for v in ph],
            dtype=np.int64,
        )


def main(argv=None):
    device = device_from(argv, __doc__)
    toy = Toy(device)
    rq, rqp, DNUM, DELTA = toy.rq, toy.rqp, toy.DNUM, toy.DELTA
    rng = toy.rng
    s, ksk_b, ksk_a = toy.keygen()
    m1 = rng.integers(0, T, size=N)
    m2 = np.zeros(N, dtype=np.int64)
    m2[0], m2[1] = 3, 2            # sparse so the product's scale is tame

    ct1 = toy.encrypt(s, m1)
    ct2 = toy.encrypt(s, m2)
    check((toy.decrypt(s, ct1, DELTA) == m1 % T).all(), "roundtrip failed")
    print("encrypt/decrypt: exact")

    # tensor multiply: degree-2 ciphertext in Q (device polymuls)
    d0 = host(rq.polymul(ct1[0], ct2[0]))
    d1 = host(rq.add(rq.polymul(ct1[0], ct2[1]), rq.polymul(ct1[1], ct2[0])))
    d2 = host(rq.polymul(ct1[1], ct2[1]))

    mm = negmul(m1, m2) % T        # plaintext product oracle

    got3 = toy.decrypt(s, [d0, d1, d2], Fraction(DELTA) ** 2)
    check((got3 == mm).all(), "degree-2 decrypt mismatch")
    print("tensor multiply: degree-2 decrypt exact vs plaintext oracle")

    # relinearize: one keyswitch per key row folds the s^2 term away
    c0 = host(rq.add(d0, rq.keyswitch(d2, ksk_b, rqp, DNUM)))
    c1 = host(rq.add(d1, rq.keyswitch(d2, ksk_a, rqp, DNUM)))
    got2 = toy.decrypt(s, [c0, c1], Fraction(DELTA) ** 2)
    check((got2 == mm).all(), "post-relinearization decrypt mismatch")
    print(f"relinearize (RNSRing.keyswitch, dnum={DNUM}): exact")

    # rescale: drop a level; the scale divides by the dropped prime
    home = rq.drop_prime()
    c0s, c1s = host(rq.rescale(c0)), host(rq.rescale(c1))
    got_low = toy.decrypt(
        s, [c0s, c1s], Fraction(DELTA) ** 2 / rq.qs[-1], ring=home
    )
    check((got_low == mm).all(), "post-rescale decrypt mismatch")
    print(f"rescale: level dropped ({rq.L} -> {home.L} primes), exact")

    # rotation: tau_k(ct) encrypts tau_k(m) under tau_k(s); a rotation key
    # (the same gadget construction, encrypting P * g_d * tau_k(s)) switches
    # it back under s: automorphism and keyswitch compose
    k = 5
    tau = lambda v: host(rq.automorphism(v, k))  # noqa: E731
    rot_b, rot_a = toy.rot_keys(s, k)
    r0 = host(rq.add(tau(ct1[0]), rq.keyswitch(tau(ct1[1]), rot_b, rqp, DNUM)))
    r1 = host(rq.keyswitch(tau(ct1[1]), rot_a, rqp, DNUM))
    m1_tau = (tau_host(m1.astype(object), k) % T).astype(np.int64)
    got_rot = toy.decrypt(s, [r0, r1], DELTA)
    check((got_rot == m1_tau % T).all(), "post-rotation decrypt mismatch")
    print(f"rotate (automorphism tau_{k} + keyswitch): exact")

    # hoisted rotation batch: ONE decomposition of c1 and eval-domain keys
    # (transformed once by ksk_to_ntt) serve several steps at once, the
    # Halevi-Shoup BSGS pattern.  The hoisted digits differ from
    # decompose(tau_k(c1)) but satisfy tau_k of the reconstruction
    # identity, so every step still decrypts exactly.
    steps = (3, 9, 2 * N - 1)
    keys = [toy.rot_keys(s, kk) for kk in steps]
    kb_ntt = rq.ksk_to_ntt(np.stack([b for b, _ in keys]), rqp, ch_axis=2)
    ka_ntt = rq.ksk_to_ntt(np.stack([a for _, a in keys]), rqp, ch_axis=2)
    hb = rq.hoisted_keyswitch(ct1[1], kb_ntt, steps, rqp, DNUM,
                              ksk_domain="ntt")
    ha = rq.hoisted_keyswitch(ct1[1], ka_ntt, steps, rqp, DNUM,
                              ksk_domain="ntt")
    for j, kk in enumerate(steps):
        h0 = host(rq.add(rq.automorphism(ct1[0], kk), hb[j]))
        h1 = host(ha[j])
        want = (tau_host(m1.astype(object), kk) % T).astype(np.int64)
        got_h = toy.decrypt(s, [h0, h1], DELTA)
        check((got_h == want).all(), f"hoisted rotation tau_{kk} mismatch")
    print(f"hoisted rotations ({len(steps)} steps, one decomposition, "
          f"eval-domain keys): all exact")

    # BSGS linear transform: sum_j pt_j (*) tau_{k_j}(ct) in ONE fused call
    # (hoisted_linear_sum), the homomorphic matrix-vector inner loop.  All
    # key and plaintext material is transformed once; products accumulate in
    # the extended basis with a single deferred ModDown per part.
    wts = [rng.integers(-2, 3, size=N).astype(object) for _ in steps]
    pts = np.stack([
        np.stack([(w % p).astype(np.uint32) for p in rqp.qs]) for w in wts
    ])  # (nk, K, N)
    ptn = rq.ksk_to_ntt(pts, rqp, ch_axis=1)
    o0, o1 = rq.hoisted_linear_sum(
        ct1[0], ct1[1], ptn, kb_ntt, ka_ntt, steps, rqp, DNUM,
        ksk_domain="ntt", pt_domain="ntt",
    )
    want_lin = np.zeros(N, dtype=object)
    for w, kk in zip(wts, steps):
        want_lin = want_lin + negmul(w, tau_host(m1.astype(object), kk))
    got_lin = toy.decrypt(s, [host(o0), host(o1)], DELTA)
    check((got_lin == (want_lin % T).astype(np.int64)).all(),
          "linear-transform decrypt mismatch")
    print(f"BSGS linear transform (hoisted_linear_sum, {len(steps)} terms, "
          f"one ModDown): exact")
    print("ckks_rns_toy: full leveled pipeline verified")


if __name__ == "__main__":
    main()
