"""Toy symmetric RLWE encryption built entirely on the public ring API.

Counterpart of ``examples/rlwe_toy.py``: every ring operation an
FHE-adjacent workload needs, on the port's ``Ring``.  THIS IS A
PEDAGOGICAL TOY: parameters and noise handling are not a secure or
complete scheme.

    sk        <- small ternary polynomial
    ct = (c0, c1) with c0 = -(a*sk) + m*Delta + e,  c1 = a
    decrypt: round((c0 + c1*sk) / Delta) mod t

Homomorphic additions and plaintext multiplications happen on ciphertexts;
everything reduces to ntt/intt/polymul/add/sub under the hood.

Run: python -m agilex_ntt_tpu_torch.examples.rlwe_toy [--device cpu|cuda]
"""

import numpy as np

from agilex_ntt_tpu_torch import Ring
from agilex_ntt_tpu_torch.examples._common import check, device_from, host

N, T = 2048, 16  # ring degree, plaintext modulus


def main(argv=None):
    device = device_from(argv, __doc__)
    ring = Ring(N, device=device)
    Q = ring.q
    DELTA = Q // T
    rng = np.random.default_rng(7)

    def small_poly(bound=1):
        return (rng.integers(-bound, bound + 1, size=N) % Q).astype(np.uint32)

    def encrypt(sk, m):
        a = rng.integers(0, Q, size=N, dtype=np.uint32)
        e = small_poly(2)
        m_scaled = (m.astype(np.uint64) * DELTA % Q).astype(np.uint32)
        c0 = ring.add(ring.sub(m_scaled, ring.polymul(a, sk)), e)
        return host(c0), a

    def decrypt(sk, ct):
        c0, c1 = ct
        phase = host(ring.add(c0, ring.polymul(c1, sk))).astype(np.int64)
        centered = np.where(phase > Q // 2, phase - Q, phase)
        return (np.round(centered / DELTA).astype(np.int64) % T).astype(np.uint32)

    sk = small_poly()
    m1 = rng.integers(0, T, size=N, dtype=np.uint32)
    m2 = rng.integers(0, T, size=N, dtype=np.uint32)

    ct1 = encrypt(sk, m1)
    ct2 = encrypt(sk, m2)
    check((decrypt(sk, ct1) == m1).all(), "roundtrip failed")

    # homomorphic addition
    ct_add = (host(ring.add(ct1[0], ct2[0])), host(ring.add(ct1[1], ct2[1])))
    check((decrypt(sk, ct_add) == (m1 + m2) % T).all(), "hom-add failed")

    # multiply by a plaintext monomial = negacyclic rotation of the message
    ct_rot = (host(ring.rotate(ct1[0], 3)), host(ring.rotate(ct1[1], 3)))
    m_rot = decrypt(sk, ct_rot)
    want = np.empty_like(m1)
    want[3:] = m1[:-3]
    want[:3] = (-m1[-3:].astype(np.int64)) % T
    check((m_rot == want).all(), "monomial-mul failed")

    print(f"RLWE toy ok: n={N}, q={Q}, t={T} — encrypt/decrypt, hom-add, "
          f"X^3-mul ({device})")


if __name__ == "__main__":
    main()
