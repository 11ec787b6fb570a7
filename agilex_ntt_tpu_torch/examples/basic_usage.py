"""Tour of the core API: rings, transforms, products, rotations.

Counterpart of ``examples/basic_usage.py`` on the port's rings.

Run: python -m agilex_ntt_tpu_torch.examples.basic_usage [--device cpu|cuda]
"""

import numpy as np

from agilex_ntt_tpu_torch import CyclicRing, Ring, RNSRing
from agilex_ntt_tpu_torch.examples._common import check, device_from, host


def main(argv=None):
    device = device_from(argv, __doc__)
    rng = np.random.default_rng(0)

    # --- negacyclic ring: Z_q[X] / (X^4096 + 1), auto-picked 30-bit NTT prime
    ring = Ring(4096, device=device)
    print("ring:", ring)

    a = rng.integers(0, ring.q, size=(4096,), dtype=np.uint32)
    b = rng.integers(0, ring.q, size=(4096,), dtype=np.uint32)

    y = ring.ntt(a)                     # forward negacyclic NTT
    check((host(ring.intt(y)) == a).all(), "intt(ntt(a)) != a")

    c = ring.polymul(a, b)              # a*b mod (X^n + 1, q), one fused kernel
    print("polymul ok, c[0] =", int(host(c)[0]))

    # NTT-domain rotation (FHE-style): tau_5 is a pure slot permutation there
    rot = ring.automorphism(y, 5, domain="ntt")
    check((host(ring.ntt(ring.automorphism(a, 5))) == host(rot)).all(),
          "NTT-domain automorphism disagrees with the coefficient one")

    # key-switch-style inner product: sum_i a_i * b_i with one inverse transform
    k = 3
    av = rng.integers(0, ring.q, size=(k, 4096), dtype=np.uint32)
    bv = rng.integers(0, ring.q, size=(k, 4096), dtype=np.uint32)
    dot = ring.polydot(av, bv)
    print("polydot ok, shape", tuple(dot.shape))

    # --- RNS: 3-prime CRT basis for wide coefficients (up to ~90 bits)
    rns = RNSRing(4096, num_primes=3, device=device)
    big_coeffs = rng.integers(0, 1 << 60, size=(8,), dtype=np.uint64)
    poly = np.zeros(4096, dtype=object)
    poly[:8] = big_coeffs
    residues = rns.to_rns(poly)          # (3, 4096)
    back = rns.from_rns(residues)
    check((back[:8] == big_coeffs).all(), "RNS roundtrip failed")
    print("RNS roundtrip ok; modulus bits:", rns.modulus.bit_length())

    # --- plain cyclic convolution (signal-processing style)
    cyc = CyclicRing(4096, device=device)
    cyc.polymul(a, b)                   # a*b mod (X^n - 1, q)
    print("cyclic convolution ok")

    # --- large N: four-step decomposition beyond the 32768 single-pass wall
    big = Ring(1 << 17, device=device)
    xa = rng.integers(0, big.q, size=(2, big.n), dtype=np.uint32)
    check((host(big.intt(big.ntt(xa))) == xa).all(), "large-N roundtrip failed")
    print(f"large-N ok: n={big.n}, method={big.method}")
    print("all examples passed")


if __name__ == "__main__":
    main()
