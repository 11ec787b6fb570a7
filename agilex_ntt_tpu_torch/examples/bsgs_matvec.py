"""Baby-step/giant-step homomorphic linear map: n1*n2 Galois terms from
n1 + n2 - 1 rotation keys.

Counterpart of ``examples/bsgs_matvec.py``.  Evaluates
M(m) = sum_{i,j} w_{ij} (*) tau_{g_i * b_j}(m) on an encrypted m, the
structure of every homomorphic matrix-vector product, by the BSGS
factorization

    M(ct) = sum_i tau_{g_i}( sum_j tau_{g_i}^{-1}(w_{ij}) (*) tau_{b_j}(ct) )

The inner sums are ONE fused ``RNSRing.hoisted_linear_sum`` call each (one
gadget decomposition and one digit transform shared by all baby steps, the
plaintext products fused in the evaluation domain, one deferred ModDown);
the giant steps are plain rotations.  Key material is O(n1 + n2) instead
of O(n1 * n2).

Builds on the toy leveled scheme of ``ckks_rns_toy`` (pedagogical, not
secure); the result is checked exactly against a host big-int oracle.

Run: python -m agilex_ntt_tpu_torch.examples.bsgs_matvec [--device cpu|cuda]
"""

import numpy as np

from agilex_ntt_tpu_torch.examples._common import check, device_from, host
from agilex_ntt_tpu_torch.examples.ckks_rns_toy import (
    N, T, Toy, negmul, tau_host,
)


def main(argv=None):
    device = device_from(argv, __doc__)
    toy = Toy(device)
    rq, rqp, DNUM = toy.rq, toy.rqp, toy.DNUM
    rng = np.random.default_rng(17)
    s, _, _ = toy.keygen()
    m = rng.integers(0, T, size=N)
    c0, c1 = toy.encrypt(s, m)

    # BSGS grid: baby steps b_j, giant steps g_i (all odd exponents; g_0 = 1
    # is the identity giant step and needs no key)
    baby = (3, 5, 9)
    giant = (1, 11, 13)
    n1, n2 = len(baby), len(giant)
    two_n = 2 * N

    # full weight grid w_ij, small-norm so the toy scheme decrypts exactly
    w = [[rng.integers(-2, 3, size=N).astype(object) for _ in baby]
         for _ in giant]

    # key material: n1 baby keys + (n2 - 1) giant keys, NOT n1 * n2
    baby_keys = [toy.rot_keys(s, b) for b in baby]
    giant_keys = {g: toy.rot_keys(s, g) for g in giant if g != 1}
    kb_ntt = rq.ksk_to_ntt(np.stack([b for b, _ in baby_keys]), rqp,
                           ch_axis=2)
    ka_ntt = rq.ksk_to_ntt(np.stack([a for _, a in baby_keys]), rqp,
                           ch_axis=2)
    n_keys = n1 + len(giant_keys)
    print(f"grid: {n1}x{n2} = {n1 * n2} Galois terms, {n_keys} rotation keys")

    out0 = out1 = None
    for i, g in enumerate(giant):
        # counter-rotate row i's weights so the giant step lands them right:
        # tau_g(tau_{g^-1}(w) (*) tau_b(m)) = w (*) tau_{g b}(m)
        ginv = pow(g, -1, two_n)
        pts = np.stack([
            np.stack([(tau_host(w[i][j], ginv) % p).astype(np.uint32)
                      for p in rqp.qs])
            for j in range(n1)
        ])  # (n1, K, N)
        ptn = rq.ksk_to_ntt(pts, rqp, ch_axis=1)
        h0, h1 = rq.hoisted_linear_sum(
            c0, c1, ptn, kb_ntt, ka_ntt, baby, rqp, DNUM,
            ksk_domain="ntt", pt_domain="ntt",
        )
        if g == 1:
            f0, f1 = h0, h1
        else:
            gb, ga = giant_keys[g]
            t0 = rq.automorphism(h0, g)
            t1 = rq.automorphism(h1, g)
            f0 = rq.add(t0, rq.keyswitch(t1, gb, rqp, DNUM))
            f1 = rq.keyswitch(t1, ga, rqp, DNUM)
        out0 = f0 if out0 is None else rq.add(out0, f0)
        out1 = f1 if out1 is None else rq.add(out1, f1)
        print(f"giant step tau_{g}: inner {n1}-term fused sum"
              + (" (identity, no key)" if g == 1 else " + rotation"))

    # host oracle: the full n1*n2-term linear map on the plaintext
    want = np.zeros(N, dtype=object)
    for i, g in enumerate(giant):
        for j, b in enumerate(baby):
            t = g * b % two_n
            want = want + negmul(w[i][j], tau_host(m.astype(object), t))
    got = toy.decrypt(s, [host(out0), host(out1)], toy.DELTA)
    check((got == (want % T).astype(np.int64)).all(),
          "BSGS matvec decrypt mismatch")
    print(f"BSGS linear map ({n1 * n2} terms, {n_keys} keys): exact")


if __name__ == "__main__":
    main()
