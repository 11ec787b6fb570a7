"""Exact integer FHE with the BFV scheme layer, the scale-invariant one.

Counterpart of ``examples/bfv_exact.py`` on the port's
``schemes.BFVContext``.  As in ``bgv_exact`` every operation decrypts to
the exact slotwise result mod a prime t (checked with ==), but BFV carries
the message at Δ = floor(Q/t) instead of in the low bits, so:

  * modulus switching is scale-invariant: no tracked correction factor;
  * multiply runs the HPS big-base pipeline (lift to an extended RNS basis,
    tensor there, scale-round by t/Q, Shenoy–Kumaresan exact return) rather
    than BGV's native-basis tensor and t-correcting divide.

Run: python -m agilex_ntt_tpu_torch.examples.bfv_exact [--device cpu|cuda]
"""

import numpy as np

from agilex_ntt_tpu_torch.examples._common import check, device_from
from agilex_ntt_tpu_torch.schemes.bfv import BFVContext

N = 256


def main(argv=None):
    device = device_from(argv, __doc__)
    rng = np.random.default_rng(17)
    ctx = BFVContext(N, num_primes=3, rng=rng, device=device)
    keys = ctx.keygen(galois_steps=(0, 1, -1))
    print(f"BFV context: n={N}, slots=(2, {N // 2}) mod t={ctx.t}, "
          f"L={ctx.L} levels, Δ_L={ctx.delta_at(ctx.L)}")

    m1 = rng.integers(0, ctx.t, (2, N // 2))
    m2 = rng.integers(0, ctx.t, (2, N // 2))
    c1 = ctx.encrypt(ctx.encode(m1), keys)
    c2 = ctx.encrypt_symmetric(ctx.encode(m2), keys)

    check((ctx.decode(ctx.decrypt(c1, keys)) == m1).all(), "encrypt/decrypt")
    print("encrypt/decrypt (Δ-scaled encoder): exact")

    got = ctx.decode(ctx.decrypt(ctx.add(c1, c2), keys))
    check((got == (m1 + m2) % ctx.t).all(), "add")
    print("add: exact")

    prod = ctx.multiply(c1, c2, keys)
    check((ctx.decode(ctx.decrypt(prod, keys)) == (m1 * m2) % ctx.t).all(),
          "multiply")
    print("multiply (HPS big-base lift/tensor/scale-round) + relinearize: exact")

    sq = ctx.square(c1, keys)
    check((ctx.decode(ctx.decrypt(sq, keys)) == (m1 * m1) % ctx.t).all(),
          "square")
    print("square (single tensor + relinearize): exact")

    low = ctx.rescale(prod)  # scale-invariant modulus switch
    check((ctx.decode(ctx.decrypt(low, keys)) == (m1 * m2) % ctx.t).all(),
          "modulus switch")
    print(f"scale-invariant modulus switch (level {prod.level} -> "
          f"{low.level}, no correction factor): exact")

    # depth 2: drop a fresh operand to the product's level and go again
    m3 = rng.integers(0, ctx.t, (2, N // 2))
    c3 = ctx.encrypt(ctx.encode(m3), keys)
    deep = ctx.multiply(low, ctx.mod_down_to(c3, low.level), keys)
    want_deep = (m1 * m2 * m3) % ctx.t
    check((ctx.decode(ctx.decrypt(deep, keys)) == want_deep).all(),
          "depth-2 multiply")
    print("depth-2 multiply chain across a modulus switch: exact")

    rot = ctx.rotate(c1, 1, keys)
    check((ctx.decode(ctx.decrypt(rot, keys))
           == np.roll(m1, -1, axis=-1)).all(), "rotate rows")
    sw = ctx.conjugate(c1, keys)
    check((ctx.decode(ctx.decrypt(sw, keys)) == m1[::-1]).all(), "swap rows")
    print("rotate rows / swap rows: exact")

    # plaintext ops ride the Δ-scaled vs raw encodings
    pm = rng.integers(0, ctx.t, (2, N // 2))
    ap = ctx.add_plain(c1, ctx.encode(pm))
    check((ctx.decode(ctx.decrypt(ap, keys)) == (m1 + pm) % ctx.t).all(),
          "add_plain")
    mp = ctx.mul_plain(c1, ctx.encode_mul(pm))
    check((ctx.decode(ctx.decrypt(mp, keys)) == (m1 * pm) % ctx.t).all(),
          "mul_plain")
    print("add_plain (Δ-scaled) / mul_plain (raw encoding): exact")

    print("bfv_exact: all checks passed with ==")


if __name__ == "__main__":
    main()
