"""Exact integer FHE with the BGV scheme layer: everything checks with ==.

Counterpart of ``examples/bgv_exact.py`` on the port's
``schemes.BGVContext``: plaintexts are (2, n/2) slot matrices mod a prime
t, packed by the package's own transform (``Ring(n, q=t)``), and every
operation decrypts to exactly the slotwise result mod t.

Run: python -m agilex_ntt_tpu_torch.examples.bgv_exact [--device cpu|cuda]
"""

import numpy as np

from agilex_ntt_tpu_torch.examples._common import check, device_from
from agilex_ntt_tpu_torch.schemes import BGVContext

N = 256


def main(argv=None):
    device = device_from(argv, __doc__)
    rng = np.random.default_rng(17)
    ctx = BGVContext(N, num_primes=3, rng=rng, device=device)
    keys = ctx.keygen(galois_steps=(0, 1, -1))
    print(f"BGV context: n={N}, slots=(2, {N // 2}) mod t={ctx.t}, "
          f"L={ctx.L} levels")

    m1 = rng.integers(0, ctx.t, (2, N // 2))
    m2 = rng.integers(0, ctx.t, (2, N // 2))
    c1 = ctx.encrypt(ctx.encode(m1), keys)
    c2 = ctx.encrypt_symmetric(ctx.encode(m2), keys)

    check((ctx.decode(ctx.decrypt(c1, keys)) == m1).all(), "encrypt/decrypt")
    print("encrypt/decrypt: exact")

    got = ctx.decode(ctx.decrypt(ctx.add(c1, c2), keys))
    check((got == (m1 + m2) % ctx.t).all(), "add")
    print("add: exact")

    prod = ctx.multiply(c1, c2, keys)
    check((ctx.decode(ctx.decrypt(prod, keys)) == (m1 * m2) % ctx.t).all(),
          "multiply")
    print("multiply + relinearize: exact")

    low = ctx.rescale(prod)   # modulus switch: noise /= q_L, factor tracked
    check((ctx.decode(ctx.decrypt(low, keys)) == (m1 * m2) % ctx.t).all(),
          "modulus switch")
    print(f"modulus switch (level {prod.level} -> {low.level}, "
          f"t-correcting divide): exact")

    rot = ctx.rotate(c1, 1, keys)
    check((ctx.decode(ctx.decrypt(rot, keys))
           == np.roll(m1, -1, axis=-1)).all(), "rotate rows")
    sw = ctx.conjugate(c1, keys)  # tau_{2n-1}: row swap
    check((ctx.decode(ctx.decrypt(sw, keys)) == m1[::-1]).all(), "swap rows")
    print("rotate rows / swap rows: exact")

    # fused BSGS linear transform, exact mod t
    steps = (0, 1, -1)
    ws = [rng.integers(0, ctx.t, (2, N // 2)) for _ in steps]
    op = ctx.make_linear_op(list(zip(steps, ws)), keys, ctx.L)
    out = ctx.apply_linear(c1, op)
    want = sum(w * np.roll(m1, -s, axis=-1) for s, w in zip(steps, ws)) % ctx.t
    check((ctx.decode(ctx.decrypt(out, keys)) == want).all(),
          "linear transform")
    print(f"fused linear transform ({len(steps)} terms, one ModDown): exact")
    print("bgv_exact: all checks passed with ==")


if __name__ == "__main__":
    main()
