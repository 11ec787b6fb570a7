"""Homomorphic activation functions through ``poly_eval`` (BSGS
Paterson-Stockmeyer).

Counterpart of ``examples/poly_activation.py``: private inference
evaluates non-linear activations as polynomial approximations under
encryption.  This approximates the logistic sigmoid on [-4, 4] by a
least-squares degree-7 polynomial, encrypts a batch of pre-activations and
applies it with ONE ``poly_eval`` call: 4 ciphertext multiplies at depth 3
instead of 7 sequential Horner multiplies at depth 7.

Run: python -m agilex_ntt_tpu_torch.examples.poly_activation
[--device cpu|cuda]
"""

import numpy as np

from agilex_ntt_tpu_torch.examples._common import check, device_from
from agilex_ntt_tpu_torch.schemes import CKKSContext

N = 2048
L = 6
DEG = 7


def main(argv=None):
    device = device_from(argv, __doc__)
    rng = np.random.default_rng(0)
    ctx = CKKSContext(N, num_primes=L, rng=rng, device=device)
    keys = ctx.keygen()

    # least-squares degree-7 fit of sigmoid on [-4, 4] (host-side, one time)
    xs = np.linspace(-4, 4, 513)
    coeffs = np.polynomial.polynomial.polyfit(xs, 1 / (1 + np.exp(-xs)), DEG)
    fit_err = np.abs(
        np.polynomial.polynomial.polyval(xs, coeffs) - 1 / (1 + np.exp(-xs))
    ).max()
    print(f"degree-{DEG} sigmoid fit, max approx error {fit_err:.2e}")

    # encrypt a batch of pre-activations (slots = one layer's outputs)
    z = rng.uniform(-4, 4, (4, N // 2))
    ct = ctx.encrypt(ctx.encode(z + 0j), keys)

    # ONE call: baby/giant powers + the dictated-scale recursion
    out = ctx.rescale(ctx.poly_eval(ct, list(coeffs), keys))
    print(f"result level {out.level} (input {ctx.L}), scale ~2^"
          f"{float(out.scale).hex().split('p')[1]}")

    got = ctx.decode(ctx.decrypt(out, keys)).real
    want = 1 / (1 + np.exp(-z))
    err = np.abs(got - want).max()
    print(f"max end-to-end error vs true sigmoid: {err:.2e} "
          f"(approximation {fit_err:.2e} + scheme noise)")
    check(err < fit_err + 1e-2, "sigmoid error above the fit's plus 1e-2")
    print("OK")


if __name__ == "__main__":
    main()
