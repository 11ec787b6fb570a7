"""Homomorphic polynomial evaluation on the port's CKKS, on the CPU.

Each CKKS test of ``tests/test_polyeval.py`` on the port alone, at the same
size (n = 256, L = 6), with the same tolerances against numpy on the slots
and the same errors; the exact scale dictation (the result at Delta^2) is
held as there.  The port's word-for-word parity with the JAX package's
``poly_eval`` is in ``test_torch_ckks.py``.  One intended divergence (R2):
a constant polynomial below level 2 raises here; the JAX package returns a
value that does not decode.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from agilex_ntt_tpu_torch.schemes import CKKSContext

N = 256
SLOTS = N // 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ctx():
    return CKKSContext(N, num_primes=6, rng=np.random.default_rng(11),
                       device="cpu")


@pytest.fixture(scope="module")
def keys(ctx):
    return ctx.keygen()


@pytest.fixture(scope="module")
def short():
    ctx = CKKSContext(N, num_primes=3, rng=np.random.default_rng(2),
                      device="cpu")
    return ctx, ctx.keygen()


@pytest.fixture()
def rng():
    return np.random.default_rng(3)


def slots(rng, lo=-0.9, hi=0.9, shape=(SLOTS,)):
    return rng.uniform(lo, hi, shape) + 1j * rng.uniform(lo, hi, shape)


def ref_poly(coeffs, z):
    out = np.zeros_like(z)
    for c in reversed(coeffs):
        out = out * z + c
    return out


def dec(ctx, keys, ct):
    return ctx.decode(ctx.decrypt(ct, keys))


def test_linear_no_multiplies(ctx, keys, rng):
    z = slots(rng)
    ct = ctx.encrypt(ctx.encode(z), keys)
    coeffs = [0.25 - 0.5j, 1.5]
    out = ctx.poly_eval(ct, coeffs, keys)
    assert out.level == ctx.L  # depth 0: no level consumed
    assert out.scale == Fraction(ctx.delta) ** 2
    np.testing.assert_allclose(dec(ctx, keys, out), ref_poly(coeffs, z),
                               atol=1e-3)


def test_cubic(ctx, keys, rng):
    z = slots(rng)
    ct = ctx.encrypt(ctx.encode(z), keys)
    coeffs = [0.5, -1.0, 0.25, 0.75]
    out = ctx.poly_eval(ct, coeffs, keys)
    assert out.scale == Fraction(ctx.delta) ** 2
    np.testing.assert_allclose(dec(ctx, keys, out), ref_poly(coeffs, z),
                               atol=5e-3)


def test_degree8_complex_coeffs(ctx, keys, rng):
    z = slots(rng, -0.8, 0.8)
    ct = ctx.encrypt(ctx.encode(z), keys)
    coeffs = [0.1 + 0.2j, -0.4, 0.3j, 0.2, -0.15,
              0.1 - 0.1j, 0.05, -0.08, 0.06]
    out = ctx.poly_eval(ct, coeffs, keys)
    assert out.scale == Fraction(ctx.delta) ** 2
    np.testing.assert_allclose(dec(ctx, keys, out), ref_poly(coeffs, z),
                               atol=5e-2)


def test_sparse_gaps(ctx, keys, rng):
    # x^5 + 0.5: zero coefficients skip work but not correctness
    z = slots(rng, -0.8, 0.8)
    ct = ctx.encrypt(ctx.encode(z), keys)
    coeffs = [0.5, 0, 0, 0, 0, 0.8]
    out = ctx.poly_eval(ct, coeffs, keys)
    np.testing.assert_allclose(dec(ctx, keys, out), ref_poly(coeffs, z),
                               atol=2e-2)


def test_rescale_composes(ctx, keys, rng):
    z = slots(rng)
    ct = ctx.encrypt(ctx.encode(z), keys)
    coeffs = [0.0, 0.5, 0.5]
    out = ctx.rescale(ctx.poly_eval(ct, coeffs, keys))
    np.testing.assert_allclose(dec(ctx, keys, out), ref_poly(coeffs, z),
                               atol=5e-3)


def test_batched(ctx, keys, rng):
    z = slots(rng, shape=(3, SLOTS))
    ct = ctx.encrypt(ctx.encode(z), keys)
    coeffs = [0.2, -0.3, 0.4]
    out = ctx.poly_eval(ct, coeffs, keys)
    np.testing.assert_allclose(dec(ctx, keys, out), ref_poly(coeffs, z),
                               atol=5e-3)


def test_constant_polynomial(ctx, keys, rng):
    z = slots(rng)
    ct = ctx.encrypt(ctx.encode(z), keys)
    out = ctx.poly_eval(ct, [0.75 + 0.25j], keys)
    np.testing.assert_allclose(dec(ctx, keys, out),
                               np.full(SLOTS, 0.75 + 0.25j), atol=1e-3)


def test_constant_below_min_level_raises(ctx, keys, rng):
    """R2, the intended divergence: at level 1 the Delta^2 result of a
    constant wraps mod Q_1, so the port refuses it as it refuses degree
    >= 1 there; at level 2 it decodes."""
    z = slots(rng)
    ct = ctx.encrypt(ctx.encode(z), keys)
    with pytest.raises(ValueError, match="level >= 2"):
        ctx.poly_eval(ctx.mod_down_to(ct, 1), [0.75], keys)
    out = ctx.poly_eval(ctx.mod_down_to(ct, 2), [0.75], keys)
    assert out.level == 2
    np.testing.assert_allclose(dec(ctx, keys, out), np.full(SLOTS, 0.75),
                               atol=1e-3)


def test_chain_too_short_raises_before_any_work(short, rng):
    ctx, kk = short
    ct = ctx.encrypt(ctx.encode(slots(rng)), kk)
    with pytest.raises(ValueError, match="prime level"):
        ctx.poly_eval(ct, [0.1] * 9, kk)  # degree 8 needs ~5 levels


def test_result_level_must_hold_delta_squared(short, rng):
    # a cubic on a 3-prime chain would land at level 1, where the Delta^2
    # scale wraps mod Q_1: the plan refuses it
    ctx, kk = short
    ct = ctx.encrypt(ctx.encode(slots(rng)), kk)
    with pytest.raises(ValueError, match="level >= 2"):
        ctx.poly_eval(ct, [0.5, -1.0, 0.25, 0.75], kk)


def test_degree4_constant_quotient(ctx, keys, rng):
    # deg == k*2^j: the quotient is the constant c_4, so the giant term is
    # a plaintext multiply (no relinearization, no level)
    z = slots(rng, -0.8, 0.8)
    ct = ctx.encrypt(ctx.encode(z), keys)
    coeffs = [0.1, -0.4, 0.3, 0.2, -0.15]
    out = ctx.poly_eval(ct, coeffs, keys)
    assert out.level == ctx.L - 2  # x^2/x^3 depth only
    np.testing.assert_allclose(dec(ctx, keys, out), ref_poly(coeffs, z),
                               atol=2e-2)


def test_empty_coeffs_raises(ctx, keys, rng):
    ct = ctx.encrypt(ctx.encode(slots(rng)), keys)
    with pytest.raises(ValueError, match="non-empty"):
        ctx.poly_eval(ct, [], keys)


def cheb_slots(rng, shape=(SLOTS,)):
    # real values inside [-1, 1], the Chebyshev domain
    return rng.uniform(-0.95, 0.95, shape) + 0j


def test_chebyshev_deg6(ctx, keys, rng):
    # the odd-baby path (T_3 = 2 T_2 T_1 - T_1 with the plaintext-ratio
    # alignment) and a full giant node
    z = cheb_slots(rng)
    ct = ctx.encrypt(ctx.encode(z), keys)
    coeffs = [0.2, -0.5, 0.3, 0.15, -0.1, 0.05, 0.1]
    out = ctx.poly_eval(ct, coeffs, keys, basis="chebyshev")
    want = np.polynomial.chebyshev.chebval(z, coeffs)
    np.testing.assert_allclose(dec(ctx, keys, out), want, atol=5e-2)


def test_chebyshev_deg12(ctx, keys, rng):
    # two giants (T_4, T_8), a constant-quotient inner node, nested
    # remainders
    z = cheb_slots(rng)
    ct = ctx.encrypt(ctx.encode(z), keys)
    coeffs = [0.1, -0.2, 0.15, 0.1, -0.08, 0.06, -0.05, 0.04,
              -0.03, 0.02, -0.02, 0.01, 0.01]
    out = ctx.poly_eval(ct, coeffs, keys, basis="chebyshev")
    want = np.polynomial.chebyshev.chebval(z, coeffs)
    np.testing.assert_allclose(dec(ctx, keys, out), want, atol=5e-2)


def test_chebyshev_matches_power_composition(ctx, keys, rng):
    z = cheb_slots(rng)
    ct = ctx.encrypt(ctx.encode(z), keys)
    tcoeffs = [0.3, -0.4, 0.25, 0.2]
    pcoeffs = list(np.polynomial.chebyshev.cheb2poly(tcoeffs))
    a = ctx.poly_eval(ct, tcoeffs, keys, basis="chebyshev")
    b = ctx.poly_eval(ct, pcoeffs, keys)
    np.testing.assert_allclose(dec(ctx, keys, a), dec(ctx, keys, b),
                               atol=2e-2)


def test_bad_basis_raises(ctx, keys, rng):
    ct = ctx.encrypt(ctx.encode(slots(rng)), keys)
    with pytest.raises(ValueError, match="basis"):
        ctx.poly_eval(ct, [1, 2], keys, basis="legendre")


@pytest.mark.parametrize("basis,levels,degree", [
    ("power", 4, 4), ("chebyshev", 4, 3), ("power", 6, 16),
    ("chebyshev", 6, 14),
])
def test_plan_gives_the_highest_degree(basis, levels, degree):
    """``poly_eval_plan`` before any ciphertext work: the highest dense
    degree a chain reaches with its result at level >= 2."""
    ctx = CKKSContext(N, num_primes=levels, device="cpu")
    cs, _, _, l_out = ctx.poly_eval_plan(levels, [0.5] * (degree + 1),
                                         basis=basis)
    assert len(cs) == degree + 1 and l_out >= 2
    with pytest.raises(ValueError, match="more prime level"):
        ctx.poly_eval_plan(levels, [0.5] * (degree + 2), basis=basis)
