"""The port's RNS-BGV (``agilex_ntt_tpu_torch.schemes.BGVContext``) on the
CPU.

(a) Parity, word for word: the flow of ``int_scheme_flows.py`` through the
JAX package's ``BGVContext`` and through the port's, every named output
held with tolerance 0; and the JAX flow's keys and ciphertexts, carried
into the port, give the JAX flow's words.

(b) Behaviour: the exact numpy-oracle checks of ``tests/test_bgv.py`` and
of ``tests/test_polyeval.py``'s BGV part on the port alone, at their sizes
(n = 256, L = 3; L = 6 for ``poly_eval``), and the refusals.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import int_scheme_flows as F
from agilex_ntt_tpu_torch.schemes import BGVContext
from agilex_ntt_tpu_torch.schemes.ckks import (
    ciphertext_from_numpy,
    keyset_from_numpy,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


# -- (a) parity with the JAX package ------------------------------------------


@pytest.fixture(scope="session")
def jax_flows(request, tmp_path_factory):
    return F.jax_flows(request, tmp_path_factory)


def test_flow_matches_jax(jax_flows):
    names = F.flow_names("bgv")
    want, got = jax_flows["bgv"], F.port_flow("bgv")
    assert len(set(names)) == len(names)
    assert sorted(want) == sorted(got) == sorted(names)
    assert F.mismatches(want, got, names) == []


def test_keys_and_ciphertexts_carried_across(jax_flows):
    """The JAX flow's keys and ciphertexts, carried into the port as numpy
    (BGV's factor as a ``Fraction``), multiply, rescale and rotate to the
    JAX flow's words."""
    f = jax_flows["bgv"]
    elements = sorted({pow(5, t % F.S, 2 * F.FLOW_N) for t in F.STEPS}
                      | {1, 2 * F.FLOW_N - 1})
    keys = keyset_from_numpy({
        "sk": f["sk"], "sk_rns": f["sk_rns"], "pk": (f["pk0"], f["pk1"]),
        "rlk": (f["rlk_b"], f["rlk_a"]),
        "gk": {g: (f[f"gk{g}_b"], f[f"gk{g}_a"]) for g in elements},
    }, device="cpu")
    ctx = BGVContext(F.FLOW_N, F.FLOW_L, device="cpu")
    a, b = (ciphertext_from_numpy({"c0": f[f"{c}.c0"], "c1": f[f"{c}.c1"],
                                   "level": F.FLOW_L, "scale": Fraction(1)},
                                  device="cpu") for c in ("enc1", "enc2"))
    prod = ctx.multiply(a, b, keys)
    low = ctx.rescale(prod)
    assert low.scale == Fraction(ctx.qs[F.FLOW_L - 1])
    tag = f"L{F.FLOW_L}"
    for name, ct in (("multiply", prod), ("rescale", low),
                     ("rotate1", ctx.rotate(a, 1, keys))):
        assert np.array_equal(ct.c0.numpy(), f[f"{tag}.{name}.c0"]), name
        assert np.array_equal(ct.c1.numpy(), f[f"{tag}.{name}.c1"]), name
    # a carried ciphertext at a tracked factor decodes like the JAX flow's
    moved = ciphertext_from_numpy({"c0": f[f"{tag}.rescale.c0"],
                                   "c1": f[f"{tag}.rescale.c1"],
                                   "level": F.FLOW_L - 1,
                                   "scale": low.scale}, device="cpu")
    assert np.array_equal(ctx.decode(ctx.decrypt(moved, keys)),
                          f[f"{tag}.decoded"])


# -- (b) behaviour: tests/test_bgv.py and test_polyeval.py's BGV part --------

N = 256
SLOTS = N // 2


@pytest.fixture(scope="module")
def ctx():
    return BGVContext(N, num_primes=3, rng=np.random.default_rng(13),
                      device="cpu")


@pytest.fixture(scope="module")
def keys(ctx):
    return ctx.keygen(galois_steps=(1, -1, 3))


def mat(ctx, rng, shape=()):
    return rng.integers(0, ctx.t, size=shape + (2, SLOTS))


def dec(ctx, keys, ct):
    return ctx.decode(ctx.decrypt(ct, keys))


def test_exact_against_numpy(ctx, keys):
    """Each test of ``tests/test_bgv.py`` but the mesh one, in turn."""
    rng = np.random.default_rng(21)
    t = ctx.t
    assert (t - 1) % (2 * N) == 0 and t not in ctx.qs and t != ctx.p
    # the encoder, one and a batch of matrices
    m = mat(ctx, rng)
    np.testing.assert_array_equal(ctx.decode(ctx.encode(m)), m)
    mb = mat(ctx, rng, (3,))
    pt = ctx.encode(mb)
    assert tuple(pt.rns.shape) == (ctx.L, 3, N)
    assert pt.rns.dtype == torch.uint32
    np.testing.assert_array_equal(ctx.decode(pt), mb)
    # both encryptions
    m = mat(ctx, rng)
    np.testing.assert_array_equal(dec(ctx, keys, ctx.encrypt(ctx.encode(m), keys)), m)
    np.testing.assert_array_equal(
        dec(ctx, keys, ctx.encrypt_symmetric(ctx.encode(m), keys)), m)
    # add, sub and the plaintext ops
    m1, m2 = mat(ctx, rng), mat(ctx, rng)
    c1 = ctx.encrypt(ctx.encode(m1), keys)
    c2 = ctx.encrypt(ctx.encode(m2), keys)
    for got, want in ((ctx.add(c1, c2), m1 + m2), (ctx.sub(c1, c2), m1 - m2),
                      (ctx.add_plain(c1, ctx.encode(m2)), m1 + m2),
                      (ctx.mul_plain(c1, ctx.encode(m2)), m1 * m2)):
        np.testing.assert_array_equal(dec(ctx, keys, got), want % t)
    # multiply and relinearize
    m1, m2 = mat(ctx, rng), mat(ctx, rng)
    c1 = ctx.encrypt(ctx.encode(m1), keys)
    c2 = ctx.encrypt(ctx.encode(m2), keys)
    np.testing.assert_array_equal(dec(ctx, keys, ctx.multiply(c1, c2, keys)),
                                  (m1 * m2) % t)
    # the modulus switch: the tracked factor undoes q_L^-1 at decode
    m = mat(ctx, rng)
    low = ctx.rescale(ctx.encrypt(ctx.encode(m), keys))
    assert low.level == ctx.L - 1
    np.testing.assert_array_equal(dec(ctx, keys, low), m)
    # multiply, switch, multiply: the key slices reused one level down
    m1, m2, m3 = mat(ctx, rng), mat(ctx, rng), mat(ctx, rng)
    c1 = ctx.encrypt(ctx.encode(m1), keys)
    c2 = ctx.encrypt(ctx.encode(m2), keys)
    prod = ctx.rescale(ctx.multiply(c1, c2, keys))
    c3 = ctx.mod_down_to(ctx.encrypt(ctx.encode(m3), keys), prod.level)
    np.testing.assert_array_equal(dec(ctx, keys, ctx.multiply(prod, c3, keys)),
                                  (m1 * m2 * m3) % t)
    # the row rotations and the row swap
    m = mat(ctx, rng)
    ct = ctx.encrypt(ctx.encode(m), keys)
    for step in (1, 3):
        np.testing.assert_array_equal(dec(ctx, keys, ctx.rotate(ct, step, keys)),
                                      np.roll(m, -step, axis=-1))
    np.testing.assert_array_equal(dec(ctx, keys, ctx.conjugate(ct, keys)),
                                  m[..., ::-1, :])
    # a batched pipeline
    m1, m2 = mat(ctx, rng, (4,)), mat(ctx, rng, (4,))
    c1 = ctx.encrypt(ctx.encode(m1), keys)
    c2 = ctx.encrypt(ctx.encode(m2), keys)
    np.testing.assert_array_equal(
        dec(ctx, keys, ctx.rescale(ctx.multiply(c1, c2, keys))), (m1 * m2) % t)
    # the fused linear transform through the t-correcting hoisted sum
    m = mat(ctx, rng)
    steps = (0, 1, -1)
    ws = [mat(ctx, rng) for _ in steps]
    op = ctx.make_linear_op(list(zip(steps, ws)), keys, ctx.L)
    got = dec(ctx, keys, ctx.apply_linear(ctx.encrypt(ctx.encode(m), keys), op))
    np.testing.assert_array_equal(
        got, sum(w * np.roll(m, -s, axis=-1) for s, w in zip(steps, ws)) % t)


def bgv_ref(coeffs, m, t):
    out = np.zeros_like(m)
    for c in reversed(coeffs):
        out = (out * m + int(c)) % t
    return out


def bgv_cheb_ref(coeffs, m, t):
    tm1 = np.ones_like(m)          # T_0
    tc = m % t                     # T_1
    out = (coeffs[0] * tm1) % t
    if len(coeffs) > 1:
        out = (out + coeffs[1] * tc) % t
    for c in coeffs[2:]:
        tm1, tc = tc, (2 * m * tc - tm1) % t
        out = (out + c * tc) % t
    return out % t


def test_poly_eval_exact_against_numpy():
    """``tests/test_polyeval.py``'s BGV tests: the cubic, degree 8 with
    gaps and Chebyshev degree 6 exact mod t at n = 256, L = 6, and float
    coefficients refused."""
    bctx = BGVContext(N, num_primes=6, rng=np.random.default_rng(5),
                      device="cpu")
    bkeys = bctx.keygen()
    rng = np.random.default_rng(3)
    for coeffs, basis, ref in (([3, 7, 1, 5], "power", bgv_ref),
                               ([2, 0, 11, 0, 5, 1, 0, 9, 4], "power", bgv_ref),
                               ([3, 1, 7, 2, 5, 0, 4], "chebyshev",
                                bgv_cheb_ref)):
        m = rng.integers(0, bctx.t, size=(2, SLOTS))
        ct = bctx.encrypt(bctx.encode(m), bkeys)
        out = bctx.poly_eval(ct, coeffs, bkeys, basis=basis)
        np.testing.assert_array_equal(dec(bctx, bkeys, out) % bctx.t,
                                      ref(coeffs, m, bctx.t))
    m = rng.integers(0, bctx.t, size=(2, SLOTS))
    ct = bctx.encrypt(bctx.encode(m), bkeys)
    with pytest.raises(ValueError, match="integers mod t"):
        bctx.poly_eval(ct, [0.5, 2], bkeys)


def test_refusals(ctx, keys):
    """The JAX package's errors: a mesh without the context's dp axis (at
    the first op), and the default t_bits at n = 16384 (no prime ≡ 1 mod
    2^15 below 2^16)."""
    from agilex_ntt_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match=r"axis 'dp' not in mesh \('sp',\)"):
        BGVContext(N, 3, mesh=make_mesh(sp=2, devices=["cpu"] * 2),
              device="cpu").ring(3)
    with pytest.raises(ValueError, match=r"could not find 1 primes ≡ 1 mod "
                                         r"32768 below 2\*\*16"):
        BGVContext(16384, 4, device="cpu")
    assert BGVContext(16384, 4, t_bits=17, device="cpu").t == 65537
    with pytest.raises(ValueError, match="not ≡ 1 mod 2n"):
        BGVContext(N, 3, t=65539, device="cpu")
    with pytest.raises(ValueError, match="disjoint"):
        BGVContext(N, 3, t=ctx.qs[0], device="cpu")
    rng = np.random.default_rng(4)
    with pytest.raises(ValueError, match="carry no scale"):
        ctx.make_linear_op([(1, mat(ctx, rng))], keys, ctx.L, scale=2)
    with pytest.raises(ValueError, match="mod t"):
        ctx.make_matvec(np.eye(SLOTS - 1, dtype=np.int64), keys, ctx.L)
    with pytest.raises(ValueError, match="expected slots"):
        ctx.encode(np.zeros((3, SLOTS), dtype=np.int64))
    with pytest.raises(TypeError, match="TPU-only"):
        BGVContext(N, 3, interpret=True, device="cpu")
