"""The port's RNS-CKKS (``agilex_ntt_tpu_torch.schemes``) on the CPU.

(a) Parity, word for word: one flow, from one seed, through the JAX
package's ``CKKSContext`` and through the port's: keys in both domains,
encodings, both encryptions, decryption, the arithmetic, ``multiply``,
``square``, ``rescale``, ``mod_down_to``, rotations, ``conjugate``, the
linear transform, the BSGS matvec and ``poly_eval`` in both bases, at the
top level and at a lower one.  Each named output is one case, held with
tolerance 0.  Both contexts draw every secret, error and mask from
``np.random.default_rng(FLOW_SEED)`` with the same calls in the same order,
so they hold the same words.

The JAX flow runs once per test session, in a child process
(``test_torch_jaxref.py``), and its result is shared by every xdist worker
through a file beside the workers' temporary directories, under a file lock.
The child runs the JAX package's functions op by op (``jax.disable_jit()``):
compiled, the flow's graphs cost minutes of XLA CPU compile, and on this
path both give the same words (the only float step, the HPS estimate of a
one-prime gadget digit, is one float32 product, which no compiler can
contract).

(b) Behaviour: each test of ``tests/test_ckks.py`` on the port alone, at the
same sizes (n = 256, L = 3; the matvec at n = 128) and tolerances, raising
the same errors; and the port's own constructor checks.
"""

import time

import numpy as np
import pytest
import torch

from agilex_ntt_tpu_torch.schemes import CKKSContext
from agilex_ntt_tpu_torch.schemes.ckks import (
    ciphertext_from_numpy,
    decode_coeffs,
    encode_coeffs,
    keyset_from_numpy,
)
from test_torch_jaxref import computed_once


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


# -- (a) parity with the JAX package ------------------------------------------

FLOW_N, FLOW_L, FLOW_LOW, FLOW_SEED = 16, 5, 2, 2026
ROT_STEPS = (1, -3)
LIN_STEPS = (0, 1, -3, 2)
# degree 5: the babies x^2 (square) and x^3 (multiply), a full giant node
POWER = [0.3, -0.5, 0.25, 0.125, 0.1, -0.05]
# degree 4: T_3 by the odd recurrence, a constant quotient on T_4
CHEB = [0.2, -0.4, 0.3, 0.1, 0.05]
STEPS = tuple(sorted(
    set(CKKSContext(FLOW_N, FLOW_L, device="cpu").bsgs_steps()) | set(ROT_STEPS)
))
ELEMENTS = tuple(sorted(
    {pow(5, t % (FLOW_N // 2), 2 * FLOW_N) for t in STEPS} | {1, 2 * FLOW_N - 1}
))
LEVEL_CTS = ("add", "sub", "negate", "add_plain", "mul_plain", "multiply",
             "square", "rescale", "conjugate", "apply_linear", "apply_matvec",
             "poly_power", "poly_cheb") + tuple(f"rotate{t}" for t in ROT_STEPS)


def _flow_names():
    names = ["sk", "sk_rns", "pk0", "pk1", "rlk_b", "rlk_a", "rlk_coeff_b",
             "rlk_coeff_a", "pt1", "pt2"]
    for g in ELEMENTS:
        names += [f"gk{g}_b", f"gk{g}_a", f"gk_coeff{g}_b", f"gk_coeff{g}_a"]
    cts = ["enc1", "enc2", "encsym"]
    for lvl in (FLOW_L, FLOW_LOW):
        names += [f"L{lvl}.decrypt", f"L{lvl}.linear.pts", f"L{lvl}.linear.kb",
                  f"L{lvl}.linear.ka", f"L{lvl}.matvec.pts",
                  f"L{lvl}.matvec.baby_ksks"]
        cts += [f"L{lvl}.{op}" for op in LEVEL_CTS]
        if lvl != FLOW_L:
            cts.append(f"L{lvl}.mod_down_to")
    return names + [f"{c}.{part}" for c in cts for part in ("c0", "c1")]


FLOW_NAMES = _flow_names()


def _flow(ctx, arr) -> dict:
    """Every op of the slice on ``ctx``, each output as numpy under a name
    of ``FLOW_NAMES`` (``arr`` turns a JAX array or a tensor into numpy),
    and under "R2" what a constant polynomial at level 1 gives."""
    S = FLOW_N // 2
    keys = ctx.keygen(galois_steps=STEPS)
    out = {"sk": np.asarray(keys.sk), "sk_rns": arr(keys.sk_rns),
           "pk0": arr(keys.pk[0]), "pk1": arr(keys.pk[1])}
    for name, pair in (("rlk", keys.rlk), ("rlk_coeff", keys.rlk_coeff)):
        out[name + "_b"], out[name + "_a"] = arr(pair[0]), arr(pair[1])
    for g in sorted(keys.gk):
        out[f"gk{g}_b"], out[f"gk{g}_a"] = (arr(k) for k in keys.gk[g])
        out[f"gk_coeff{g}_b"], out[f"gk_coeff{g}_a"] = (
            arr(k) for k in keys.gk_coeff[g])
    rng = np.random.default_rng(FLOW_SEED + 1)

    def slots(shape):
        return rng.uniform(-0.9, 0.9, shape) + 1j * rng.uniform(-0.9, 0.9, shape)

    z1, z2 = slots((2, S)), slots((2, S))
    ws = [slots(S) for _ in LIN_STEPS]
    M = slots((S, S)) / S
    pt1, pt2 = ctx.encode(z1), ctx.encode(z2)
    out["pt1"], out["pt2"] = arr(pt1.rns), arr(pt2.rns)

    def put(name, ct):
        out[name + ".c0"], out[name + ".c1"] = arr(ct.c0), arr(ct.c1)

    c1, c2 = ctx.encrypt(pt1, keys), ctx.encrypt(pt2, keys)
    put("enc1", c1)
    put("enc2", c2)
    put("encsym", ctx.encrypt_symmetric(pt1, keys))
    for lvl in (FLOW_L, FLOW_LOW):
        tag = f"L{lvl}"
        a, b = ctx.mod_down_to(c1, lvl), ctx.mod_down_to(c2, lvl)
        if lvl != FLOW_L:
            put(f"{tag}.mod_down_to", a)
        out[f"{tag}.decrypt"] = arr(ctx.decrypt(a, keys).rns)
        put(f"{tag}.add", ctx.add(a, b))
        put(f"{tag}.sub", ctx.sub(a, b))
        put(f"{tag}.negate", ctx.negate(a))
        put(f"{tag}.add_plain", ctx.add_plain(a, pt2))
        put(f"{tag}.mul_plain", ctx.mul_plain(a, pt2))
        prod = ctx.multiply(a, b, keys)
        put(f"{tag}.multiply", prod)
        put(f"{tag}.square", ctx.square(a, keys))
        put(f"{tag}.rescale", ctx.rescale(prod))
        for t in ROT_STEPS:
            put(f"{tag}.rotate{t}", ctx.rotate(a, t, keys))
        put(f"{tag}.conjugate", ctx.conjugate(a, keys))
        op = ctx.make_linear_op(list(zip(LIN_STEPS, ws)), keys, lvl)
        for name in ("pts", "kb", "ka"):
            out[f"{tag}.linear.{name}"] = arr(getattr(op, name))
        put(f"{tag}.apply_linear", ctx.apply_linear(a, op))
        mv = ctx.make_matvec(M, keys, lvl)
        out[f"{tag}.matvec.pts"] = arr(mv.pts)
        out[f"{tag}.matvec.baby_ksks"] = arr(mv.baby_ksks)
        put(f"{tag}.apply_matvec", ctx.apply_matvec(a, mv))
        top = lvl == FLOW_L  # degree 1 below: no depth left
        put(f"{tag}.poly_power", ctx.poly_eval(a, POWER if top else POWER[:2],
                                                keys))
        put(f"{tag}.poly_cheb", ctx.poly_eval(a, CHEB if top else CHEB[:2],
                                               keys, basis="chebyshev"))
    try:
        out["R2"] = ctx.poly_eval(ctx.mod_down_to(c1, 1), [0.75], keys).level
    except ValueError as err:
        out["R2"] = str(err)
    return out


def _jax_flow() -> dict:
    """The flow on the JAX package's context, op by op; "__seconds__" is
    its time in the child."""
    import jax

    from agilex_ntt_tpu.schemes.ckks import CKKSContext as JCKKSContext

    t0 = time.perf_counter()
    with jax.disable_jit():
        ctx = JCKKSContext(FLOW_N, FLOW_L, rng=np.random.default_rng(FLOW_SEED))
        out = _flow(ctx, np.asarray)
    out["__seconds__"] = time.perf_counter() - t0
    return out


@pytest.fixture(scope="session")
def jax_flow(request, tmp_path_factory):
    """The JAX flow, computed once for every xdist worker of the session."""
    return computed_once(request, tmp_path_factory, "ckks_jax_flow", _jax_flow)


@pytest.fixture(scope="module")
def port_flow():
    ctx = CKKSContext(FLOW_N, FLOW_L, rng=np.random.default_rng(FLOW_SEED),
                      device="cpu")
    return _flow(ctx, lambda t: t.numpy())


def test_flow_names(jax_flow, port_flow):
    assert len(set(FLOW_NAMES)) == len(FLOW_NAMES)
    assert sorted(jax_flow) == sorted(FLOW_NAMES + ["R2", "__seconds__"])
    assert sorted(port_flow) == sorted(FLOW_NAMES + ["R2"])


@pytest.mark.parametrize("name", FLOW_NAMES)
def test_flow_matches_jax(jax_flow, port_flow, name):
    want, got = jax_flow[name], port_flow[name]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_constant_below_min_level_is_an_intended_divergence(jax_flow, port_flow):
    """R2: the JAX package returns a constant polynomial at level 1, which
    does not decode (Delta^2 wraps mod Q_1); the port raises there as it
    does for degree >= 1."""
    assert jax_flow["R2"] == 1
    assert "level >= 2" in port_flow["R2"]


def test_keys_and_ciphertexts_carried_across(jax_flow):
    """The JAX flow's keys and ciphertexts, carried into the port as numpy,
    multiply and rotate to the JAX flow's words."""
    f = jax_flow
    keys = keyset_from_numpy({
        "sk": f["sk"], "sk_rns": f["sk_rns"], "pk": (f["pk0"], f["pk1"]),
        "rlk": (f["rlk_b"], f["rlk_a"]),
        "gk": {g: (f[f"gk{g}_b"], f[f"gk{g}_a"]) for g in ELEMENTS},
    }, device="cpu")
    assert keys.gk_coeff is None and keys.sk.dtype == np.int64
    ctx = CKKSContext(FLOW_N, FLOW_L, device="cpu")
    a, b = (ciphertext_from_numpy({"c0": f[f"{c}.c0"], "c1": f[f"{c}.c1"],
                                   "level": FLOW_L, "scale": ctx.delta},
                                  device="cpu") for c in ("enc1", "enc2"))
    tag = f"L{FLOW_L}"
    for name, ct in (("multiply", ctx.multiply(a, b, keys)),
                     ("rotate1", ctx.rotate(a, 1, keys))):
        assert np.array_equal(ct.c0.numpy(), f[f"{tag}.{name}.c0"])
        assert np.array_equal(ct.c1.numpy(), f[f"{tag}.{name}.c1"])


# -- (b) behaviour: tests/test_ckks.py on the port ---------------------------

N = 256
SLOTS = N // 2
TOL = 1e-3


@pytest.fixture(scope="module")
def ctx():
    return CKKSContext(N, num_primes=3, rng=np.random.default_rng(7),
                       device="cpu")


@pytest.fixture(scope="module")
def keys(ctx):
    return ctx.keygen(galois_steps=(0, 1, -1, 3, 5))


@pytest.fixture()
def rng():
    return np.random.default_rng(42)


def slots(rng, shape=(SLOTS,), lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape) + 1j * rng.uniform(lo, hi, shape)


def dec(ctx, keys, ct):
    return ctx.decode(ctx.decrypt(ct, keys))


def test_encoder_roundtrip(rng):
    z = slots(rng)
    m = encode_coeffs(z, N, 1 << 29)
    back = decode_coeffs(m, N, 1 << 29)
    np.testing.assert_allclose(back, z, atol=1e-6)


def test_encoder_coeffs_are_real_integers(rng):
    m = encode_coeffs(slots(rng), N, 1 << 29)
    assert m.dtype == np.int64
    assert np.abs(m).max() < (1 << 31)


def test_encoder_is_ring_homomorphism(rng):
    z1, z2 = slots(rng), slots(rng)
    m1 = encode_coeffs(z1, N, 1 << 20).astype(object)
    m2 = encode_coeffs(z2, N, 1 << 20).astype(object)
    conv = np.convolve(m1, m2)
    prod = conv[:N].copy()
    prod[: N - 1] -= conv[N:]
    got = decode_coeffs(prod.astype(np.float64), N, (1 << 20) ** 2)
    np.testing.assert_allclose(got, z1 * z2, atol=1e-3)


def test_encoder_batch(rng):
    z = slots(rng, (3, 2, SLOTS))
    m = encode_coeffs(z, N, 1 << 29)
    assert m.shape == (3, 2, N)
    np.testing.assert_allclose(decode_coeffs(m, N, 1 << 29), z, atol=1e-6)


def test_public_key_roundtrip(ctx, keys, rng):
    z = slots(rng)
    ct = ctx.encrypt(ctx.encode(z), keys)
    assert ct.c0.dtype == torch.uint32 and ct.c0.device.type == "cpu"
    np.testing.assert_allclose(dec(ctx, keys, ct), z, atol=TOL)


def test_symmetric_roundtrip(ctx, keys, rng):
    z = slots(rng)
    ct = ctx.encrypt_symmetric(ctx.encode(z), keys)
    np.testing.assert_allclose(dec(ctx, keys, ct), z, atol=TOL)


def test_batched_ciphertext(ctx, keys, rng):
    z = slots(rng, (4, SLOTS))
    ct = ctx.encrypt(ctx.encode(z), keys)
    assert tuple(ct.c0.shape) == (ctx.L, 4, N)
    np.testing.assert_allclose(dec(ctx, keys, ct), z, atol=TOL)


def test_add_sub_negate(ctx, keys, rng):
    z1, z2 = slots(rng), slots(rng)
    c1 = ctx.encrypt(ctx.encode(z1), keys)
    c2 = ctx.encrypt(ctx.encode(z2), keys)
    np.testing.assert_allclose(dec(ctx, keys, ctx.add(c1, c2)), z1 + z2, atol=TOL)
    np.testing.assert_allclose(dec(ctx, keys, ctx.sub(c1, c2)), z1 - z2, atol=TOL)
    np.testing.assert_allclose(dec(ctx, keys, ctx.negate(c1)), -z1, atol=TOL)


def test_add_plain(ctx, keys, rng):
    z1, z2 = slots(rng), slots(rng)
    ct = ctx.encrypt(ctx.encode(z1), keys)
    out = ctx.add_plain(ct, ctx.encode(z2))
    np.testing.assert_allclose(dec(ctx, keys, out), z1 + z2, atol=TOL)


def test_mul_plain_rescale(ctx, keys, rng):
    z1, z2 = slots(rng), slots(rng)
    ct = ctx.encrypt(ctx.encode(z1), keys)
    out = ctx.rescale(ctx.mul_plain(ct, ctx.encode(z2)))
    assert out.level == ctx.L - 1
    np.testing.assert_allclose(dec(ctx, keys, out), z1 * z2, atol=TOL)


def test_multiply_relinearize(ctx, keys, rng):
    z1, z2 = slots(rng), slots(rng)
    c1 = ctx.encrypt(ctx.encode(z1), keys)
    c2 = ctx.encrypt(ctx.encode(z2), keys)
    out = ctx.rescale(ctx.multiply(c1, c2, keys))
    np.testing.assert_allclose(dec(ctx, keys, out), z1 * z2, atol=TOL)


def test_square(ctx, keys, rng):
    z = slots(rng)
    ct = ctx.encrypt(ctx.encode(z), keys)
    out = ctx.rescale(ctx.square(ct, keys))
    np.testing.assert_allclose(dec(ctx, keys, out), z * z, atol=TOL)


def test_multiply_at_lower_level_reuses_keys(ctx, keys, rng):
    # x^4 by two squarings: the second at level L-1 on the same key tensors,
    # sliced (the g_d ≡ g_d^(l) congruence)
    z = slots(rng, lo=-0.8, hi=0.8)
    ct = ctx.encrypt(ctx.encode(z), keys)
    sq = ctx.rescale(ctx.square(ct, keys))
    assert sq.level == ctx.L - 1
    quad = ctx.rescale(ctx.square(sq, keys))
    assert quad.level == ctx.L - 2
    np.testing.assert_allclose(dec(ctx, keys, quad), z ** 4, atol=5 * TOL)


def test_mod_down_to(ctx, keys, rng):
    z = slots(rng)
    ct = ctx.encrypt(ctx.encode(z), keys)
    low = ctx.mod_down_to(ct, 1)
    assert low.level == 1
    np.testing.assert_allclose(dec(ctx, keys, low), z, atol=TOL)


def test_level_scale_mismatch_raises(ctx, keys, rng):
    z = slots(rng)
    c1 = ctx.encrypt(ctx.encode(z), keys)
    c2 = ctx.mod_down_to(ctx.encrypt(ctx.encode(z), keys), ctx.L - 1)
    with pytest.raises(ValueError, match="level mismatch"):
        ctx.add(c1, c2)


@pytest.mark.parametrize("t", [1, -1, 3, 5])
def test_rotate(ctx, keys, rng, t):
    z = slots(rng)
    ct = ctx.encrypt(ctx.encode(z), keys)
    out = ctx.rotate(ct, t, keys)
    np.testing.assert_allclose(dec(ctx, keys, out), np.roll(z, -t), atol=TOL)


def test_conjugate(ctx, keys, rng):
    z = slots(rng)
    ct = ctx.encrypt(ctx.encode(z), keys)
    out = ctx.conjugate(ct, keys)
    np.testing.assert_allclose(dec(ctx, keys, out), np.conj(z), atol=TOL)


def test_rotate_at_lower_level(ctx, keys, rng):
    z = slots(rng)
    ct = ctx.mod_down_to(ctx.encrypt(ctx.encode(z), keys), ctx.L - 1)
    out = ctx.rotate(ct, 1, keys)
    np.testing.assert_allclose(dec(ctx, keys, out), np.roll(z, -1), atol=TOL)


def test_missing_rotation_key_raises(ctx, keys, rng):
    ct = ctx.encrypt(ctx.encode(slots(rng)), keys)
    with pytest.raises(KeyError, match="no rotation key"):
        ctx.rotate(ct, 7, keys)


def test_linear_op_matches_composed(ctx, keys, rng):
    z = slots(rng)
    steps = (0, 1, -1)
    ws = [slots(rng) for _ in steps]
    op = ctx.make_linear_op(list(zip(steps, ws)), keys, ctx.L)
    ct = ctx.encrypt(ctx.encode(z), keys)
    got = dec(ctx, keys, ctx.rescale(ctx.apply_linear(ct, op)))
    want = sum(w * np.roll(z, -t) for t, w in zip(steps, ws))
    np.testing.assert_allclose(got, want, atol=5 * TOL)


def test_linear_op_identity_term_only(ctx, keys, rng):
    # the t=0 term takes the same hoisted path through the g=1 key
    z, w = slots(rng), slots(rng)
    op = ctx.make_linear_op([(0, w)], keys, ctx.L)
    ct = ctx.encrypt(ctx.encode(z), keys)
    got = dec(ctx, keys, ctx.rescale(ctx.apply_linear(ct, op)))
    np.testing.assert_allclose(got, w * z, atol=5 * TOL)


def test_linear_op_batched(ctx, keys, rng):
    z = slots(rng, (3, SLOTS))
    steps = (1, 3)
    ws = [slots(rng) for _ in steps]
    op = ctx.make_linear_op(list(zip(steps, ws)), keys, ctx.L)
    ct = ctx.encrypt(ctx.encode(z), keys)
    got = dec(ctx, keys, ctx.rescale(ctx.apply_linear(ct, op)))
    want = sum(w[None] * np.roll(z, -t, axis=-1) for t, w in zip(steps, ws))
    np.testing.assert_allclose(got, want, atol=5 * TOL)


MN = 128
MSLOTS = MN // 2


@pytest.fixture(scope="module")
def mv_ctx():
    return CKKSContext(MN, num_primes=3, rng=np.random.default_rng(7),
                       device="cpu")


@pytest.fixture(scope="module")
def mv_keys(mv_ctx):
    steps = set(mv_ctx.bsgs_steps()) | set(
        mv_ctx.bsgs_steps(bsgs=(16, MSLOTS // 16))
    )
    return mv_ctx.keygen(galois_steps=sorted(steps))


def mslots(rng, shape=(MSLOTS,)):
    return rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)


def test_matvec_full_matrix(mv_ctx, mv_keys, rng):
    ctx = mv_ctx
    z = mslots(rng)
    M = (rng.uniform(-1, 1, (MSLOTS, MSLOTS))
         + 1j * rng.uniform(-1, 1, (MSLOTS, MSLOTS))) / MSLOTS
    op = ctx.make_matvec(M, mv_keys, ctx.L)
    ct = ctx.encrypt(ctx.encode(z), mv_keys)
    got = dec(ctx, mv_keys, ctx.rescale(ctx.apply_matvec(ct, op)))
    np.testing.assert_allclose(got, M @ z, atol=5 * TOL)


def test_matvec_explicit_bsgs_split(mv_ctx, mv_keys, rng):
    # a split other than the default: the zero tail diagonals add nothing
    ctx = mv_ctx
    z = mslots(rng)
    M = np.diag(rng.uniform(-1, 1, MSLOTS)) + 0j
    b, g = 16, MSLOTS // 16
    op = ctx.make_matvec(M, mv_keys, ctx.L, bsgs=(b, g))
    assert op.b == b and op.g == g
    ct = ctx.encrypt(ctx.encode(z), mv_keys)
    got = dec(ctx, mv_keys, ctx.rescale(ctx.apply_matvec(ct, op)))
    np.testing.assert_allclose(got, M @ z, atol=5 * TOL)


def test_matvec_at_lower_level(mv_ctx, mv_keys, rng):
    ctx = mv_ctx
    z = mslots(rng)
    M = np.eye(MSLOTS, k=1) + np.eye(MSLOTS, k=-(MSLOTS - 1)) + 0j
    op = ctx.make_matvec(M, mv_keys, ctx.L - 1)
    ct = ctx.mod_down_to(ctx.encrypt(ctx.encode(z), mv_keys), ctx.L - 1)
    got = dec(ctx, mv_keys, ctx.rescale(ctx.apply_matvec(ct, op)))
    np.testing.assert_allclose(got, np.roll(z, -1), atol=5 * TOL)


def test_matvec_missing_key_raises(ctx, keys, rng):
    M = np.eye(SLOTS) + 0j
    with pytest.raises(KeyError, match="rotation key"):
        ctx.make_matvec(M, keys, ctx.L)


# -- the port's own checks ------------------------------------------------------


def test_mesh_matches_single_device():
    """CKKS, BGV and BFV with ``mesh=make_mesh(dp=4)`` on four CPU devices
    (N=256, L=3, B=8): multiply and rescale, square, rotate by 1, a
    two-term linear transform and BFV's ``mod_down_to``, each equal word
    for word to the port's unsharded context with the same keys (which the
    parity flows hold to the JAX package; the JAX package's own sharded
    tests hold its mesh flows to its single-chip ones).  A LinearOp built
    for the other domain raises, and a mesh without the context's dp axis
    raises at the first op, as in the JAX package."""
    from agilex_ntt_tpu_torch.parallel import make_mesh
    from agilex_ntt_tpu_torch.schemes import BFVContext, BGVContext

    mesh = make_mesh(dp=4, devices=["cpu"] * 4)
    batch = 8
    rng = np.random.default_rng(43)
    for cls in (CKKSContext, BGVContext, BFVContext):
        one = cls(N, 3, rng=np.random.default_rng(5), device="cpu")
        sh = cls(N, 3, rng=np.random.default_rng(5), device="cpu", mesh=mesh)
        keys = one.keygen(galois_steps=(1,))
        if cls is CKKSContext:
            ms = [slots(rng, (batch, SLOTS)) for _ in range(2)]
            ws = [slots(rng) for _ in range(2)]
        else:
            ms = [rng.integers(0, one.t, size=(batch, 2, SLOTS))
                  for _ in range(2)]
            ws = [rng.integers(0, one.t, size=(2, SLOTS)) for _ in range(2)]
        ca, cb = (one.encrypt(one.encode(m), keys) for m in ms)
        sa, sb = sh.place(ca), sh.place(cb)
        terms = list(zip((0, 1), ws))
        op1 = one.make_linear_op(terms, keys, 3)
        op2 = sh.make_linear_op(terms, keys, 3)
        pairs = {
            "multiply+rescale": (one.rescale(one.multiply(ca, cb, keys)),
                                 sh.rescale(sh.multiply(sa, sb, keys))),
            "square": (one.square(ca, keys), sh.square(sa, keys)),
            "rotate 1": (one.rotate(ca, 1, keys), sh.rotate(sa, 1, keys)),
            "apply_linear": (one.apply_linear(ca, op1),
                             sh.apply_linear(sa, op2)),
        }
        if cls is BFVContext:
            pairs["mod_down_to 1"] = (one.mod_down_to(ca, 1),
                                      sh.mod_down_to(sa, 1))
        for name, (want, got) in pairs.items():
            what = f"{cls.__name__} {name}"
            assert (got.level, got.scale) == (want.level, want.scale), what
            assert torch.equal(got.c0, want.c0), what
            assert torch.equal(got.c1, want.c1), what
        with pytest.raises(ValueError, match="LinearOp baked for domain "
                                             "'ntt'; this context dispatches "
                                             "'coeff'"):
            sh.apply_linear(sa, op1)
        with pytest.raises(ValueError, match="LinearOp baked for domain "
                                             "'coeff'; this context "
                                             "dispatches 'ntt'"):
            one.apply_linear(ca, op2)
    bad = CKKSContext(N, 3, device="cpu",
                      mesh=make_mesh(sp=2, devices=["cpu"] * 2))
    with pytest.raises(ValueError, match=r"axis 'dp' not in mesh \('sp',\)"):
        bad.ring(3)


def test_tpu_only_ring_options_are_refused():
    with pytest.raises(TypeError, match="TPU-only"):
        CKKSContext(N, 3, block_rows=8, device="cpu")
    ctx = CKKSContext(N, 2, method="radix2", device="cpu")
    assert ctx.base_ring(2).rings[0].method == "radix2"
    assert ctx.ext_ring(2).qs == list(ctx.qs) + [ctx.p]


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert CKKSContext(N, 3).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CKKSContext(N, 3)


def test_sliced_keys_are_cached_and_pin_their_parent(ctx, keys):
    pair = keys.gk[ctx.galois_element(1)]
    first = ctx._sliced_keys(pair, 2)
    assert ctx._sliced_keys(pair, 2) is first
    assert tuple(first.shape) == (2, 2, 3, N)
    held, _ = ctx._key_slices[(id(pair[0]), id(pair[1]), 2)]
    assert held is pair
    assert torch.equal(first[0][:, 2], pair[0][:2, ctx.L])
