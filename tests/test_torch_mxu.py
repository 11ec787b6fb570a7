"""The port's matrix-product four-step transform (``ops/mxu_ntt.py``, kernel
M1's plain version on the CPU) against the JAX package's
``agilex_ntt_tpu/ops/mxu_ntt.py`` on the same arrays, made with numpy from
one seed: the digit split, the constant matrices' digits, the whole forward
transform and the column pass, for a negacyclic and a cyclic plan at
n = 4096 (64 x 64), and the transform against the port's four-step
``Ring``/``CyclicRing``.  Exact comparisons (tolerance 0: integer
arithmetic).  The JAX side runs once a session in a process of its own
(``test_torch_jaxref.computed_once``).  The reconstruction is held against
Python integers at the partials' bound, and the kernel's four-partial
decomposition against the JAX column pass at K = 2048; the kernel's own
epilogue, digit packing and converter are built with g++ in
``test_torch_arith_host.py``."""

import numpy as np
import pytest
import torch

from agilex_ntt_tpu_torch import CyclicRing, Ring, find_primes
from agilex_ntt_tpu_torch.ops import fourstep
from agilex_ntt_tpu_torch.ops import mxu_ntt as M
from test_torch_jaxref import computed_once

N, SEED = 4096, 23
KINDS = ("negacyclic", "cyclic")
# values of the digit split: the edges, then random words below 2^30
EDGES = (0, 1, (1 << 30) - 1, 127, 128, 255, 256, 32767, 32768)


def _digit_values() -> np.ndarray:
    v = np.random.default_rng(SEED).integers(0, 1 << 30, size=4096,
                                             dtype=np.uint32)
    v[: len(EDGES)] = EDGES
    return v


# the widest pass the partials' bound allows: K = n1 = 2048 (n2 = 64, B = 1)
WIDE_N1, WIDE_N = 2048, 2048 * 64


def _wide_input(q: int) -> np.ndarray:
    """(1, 2048, 64) words below q whose digits reach the ends: every low
    digit -128 (0x7F7F80 + e 2^24) or 127 (0x7F7F7F + e 2^24), q - 1, 0,
    then random words."""
    rng = np.random.default_rng(SEED)
    x = rng.integers(0, q, size=(1, WIDE_N1, 64), dtype=np.uint32)
    top = (q - 0x7F7F80) >> 24
    flat = x.reshape(-1)
    flat[: 3 * 4096: 3] = 0x7F7F80 + (rng.integers(0, top, 4096) << 24)
    flat[1: 3 * 4096: 3] = 0x7F7F7F + (rng.integers(0, top, 4096) << 24)
    flat[-2:] = q - 1, 0
    return x


def _inputs(q: int, seed: int):
    """(4, N) words over the lazy [0, 4q) with its edges, and (2, 64, 64)
    words below q for the column pass."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4 * q, size=(4, N), dtype=np.uint64).astype(np.uint32)
    x[0, :4] = [0, q - 1, q, 4 * q - 1]
    xt = rng.integers(0, q, size=(2, 64, 64), dtype=np.uint32)
    return x, xt


def _jax_mxu():
    """Everything the tests compare, from the JAX package: the digits of
    ``_digit_values()``, and for each plan its omega, the matrices' digits,
    the transform of ``_inputs``' x and the column pass of its xt."""
    import jax.numpy as jnp

    from agilex_ntt_tpu import CyclicRing as JCyclicRing
    from agilex_ntt_tpu.ops import fourstep as jfs
    from agilex_ntt_tpu.ops import mxu_ntt

    v = _digit_values()
    out = {"digits": np.stack([np.asarray(d) for d in
                               mxu_ntt._balanced_digits(jnp.asarray(v))]),
           "digits_np": mxu_ntt._balanced_digits_np(v)}
    cring = JCyclicRing(N, backend="xla")
    q = find_primes(N, 1)[0]
    plans = {"negacyclic": (jfs.make_plan(N, q), 0),
             "cyclic": (jfs.make_cyclic_plan(N, cring.q, cring.omega),
                        cring.omega)}
    for kind, (plan, omega) in plans.items():
        x, xt = _inputs(plan.q, SEED + len(kind))
        out[kind] = {
            "q": plan.q, "omega": omega,
            "col_digits": mxu_ntt._col_matrix_digits(plan),
            "row_digits": mxu_ntt._row_matrix_digits(plan),
            "fwd": np.asarray(mxu_ntt.fwd_ntt_fourstep_mxu(jnp.asarray(x), plan)),
            "col": np.asarray(mxu_ntt.fwd_col_pass_mxu(jnp.asarray(xt), plan)),
        }
    q = find_primes(WIDE_N, 1)[0]
    out["wide_col"] = np.asarray(mxu_ntt.fwd_col_pass_mxu(
        jnp.asarray(_wide_input(q)), jfs.make_plan(WIDE_N, q, n1=WIDE_N1)))
    return out


@pytest.fixture(scope="module")
def jax_out(request, tmp_path_factory):
    return computed_once(request, tmp_path_factory, "mxu_jax", _jax_mxu)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _ring(kind: str, jax_kind: dict):
    """The port's four-step ring of the JAX plan's prime (and omega)."""
    if kind == "cyclic":
        return CyclicRing(N, jax_kind["q"], omega=jax_kind["omega"],
                          method="fourstep", device="cpu")
    return Ring(N, jax_kind["q"], method="fourstep", device="cpu")


def test_balanced_digits_match_jax(jax_out):
    v = _digit_values()
    got = M._balanced_digits(torch.from_numpy(v))
    assert all(d.dtype == torch.int8 for d in got)
    digits = np.stack([d.numpy() for d in got])
    assert np.array_equal(digits, jax_out["digits"])
    assert np.array_equal(M._balanced_digits_np(v), jax_out["digits_np"])
    assert np.array_equal(M._balanced_digits_np(v), digits)
    back = sum(digits[k].astype(np.int64) << (8 * k) for k in range(M.DIGITS))
    assert np.array_equal(back, v.astype(np.int64))
    assert digits[:-1].min() >= -128 and digits[-1].max() <= 64
    with pytest.raises(ValueError, match="digit range"):
        M._balanced_digits_np(np.array([1 << 31], dtype=np.uint64))


@pytest.mark.parametrize("kind", KINDS)
def test_matrix_digits_match_jax(jax_out, kind):
    plan = _ring(kind, jax_out[kind]).plan
    for name, fn in (("col_digits", M._col_matrix_digits),
                     ("row_digits", M._row_matrix_digits)):
        got = fn(plan)
        assert got.dtype == np.int8 and got.shape == jax_out[kind][name].shape
        assert np.array_equal(got, jax_out[kind][name]), name
        assert fn(plan) is got  # cached per plan
    mt = M.mxu_tables(plan, torch.device("cpu"))
    assert mt is M.mxu_tables(plan, torch.device("cpu"))
    assert np.array_equal(mt.col.numpy(), jax_out[kind]["col_digits"])
    assert np.array_equal(mt.tw.numpy(), plan.tw)


@pytest.mark.parametrize("kind", KINDS)
def test_fwd_ntt_fourstep_mxu_matches_jax_and_ring(jax_out, kind):
    ring = _ring(kind, jax_out[kind])
    x, _ = _inputs(ring.q, SEED + len(kind))
    got = M.fwd_ntt_fourstep_mxu(torch.from_numpy(x), ring.plan)
    assert got.dtype == torch.uint32 and got.shape == (4, N)
    assert np.array_equal(got.numpy(), jax_out[kind]["fwd"])
    assert torch.equal(got, ring.ntt(x))


@pytest.mark.parametrize("kind", KINDS)
def test_fwd_col_pass_mxu_matches_jax(jax_out, kind):
    ring = _ring(kind, jax_out[kind])
    x, xt = _inputs(ring.q, SEED + len(kind))
    got = M.fwd_col_pass_mxu(torch.from_numpy(xt), ring.plan)
    assert np.array_equal(got.numpy(), jax_out[kind]["col"])
    # the column pass takes the lazy [0, 4q) too: the same words as on the
    # reduced input
    lazy = x.reshape(4, 64, 64)
    assert torch.equal(M.fwd_col_pass_mxu(torch.from_numpy(lazy), ring.plan),
                       M.fwd_col_pass_mxu(torch.from_numpy(lazy % ring.q),
                                          ring.plan))


def test_reconstruction_at_the_partials_bound(jax_out):
    """_reconstruct_mod (the JAX package's Horner and Barrett words) equals
    sum_s P_s 256^s mod q in Python integers, for partials at and inside
    +-4 * 2048 * 2^14 = +-2^27, at a 30-bit and a small prime.  The
    kernel's decomposition, with the data's P powers B^(p) = 2^(32 p / P) X
    mod q: P_s = sum D_(p 4/P + u) B^(p)_j over u + j = s, and
    sum_s P_s 256^s reduced in int64 as its epilogue does, gives the JAX
    column pass's words at K = 2048 on data whose digits reach the ends,
    its partials inside the bound, at P = 2 (the kernel's) and 4."""
    bound = 4 * 2048 * (1 << 14)
    rng = np.random.default_rng(SEED)
    for q in (find_primes(1 << 21, 1)[0], find_primes(N, 1)[0], 12289):
        p = rng.integers(-bound, bound + 1, size=(7, 4096), dtype=np.int64)
        p[:, 0], p[:, 1], p[:, 2] = bound, -bound, 0
        p[::2, 3], p[1::2, 3] = bound, -bound
        got = M._reconstruct_mod(list(torch.from_numpy(p)), q).numpy()
        want = sum(p[s].astype(object) * (256 ** s) for s in range(7)) % q
        assert np.array_equal(got.astype(object), want), q

    q = find_primes(WIDE_N, 1)[0]
    plan = fourstep.make_plan(WIDE_N, q, n1=WIDE_N1)
    x = torch.from_numpy(_wide_input(q)[0].astype(np.int64))  # (K, 64)
    d = [torch.from_numpy(di).to(torch.float64)
         for di in M._col_matrix_digits(plan)]
    for powers in (2, 4):
        span = M.DIGITS // powers
        parts = [torch.zeros((WIDE_N1, 64), dtype=torch.float64)
                 for _ in range(span + M.DIGITS - 1)]
        for pw in range(powers):
            xp = M._balanced_digits(x * pow(256, span * pw, q) % q)
            for u in range(span):
                for j in range(M.DIGITS):  # exact: below 2^53
                    parts[u + j] += d[pw * span + u] @ xp[j].to(torch.float64)
        parts = [p_.to(torch.int64) for p_ in parts]
        assert max(int(p_.abs().max()) for p_ in parts) <= bound
        # the epilogue: sum_s P_s (256^s mod q) + off, Barrett by
        # floor(2^64 / q), in Python integers on the int64 sum (each term
        # below 2^57)
        s = sum(p_ * pow(256, j, q) for j, p_ in enumerate(parts))
        off = ((1 << 61) // q + 1) * q
        mu = ((1 << 64) - 1) // q
        t = [int(v) + off for v in s.reshape(-1)]
        r = [v - ((v * mu) >> 64) * q for v in t]
        got = np.array([v - q if v >= q else v for v in r], dtype=np.uint32)
        assert np.array_equal(got, jax_out["wide_col"].reshape(-1)), powers


def test_refusals():
    ring = Ring(N, method="fourstep", device="cpu")
    x = torch.zeros((2, N), dtype=torch.uint32)
    mt = M.mxu_tables(ring.plan, torch.device("cpu"))
    with pytest.raises(ValueError, match="expected \\(batch, n=4096\\)"):
        M.fwd_ntt_fourstep_mxu(x.view(1, 2, N), ring.plan)
    with pytest.raises(TypeError, match="torch.uint32"):
        M.mxu_pass(x.view(2, 64, 64).to(torch.int64), mt, row=False)
    with pytest.raises(ValueError, match="n1=64, n2=64"):
        M.mxu_pass(x.view(4, 32, 64), mt, row=False)
    with pytest.raises(ValueError, match="contiguous"):
        M.mxu_pass(x.view(2, 64, 64).transpose(1, 2), mt, row=True)
    with pytest.raises(ValueError, match="empty|B >= 1"):
        M.mxu_pass(torch.zeros((0, 64, 64), dtype=torch.uint32), mt, row=True)
    # a side above the partials' bound: 4096 x 2
    plan = fourstep.make_plan(1 << 13, find_primes(1 << 13, 1)[0], n1=4096)
    with pytest.raises(ValueError, match="n1, n2 <= 2048"):
        M.fwd_ntt_fourstep_mxu(torch.zeros((1, 1 << 13), dtype=torch.uint32),
                               plan)
