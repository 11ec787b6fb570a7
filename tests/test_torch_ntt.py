"""The port's transforms (plain versions, through the kernel wrappers on CPU
tensors) against the JAX package: its XLA path, its Pallas kernels in
interpret mode, and the known-answer vectors.  Integer arithmetic, so every
comparison is exact (tolerance 0)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from agilex_ntt_tpu import Ring as JRing, golden as JG
from agilex_ntt_tpu.ops import ntt_kernel as JK
from agilex_ntt_tpu_torch import Ring, golden as TG
from agilex_ntt_tpu_torch.ops import ntt_kernel as K
from agilex_ntt_tpu_torch.ops import plain_ntt as P

KAT = Path(__file__).parent / "vectors" / "ntt_kat.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


@pytest.mark.parametrize("n", [8, 32, 256, 1024, 4096])
def test_fwd_inv_match_jax_xla(n):
    rng = np.random.default_rng(n)
    ring, ref = Ring(n, device="cpu"), JRing(n)
    q = ring.q
    # lazy inputs: [0, 4q) forward, [0, 2q) inverse
    x = rng.integers(0, 4 * q, size=(3, n), dtype=np.uint32)
    y = rng.integers(0, 2 * q, size=(3, n), dtype=np.uint32)
    assert np.array_equal(_np(ring.ntt(x)), np.asarray(ref.ntt(x)))
    assert np.array_equal(_np(ring.intt(y)), np.asarray(ref.intt(y)))
    back = ring.intt(ring.ntt(x))
    assert np.array_equal(_np(back), x % np.uint32(q))


@pytest.mark.parametrize("n", [32, 1024])
def test_inv_custom_scale_matches_jax(n):
    rng = np.random.default_rng(7 + n)
    ring, ref = Ring(n, device="cpu"), JRing(n)
    y = rng.integers(0, 2 * ring.q, size=(2, 2, n), dtype=np.uint32)
    for scale in (ring.polymul_scale, 12345, 1):
        got = ring.intt(y, scale=scale)
        assert got.shape == (2, 2, n)
        assert np.array_equal(_np(got), np.asarray(ref.intt(y, scale=scale)))


@pytest.mark.parametrize("n", [128, 1024])
def test_fwd_inv_match_pallas_interpret(n):
    """K1 and K2 of the JAX package, run as its own kernel tests run them."""
    rng = np.random.default_rng(100 + n)
    ring = Ring(n, device="cpu")
    pp, q = ring.params, ring.q
    x = rng.integers(0, 4 * q, size=(8, n), dtype=np.uint32)
    y = rng.integers(0, 2 * q, size=(8, n), dtype=np.uint32)
    want_f = np.asarray(JK.fwd_ntt(x, pp, block_rows=8, interpret=True))
    want_i = np.asarray(JK.inv_ntt(y, pp, block_rows=8, interpret=True))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    assert np.array_equal(_np(K.fwd_ntt(xt, ring.tables)), want_f)
    assert np.array_equal(_np(K.inv_ntt(yt, ring.tables)), want_i)
    want_s = np.asarray(
        JK.inv_ntt(y, pp, scale=ring.polymul_scale, block_rows=8, interpret=True)
    )
    got_s = K.inv_ntt(yt, ring.tables, scale=ring.polymul_scale)
    assert np.array_equal(_np(got_s), want_s)


@pytest.mark.parametrize("n", [32, 1024, 4096, 8192, 16384, 32768])
def test_known_answer_vectors(n):
    kat = np.load(KAT)
    q, psi = int(kat[f"n{n}_q"]), int(kat[f"n{n}_psi"])
    ring = Ring(n, q, psi=psi, device="cpu")
    x = kat[f"n{n}_input"].astype(np.uint32)
    assert np.array_equal(_np(ring.ntt(x)), kat[f"n{n}_ntt"].astype(np.uint32))
    a = kat[f"n{n}_pm_a"].astype(np.uint32)
    b = kat[f"n{n}_pm_b"].astype(np.uint32)
    want = kat[f"n{n}_pm_c"].astype(np.uint32)
    assert np.array_equal(_np(ring.polymul(a, b)), want)


@pytest.mark.parametrize("n", [32, 1024])
def test_golden_copy_matches_jax(n):
    """The port's numpy golden models (the CLI's and chip_smoke.py's
    oracle) equal the JAX package's."""
    rng = np.random.default_rng(200 + n)
    ring = Ring(n, device="cpu")
    pp = ring.params
    x = rng.integers(0, 4 * ring.q, size=(2, n), dtype=np.uint32)
    y = rng.integers(0, 2 * ring.q, size=(2, n), dtype=np.uint32)
    for name, arg in (("fwd_ntt_u64", x), ("inv_ntt_u64", y),
                      ("fwd_ntt_u32", x), ("inv_ntt_u32", y)):
        got, want = getattr(TG, name)(arg, pp), getattr(JG, name)(arg, pp)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    a, b = x[0] % np.uint32(ring.q), x[1] % np.uint32(ring.q)
    assert TG.negacyclic_convolution(a, b, ring.q) == JG.negacyclic_convolution(
        a, b, ring.q
    )


def test_plain_versions_take_int64_and_reduce():
    """The plain versions work on int64 and give canonical [0, q) outputs
    whatever lazy representative comes in."""
    n = 64
    ring = Ring(n, device="cpu")
    q, tabs = ring.q, ring.tables
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, q, size=(4, n)))
    for lazy in (x, x + q, x + 3 * q):
        y = P.fwd_ntt_plain(lazy, tabs)
        assert y.dtype == torch.int64 and int(y.max()) < q
        assert torch.equal(y, P.fwd_ntt_plain(x, tabs))
    assert torch.equal(P.inv_ntt_plain(P.fwd_ntt_plain(x, tabs), tabs), x)


def test_wrappers_reject_what_the_kernels_do_not_take():
    n = 32
    ring = Ring(n, device="cpu")
    tabs = ring.tables
    good = torch.zeros((4, n), dtype=torch.uint32)
    with pytest.raises(TypeError, match="uint32"):
        K.fwd_ntt(good.to(torch.int64), tabs)
    with pytest.raises(ValueError, match="n=32"):
        K.fwd_ntt(torch.zeros((4, 2 * n), dtype=torch.uint32), tabs)
    with pytest.raises(ValueError, match="dims"):
        K.inv_ntt(good.view(2, 2, n), tabs)
    with pytest.raises(ValueError, match="contiguous"):
        K.fwd_ntt(torch.zeros((n, 4), dtype=torch.uint32).t(), tabs)
    with pytest.raises(ValueError, match="empty"):
        K.fwd_ntt(torch.zeros((0, n), dtype=torch.uint32), tabs)
    with pytest.raises(ValueError, match="differ"):
        K.polymul_fused(good, good[:2], tabs)
    with pytest.raises(ValueError, match="k must"):
        K.polydot_fused(
            torch.zeros((4, 0, n), dtype=torch.uint32),
            torch.zeros((4, 0, n), dtype=torch.uint32),
            tabs,
        )
    with pytest.raises(TypeError):
        K.fwd_ntt(np.zeros((4, n), dtype=np.uint32), tabs)


def test_wrappers_on_cpu_count_no_launch():
    ring = Ring(32, device="cpu")
    before = dict(K.LAUNCHES)
    x = torch.zeros((4, 32), dtype=torch.uint32)
    K.fwd_ntt(x, ring.tables)
    K.inv_ntt(x, ring.tables)
    K.polymul_fused(x, x, ring.tables)
    K.polydot_fused(x.view(2, 2, 32), x.view(2, 2, 32), ring.tables)
    assert K.LAUNCHES == before
