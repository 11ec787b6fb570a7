"""The port's host layer (config, primes, psi, twiddle tables) against the
JAX package's: every table equal word for word."""

import numpy as np
import pytest
import torch

from agilex_ntt_tpu import config as jcfg
from agilex_ntt_tpu import params as jp
from agilex_ntt_tpu_torch import NTTConfig, REFERENCE_SIZES, config as tcfg
from agilex_ntt_tpu_torch import params as tp

TABLES = ("roots32", "precon32", "inv_roots32", "inv_precon32")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("n", [32, 1024, 4096, 32768])
def test_params_match_jax(n):
    assert tp.find_primes(n, 3) == jp.find_primes(n, 3)
    q = tp.find_primes(n, 1)[0]
    assert tp.find_psi(n, q) == jp.find_psi(n, q)
    mine, ref = tp.make_params(n, q), jp.make_params(n, q)
    assert (mine.n, mine.q, mine.psi, mine.n_inv, mine.log_n) == (
        ref.n, ref.q, ref.psi, ref.n_inv, ref.log_n
    )
    for name in TABLES + ("roots", "precon64", "inv_roots", "inv_precon64"):
        a, b = getattr(mine, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name


@pytest.mark.parametrize("n", [32, 1024, 4096, 8192, 16384, 32768])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6])
def test_prime_chains_match_jax(n, k):
    """The RNS chains of every reference size, up to 6 primes: the presets
    (n4096: 3 primes, n16384 and n32768: 4) and the extended bases of
    their key switches."""
    chain = tp.find_primes(n, k)
    assert chain == jp.find_primes(n, k)
    assert len(set(chain)) == k and all(q % (2 * n) == 1 for q in chain)


@pytest.mark.parametrize("n", [32, 4096])
def test_params_from_numpy_round_trips_a_jax_ring(n):
    ref = jp.make_params(n, jp.find_primes(n, 1)[0])
    got = tp.params_from_numpy(
        ref.n, ref.q, ref.psi, *(getattr(ref, name) for name in TABLES)
    )
    assert (got.n, got.q, got.psi) == (ref.n, ref.q, ref.psi)
    for name in TABLES:
        assert np.array_equal(getattr(got, name), getattr(ref, name))


def test_params_from_numpy_rejects_other_tables():
    n = 64
    q0, q1 = jp.find_primes(n, 2)
    ref = jp.make_params(n, q0)
    tabs = [getattr(ref, name).copy() for name in TABLES]
    tabs[1][5] ^= 1
    with pytest.raises(ValueError, match=r"precon32\[5\]"):
        tp.params_from_numpy(n, q0, ref.psi, *tabs)
    other = jp.make_params(n, q1)
    with pytest.raises(ValueError, match="roots32"):
        tp.params_from_numpy(
            n, q0, ref.psi, *(getattr(other, name) for name in TABLES)
        )
    with pytest.raises(ValueError, match="shape"):
        tp.params_from_numpy(n, q0, ref.psi, ref.roots32[:-1], *tabs[1:])


def test_ring_built_from_jax_tables_uses_its_psi():
    from agilex_ntt_tpu_torch import Ring

    n = 256
    q = jp.find_primes(n, 1)[0]
    # another primitive 2n-th root than the default: psi^3
    psi = pow(jp.find_psi(n, q), 3, q)
    ref = jp.make_params(n, q, psi)
    got = tp.params_from_numpy(n, q, psi, *(getattr(ref, t) for t in TABLES))
    ring = Ring(n, q, psi=got.psi, device="cpu")
    assert ring.params is got
    assert np.array_equal(ring.tables.roots.numpy(), ref.roots32)


def test_config_and_helpers_match_jax():
    assert REFERENCE_SIZES == jcfg.REFERENCE_SIZES
    for x in (1, 2, 8, 4096, 1 << 20):
        assert tcfg.log2_exact(x) == jcfg.log2_exact(x)
    for bad in (0, 3, 12):
        with pytest.raises(ValueError):
            tcfg.log2_exact(bad)
    q = jp.find_primes(1024, 1)[0]
    assert NTTConfig(1024, q).log_n == 10
    for n, qq in ((4, 17), (1024, q + 2), (1024, (1 << 30) + 1), (96, q)):
        with pytest.raises(ValueError):
            jcfg.NTTConfig(n, qq)
        with pytest.raises(ValueError):
            NTTConfig(n, qq)
    for v in (0, 1, 2, 97, 65537, 2**31 - 1, 2**32 + 1, q, q * 3):
        assert tp.is_prime(v) == jp.is_prime(v)
    for x in range(64):
        assert tp.bit_reverse(x, 6) == jp.bit_reverse(x, 6)
