"""The port's ``Ring(n, device="cpu")`` against the JAX package's ``Ring(n)``
on the same arrays, including the fused Pallas kernels K3 (polymul) and K6a
(polydot) in interpret mode.  Exact comparisons throughout."""

import numpy as np
import pytest
import torch

from agilex_ntt_tpu import Ring as JRing
from agilex_ntt_tpu.ops import ntt_kernel as JK
from agilex_ntt_tpu_torch import Ring
from agilex_ntt_tpu_torch.ops import ntt_kernel as K

N = 256


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rings():
    return Ring(N, device="cpu"), JRing(N)


def _same(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    return got.dtype == torch.uint32 and got.shape == want.shape and bool(
        np.array_equal(got.numpy(), want)
    )


def _coeffs(q, shape, seed, bound=None):
    rng = np.random.default_rng(seed)
    return rng.integers(0, q if bound is None else bound, size=shape, dtype=np.uint32)


def test_polymul_matches_jax_and_fused_kernel(rings):
    ring, ref = rings
    a = _coeffs(ring.q, (8, N), 1)
    b = _coeffs(ring.q, (8, N), 2)
    got = ring.polymul(a, b)
    assert _same(got, ref.polymul(a, b))
    fused = JK.polymul_fused(
        a, b, ref.params, scale=ref.polymul_scale, qinv_neg=ref.qinv_neg,
        block_rows=8, interpret=True,
    )
    assert _same(got, fused)


def test_polymul_broadcasts_leading_dims(rings):
    ring, ref = rings
    a = _coeffs(ring.q, (2, 3, N), 3)
    b = _coeffs(ring.q, (3, N), 4)
    assert _same(ring.polymul(a, b), ref.polymul(a, b))


def test_polydot_matches_jax_and_fused_kernel(rings):
    ring, ref = rings
    a = _coeffs(ring.q, (8, 3, N), 5)
    b = _coeffs(ring.q, (8, 3, N), 6)
    got = ring.polydot(a, b)
    assert _same(got, ref.polydot(a, b))
    fused = JK.polydot_fused(
        a, b, ref.params, scale=ref.polymul_scale, qinv_neg=ref.qinv_neg,
        block_rows=8, interpret=True,
    )
    assert _same(got, fused)
    lead = ring.polydot(a.reshape(2, 4, 3, N), b.reshape(2, 4, 3, N))
    assert _same(lead, np.asarray(fused).reshape(2, 4, N))
    with pytest.raises(ValueError, match="polydot"):
        ring.polydot(a, b[:, :2])


def test_pointwise_ops_match_jax_bit_for_bit(rings):
    ring, ref = rings
    q = ring.q
    # NTT-domain operands may be lazy: pointwise_mul_lazy takes them below 2**31
    a = _coeffs(q, (4, N), 7, bound=2 * q)
    b = _coeffs(q, (4, N), 8, bound=2 * q)
    a[0, :4] = [0, q - 1, 2 * q - 1, (1 << 31) - 1]
    b[0, :4] = [2 * q - 1, (1 << 31) - 1, 1, (1 << 31) - 1]
    assert _same(ring.pointwise_mul_lazy(a, b), ref.pointwise_mul_lazy(a, b))
    ar, br = a % np.uint32(q), b % np.uint32(q)
    assert _same(ring.pointwise_mul(ar, br), ref.pointwise_mul(ar, br))
    with pytest.raises(ValueError, match="2\\*\\*31"):
        ring.pointwise_mul_lazy(np.full((1, N), 1 << 31, dtype=np.uint32), ar[:1])


def test_add_sub_neg_match_jax(rings):
    ring, ref = rings
    a = _coeffs(ring.q, (3, N), 9)
    b = _coeffs(ring.q, (3, N), 10)
    a[0, :3] = [0, 0, ring.q - 1]
    b[0, :3] = [0, ring.q - 1, ring.q - 1]
    assert _same(ring.add(a, b), ref.add(a, b))
    assert _same(ring.sub(a, b), ref.sub(a, b))
    assert _same(ring.neg(a), ref.neg(a))


def test_tensor_and_tensor_square_match_jax(rings):
    ring, ref = rings
    a0, a1, b0, b1 = (_coeffs(ring.q, (2, N), 20 + i) for i in range(4))
    for got, want in zip(ring.tensor(a0, a1, b0, b1), ref.tensor(a0, a1, b0, b1)):
        assert _same(got, want)
    for got, want in zip(ring.tensor_square(a0, a1), ref.tensor_square(a0, a1)):
        assert _same(got, want)


@pytest.mark.parametrize("k", [0, 1, 5, N - 1, N, N + 3, -7, 3 * N + 1])
def test_rotate_matches_jax(rings, k):
    ring, ref = rings
    x = _coeffs(ring.q, (2, N), 30)
    x[0, :2] = 0
    assert _same(ring.rotate(x, k), ref.rotate(x, k))


@pytest.mark.parametrize("k", [3, 5, 2 * N - 1, 2 * N + 3])
def test_automorphism_matches_jax_in_both_domains(rings, k):
    ring, ref = rings
    x = _coeffs(ring.q, (2, N), 40)
    for domain in ("coeff", "ntt"):
        got = ring.automorphism(x, k, domain=domain)
        assert _same(got, ref.automorphism(x, k, domain=domain)), domain
    # the NTT-domain permutation is the coefficient automorphism transformed
    via_ntt = ring.intt(ring.automorphism(ring.ntt(x), k, domain="ntt"))
    assert torch.equal(via_ntt, ring.automorphism(x, k))
    with pytest.raises(ValueError, match="odd"):
        ring.automorphism(x, 2)
    with pytest.raises(ValueError, match="domain"):
        ring.automorphism(x, 3, domain="eval")


def test_check_and_random_coeffs(rings):
    ring, _ = rings
    gen = torch.Generator().manual_seed(0)
    x = ring.random_coeffs(gen, (3, 2))
    assert x.shape == (3, 2, N) and x.dtype == torch.uint32
    assert ring.check(x) is not None
    again = ring.random_coeffs(torch.Generator().manual_seed(0), (3, 2))
    assert torch.equal(again, x)
    lazy = x.to(torch.int64) + ring.q
    with pytest.raises(ValueError, match="outside"):
        ring.check(lazy.to(torch.uint32))
    ring.check(lazy.to(torch.uint32), bound=2 * ring.q)


def test_ring_needs_a_card_unless_asked_for_the_cpu():
    """This machine has no CUDA device: the default ring raises and there
    is no silent CPU path."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        Ring(1024)
    with pytest.raises(RuntimeError, match="CUDA"):
        Ring(1024, device="cuda")
    with pytest.raises(NotImplementedError, match="four-step"):
        Ring(1 << 16, device="cpu")
    with pytest.raises(ValueError):
        Ring(1000, device="cpu")


def test_cpu_ring_counts_no_kernel_launch(rings):
    ring, _ = rings
    before = dict(K.LAUNCHES)
    x = _coeffs(ring.q, (2, N), 50)
    ring.polymul(ring.intt(ring.ntt(x)), x)
    ring.polydot(x.reshape(1, 2, N), x.reshape(1, 2, N))
    assert K.LAUNCHES == before
