"""Each CUDA kernel against its plain version, on the card.

Marked ``cuda``: the tests skip where ``torch.cuda.is_available()`` is false
(decided in a fixture, never at import).  ``chip_smoke.py`` makes the same
comparisons at the main path's full shapes; these are small and quick.  On
a machine with an H100: ``python -m pytest tests/test_torch_cuda.py -q``.
"""

import numpy as np
import pytest
import torch

from agilex_ntt_tpu_torch import Ring, golden as G
from agilex_ntt_tpu_torch.ops import ntt_kernel as K
from agilex_ntt_tpu_torch.ops import plain_ntt as P

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(gen, bound, shape, device):
    return torch.randint(
        0, bound, shape, generator=gen, dtype=torch.int64, device=device
    )


@pytest.mark.parametrize("n,batch", [(8, 5), (32, 1000), (256, 1001),
                                     (4096, 64), (16384, 8), (32768, 4)])
def test_transforms_match_plain(cuda, n, batch):
    ring = Ring(n, device=cuda)
    gen = torch.Generator(cuda).manual_seed(n)
    x = _rand(gen, 4 * ring.q, (batch, n), cuda)
    y = _rand(gen, 2 * ring.q, (batch, n), cuda)
    before = dict(K.LAUNCHES)
    got_f = K.fwd_ntt(x.to(torch.uint32), ring.tables)
    got_i = K.inv_ntt(y.to(torch.uint32), ring.tables, scale=ring.polymul_scale)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fwd"] == before["fwd"] + 1
    assert K.LAUNCHES["inv"] == before["inv"] + 1
    assert torch.equal(got_f.to(torch.int64), P.fwd_ntt_plain(x, ring.tables))
    want_i = P.inv_ntt_plain(y, ring.tables, ring.polymul_scale)
    assert torch.equal(got_i.to(torch.int64), want_i)
    golden = G.fwd_ntt_u32(x[:2].cpu().numpy().astype(np.uint32), ring.params)
    assert np.array_equal(got_f[:2].cpu().numpy(), golden)


@pytest.mark.parametrize("n,batch,k", [(32, 999, 1), (32, 999, 3),
                                       (4096, 16, 1), (4096, 16, 3),
                                       (16384, 4, 3), (32768, 3, 1),
                                       (32768, 3, 2)])
def test_fused_match_plain(cuda, n, batch, k):
    ring = Ring(n, device=cuda)
    gen = torch.Generator(cuda).manual_seed(n + k)
    a = _rand(gen, ring.q, (batch, k, n), cuda)
    b = _rand(gen, ring.q, (batch, k, n), cuda)
    a32, b32 = a.to(torch.uint32), b.to(torch.uint32)
    if k == 1:
        got = K.polymul_fused(a32[:, 0], b32[:, 0], ring.tables)
        want = P.polymul_plain(a[:, 0], b[:, 0], ring.tables)
    else:
        got = K.polydot_fused(a32, b32, ring.tables)
        want = P.polydot_plain(a, b, ring.tables)
    torch.cuda.synchronize()
    assert torch.equal(got.to(torch.int64), want)


def test_wrappers_refuse_mixed_devices(cuda):
    ring = Ring(64, device=cuda)
    with pytest.raises(ValueError, match="ring tables"):
        K.fwd_ntt(torch.zeros((2, 64), dtype=torch.uint32), ring.tables)
