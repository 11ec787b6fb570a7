"""Each CUDA kernel against its plain version, on the card.

Marked ``cuda``: the tests skip where ``torch.cuda.is_available()`` is false
(decided in a fixture, never at import).  ``chip_smoke.py`` makes the same
comparisons at the main path's full shapes; these are small and quick.  On
a machine with an H100: ``python -m pytest tests/test_torch_cuda.py -q``.
"""

import numpy as np
import pytest
import torch

from agilex_ntt_tpu_torch import (
    CyclicRing, Ring, RNSRing, WideRing, find_primes, golden as G,
)
from agilex_ntt_tpu_torch.ops import basechange as B
from agilex_ntt_tpu_torch.ops import fourstep as FS
from agilex_ntt_tpu_torch.ops import mxu_ntt as MX
from agilex_ntt_tpu_torch.ops import ntt_kernel as K
from agilex_ntt_tpu_torch.ops import plain_ntt as P
from agilex_ntt_tpu_torch.ops import wide as W
from agilex_ntt_tpu_torch.ops import wide_kernel as WK
from agilex_ntt_tpu_torch.params import find_psi

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


def _transform_tables(device):
    """The tables K1 and K2 take from their callers beyond ``Ring``'s, as
    (what, RingTables, batch, inverse scales): ``CyclicRing``'s at n = 2
    to 1024 (rows of 2 and 4 words), a Ring(1024)'s stage-shard tables over
    4 shards, and the four-step row tables (at 2^20's n2 = 1024) and column
    tables of ``Ring(2^16)`` with their scales."""
    out = []
    for n, batch in ((2, 4097), (4, 1001), (8, 33), (256, 37), (1024, 5)):
        rt = CyclicRing(n, device=device).tables
        out.append((f"cyclic n={n}", rt, batch, (None, rt.polymul_scale)))
    from agilex_ntt_tpu_torch.parallel import stage_shard as SS
    params = Ring(1024, device=device).params
    for d in range(4):
        out.append((f"shard {d}", SS._shard_tables(params, 4, d, device), 7,
                    (1, None)))
    ft = Ring(1 << 16, device=device).fourstep
    row = Ring(1 << 20, device=device).fourstep.row
    out.append(("row n2=1024", row, 65, (None,)))
    out.append(("col n1=256", ft.col, 19,
                (ft.col_scale(), ft.col_scale(ft.polymul_scale))))
    return out


def _wide_matches_cpu(device):
    """WideRing on the card (ntt_wide.cuh) against the CPU's plain version,
    every method, at a 45-bit and a 62-bit prime: several rows a CTA at n =
    8 and 256 (the last CTA part-empty), a row a CTA at 4096, clusters of
    2, 4, 8 and 16 CTAs at 8192 to 65536 (one launch a transform), and
    the passes in device memory at 2^17 and 2^19 (one launch more for every
    three doublings or fewer); inputs over the lazy ranges, numpy and (lo,
    hi) pair I/O."""
    rng = np.random.default_rng(9)
    for n, batch in ((8, 1001), (256, 37), (4096, 3), (8192, 3), (16384, 3),
                     (32768, 2), (65536, 2), (1 << 17, 1), (1 << 19, 1)):
        for bits in (45, 62):
            q = find_primes(n, 1, bits=bits)[0]
            card = WideRing(n, q, device=device)
            cpu = WideRing(n, q, device="cpu")
            x4, a4, b4 = (rng.integers(0, 4 * q, size=(batch, n),
                                       dtype=np.uint64) for _ in range(3))
            y2 = rng.integers(0, 2 * q, size=(batch, n), dtype=np.uint64)
            x4.flat[0], y2.flat[0] = 4 * q - 1, 2 * q - 1
            a, b = a4 % np.uint64(q), b4 % np.uint64(q)
            calls = (("ntt", (x4,), {}), ("intt", (y2,), {}),
                     ("intt", (y2,), {"scale": 3 * q + 7}),
                     ("polymul", (a, b), {}), ("polymul", (a, b[0]), {}),
                     ("pointwise_mul", (a4, b4), {}), ("add", (a4, b4), {}),
                     ("sub", (a4, b4), {}))
            for name, args, kw in calls:
                before = dict(K.LAUNCHES)
                got = getattr(card, name)(*args, **kw)
                want = getattr(cpu, name)(*args, **kw)
                assert got.dtype == np.uint64 and np.array_equal(got, want), (
                    n, bits, name, kw)
                ran = {k: v - before[k] for k, v in K.LAUNCHES.items()
                       if v != before[k]}
                if name in ("ntt", "intt"):
                    key = "wide_fwd" if name == "ntt" else "wide_inv"
                    passes = -(-max(0, n.bit_length() - 17) // 3)
                    assert ran == {key: 1 + passes}, ran
            pair = tuple(torch.from_numpy(t).to(device)
                         for t in W.split_u64_np(x4))
            lo, hi = card.ntt(pair)
            assert lo.device.type == "cuda" and lo.dtype == torch.uint32
            assert np.array_equal(
                W.join_u64_np(lo.cpu().numpy(), hi.cpu().numpy()),
                cpu.ntt(x4))
            # limbs one word off a 16-byte boundary (the kernels' vector
            # loads): the wrapper copies them first
            off = tuple(torch.cat([t.new_zeros(1), t.reshape(-1)])[1:]
                        .view(batch, n) for t in pair)
            assert off[0].data_ptr() % 16 != 0
            lo, hi = card.ntt(off)
            assert np.array_equal(
                W.join_u64_np(lo.cpu().numpy(), hi.cpu().numpy()),
                cpu.ntt(x4))
            info = WK.wide_launch_info(card.tables, "wide_inv", batch)
            logc = max(0, min(n.bit_length() - 1, 16) - 12)
            assert (info["ctas"], info["threads"], info["passes"]) == (
                1 << logc, 256, -(-max(0, n.bit_length() - 17) // 3)), info
            if n == 256:
                assert np.array_equal(card.ntt(x4[:4]),
                                      G.fwd_ntt_u64(x4[:4], card.params))
                assert np.array_equal(card.intt(y2[:4]),
                                      G.inv_ntt_u64(y2[:4], card.params))


@pytest.mark.parametrize("n,batch", [(8, 5), (32, 1000), (256, 1001),
                                     (4096, 64), (16384, 8), (32768, 4)])
def test_transforms_match_plain(cuda, n, batch):
    """K1 and K2 against their plain versions on the multi-prime transform
    kernels at one channel (``launch_info``: a CTA holds 4096 words), one
    launch a call; inputs over [0, 4q) and [0, 2q) with their tops and 0.
    The first case also runs the other callers' tables
    (``_transform_tables``), and the wide ring's kernels against the CPU's
    (``_wide_matches_cpu``)."""
    ring = Ring(n, device=cuda)
    cases = [(f"ring n={n}", ring.tables, batch, (ring.polymul_scale,))]
    if (n, batch) == (8, 5):
        cases += _transform_tables(cuda)
        _wide_matches_cpu(cuda)
    for what, tabs, batch, scales in cases:
        n, q = tabs.n, tabs.q
        gen = torch.Generator(cuda).manual_seed(n + batch)
        x = _rand(gen, 4 * q, (batch, n), cuda)
        y = _rand(gen, 2 * q, (batch, n), cuda)
        x.view(-1)[: x.numel() // 4], x.view(-1)[-2:] = 4 * q - 1, 0
        y.view(-1)[: y.numel() // 4], y.view(-1)[-2:] = 2 * q - 1, 0
        for which in ("fwd", "inv"):
            info = K.launch_info(tabs, which, batch)
            assert (info["ctas"], info["polys"], info["threads"]) == (
                max(1, n // 4096), max(1, 4096 // n), 256), (what, info)
        before = dict(K.LAUNCHES)
        got_f = K.fwd_ntt(x.to(torch.uint32), tabs)
        got_i = [K.inv_ntt(y.to(torch.uint32), tabs, scale=s) for s in scales]
        torch.cuda.synchronize()
        assert K.LAUNCHES["fwd"] == before["fwd"] + 1
        assert K.LAUNCHES["inv"] == before["inv"] + len(scales)
        assert torch.equal(got_f.to(torch.int64), P.fwd_ntt_plain(x, tabs)), what
        for s, got in zip(scales, got_i):
            want_i = P.inv_ntt_plain(y, tabs, s)
            assert torch.equal(got.to(torch.int64), want_i), (what, s)
        if tabs is ring.tables:
            golden = G.fwd_ntt_u32(x[:2].cpu().numpy().astype(np.uint32),
                                   ring.params)
            assert np.array_equal(got_f[:2].cpu().numpy(), golden)


# K3's and K6a's cases that the parametrized ones below do not reach, run
# inside the first case: (n, batch, k, cyclic): CyclicRing's rows of 2 and
# 4 words, a cluster of 2 CTAs (n = 8192), k = 8 terms through the cp.async
# pipeline, and the cyclic tables on a cluster of 8 CTAs
FUSED_MORE = ((2, 4097, 1, True), (4, 1001, 3, True), (8192, 5, 1, False),
              (8192, 3, 8, False), (4096, 33, 8, False), (32768, 2, 1, True))


@pytest.mark.parametrize("n,batch,k", [(32, 999, 1), (32, 999, 3),
                                       (4096, 16, 1), (4096, 16, 3),
                                       (16384, 4, 3), (32768, 3, 1),
                                       (32768, 3, 2)])
def test_fused_match_plain(cuda, n, batch, k):
    """K3 (k = 1) and K6a against their plain versions on the polydot
    kernel at one channel: a over the lazy [0, 4q) with 4q - 1 and 0 in its
    first polynomial, b over [0, q) with q - 1 and 0; the launch info's
    shape (a CTA holds 4096 words), one launch a call."""
    cases = ((n, batch, k, False),)
    if (n, batch, k) == (32, 999, 1):
        cases += FUSED_MORE
    for n, batch, k, cyclic in cases:
        ring = (CyclicRing if cyclic else Ring)(n, device=cuda)
        gen = torch.Generator(cuda).manual_seed(n + k)
        a = _rand(gen, 4 * ring.q, (batch, k, n), cuda)
        b = _rand(gen, ring.q, (batch, k, n), cuda)
        a[0, :, : n // 2], a[0, :, n // 2:] = 4 * ring.q - 1, 0
        b[0, :, : n // 2], b[0, :, n // 2:] = ring.q - 1, 0
        a32, b32 = a.to(torch.uint32), b.to(torch.uint32)
        before = dict(K.LAUNCHES)
        if k == 1:
            got = K.polymul_fused(a32[:, 0], b32[:, 0], ring.tables)
            want = P.polymul_plain(a[:, 0], b[:, 0], ring.tables)
        else:
            got = K.polydot_fused(a32, b32, ring.tables)
            want = P.polydot_plain(a, b, ring.tables)
        torch.cuda.synchronize()
        key = "polymul" if k == 1 else "polydot"
        assert K.LAUNCHES[key] == before[key] + 1
        assert torch.equal(got.to(torch.int64), want), (n, batch, k, cyclic)
        info = K.polydot_launch_info(ring.tables, k)
        assert (info["ctas"], info["polys"], info["threads"]) == (
            max(1, n // 4096), max(1, 4096 // n), 256), (n, info)


def test_wrappers_refuse_mixed_devices(cuda):
    ring = Ring(64, device=cuda)
    with pytest.raises(ValueError, match="ring tables"):
        K.fwd_ntt(torch.zeros((2, 64), dtype=torch.uint32), ring.tables)
    wide = WideRing(64, device=cuda)
    cpu_pair = tuple(torch.zeros((2, 64), dtype=torch.uint32)
                     for _ in range(2))
    for call in (lambda: WK.wide_fwd(cpu_pair, wide.tables),
                 lambda: WK.wide_inv(cpu_pair, wide.tables, 1),
                 lambda: WK.wide_pointwise(cpu_pair, cpu_pair, wide.tables,
                                           "add")):
        with pytest.raises(ValueError, match="ring tables"):
            call()


def _channels(gen, qs, mult, shape, device):
    """(L, *shape) int64, channel l uniform in [0, mult * q_l)."""
    return torch.stack([_rand(gen, mult * q, shape, device) for q in qs])


# K4a/K4b's launch shapes that the parametrized cases below do not reach,
# run inside the first case: (n, L, batch, scales): a cluster of 2 CTAs
# (n = 8192) and of 8 (32768) with a ragged batch, 16 and 512 polynomials a
# CTA (n = 256 and 8, ragged last CTAs), and more units than the card
# holds clusters at once; "random": K4b with a random scale a channel
RNS_TRANSFORMS_MORE = ((8192, 2, 3, "random"), (32768, 3, 5, None),
                       (256, 3, 37, "random"), (8, 2, 1001, None),
                       (4096, 3, 3001, "random"), (16384, 5, 301, None))


@pytest.mark.parametrize("n,L,batch", [(8, 2, 5), (32, 3, 1000), (256, 3, 333),
                                       (4096, 3, 16), (16384, 4, 3),
                                       (32768, 4, 2)])
def test_rns_transforms_match_plain(cuda, n, L, batch):
    """K4a and K4b against their plain versions (and K4a's first rows
    against the golden model) at every launch shape of their kernels: a CTA
    holds 4096 words, so n = 8192 to 32768 take clusters of 2 to 8 CTAs,
    smaller n several polynomials a CTA; inputs over [0, 4q) and [0, 2q),
    K4b with the polymul scale or random ones; the launch info's shape, one
    unit a cluster."""
    cases = ((n, L, batch, "polymul"),)
    if (n, L, batch) == (8, 2, 5):
        cases += RNS_TRANSFORMS_MORE
    for n, L, batch, scale in cases:
        ring = RNSRing(n, L, device=cuda)
        tabs = ring.tables
        units = -(-batch * n // 4096) if n < 4096 else batch
        for which in ("fwd_rns", "inv_rns"):
            info = K.rns_launch_info(tabs, which, batch)
            assert (info["ctas"], info["polys"], info["threads"]) == (
                max(1, n // 4096), max(1, 4096 // n), 256), (n, which)
            # one unit a cluster, one slab of 512 rows of 8 words at pitch 9
            assert info["smem_bytes"] == 4 * 512 * 9, info
            assert info["registers"] <= 40 and info["ctas_per_sm"] >= 1, info
            assert info["clusters"] == units, info
        gen = torch.Generator(cuda).manual_seed(n + L + batch)
        x = _channels(gen, ring.qs, 4, (batch, n), cuda)
        y = _channels(gen, ring.qs, 2, (batch, n), cuda)
        for l, q in enumerate(ring.qs):  # the top of each lazy range
            x[l].view(-1)[: x[l].numel() // 4] = 4 * q - 1
            y[l].view(-1)[: y[l].numel() // 4] = 2 * q - 1
        if scale == "random":
            scales = [int(s) for s in np.random.default_rng(n).integers(
                1, min(ring.qs), size=L)]
        else:
            scales = tabs.polymul_scale if scale == "polymul" else None
        before = dict(K.LAUNCHES)
        got_f = K.fwd_ntt_rns(x.to(torch.uint32), tabs)
        got_i = K.inv_ntt_rns(y.to(torch.uint32), tabs, scales=scales)
        torch.cuda.synchronize()
        assert K.LAUNCHES["fwd_rns"] == before["fwd_rns"] + 1
        assert K.LAUNCHES["inv_rns"] == before["inv_rns"] + 1
        assert torch.equal(got_f.to(torch.int64), P.fwd_ntt_rns_plain(x, tabs)), (
            n, L, batch)
        want_i = P.inv_ntt_rns_plain(y, tabs, scales)
        assert torch.equal(got_i.to(torch.int64), want_i), (n, L, batch, scale)
        for l, r in enumerate(ring.rings):  # channel l used its own prime
            golden = G.fwd_ntt_u32(x[l, :2].cpu().numpy().astype(np.uint32),
                                   r.params)
            assert np.array_equal(got_f[l, :2].cpu().numpy(), golden)


# K5/K6b's launch shapes that the parametrized cases below do not reach,
# run inside the first case: a cluster of 2 CTAs (n = 8192), 16 and 512
# polynomials a CTA (n = 256 and 8, ragged last CTAs)
RNS_FUSED_MORE = ((8192, 2, 3, 3), (8192, 3, 5, 1), (256, 3, 37, 2),
                  (8, 2, 1001, 3))


@pytest.mark.parametrize("n,L,batch,k", [(32, 3, 999, 1), (32, 3, 999, 3),
                                         (4096, 3, 16, 1), (4096, 5, 8, 4),
                                         (16384, 5, 2, 4), (32768, 4, 3, 1),
                                         (32768, 3, 2, 2)])
def test_rns_fused_match_plain(cuda, n, L, batch, k):
    """K5 (k = 1) and K6b against their plain versions at every launch
    shape of the kernel: a CTA holds 4096 words of each operand, so n =
    8192, 16384 and 32768 take clusters of 2, 4 and 8 CTAs, n = 4096 one
    CTA, smaller n several polynomials a CTA; operands at q - 1 on half of
    the words and 0 on a quarter."""
    cases = ((n, L, batch, k),)
    if (n, L, batch, k) == (32, 3, 999, 1):
        cases += RNS_FUSED_MORE
    for n, L, batch, k in cases:
        ring = RNSRing(n, L, device=cuda)
        tabs = ring.tables
        info = K.polydot_rns_launch_info(tabs, k)
        assert (info["ctas"], info["polys"], info["threads"]) == (
            max(1, n // 4096), max(1, 4096 // n), 256), n
        gen = torch.Generator(cuda).manual_seed(n + L + k)
        a = _channels(gen, ring.qs, 1, (batch, k, n), cuda)
        b = _channels(gen, ring.qs, 1, (batch, k, n), cuda)
        for l, q in enumerate(ring.qs):
            a[l].view(-1)[: a[l].numel() // 2] = q - 1
            b[l].view(-1)[b[l].numel() // 2: 3 * b[l].numel() // 4] = 0
        a32, b32 = a.to(torch.uint32), b.to(torch.uint32)
        key = "polymul_rns" if k == 1 else "polydot_rns"
        before = K.LAUNCHES[key]
        if k == 1:
            got = K.polymul_rns_fused(a32[:, :, 0].contiguous(),
                                      b32[:, :, 0].contiguous(), tabs)
            want = P.polymul_rns_plain(a[:, :, 0], b[:, :, 0], tabs)
        else:
            got = K.polydot_rns_fused(a32, b32, tabs)
            want = P.polydot_rns_plain(a, b, tabs)
        torch.cuda.synchronize()
        assert K.LAUNCHES[key] == before + 1
        assert torch.equal(got.to(torch.int64), want), (n, L, batch, k)


def test_rns_keyswitch_on_the_card_matches_the_cpu(cuda):
    n = 1024
    primes = find_primes(n, 5)
    qs, ext = primes[:3], primes[:5]
    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(0, q, size=(4, n), dtype=np.uint32) for q in qs])
    ksk = np.stack([rng.integers(0, q, size=(3, n), dtype=np.uint32) for q in ext],
                   axis=1)
    outs = []
    for dev in ("cpu", cuda):
        ring = RNSRing(n, qs=qs, device=dev)
        kn = ring.ksk_to_ntt(ksk, ext)
        outs.append([ring.keyswitch(x, ksk, ext, 3).cpu(),
                     ring.keyswitch(x, kn, ext, 3, ksk_domain="ntt").cpu(),
                     ring.hoisted_keyswitch(x, ksk[None], (5,), ext, 3).cpu()])
    for got, want in zip(outs[1], outs[0]):
        assert torch.equal(got, want)


def test_fourstep_kernels_match_plain(cuda):
    """K7a, K7b, K8, K9a and K9b against their plain versions, bit for bit,
    at 16 x 16 and the unbalanced 128 x 32 (clusters of one CTA), 256 x 256
    with a ragged batch of 7 (K7a and K7b on 4 CTAs, K8 on 8), 512 x 256
    (8, 16), 512 x 512 (16, 16 of one CTA an SM), 1024 x 512 (K7a and K7b
    on 16 CTAs of one an SM, K8 on the walking kernel), 1024 x 1024 and
    2048 x 1024 (all three walking; the column tile of 16 columns), a
    cyclic plan at 256 x 256, and the unbalanced 8192 x 128 and 16384 x 128
    (K9a's slabs of one CTA of 512 an SM) and 32768 x 2 (K9a's walking
    kernel; K9b's walking kernel likewise).  The cluster each wrapper picks
    and K9a's and K9b's slab width and threads are checked; K8's first
    operands hold the edge words q - 1 and 0, K9b's input reaches 2^32 - 1
    and 4q - 1.  Where 64 <= n1, n2 <= 2048, M1 (``ops/mxu_ntt.py``): both
    passes against their plain versions and its transform against K7a's
    words."""
    # (n, n1, batch, cyclic, log2 of K7a's and K7b's cluster, of K8's, K9a's
    # slab width and threads; -1 and 0: walking)
    for n, n1, batch, cyclic, c7, c8, w9, t9 in (
            (256, None, 5, False, 0, 0, 16, 256),
            (4096, 128, 3, False, 0, 0, 32, 256),
            (1 << 16, None, 7, False, 2, 3, 64, 256),
            (1 << 17, 512, 2, False, 3, 4, 32, 256),
            (1 << 18, None, 1, False, 4, 4, 32, 256),
            (1 << 19, None, 1, False, 4, -1, 16, 256),
            (1 << 20, None, 1, False, -1, -1, 16, 256),
            (1 << 21, None, 1, False, -1, -1, 8, 256),
            (1 << 16, None, 2, True, 2, 3, 64, 256),
            (1 << 20, 1 << 13, 1, False, -1, -1, 4, 512),
            (1 << 21, 1 << 14, 1, False, -1, -1, 2, 512),
            (1 << 16, 1 << 15, 1, False, -1, -1, 0, 0)):
        q = find_primes(n, 1)[0]
        if cyclic:
            omega = pow(find_psi(n, q), 2, q)  # of order n
            plan = FS.make_cyclic_plan(n, q, omega, n1)
        else:
            plan = FS.make_plan(n, q, None, n1)
        ft = P.make_fourstep_tables(plan, cuda)
        assert (K.fourstep_cluster(ft, 1), K.fourstep_cluster(ft, 2)) == (c7, c8)
        for key in ("col_fwd", "col_inv"):
            info = K.fourstep_launch_info(ft, key)
            assert (info["width"], info["threads"]) == (w9, t9), (key, n)
        for key in ("fwd4", "inv4"):
            assert K.fourstep_launch_info(ft, key)["ctas"] == (
                1 << c7 if c7 >= 0 else 0)
        gen = torch.Generator(cuda).manual_seed(n + batch)
        shape = (batch, ft.n1, ft.n2)
        x, y = _rand(gen, 4 * q, shape, cuda), _rand(gen, 2 * q, shape, cuda)
        a, b = _rand(gen, q, shape, cuda), _rand(gen, q, shape, cuda)
        a[0].view(-1)[: n // 2] = q - 1
        b[0].view(-1)[: n // 4] = q - 1
        b[0].view(-1)[n // 2:] = 0
        z = _rand(gen, 1 << 32, shape, cuda)  # K9b takes any words
        z[0].view(-1)[:2] = torch.tensor([2**32 - 1, 4 * q - 1])
        x32, y32 = x.to(torch.uint32), y.to(torch.uint32)
        before = dict(K.LAUNCHES)
        got = {
            "fwd4": K.fwd_ntt_fourstep(x32, ft),
            "inv4": K.inv_ntt_fourstep(y32, ft, scale=ft.polymul_scale),
            "polymul4": K.polymul_fourstep_fused(
                a.to(torch.uint32), b.to(torch.uint32), ft),
            "col_fwd": K.fwd_col_fourstep(x32, ft),
            "col_inv": K.inv_col_fourstep(y32, ft),
        }
        torch.cuda.synchronize()
        want = {
            "fwd4": P.fwd_ntt_fourstep_plain(x, ft),
            "inv4": P.inv_ntt_fourstep_plain(y, ft, ft.polymul_scale),
            "polymul4": P.polymul_fourstep_plain(a, b, ft),
            "col_fwd": P.fwd_col_fourstep_plain(x, ft),
            "col_inv": P.inv_col_fourstep_plain(y, ft),
        }
        for key, out in got.items():
            assert K.LAUNCHES[key] == before[key] + 1
            assert torch.equal(out.to(torch.int64), want[key]), (key, n, cyclic)
        got = K.inv_col_fourstep(z.to(torch.uint32), ft, scale=ft.polymul_scale)
        want = P.inv_col_fourstep_plain(z, ft, ft.polymul_scale)
        assert torch.equal(got.to(torch.int64), want), ("col_inv any word", n)
        if 64 <= min(ft.n1, ft.n2) and max(ft.n1, ft.n2) <= 2048:
            mt = MX.mxu_tables(plan, cuda)
            for row, v in ((False, x), (True, a)):
                before = K.LAUNCHES["mxu"]
                got = MX.mxu_pass(v.to(torch.uint32), mt, row)
                plain = MX.row_pass_plain if row else MX.col_pass_plain
                assert K.LAUNCHES["mxu"] == before + 1
                assert torch.equal(got.to(torch.int64), plain(v, mt)), (
                    "mxu", row, n, cyclic)
            full = MX.fwd_ntt_fourstep_mxu(x32.view(batch, n), plan)
            assert torch.equal(full.view(shape),
                               K.fwd_ntt_fourstep(x32, ft)), ("mxu", n)


def test_fourstep_rings_on_the_card_match_the_cpu(cuda):
    """Ring(65536) and its tiled, flat and two-kernel routes, CyclicRing and
    RNSRing on the card equal the CPU rings; the four-step transform at
    n = 32768 equals the radix-2 kernels' output."""
    rng = np.random.default_rng(7)
    n = 1 << 16
    rings = [(Ring(n, device=d), Ring(n, fourstep_kernel="flat", device=d),
              CyclicRing(n, device=d), RNSRing(n, 2, device=d))
             for d in ("cpu", cuda)]
    q = rings[0][0].q
    x = rng.integers(0, q, size=(3, n), dtype=np.uint32)
    b = rng.integers(0, q, size=(3, n), dtype=np.uint32)
    xs = np.stack([x % p for p in rings[0][3].qs])
    outs = []
    for ring, flat, cyc, rns in rings:
        outs.append([ring.ntt(x), ring.intt(x), ring.polymul(x, b),
                     ring.polydot(x[None], b[None]), flat.ntt(x),
                     ring.from_tiled(ring.polymul_tiled(ring.to_tiled(x),
                                                        ring.to_tiled(b))),
                     cyc.ntt(x), cyc.polymul(x, b), rns.ntt(xs),
                     rns.intt(xs), rns.polymul(xs, xs)])
    for got, want in zip(outs[1], outs[0]):
        assert torch.equal(got.cpu(), want)
    assert np.array_equal(outs[1][0][:1].cpu().numpy(),
                          G.fwd_ntt_u32(x[:1], rings[0][0].params))
    r2, r4 = Ring(32768, device=cuda), Ring(32768, method="fourstep", device=cuda)
    z = rng.integers(0, 4 * r2.q, size=(8, 32768), dtype=np.uint32)
    assert torch.equal(r4.ntt(z), r2.ntt(z))
    assert torch.equal(r4.intt(z % (2 * r2.q)), r2.intt(z % (2 * r2.q)))
    big = Ring(1 << 21, device=cuda)  # the two-kernel route on the card
    w = rng.integers(0, big.q, size=(1, 1 << 21), dtype=np.uint32)
    assert torch.equal(big.intt(big.ntt(w)).cpu(), torch.from_numpy(w))


def test_exchange_and_dit_kernels_match_plain(cuda):
    """K11 (forward, inverse, each role, with and without ``last``; one
    shard's half, and group launches of 2, 4 and 8 entries, each writing
    both halves of its pair or one, one launch each) and K12 (ragged
    batches at n = 32 and 4096) against their plain versions;
    ``inv_ntt_dit`` against K2; the sharded ring on ``["cuda:0"] * 4``
    against ``Ring`` on the card (both ``sp_comm`` forms, dp x sp,
    four-step sp; on one card one K11 launch a cross stage and sp group),
    and, where the machine has two or more cards, over
    distinct cards (K11 reading its partner through P2P for ``overlap``)."""
    from agilex_ntt_tpu_torch.ops import dit_inv as D
    from agilex_ntt_tpu_torch.parallel import ShardedRing, make_mesh

    gen = torch.Generator(cuda).manual_seed(11)
    q = find_primes(1024, 1)[0]
    for fwd in (True, False):
        for last in (False, True):
            for is_u in (True, False):
                x = _rand(gen, (4 if fwd else 2) * q, (24, 1024), cuda)
                p = _rand(gen, (4 if fwd else 2) * q, (24, 1024), cuda)
                w = _rand(gen, q, (1024,), cuda)
                wp = (w << 32) // q
                before = dict(K.LAUNCHES)
                got = K.xchg_step(*(t.to(torch.uint32) for t in (x, p, w, wp)),
                                  q=q, fwd=fwd, is_u=is_u, last=last, scale=777)
                torch.cuda.synchronize()
                key = "xchg_fwd" if fwd else "xchg_inv"
                assert K.LAUNCHES[key] == before[key] + 1
                if fwd:
                    want = P.fwd_stage_step_plain(x, p, is_u, w, wp, q, last)
                else:
                    want = P.inv_stage_step_plain(
                        x, p, is_u, w, wp, q,
                        (777, (777 << 32) // q) if last else None)
                assert torch.equal(got.to(torch.int64), want), (fwd, last, is_u)
        for P_ in (2, 4, 8):
            # entry d writes both halves of its pair, the u-half or the
            # v-half, in turn
            bound = (4 if fwd else 2) * q
            us = [_rand(gen, bound, (24, 1024), cuda) for _ in range(P_)]
            vs = [_rand(gen, bound, (24, 1024), cuda) for _ in range(P_)]
            ws = [_rand(gen, q, (1024,), cuda) for _ in range(P_)]
            halves = [("uv", "u", "v")[d % 3] for d in range(P_)]
            for last in (False, True):
                outs = [[torch.empty((24, 1024), dtype=torch.uint32,
                                     device=cuda) if h in halves[d] else None
                         for h in "uv"] for d in range(P_)]
                entries = [(us[d].to(torch.uint32), vs[d].to(torch.uint32),
                            ws[d].to(torch.uint32),
                            ((ws[d] << 32) // q).to(torch.uint32), *outs[d])
                           for d in range(P_)]
                before = dict(K.LAUNCHES)
                K.xchg_group(entries, q=q, fwd=fwd, last=last, scale=777)
                torch.cuda.synchronize()
                key = "xchg_fwd" if fwd else "xchg_inv"
                assert K.LAUNCHES[key] == before[key] + 1
                for d in range(P_):
                    for is_u, got in zip((True, False), outs[d]):
                        if got is None:
                            continue
                        mine, other = (us[d], vs[d]) if is_u else (vs[d], us[d])
                        args = (mine, other, is_u, ws[d], (ws[d] << 32) // q, q)
                        want = (P.fwd_stage_step_plain(*args, last) if fwd else
                                P.inv_stage_step_plain(
                                    *args, (777, (777 << 32) // q) if last
                                    else None))
                        assert torch.equal(got.to(torch.int64), want), (
                            P_, d, is_u, last)
    for n, batch in ((32, 999), (256, 5), (4096, 17), (32768, 2)):
        ring = Ring(n, device=cuda)
        dt = D._dit_tables(ring.params, cuda)
        y = _rand(gen, 2 * ring.q, (batch, n), cuda)
        before = K.LAUNCHES["dit_inv"]
        got = K.dit_inv_core(y.to(torch.uint32), dt)
        assert K.LAUNCHES["dit_inv"] == before + 1
        assert torch.equal(got.to(torch.int64), P.dit_inv_core_plain(y, dt))
        y32 = y.to(torch.uint32)
        for fac in (False, True) if n.bit_length() % 2 else (False,):
            assert torch.equal(D.inv_ntt_dit(y32, ring.params, factored=fac),
                               ring.intt(y32))
    meshes = [["cuda:0"] * 4]
    if torch.cuda.device_count() >= 2:
        meshes.append([f"cuda:{i % torch.cuda.device_count()}" for i in range(4)])
    ring, big = Ring(4096, device=cuda), Ring(1 << 16, device=cuda)
    x = ring.random_coeffs(gen, (32,))
    b = ring.random_coeffs(gen, (32,))
    xb = big.random_coeffs(gen, (8,))
    for devices in meshes:
        for comm in ("ppermute", "overlap"):
            for axes, kw in ((dict(sp=4), dict(dp_axis=None, sp_axis="sp")),
                             (dict(dp=2, sp=2), dict(sp_axis="sp"))):
                sr = ShardedRing(ring, make_mesh(devices=devices, **axes),
                                 sp_comm=comm, **kw)
                before = K.LAUNCHES["xchg_fwd"]
                assert torch.equal(sr.ntt(x), ring.ntt(x)), (devices, comm)
                if len(set(devices)) == 1:  # a launch a stage and group
                    groups = axes.get("dp", 1)
                    stages = axes["sp"].bit_length() - 1
                    assert K.LAUNCHES["xchg_fwd"] == before + groups * stages
                assert torch.equal(sr.intt(x), ring.intt(x)), (devices, comm)
                assert torch.equal(sr.polymul(x, b), ring.polymul(x, b))
        sr = ShardedRing(big, make_mesh(sp=4, devices=devices), dp_axis=None,
                         sp_axis="sp")
        assert torch.equal(sr.ntt(xb), big.ntt(xb)), devices
        assert torch.equal(sr.intt(xb), big.intt(xb)), devices


def test_sharded_ring_across_processes_on_card(cuda):
    """Two processes on ``cuda:0`` over gloo (``utils/multihost_probe``):
    each starts the group and builds ``pod_mesh``; ``ShardedRing(Ring(4096))``
    over sp=2 with both ``sp_comm``, ntt and intt, each process's global
    result equal word for word to the unsharded ring on its card and, on
    the first rows, to the plain version, with its K1, K2 and K11 launches;
    every transfer staged through pinned host memory."""
    from agilex_ntt_tpu_torch.ops import _build
    from agilex_ntt_tpu_torch.utils import multihost_probe as MP

    _build.build()  # here, so that the processes only load it
    plan = tuple((f"Ring(4096) sp=2 {comm}", 4096, False, (1, 2), kw, 64,
                  ("ntt", "intt"))
                 for comm, kw in (("ppermute", MP.STAGE),
                                  ("overlap", MP.OVERLAP)))
    results = MP.run_world(2, "gloo", MP.check_calls, plan, one_card=True,
                           timeout=300)
    assert [r["rank"] for r in results] == [0, 1]
    assert all(r["staged"] and r["device"] == "cuda:0" for r in results)
    assert all(len(r["calls"]) == 4 for r in results)


def test_sharded_rns_on_card(cuda):
    """``ShardedRNSRing`` in every layout on ``["cuda:0"] * 8`` (and over
    four cards where the machine has them): dp on K4a/K4b/K5/K6b a rows
    block (a remainder batch), ch x dp a channel block each, ch x sp x dp
    (``chsp.py``: K4a/K4b on the four-step column and cyclic row tables),
    dp x sp stage with both ``sp_comm`` (K11) and four-step; then the key
    switch, the mixing ops and the gadget split at dp=2.  Each output
    equals the unsharded ring's on the card and the plain versions' (the
    same ring on the CPU)."""
    from agilex_ntt_tpu_torch.parallel import ShardedRNSRing, make_mesh

    rng = np.random.default_rng(61)
    meshes = [["cuda:0"] * 8]
    if torch.cuda.device_count() >= 4:
        meshes.append([f"cuda:{i % 4}" for i in range(8)])
    rns_ops = ("fwd_rns", "inv_rns", "polymul_rns", "polydot_rns")
    layouts = (  # (n, L, ring arguments, mesh axes, ShardedRNSRing
                 # arguments, batch, the kernels that must launch)
        (256, 3, {}, dict(dp=8), {}, 13, rns_ops),
        (256, 4, {}, dict(ch=4, dp=2), dict(ch_axis="ch"), 5, rns_ops),
        (4096, 4, {}, dict(ch=2, dp=4), dict(ch_axis="ch"), 5, rns_ops),
        (16384, 2, dict(method="fourstep"), dict(ch=2, sp=2, dp=2),
         dict(sp_axis="sp", ch_axis="ch"), 3, ("fwd_rns", "inv_rns")),
        (1024, 2, {}, dict(dp=2, sp=4), dict(sp_axis="sp"), 5,
         ("xchg_fwd", "xchg_inv", "fwd", "inv")),
        (1024, 2, {}, dict(dp=2, sp=4), dict(sp_axis="sp", sp_comm="overlap"),
         5, ("xchg_fwd", "xchg_inv")),
        (2048, 2, {}, dict(dp=2, sp=4), dict(sp_axis="sp", sp_method="fourstep"),
         4, ("fwd", "inv")),
    )

    def res(qs, shape):
        return np.stack([rng.integers(0, q, size=shape, dtype=np.uint32)
                         for q in qs])

    for devices in meshes:
        for n, L, kw, axes, skw, batch, kernels in layouts:
            rns = RNSRing(n, L, device=cuda, **kw)
            plain = RNSRing(n, L, device="cpu", **kw)
            s = ShardedRNSRing(rns, make_mesh(devices=devices, **axes), **skw)
            x, y = res(rns.qs, (batch, n)), res(rns.qs, (batch, n))
            da, db = res(rns.qs, (batch, 2, n)), res(rns.qs, (batch, 2, n))
            calls = {"ntt": (x,), "intt": (x,), "polymul": (x, y),
                     "polydot": (da, db)}
            before = dict(K.LAUNCHES)
            outs = {op: getattr(s, op)(*args) for op, args in calls.items()}
            for key in kernels:
                assert K.LAUNCHES[key] > before[key], (axes, skw, key)
            for op, got in outs.items():
                what = (devices, axes, skw, op)
                assert got.device == torch.device(devices[0]), what
                assert torch.equal(got, getattr(rns, op)(*calls[op])), what
                assert torch.equal(got.cpu(), getattr(plain, op)(*calls[op])), what
    n, dnum, ks = 256, 2, (3, 7)
    qs = find_primes(n, 9)
    rings = [(RNSRing(n, qs=qs[:4], device=d), RNSRing(n, qs=qs[:6], device=d))
             for d in (cuda, "cpu")]
    x, xe = res(qs[:4], (4, n)), res(qs[:6], (4, n))
    keys = [np.stack([np.stack([res(qs[:6], (n,)) for _ in range(dnum)])
                      for _ in ks]) for _ in range(3)]
    c1, d = res(qs[:4], (4, n)), res(qs[:7], (4, n))
    pts = np.stack([res(qs[:6], (n,)) for _ in ks])
    mesh = make_mesh(dp=2, devices=["cuda:0"] * 2)
    srq = ShardedRNSRing(rings[0][0], mesh)
    sext = ShardedRNSRing(rings[0][1], mesh)
    before = K.LAUNCHES["polydot_rns"]
    calls = {
        "keyswitch": lambda r, e: r.keyswitch(x, keys[0][0], e, dnum),
        "hoisted_keyswitch": lambda r, e: r.hoisted_keyswitch(
            x, keys[0], ks, e, dnum),
        "hoisted_linear_sum": lambda r, e: torch.stack(r.hoisted_linear_sum(
            x, c1, pts, keys[1], keys[2], ks, e, dnum)),
        "gadget_decompose": lambda r, e: r.gadget_decompose(x, e, dnum),
    }
    for what, call in calls.items():
        got = call(srq, rings[0][1])
        assert torch.equal(got, call(rings[0][0], rings[0][1])), what
        assert torch.equal(got.cpu(), call(*rings[1])), what
    assert K.LAUNCHES["polydot_rns"] > before
    for what, got, want in (
        ("mod_down", sext.mod_down(xe, 2), rings[1][1].mod_down(xe, 2)),
        ("mod_down_bgv", sext.mod_down_bgv(xe, 17, 2),
         rings[1][1].mod_down_bgv(xe, 17, 2)),
        ("hps_scale_sk", srq.hps_scale_sk(d, qs[:4], qs[6:9], 17),
         B.base_convert_sk(*_hps_parts(d, qs), qs[6:8], qs[8], qs[:4])),
    ):
        assert torch.equal(got.cpu(), want.to(torch.uint32)), what


def _hps_parts(d, qs):
    """scale_round of the union-basis words ``d`` on the CPU, split into the
    B residues and the m_sk residue (the plain hps_scale_sk's first half)."""
    y = B.scale_round(torch.from_numpy(d[:4]).to(torch.int64),
                      torch.from_numpy(d[4:]).to(torch.int64), qs[:4],
                      qs[6:9], 17)
    return y[:-1], y[-1]


def _ckks_twins(cuda, n, levels, seed, steps=()):
    """A CKKS context on the card and one on the CPU from the same seed,
    with their key sets (the same words, if the card computes as the CPU
    plain versions do)."""
    from agilex_ntt_tpu_torch.schemes import CKKSContext

    out = []
    for device in (cuda, "cpu"):
        ctx = CKKSContext(n, levels, rng=np.random.default_rng(seed),
                          device=device)
        out.append((ctx, ctx.keygen(galois_steps=steps)))
    return out


def _same_ct(card, cpu):
    assert (card.level, card.scale) == (cpu.level, cpu.scale)
    assert card.c0.device.type == "cuda"
    assert torch.equal(card.c0.cpu(), cpu.c0)
    assert torch.equal(card.c1.cpu(), cpu.c1)


def _slots(rng, shape, lo=-0.9, hi=0.9):
    return rng.uniform(lo, hi, shape) + 1j * rng.uniform(lo, hi, shape)


def test_ckks_keys_and_encryption_on_the_card_match_the_cpu(cuda):
    """Keygen (both key domains), both encryptions and decryption on the card
    equal the CPU plain versions word for word; K4a and K5 launch."""
    before = dict(K.LAUNCHES)
    (gctx, gkeys), (cctx, ckeys) = _ckks_twins(cuda, 256, 3, 5, (1, -1))
    assert K.LAUNCHES["fwd_rns"] > before["fwd_rns"]
    assert K.LAUNCHES["polymul_rns"] > before["polymul_rns"]
    assert torch.equal(gkeys.sk_rns.cpu(), ckeys.sk_rns)
    for name in ("pk", "rlk", "rlk_coeff"):
        for g, c in zip(getattr(gkeys, name), getattr(ckeys, name)):
            assert torch.equal(g.cpu(), c), name
    assert sorted(gkeys.gk) == sorted(ckeys.gk)
    for table in ("gk", "gk_coeff"):
        for elt, pair in getattr(gkeys, table).items():
            for g, c in zip(pair, getattr(ckeys, table)[elt]):
                assert torch.equal(g.cpu(), c), (table, elt)
    z = _slots(np.random.default_rng(6), (5, 128))
    for enc in ("encrypt", "encrypt_symmetric"):
        g = getattr(gctx, enc)(gctx.encode(z), gkeys)
        c = getattr(cctx, enc)(cctx.encode(z), ckeys)
        _same_ct(g, c)
        assert torch.equal(gctx.decrypt(g, gkeys).rns.cpu(),
                           cctx.decrypt(c, ckeys).rns)
        np.testing.assert_allclose(gctx.decode(gctx.decrypt(g, gkeys)), z,
                                   atol=1e-3)


def test_ckks_evaluator_on_the_card_matches_the_cpu(cuda):
    """multiply, square, rescale, mod_down_to, rotations, conjugate and the
    plaintext ops; the key switch's transforms run K4a and K4b."""
    (gctx, gkeys), (cctx, ckeys) = _ckks_twins(cuda, 256, 3, 7, (1, -3))
    z1, z2 = (_slots(np.random.default_rng(s), (3, 128)) for s in (8, 9))
    g1, g2 = (gctx.encrypt(gctx.encode(z), gkeys) for z in (z1, z2))
    c1, c2 = (cctx.encrypt(cctx.encode(z), ckeys) for z in (z1, z2))
    before = dict(K.LAUNCHES)
    for op in (lambda x, a, b, k: x.multiply(a, b, k),
               lambda x, a, b, k: x.rescale(x.square(a, k)),
               lambda x, a, b, k: x.rotate(x.mod_down_to(a, 2), 1, k),
               lambda x, a, b, k: x.rotate(a, -3, k),
               lambda x, a, b, k: x.conjugate(a, k),
               lambda x, a, b, k: x.add_plain(x.sub(a, b), x.encode(z2)),
               lambda x, a, b, k: x.mul_plain(x.negate(a), x.encode(z2))):
        _same_ct(op(gctx, g1, g2, gkeys), op(cctx, c1, c2, ckeys))
    for key in ("fwd_rns", "inv_rns", "polymul_rns"):
        assert K.LAUNCHES[key] > before[key], key
    # tests/test_ckks.py's TOL at its size
    dec = lambda ct: gctx.decode(gctx.decrypt(ct, gkeys))  # noqa: E731
    out = gctx.rescale(gctx.multiply(g1, g2, gkeys))
    np.testing.assert_allclose(dec(out), z1 * z2, atol=1e-3)
    np.testing.assert_allclose(dec(gctx.rotate(g1, -3, gkeys)),
                               np.roll(z1, 3, axis=-1), atol=1e-3)
    np.testing.assert_allclose(dec(gctx.conjugate(g1, gkeys)), np.conj(z1),
                               atol=1e-3)


def test_ckks_linear_and_matvec_on_the_card_match_the_cpu(cuda):
    """apply_linear (hoisted_linear_sum) and the BSGS matvec (its hoisted
    baby steps, polydot_multi, the giant rotations) at n = 128."""
    from agilex_ntt_tpu_torch.schemes import CKKSContext

    n, S = 128, 64
    steps = CKKSContext(n, 3, device="cpu").bsgs_steps()
    (gctx, gkeys), (cctx, ckeys) = _ckks_twins(cuda, n, 3, 11, steps)
    rng = np.random.default_rng(12)
    z = _slots(rng, (2, S))
    ws = [_slots(rng, S) for _ in range(3)]
    M = _slots(rng, (S, S)) / S
    g, c = (x.encrypt(x.encode(z), k) for x, k in ((gctx, gkeys), (cctx, ckeys)))
    for lvl in (3, 2):
        terms = list(zip((0, 1, 2), ws))
        gl = gctx.make_linear_op(terms, gkeys, lvl)
        cl = cctx.make_linear_op(terms, ckeys, lvl)
        assert torch.equal(gl.pts.cpu(), cl.pts)
        gm, cm = gctx.make_matvec(M, gkeys, lvl), cctx.make_matvec(M, ckeys, lvl)
        assert torch.equal(gm.pts.cpu(), cm.pts)
        ga, ca = gctx.mod_down_to(g, lvl), cctx.mod_down_to(c, lvl)
        _same_ct(gctx.apply_linear(ga, gl), cctx.apply_linear(ca, cl))
        got = gctx.apply_matvec(ga, gm)
        _same_ct(got, cctx.apply_matvec(ca, cm))
    out = gctx.decode(gctx.decrypt(gctx.rescale(got), gkeys))
    np.testing.assert_allclose(out, z @ M.T, atol=5e-3)


def test_ckks_poly_eval_on_the_card_matches_the_cpu(cuda):
    """poly_eval in both bases at L = 6 (babies, giants, both node kinds,
    Chebyshev's odd recurrence)."""
    (gctx, gkeys), (cctx, ckeys) = _ckks_twins(cuda, 256, 6, 13)
    z = np.random.default_rng(14).uniform(-0.9, 0.9, (2, 128)) + 0j
    g, c = (x.encrypt(x.encode(z), k) for x, k in ((gctx, gkeys), (cctx, ckeys)))
    for coeffs, basis in (([0.1, -0.4, 0.3, 0.2, -0.15, 0.05], "power"),
                          ([0.2, -0.5, 0.3, 0.15, -0.1, 0.05, 0.1], "chebyshev")):
        got = gctx.poly_eval(g, coeffs, gkeys, basis=basis)
        _same_ct(got, cctx.poly_eval(c, coeffs, ckeys, basis=basis))
        want = (np.polynomial.polynomial.polyval(z, coeffs) if basis == "power"
                else np.polynomial.chebyshev.chebval(z, coeffs))
        np.testing.assert_allclose(gctx.decode(gctx.decrypt(got, gkeys)), want,
                                   atol=5e-2)


@pytest.mark.parametrize("n,lead", [(256, ()), (16384, (2, 3))])
def test_evaluator_ring_methods_on_the_card_match_the_cpu(cuda, n, lead):
    """polydot_multi and hoisted_linear_sum (both domains, the BGV ModDown)
    on the card against the CPU plain versions, also at the key switch's
    n = 16384 with a lead of 2 x 3 ciphertexts (clusters of 4 CTAs)."""
    primes = find_primes(n, 4)
    qs, ext = primes[:3], primes
    gen = torch.Generator(cuda).manual_seed(n)

    def words(basis, shape):
        return torch.stack([_rand(gen, q, shape, cuda) for q in basis]).to(
            torch.uint32)

    terms = (1, 5, 2 * n - 1)
    c0, c1 = words(qs, lead + (n,)), words(qs, lead + (n,))
    pts = words(ext, (3, n)).movedim(0, 1).contiguous()
    kb, ka = (words(ext, (3, 3, n)).movedim(0, 2).contiguous() for _ in range(2))
    a, ws = words(qs, lead + (4, n)), words(qs, (2, 4, n))
    card, cpu = RNSRing(n, qs=qs, device=cuda), RNSRing(n, qs=qs, device="cpu")
    for kd, pd, pm in (("coeff", "coeff", None), ("ntt", "ntt", 65537)):
        outs = [r.hoisted_linear_sum(*(v.to(r.device) for v in (c0, c1, pts, kb, ka)),
                                     terms, ext, 3, ksk_domain=kd, pt_domain=pd,
                                     plain_mod=pm) for r in (card, cpu)]
        for g, c in zip(*outs):
            assert torch.equal(g.cpu(), c), (kd, pd, pm)
    got = card.polydot_multi(a, ws)
    assert tuple(got.shape) == (2, 3) + lead + (n,)
    assert torch.equal(got.cpu(), cpu.polydot_multi(a.cpu(), ws.cpu()))


def _int_twins(cuda, scheme, seed, steps):
    """A BGV or BFV context on the card and one on the CPU from the same
    seed (n = 256, L = 3), with their key sets."""
    from agilex_ntt_tpu_torch.schemes import BFVContext, BGVContext

    out = []
    for device in (cuda, "cpu"):
        ctx = (BGVContext if scheme == "bgv" else BFVContext)(
            256, 3, rng=np.random.default_rng(seed), device=device)
        out.append((ctx, ctx.keygen(galois_steps=steps)))
    return out


def _int_ops_match(cuda, scheme, seed):
    """Keys, encryptions and every op of ``scheme`` on the card equal the
    CPU plain versions word for word, and decode exactly; the plaintext
    ring's transforms run K1 and K2, the evaluator K4a, K4b and K5.
    Returns the twins."""
    before = dict(K.LAUNCHES)
    (gctx, gkeys), (cctx, ckeys) = _int_twins(cuda, scheme, seed, (1, -1))
    assert gctx.tring.device.type == "cuda"
    for name in ("sk_rns", "pk", "rlk", "rlk_coeff"):
        g, c = getattr(gkeys, name), getattr(ckeys, name)
        for gv, cv in (zip(g, c) if isinstance(g, tuple) else ((g, c),)):
            assert torch.equal(gv.cpu(), cv), name
    for elt, pair in gkeys.gk.items():
        for g, c in zip(pair, ckeys.gk[elt]):
            assert torch.equal(g.cpu(), c), elt
    rng = np.random.default_rng(seed + 1)
    m1, m2 = (rng.integers(0, gctx.t, (3, 2, 128)) for _ in range(2))
    w = rng.integers(0, gctx.t, (2, 128))
    g1, g2 = (gctx.encrypt(gctx.encode(m), gkeys) for m in (m1, m2))
    c1, c2 = (cctx.encrypt(cctx.encode(m), ckeys) for m in (m1, m2))
    _same_ct(g1, c1)
    mul_pt = "encode_mul" if scheme == "bfv" else "encode"
    t = gctx.t
    for op, want in (
            (lambda x, a, b, k: x.multiply(a, b, k), m1 * m2),
            (lambda x, a, b, k: x.rescale(x.square(a, k)), m1 * m1),
            (lambda x, a, b, k: x.rotate(x.mod_down_to(a, 2), 1, k),
             np.roll(m1, -1, axis=-1)),
            (lambda x, a, b, k: x.conjugate(a, k), m1[..., ::-1, :]),
            (lambda x, a, b, k: x.add_plain(x.sub(a, b), x.encode(m2)), m1),
            (lambda x, a, b, k: x.mul_plain(x.negate(a),
                                            getattr(x, mul_pt)(w)), -m1 * w),
            (lambda x, a, b, k: x.apply_linear(a, x.make_linear_op(
                [(0, w), (-1, w)], k, 3)),
             w * m1 + w * np.roll(m1, 1, axis=-1))):
        got = op(gctx, g1, g2, gkeys)
        _same_ct(got, op(cctx, c1, c2, ckeys))
        np.testing.assert_array_equal(gctx.decode(gctx.decrypt(got, gkeys)),
                                      want % t)
    for key in ("fwd", "inv", "fwd_rns", "inv_rns", "polymul_rns"):
        assert K.LAUNCHES[key] > before[key], key
    return (gctx, gkeys, g1), (cctx, ckeys, c1)


def test_bgv_on_the_card_matches_the_cpu(cuda):
    """BGV at n = 256, L = 3: the ops above; then ``poly_eval`` in both
    bases at L = 6 (tests/test_polyeval.py's BGV size), word for word and
    exact mod t."""
    from agilex_ntt_tpu_torch.schemes import BGVContext

    _int_ops_match(cuda, "bgv", 41)
    twins = []
    for device in (cuda, "cpu"):
        ctx = BGVContext(256, 6, rng=np.random.default_rng(45), device=device)
        keys = ctx.keygen()
        m = np.random.default_rng(46).integers(0, ctx.t, (2, 128))
        twins.append((ctx, keys, ctx.encrypt(ctx.encode(m), keys)))
    (gctx, gkeys, g), (cctx, ckeys, c) = twins
    _same_ct(g, c)
    t = gctx.t
    for coeffs, basis in (([3, 7, 1, 5], "power"), ([3, 1, 7, 2], "chebyshev")):
        got = gctx.poly_eval(g, coeffs, gkeys, basis=basis)
        _same_ct(got, cctx.poly_eval(c, coeffs, ckeys, basis=basis))
        # T_0 = 1, T_1 = m, T_k = 2 m T_{k-1} - T_{k-2}, all mod t
        powers = [np.ones_like(m), m % t]
        for _ in range(2, len(coeffs)):
            powers.append((powers[-1] * m if basis == "power"
                           else 2 * m * powers[-1] - powers[-2]) % t)
        want = sum(cf * pw for cf, pw in zip(coeffs, powers)) % t
        np.testing.assert_array_equal(gctx.decode(gctx.decrypt(got, gkeys)),
                                      want)


def test_bfv_on_the_card_matches_the_cpu(cuda):
    """BFV at n = 256, L = 3: the ops above, with the HPS multiply's
    stages (the lift, the 6-prime union basis's tensor on K4a/K4b, the
    scale and round, the Shenoy-Kumaresan return) and ``mod_down_to``."""
    (gctx, gkeys, g1), (cctx, ckeys, c1) = _int_ops_match(cuda, "bfv", 43)
    _, rbig = gctx._aux(3)
    assert rbig.device.type == "cuda" and rbig.tables is not None
    for lift_g, lift_c in zip((gctx._lift(g1.c0, 3), gctx._lift(g1.c1, 3)),
                              (cctx._lift(c1.c0, 3), cctx._lift(c1.c1, 3))):
        assert torch.equal(lift_g.cpu(), lift_c)
    parts = rbig.tensor_square(gctx._lift(g1.c0, 3), gctx._lift(g1.c1, 3))
    cparts = cctx._aux(3)[1].tensor_square(cctx._lift(c1.c0, 3),
                                           cctx._lift(c1.c1, 3))
    for d, cd in zip(parts, cparts):
        assert torch.equal(d.cpu(), cd)
        assert torch.equal(gctx._scale_down(d, 3).cpu(),
                           cctx._scale_down(cd, 3))
    _same_ct(gctx.mod_down_to(g1, 1), cctx.mod_down_to(c1, 1))
