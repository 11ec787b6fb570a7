#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``agilex_ntt_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package.  Phases, each of which
fails the run (non-zero exit, no result line) when it goes wrong:

1. Build: ``nvcc`` compiles the kernels from ``agilex_ntt_tpu_torch/csrc``
   for ``sm_90a`` (``ops/_build.py``).
2. Kernels: each of the eight kernels against its plain PyTorch version on
   the same inputs on the card, bit for bit over the whole output
   (tolerance 0: integer arithmetic).  Single prime: at the main path's
   shapes (n=4096, batch 8192; polydot k=3, batch 2048), at n=32768 and
   n=32, and at two shapes that reach the kernels' other branches.  L
   primes: the "n4096" chain (L=3, batch 2048), the key-switch dot of the
   "n16384" chain (K=5 primes, batch 64, k=dnum=4), n=32768 (L=4, the
   fused kernels' scratch path), n=32 (L=3, batch 4096) and a ragged
   batch.  The first rows are also held against the package's numpy golden
   model, channel by channel.
3. Main paths, each with the launch counters set to 0 just before and read
   just after; every kernel of the path must have launched:
   a. ``Ring(4096)`` ntt -> intt -> polymul -> polydot at the main shapes,
      outputs against the golden model;
   b. the key switch of the "n16384" CKKS chain (4 primes and the largest
      of ``find_primes(16384, 5)`` as the special prime, dnum = 4):
      ``RNSRing.keyswitch`` of (4, 64, 16384) residues with coefficient-
      and evaluation-domain keys, ``hoisted_keyswitch`` over 3 Galois
      steps, then ``RNSRing(4096, 3)`` ntt -> intt -> polymul -> polydot at
      batch 2048.  The first rows must equal the port's own CPU plain
      composition, the two key domains each other, and the 4096 outputs
      the golden model.
4. Timing: each kernel and its plain version (CUDA events) at its main
   path's shape, beside the least time the card could take
   (``bound_ms``), and the key switch end to end.

Output: the card's name and power limit as ``nvidia-smi`` prints them, a
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
# int32 rates from the SM's pipes, at the clock behind the data sheet's
# 67 TFLOP/s float32 (132 SMs x 128 FP32 lanes x 2 for an FMA = 1.98 GHz).
# Multiplies issue only on the FMA pipe and compares, selects and min/max
# only on the ALU pipe, each 64 lanes an SM; adds go to either pipe; an SM
# issues at most 128 lane-operations a clock.
INT32_PIPE_PER_S = 67e12 / 4
INT32_ISSUE_PER_S = 67e12 / 2

# int32 operations the kernels' arithmetic needs (ntt_arith.cuh) as
# (multiplies, compares or selects, adds), each at its fewest instructions:
# a Shoup product is 3 multiplies (the subtract fused into a multiply-add),
# a conditional subtraction an add and an unsigned min, and x + y - z one
# three-input add.
OPS_BUTTERFLY = (3, 1, 3)  # CT or GS: a Shoup product, a cond_sub, 2 adds
OPS_LAST_INV_BUTTERFLY = (6, 2, 4)  # two scaled products and reductions
OPS_FINAL_REDUCE = (0, 2, 2)  # two conditional subtractions per output word
OPS_MONT = (4, 1, 1)  # 4 multiplies, the carry test, one three-input add
OPS_ACCUMULATE = (0, 1, 2)  # an add and a conditional subtraction

MAIN_N, MAIN_BATCH, MAIN_K, MAIN_DOT_BATCH = 4096, 8192, 3, 2048
# (n, batch, polydot k, polydot batch)
CHECK_SHAPES = (
    (MAIN_N, MAIN_BATCH, MAIN_K, MAIN_DOT_BATCH),
    (32768, 1024, MAIN_K, 1024),
    (32, 65536, MAIN_K, 65536),
    (16384, 256, MAIN_K, 256),  # polydot with every tile in shared memory
    (256, 1001, 2, 333),  # several polynomials a block, a ragged last block
)
GOLDEN_ROWS = 8
DEVICE = "cuda"

# (n, L, batch, polydot k, polydot batch) of the multi-prime checks
RNS_N, RNS_L, RNS_BATCH, RNS_K = 4096, 3, 2048, 3
KS_N, KS_L, KS_BATCH = 16384, 4, 64  # the key switch: dnum = L, K = L + 1
KS_STEPS = (5, 25, 2 * KS_N - 1)  # rotations by 1 and 2 slots, conjugation
RNS_CHECK_SHAPES = (
    (RNS_N, RNS_L, RNS_BATCH, 4, 256),  # the "n4096" chain, 96 MiB an operand
    (KS_N, KS_L + 1, KS_BATCH, KS_L, KS_BATCH),  # the key-switch dot, 80 MiB
    (32768, 4, 64, 2, 64),  # the fused kernels' scratch path
    (32, 3, 4096, 3, 4096),  # 32 polynomials a block
    (256, 3, 1001, 2, 333),  # a ragged last block
)

KERNEL_SOURCE = "agilex_ntt_tpu_torch/csrc/ntt_kernels.cu"
KERNELS = {  # wrapper counter -> (name, TPU kernel replaced)
    "fwd": ("fwd_ntt", "agilex_ntt_tpu/ops/ntt_kernel.py:97"),
    "inv": ("inv_ntt", "agilex_ntt_tpu/ops/ntt_kernel.py:110"),
    "polymul": ("polymul_fused", "agilex_ntt_tpu/ops/ntt_kernel.py:241"),
    "polydot": ("polydot_fused", "agilex_ntt_tpu/ops/ntt_kernel.py:760"),
    "fwd_rns": ("fwd_ntt_rns", "agilex_ntt_tpu/ops/ntt_kernel.py:340"),
    "inv_rns": ("inv_ntt_rns", "agilex_ntt_tpu/ops/ntt_kernel.py:350"),
    "polymul_rns": ("polymul_rns_fused", "agilex_ntt_tpu/ops/ntt_kernel.py:360"),
    "polydot_rns": ("polydot_rns_fused", "agilex_ntt_tpu/ops/ntt_kernel.py:646"),
}
SINGLE = ("fwd", "inv", "polymul", "polydot")
MULTI = ("fwd_rns", "inv_rns", "polymul_rns", "polydot_rns")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    if len(out) < 1:
        raise RuntimeError("nvidia-smi listed no card")
    return out[0]


def ops_sum(*terms):
    """Sum of (count, (multiplies, compares, adds)) terms."""
    return tuple(sum(c * ops[i] for c, ops in terms) for i in range(3))


def fwd_ops(batch: int, n: int):
    logn = n.bit_length() - 1
    return ops_sum((batch * n // 2 * logn, OPS_BUTTERFLY),
                   (batch * n, OPS_FINAL_REDUCE))


def inv_ops(batch: int, n: int):
    logn = n.bit_length() - 1
    return ops_sum((batch * n // 2 * (logn - 1), OPS_BUTTERFLY),
                   (batch * n // 2, OPS_LAST_INV_BUTTERFLY))


def dot_ops(batch: int, k: int, n: int):
    return ops_sum((2 * k, fwd_ops(batch, n)), (batch * n * k, OPS_MONT),
                   (batch * n * (k - 1), OPS_ACCUMULATE),
                   (1, inv_ops(batch, n)))


def scaled(L: int, ops):
    """The operations of L channels."""
    return tuple(L * v for v in ops)


def bound(words_moved: int, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    the int32 operations over the rate of the pipes they need."""
    mul, cmp, add = ops
    t_bytes = words_moved * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = max(mul / INT32_PIPE_PER_S, cmp / INT32_PIPE_PER_S,
                (mul + cmp + add) / INT32_ISSUE_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# names of ntt_kernels.cu's kernels, demangled or not
OUR_KERNEL = re.compile(r"(?<![A-Za-z_])(fwd|inv|polydot)(_rns)?_kernel")


def device_breakdown(torch, call, what: str, call_ms: float, top: int = 5) -> None:
    """Where one call's device time goes, from ``torch.profiler``: the
    kernels' device time (each kernel counted once, by its own event),
    split into this repository's NTT kernels and the PyTorch operations
    around them, against ``call_ms``, the call's unprofiled time on CUDA
    events; and the PyTorch operations that launched the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    if not kernels:
        log(f"  {what}: the profiler recorded no device time")
        return
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    ntt = sum(e.self_device_time_total for e in kernels
              if OUR_KERNEL.search(e.key)) / 1e3
    launches = sum(e.count for e in kernels)
    log(f"  {what}: {launches} kernel launches, device busy {busy:.4f} ms of "
        f"{call_ms:.4f} ms a call ({1 - busy / call_ms:.1%} idle): NTT "
        f"kernels {ntt:.4f} ms, PyTorch ops {busy - ntt:.4f} ms")
    ops = [e for e in events if e.device_type == DeviceType.CPU
           and e.key.startswith("aten::")]
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"    {e.key:24s} {e.count:5d} calls, {e.self_device_time_total / 1e3:.4f} "
            f"ms on the device")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np

    from agilex_ntt_tpu_torch import RNSRing, Ring, find_primes, golden as G
    from agilex_ntt_tpu_torch.ops import _build
    from agilex_ntt_tpu_torch.ops import ntt_kernel as K
    from agilex_ntt_tpu_torch.ops import plain_ntt as P
    from agilex_ntt_tpu_torch.utils.profiling import cuda_time_ms

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    log(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    kernel = "?"
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        entry = re.search(r"\d+([a-z_]+_kernel)E", line)
        if "Compiling entry" in line and entry:
            kernel = entry.group(1)
        elif "registers" in line or "spill" in line:
            log(f"  ptxas {kernel}: " + line.split(":", 1)[-1].strip())

    # -- 2. each kernel against its plain version ------------------------------
    def rand(gen, bound_, shape):
        return torch.randint(0, bound_, shape, generator=gen,
                             dtype=torch.int64, device=dev)

    worst = {key: 0 for key in KERNELS}
    mismatched = {key: 0 for key in KERNELS}

    def compare(name, got, want, shape_note):
        diff = (got.to(torch.int64) - want).abs()
        err, bad = int(diff.max()), int((diff != 0).sum())
        worst[name] = max(worst[name], err)
        mismatched[name] += bad
        log(f"  {name:11s} {shape_note:34s} max_abs_err={err} mismatches={bad}")
        if bad:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at {shape_note}")

    def golden_fwd(rows, params):
        return G.fwd_ntt_u64(rows.cpu().numpy(), params)

    def golden_dot(a_rows, b_rows, params):
        """sum_i a_i * b_i by the golden transforms; a, b: (rows, k, n)."""
        q = np.uint64(params.q)
        fa, fb = golden_fwd(a_rows, params), golden_fwd(b_rows, params)
        return G.inv_ntt_u64((fa * fb % q).sum(axis=-2) % q, params)

    def same_as_golden(got_rows, want, what):
        if not np.array_equal(got_rows.cpu().numpy().astype(np.uint64), want):
            raise AssertionError(f"{what} disagrees with the golden model")

    log("kernels vs plain versions (tolerance 0: bit-exact), first rows vs golden:")
    for n, batch, k, dot_batch in CHECK_SHAPES:
        ring = Ring(n, device=dev)
        q, tabs, params = ring.q, ring.tables, ring.params
        gen = torch.Generator(dev).manual_seed(n)
        g = GOLDEN_ROWS

        x = rand(gen, 4 * q, (batch, n))  # lazy forward range [0, 4q)
        got = K.fwd_ntt(x.to(torch.uint32), tabs)
        compare("fwd", got, P.fwd_ntt_plain(x, tabs), f"n={n} B={batch}")
        same_as_golden(got[:g], golden_fwd(x[:g], params), "fwd_ntt")
        del x, got

        y = rand(gen, 2 * q, (batch, n))  # lazy inverse range [0, 2q)
        got = K.inv_ntt(y.to(torch.uint32), tabs)
        compare("inv", got, P.inv_ntt_plain(y, tabs), f"n={n} B={batch}")
        same_as_golden(got[:g], G.inv_ntt_u64(y[:g].cpu().numpy(), params),
                       "inv_ntt")
        del y, got

        a, b = rand(gen, q, (batch, n)), rand(gen, q, (batch, n))
        got = K.polymul_fused(a.to(torch.uint32), b.to(torch.uint32), tabs)
        compare("polymul", got, P.polymul_plain(a, b, tabs), f"n={n} B={batch}")
        same_as_golden(got[:g], golden_dot(a[:g, None], b[:g, None], params),
                       "polymul_fused")
        if n <= 256:  # the schoolbook product, an oracle sharing no transform
            want = G.negacyclic_convolution(a[0].tolist(), b[0].tolist(), q)
            if got[0].to(torch.int64).tolist() != want:
                raise AssertionError("polymul_fused disagrees with schoolbook")
        del a, b, got

        a = rand(gen, q, (dot_batch, k, n))
        b = rand(gen, q, (dot_batch, k, n))
        got = K.polydot_fused(a.to(torch.uint32), b.to(torch.uint32), tabs)
        compare("polydot", got, P.polydot_plain(a, b, tabs),
                f"n={n} B={dot_batch} k={k}")
        same_as_golden(got[:g], golden_dot(a[:g], b[:g], params),
                       "polydot_fused")
        del a, b, got
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def channels(gen, qs, mult, shape):
        """(L, *shape) int64, channel l uniform in [0, mult * q_l)."""
        return torch.stack([rand(gen, mult * q, shape) for q in qs])

    def golden_channels(got, want_fn, rings, what):
        """Each channel's first rows against the golden model of its prime."""
        for l, r in enumerate(rings):
            same_as_golden(got[l, :GOLDEN_ROWS], want_fn(l, r.params),
                           f"{what} channel {l}")

    g = GOLDEN_ROWS
    for n, L, batch, k, dot_batch in RNS_CHECK_SHAPES:
        ring = RNSRing(n, L, device=dev)
        tabs, qs = ring.tables, ring.qs
        gen = torch.Generator(dev).manual_seed(n + L)
        note = f"n={n} L={L} B={batch}"

        x = channels(gen, qs, 4, (batch, n))
        got = K.fwd_ntt_rns(x.to(torch.uint32), tabs)
        compare("fwd_rns", got, P.fwd_ntt_rns_plain(x, tabs), note)
        golden_channels(got, lambda l, p: golden_fwd(x[l, :g], p), ring.rings,
                        "fwd_ntt_rns")
        del x, got

        y = channels(gen, qs, 2, (batch, n))
        got = K.inv_ntt_rns(y.to(torch.uint32), tabs)
        compare("inv_rns", got, P.inv_ntt_rns_plain(y, tabs), note)
        golden_channels(
            got, lambda l, p: G.inv_ntt_u64(y[l, :g].cpu().numpy(), p),
            ring.rings, "inv_ntt_rns")
        got = K.inv_ntt_rns(y.to(torch.uint32), tabs, scales=tabs.polymul_scale)
        compare("inv_rns", got, P.inv_ntt_rns_plain(y, tabs, tabs.polymul_scale),
                note + " polymul_scale")
        del y, got

        a, b = channels(gen, qs, 1, (batch, n)), channels(gen, qs, 1, (batch, n))
        got = K.polymul_rns_fused(a.to(torch.uint32), b.to(torch.uint32), tabs)
        compare("polymul_rns", got, P.polymul_rns_plain(a, b, tabs), note)
        golden_channels(
            got, lambda l, p: golden_dot(a[l, :g, None], b[l, :g, None], p),
            ring.rings, "polymul_rns_fused")
        del a, b, got

        a = channels(gen, qs, 1, (dot_batch, k, n))
        b = channels(gen, qs, 1, (dot_batch, k, n))
        got = K.polydot_rns_fused(a.to(torch.uint32), b.to(torch.uint32), tabs)
        compare("polydot_rns", got, P.polydot_rns_plain(a, b, tabs),
                f"n={n} L={L} B={dot_batch} k={k}")
        golden_channels(got, lambda l, p: golden_dot(a[l, :g], b[l, :g], p),
                        ring.rings, "polydot_rns_fused")
        del a, b, got
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    log(f"phase 2 done at {time.perf_counter() - t_start:.1f} s")

    # -- 3a. the single-prime main path, counted ------------------------------
    ring = Ring(MAIN_N, device=dev)
    gen = torch.Generator(dev).manual_seed(20261016)
    x = ring.random_coeffs(gen, (MAIN_BATCH,))
    a = ring.random_coeffs(gen, (MAIN_BATCH,))
    b = ring.random_coeffs(gen, (MAIN_BATCH,))
    da = ring.random_coeffs(gen, (MAIN_DOT_BATCH, MAIN_K))
    db = ring.random_coeffs(gen, (MAIN_DOT_BATCH, MAIN_K))
    torch.cuda.synchronize()
    for key in K.LAUNCHES:
        K.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    y = ring.ntt(x)
    z = ring.intt(y)
    c = ring.polymul(a, b)
    d = ring.polydot(da, db)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    log(f"main path: Ring({MAIN_N}) ntt+intt+polymul (B={MAIN_BATCH}) + "
        f"polydot (B={MAIN_DOT_BATCH}, k={MAIN_K}) in {main_s * 1e3:.3f} ms "
        f"(host clock); launches {launches}")
    missing = [key for key in SINGLE if launches[key] < 1]
    if missing:
        raise AssertionError(f"main path launched no {missing} kernel")
    params, g = ring.params, GOLDEN_ROWS
    for out, shape in ((y, (MAIN_BATCH, MAIN_N)), (z, (MAIN_BATCH, MAIN_N)),
                       (c, (MAIN_BATCH, MAIN_N)), (d, (MAIN_DOT_BATCH, MAIN_N))):
        if out.dtype != torch.uint32 or tuple(out.shape) != shape:
            raise AssertionError(f"main path output {out.dtype} "
                                 f"{tuple(out.shape)}, expected {shape}")
        if int(out.to(torch.int64).max()) >= ring.q:
            raise AssertionError("main path output not reduced below q")
    if not torch.equal(z, x):
        raise AssertionError("intt(ntt(x)) != x on the main path")
    same_as_golden(y[:g], golden_fwd(x[:g], params), "main path ntt")
    same_as_golden(c[:g], golden_dot(a[:g, None], b[:g, None], params),
                   "main path polymul")
    same_as_golden(d[:g], golden_dot(da[:g], db[:g], params),
                   "main path polydot")
    log("main path: outputs agree with the golden model")

    # -- 3b. the key switch of the n16384 chain, and RNSRing(4096), counted ----
    primes = find_primes(KS_N, KS_L + 1)
    special, ks_qs = primes[0], primes[1:]  # the largest is the special prime
    ext_qs = ks_qs + [special]
    dnum, ext_k = KS_L, KS_L + 1
    ks_ring = RNSRing(KS_N, qs=ks_qs, device=dev)
    ext_ring = RNSRing(KS_N, qs=ext_qs, device=dev)
    rns = RNSRing(RNS_N, RNS_L, device=dev)
    gen = torch.Generator(dev).manual_seed(20261017)
    ks_x = channels(gen, ks_qs, 1, (KS_BATCH, KS_N)).to(torch.uint32)
    ksk = channels(gen, ext_qs, 1, (dnum, KS_N)).movedim(0, 1)
    ksk = ksk.to(torch.uint32).contiguous()  # (dnum, K, n), shared
    ksks = channels(gen, ext_qs, 1, (len(KS_STEPS), dnum, KS_N)).movedim(0, 2)
    ksks = ksks.to(torch.uint32).contiguous()  # (steps, dnum, K, n)
    rx = channels(gen, rns.qs, 1, (RNS_BATCH, RNS_N)).to(torch.uint32)
    ra = channels(gen, rns.qs, 1, (RNS_BATCH, RNS_N)).to(torch.uint32)
    rb = channels(gen, rns.qs, 1, (RNS_BATCH, RNS_N)).to(torch.uint32)
    rda = channels(gen, rns.qs, 1, (RNS_BATCH, RNS_K, RNS_N)).to(torch.uint32)
    rdb = channels(gen, rns.qs, 1, (RNS_BATCH, RNS_K, RNS_N)).to(torch.uint32)
    torch.cuda.synchronize()
    for key in K.LAUNCHES:
        K.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    ks_coeff = ks_ring.keyswitch(ks_x, ksk, ext_ring, dnum)
    ksk_ntt = ks_ring.ksk_to_ntt(ksk, ext_ring)
    ks_ntt = ks_ring.keyswitch(ks_x, ksk_ntt, ext_ring, dnum, ksk_domain="ntt")
    ksks_ntt = ks_ring.ksk_to_ntt(ksks, ext_ring, ch_axis=2)
    hoisted = ks_ring.hoisted_keyswitch(ks_x, ksks_ntt, KS_STEPS, ext_ring, dnum,
                                        ksk_domain="ntt")
    ry = rns.ntt(rx)
    rz = rns.intt(ry)
    rc = rns.polymul(ra, rb)
    rd = rns.polydot(rda, rdb)
    torch.cuda.synchronize()
    rns_s = time.perf_counter() - t0
    rns_launches = dict(K.LAUNCHES)
    log(f"main path: RNSRing({KS_N}, L={KS_L}) keyswitch coeff + ntt keys "
        f"(B={KS_BATCH}, dnum={dnum}, K={ext_k}) + hoisted over {len(KS_STEPS)} "
        f"steps, RNSRing({RNS_N}, L={RNS_L}) ntt+intt+polymul+polydot "
        f"(B={RNS_BATCH}, k={RNS_K}) in {rns_s * 1e3:.3f} ms (host clock); "
        f"launches {rns_launches}")
    missing = [key for key in MULTI if rns_launches[key] < 1]
    if missing:
        raise AssertionError(f"key-switch path launched no {missing} kernel")
    for out, shape, qs in (
        (ks_coeff, (KS_L, KS_BATCH, KS_N), ks_qs),
        (ks_ntt, (KS_L, KS_BATCH, KS_N), ks_qs),
        (hoisted[0], (KS_L, KS_BATCH, KS_N), ks_qs),
        (ry, (RNS_L, RNS_BATCH, RNS_N), rns.qs),
        (rz, (RNS_L, RNS_BATCH, RNS_N), rns.qs),
        (rc, (RNS_L, RNS_BATCH, RNS_N), rns.qs),
        (rd, (RNS_L, RNS_BATCH, RNS_N), rns.qs),
    ):
        if out.dtype != torch.uint32 or tuple(out.shape) != shape:
            raise AssertionError(f"key-switch path output {out.dtype} "
                                 f"{tuple(out.shape)}, expected {shape}")
        top = out.to(torch.int64).amax(dim=tuple(range(1, out.dim())))
        if any(int(t) >= q for t, q in zip(top.tolist(), qs)):
            raise AssertionError("key-switch path output not reduced below q")
    if tuple(hoisted.shape) != (len(KS_STEPS), KS_L, KS_BATCH, KS_N):
        raise AssertionError(f"hoisted_keyswitch shape {tuple(hoisted.shape)}")
    if not torch.equal(ks_coeff, ks_ntt):
        raise AssertionError("keyswitch: the two key domains disagree")
    if not torch.equal(rz, rx):
        raise AssertionError("RNSRing intt(ntt(x)) != x")
    # the first rows through the port's own CPU plain composition
    cpu_ring = RNSRing(KS_N, qs=ks_qs, device="cpu")
    rows = ks_x[:, :2].cpu()
    want = cpu_ring.keyswitch(rows, ksk.cpu(), ext_qs, dnum)
    if not torch.equal(ks_coeff[:, :2].cpu(), want):
        raise AssertionError("keyswitch disagrees with the CPU plain composition")
    want = cpu_ring.hoisted_keyswitch(rows, ksks.cpu(), KS_STEPS, ext_qs, dnum)
    if not torch.equal(hoisted[:, :, :2].cpu(), want):
        raise AssertionError("hoisted_keyswitch disagrees with the CPU plain "
                             "composition")
    golden_channels(ry, lambda l, p: golden_fwd(rx[l, :g], p), rns.rings,
                    "RNSRing.ntt")
    golden_channels(rc, lambda l, p: golden_dot(ra[l, :g, None],
                                                rb[l, :g, None], p),
                    rns.rings, "RNSRing.polymul")
    golden_channels(rd, lambda l, p: golden_dot(rda[l, :g], rdb[l, :g], p),
                    rns.rings, "RNSRing.polydot")
    log("key-switch path: both key domains agree, the first rows equal the "
        "CPU plain composition, RNSRing outputs agree with the golden model")
    log(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")

    # -- 4. timing at the main shapes -----------------------------------------
    tabs = ring.tables
    x64, c64 = x.to(torch.int64), c.to(torch.int64)
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    da64, db64 = da.to(torch.int64), db.to(torch.int64)
    n, bsz, k, dbsz = MAIN_N, MAIN_BATCH, MAIN_K, MAIN_DOT_BATCH
    timed = {
        "fwd": (lambda: K.fwd_ntt(x, tabs),
                lambda: P.fwd_ntt_plain(x64, tabs),
                2 * bsz * n, fwd_ops(bsz, n), f"(B={bsz}, n={n})"),
        "inv": (lambda: K.inv_ntt(c, tabs),
                lambda: P.inv_ntt_plain(c64, tabs),
                2 * bsz * n, inv_ops(bsz, n), f"(B={bsz}, n={n})"),
        "polymul": (lambda: K.polymul_fused(a, b, tabs),
                    lambda: P.polymul_plain(a64, b64, tabs),
                    3 * bsz * n, dot_ops(bsz, 1, n), f"(B={bsz}, n={n}) x2"),
        "polydot": (lambda: K.polydot_fused(da, db, tabs),
                    lambda: P.polydot_plain(da64, db64, tabs),
                    (2 * k + 1) * dbsz * n, dot_ops(dbsz, k, n),
                    f"(B={dbsz}, k={k}, n={n}) x2"),
    }
    rtabs, etabs = rns.tables, ext_ring.tables
    rx64, rc64 = rx.to(torch.int64), rc.to(torch.int64)
    ra64, rb64 = ra.to(torch.int64), rb.to(torch.int64)
    # the key-switch dot's operands: (K, B, dnum, n) digits against the key
    dig = channels(gen, ext_qs, 1, (KS_BATCH, dnum, KS_N))
    kdot = ksk.to(torch.int64).movedim(0, -2)[:, None].expand(
        ext_k, KS_BATCH, dnum, KS_N).contiguous()
    dig32, kdot32 = dig.to(torch.uint32), kdot.to(torch.uint32)
    L, rb_, rn = RNS_L, RNS_BATCH, RNS_N
    tab_words = 4 * rn  # four twiddle tables of n words a channel
    timed.update({
        "fwd_rns": (lambda: K.fwd_ntt_rns(rx, rtabs),
                    lambda: P.fwd_ntt_rns_plain(rx64, rtabs),
                    L * (2 * rb_ * rn + tab_words), scaled(L, fwd_ops(rb_, rn)),
                    f"(L={L}, B={rb_}, n={rn})"),
        "inv_rns": (lambda: K.inv_ntt_rns(rc, rtabs),
                    lambda: P.inv_ntt_rns_plain(rc64, rtabs),
                    L * (2 * rb_ * rn + tab_words), scaled(L, inv_ops(rb_, rn)),
                    f"(L={L}, B={rb_}, n={rn})"),
        "polymul_rns": (lambda: K.polymul_rns_fused(ra, rb, rtabs),
                        lambda: P.polymul_rns_plain(ra64, rb64, rtabs),
                        L * (3 * rb_ * rn + tab_words),
                        scaled(L, dot_ops(rb_, 1, rn)),
                        f"(L={L}, B={rb_}, n={rn}) x2"),
        "polydot_rns": (lambda: K.polydot_rns_fused(dig32, kdot32, etabs),
                        lambda: P.polydot_rns_plain(dig, kdot, etabs),
                        ext_k * ((2 * dnum + 1) * KS_BATCH * KS_N + 4 * KS_N),
                        scaled(ext_k, dot_ops(KS_BATCH, dnum, KS_N)),
                        f"(K={ext_k}, B={KS_BATCH}, k={dnum}, n={KS_N}) x2"),
    })
    rows = []
    log(f"timing on {card} (CUDA events, median of 5 runs of 10 calls):")
    for key, (kern, plain, words, ops, shape) in timed.items():
        ms = cuda_time_ms(kern)
        plain_ms = cuda_time_ms(plain, warmup=1, reps=3, inner=2)
        bound_ms, bound_by = bound(words, ops)
        name, replaces = KERNELS[key]
        log(f"  {name:17s} {shape:36s} {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}; {words * 4} bytes, int32 "
            f"{ops[0]} multiplies, {ops[1]} compares, {ops[2]} adds), "
            f"{bound_ms / ms:.1%} of bound")
        path_launches = launches if key in SINGLE else rns_launches
        rows.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": replaces, "launches": path_launches[key],
            "max_abs_err": worst[key], "mismatches": mismatched[key],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "shape": shape,
        })
    log("library_ms: null for every kernel - no PyTorch call computes a "
        "negacyclic NTT mod q")
    # end to end through the public API, wrapper checks and allocation included
    for what, call, polys in (
        ("Ring.ntt", lambda: ring.ntt(x), bsz),
        ("Ring.intt", lambda: ring.intt(y), bsz),
        ("Ring.polymul", lambda: ring.polymul(a, b), bsz),
        ("Ring.polydot", lambda: ring.polydot(da, db), dbsz),
    ):
        ms = cuda_time_ms(call)
        log(f"  {what:14s} {ms:.4f} ms per call of {polys} polynomials: "
            f"{polys / ms / 1e3:.3f} M per second")
    for what, call, polys in (
        ("RNSRing.ntt", lambda: rns.ntt(rx), RNS_L * rb_),
        ("RNSRing.intt", lambda: rns.intt(ry), RNS_L * rb_),
        ("RNSRing.polymul", lambda: rns.polymul(ra, rb), RNS_L * rb_),
        ("RNSRing.polydot", lambda: rns.polydot(rda, rdb), RNS_L * rb_),
    ):
        ms = cuda_time_ms(call)
        log(f"  {what:16s} {ms:.4f} ms per call of {polys} channel "
            f"polynomials: {polys / ms / 1e3:.3f} M per second")
    # the key switch end to end, host work (checks, table uploads) included
    log(f"key switch end to end on {card} (n={KS_N}, L={KS_L}, dnum={dnum}, "
        f"K={ext_k}, batch {KS_BATCH}; CUDA events, median of 3 runs of 2 "
        f"calls):")
    call_ms = {}
    for what, call, per in (
        ("keyswitch coeff keys",
         lambda: ks_ring.keyswitch(ks_x, ksk, ext_ring, dnum), KS_BATCH),
        ("keyswitch ntt keys",
         lambda: ks_ring.keyswitch(ks_x, ksk_ntt, ext_ring, dnum,
                                   ksk_domain="ntt"), KS_BATCH),
        (f"hoisted x{len(KS_STEPS)}",
         lambda: ks_ring.hoisted_keyswitch(ks_x, ksks_ntt, KS_STEPS, ext_ring,
                                           dnum, ksk_domain="ntt"),
         KS_BATCH * len(KS_STEPS)),
    ):
        ms = cuda_time_ms(call, warmup=1, reps=3, inner=2)
        call_ms[what] = ms
        log(f"  {what:22s} {ms:.4f} ms per call, {ms / per * 1e3:.3f} us per "
            f"ciphertext{' step' if 'hoisted' in what else ''}")
    log("where the key switch's device time goes (torch.profiler, one call):")
    device_breakdown(torch, lambda: ks_ring.keyswitch(ks_x, ksk, ext_ring, dnum),
                     "keyswitch coeff keys", call_ms["keyswitch coeff keys"])
    device_breakdown(torch, lambda: ks_ring.keyswitch(
        ks_x, ksk_ntt, ext_ring, dnum, ksk_domain="ntt"), "keyswitch ntt keys",
        call_ms["keyswitch ntt keys"])
    torch.cuda.synchronize()

    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
