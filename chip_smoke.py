#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``agilex_ntt_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package.  Phases, each of which
fails the run (non-zero exit, no result line) when it goes wrong:

1. Build: ``nvcc`` compiles the kernels from ``agilex_ntt_tpu_torch/csrc``
   for ``sm_90a`` (``ops/_build.py``).
2. Kernels: each of the four kernels against its plain PyTorch version on
   the same inputs on the card, bit for bit over the whole output
   (tolerance 0: integer arithmetic), at the main path's shapes (n=4096,
   batch 8192; polydot k=3, batch 2048), at n=32768 and n=32, and at two
   shapes that reach the kernels' other branches.  The first rows are also
   held against the package's numpy golden model.
3. Main path: ``Ring(4096)`` ntt -> intt -> polymul -> polydot at the
   main shapes, with the launch counters set to 0 just before and read just
   after; every kernel must have launched, and the outputs must agree with
   the golden model.
4. Timing at the main shapes: each kernel and its plain version (CUDA
   events), beside the least time the card could take (``bound_ms``).

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

KERNEL_SOURCE = "agilex_ntt_tpu_torch/csrc/ntt_kernels.cu"
KERNELS = {  # wrapper counter -> (name, TPU kernel replaced)
    "fwd": ("fwd_ntt", "agilex_ntt_tpu/ops/ntt_kernel.py:97"),
    "inv": ("inv_ntt", "agilex_ntt_tpu/ops/ntt_kernel.py:110"),
    "polymul": ("polymul_fused", "agilex_ntt_tpu/ops/ntt_kernel.py:241"),
    "polydot": ("polydot_fused", "agilex_ntt_tpu/ops/ntt_kernel.py:760"),
}


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


def bound(words_moved: int, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    the int32 operations over the rate of the pipes they need."""
    mul, cmp, add = ops
    t_bytes = words_moved * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = max(mul / INT32_PIPE_PER_S, cmp / INT32_PIPE_PER_S,
                (mul + cmp + add) / INT32_ISSUE_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np

    from agilex_ntt_tpu_torch import Ring, golden as G
    from agilex_ntt_tpu_torch.ops import _build
    from agilex_ntt_tpu_torch.ops import ntt_kernel as K
    from agilex_ntt_tpu_torch.ops import plain_ntt as P
    from agilex_ntt_tpu_torch.utils.profiling import cuda_time_ms

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

    worst = {name: 0 for name in KERNELS}
    mismatched = {name: 0 for name in KERNELS}

    def compare(name, got, want, shape_note):
        diff = (got.to(torch.int64) - want).abs()
        err, bad = int(diff.max()), int((diff != 0).sum())
        worst[name] = max(worst[name], err)
        mismatched[name] += bad
        log(f"  {name:8s} {shape_note:28s} max_abs_err={err} mismatches={bad}")
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

    # -- 3. the main path, counted -------------------------------------------
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
    missing = [key for key, count in launches.items() if count < 1]
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
    rows = []
    log(f"timing on {card} (CUDA events, median of 5 runs of 10 calls):")
    for key, (kern, plain, words, ops, shape) in timed.items():
        ms = cuda_time_ms(kern)
        plain_ms = cuda_time_ms(plain, warmup=1, reps=3, inner=2)
        bound_ms, bound_by = bound(words, ops)
        name, replaces = KERNELS[key]
        log(f"  {name:14s} {shape:26s} {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}; {words * 4} bytes, int32 "
            f"{ops[0]} multiplies, {ops[1]} compares, {ops[2]} adds), "
            f"{bound_ms / ms:.1%} of bound")
        rows.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": replaces, "launches": launches[key],
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
    torch.cuda.synchronize()

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
