"""``ShardedRing`` with one process a card, checked and timed.

On a machine with cards, from the repository root:

    python3 -m agilex_ntt_tpu_torch.utils.multihost_probe [--procs N]

It builds the kernels, then spawns N processes (default 4) that start a
process group (``multihost.init_distributed`` on a ``file://`` store in a
temporary directory) and build ``pod_mesh`` meshes.  With at least N cards
the group runs NCCL, one process a card; with fewer (one card) it runs
gloo with every process on ``cuda:0`` and every transfer staged through
pinned host memory (``comm.stages_through_host``), since NCCL refuses two
processes on one card.  Each process:

  * runs ``check_calls``: each call of the plan (``FOUR_CARD_PLAN``, or
    ``ONE_CARD_PLAN`` on one card) held word for word against the
    unsharded ``Ring`` on its card and, on the first rows, the plain
    version on the CPU, with its K1, K2 and K11 launches asserted;
  * with NCCL, runs ``time_calls`` on ``TIME_PLAN``: each call's time on
    the host clock, a barrier and ``torch.cuda.synchronize()`` around it,
    the largest over the processes, the median of 3; the transform alone
    (the grid transform, no gather of the result); and the unsharded
    ``Ring``'s call on one card.

``chip_smoke.py`` phase 3k runs ``run_world`` with ``check_calls`` on
``ONE_CARD_PLAN`` (and, with four cards or more, ``FOUR_CARD_PLAN``).
"""

from __future__ import annotations

import argparse
import multiprocessing
import multiprocessing.connection
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

STAGE = dict(dp_axis=None, sp_axis="sp")
OVERLAP = dict(STAGE, sp_comm="overlap")
FOUR = dict(STAGE, sp_method="fourstep")
TRANSFORMS = ("ntt", "intt", "polymul")
# (label, n, four-step ring?, pod_mesh (dp, sp), ShardedRing arguments,
# global batch, calls)
ONE_CARD_PLAN = (
    ("Ring(32768) sp=2 ppermute", 32768, False, (1, 2), STAGE, 1024,
     TRANSFORMS),
    ("Ring(32768) sp=2 overlap", 32768, False, (1, 2), OVERLAP, 1024,
     TRANSFORMS),
    ("Ring(4096) dp=2, a remainder batch", 4096, False, (2, 1), {}, 8191,
     ("ntt",)),
    ("Ring(2^16) sp=2 four-step", 1 << 16, True, (1, 2), FOUR, 512,
     ("ntt", "intt")),
)
FOUR_CARD_PLAN = (
    *((f"Ring(32768) sp=4 {comm} B={b}", 32768, False, (1, 4), kw, b,
       TRANSFORMS)
      for b in (1024, 8192)
      for comm, kw in (("ppermute", STAGE), ("overlap", OVERLAP))),
    ("Ring(4096) dp=4, a remainder batch", 4096, False, (4, 1), {},
     4 * 8192 - 1, ("ntt",)),
    ("Ring(32768) dp=2 x sp=2", 32768, False, (2, 2), dict(sp_axis="sp"),
     1024, TRANSFORMS),
    *((f"Ring(2^16) sp=4 four-step {comm}", 1 << 16, True, (1, 4), kw, 512,
       ("ntt", "intt"))
      for comm, kw in (("ppermute", FOUR),
                       ("overlap", dict(FOUR, sp_comm="overlap")))),
)
# the timed calls: (label, n, four-step?, (dp, sp), arguments, global
# batch, calls, batch of the unsharded call on one card)
TIME_PLAN = (
    *((f"Ring(32768) sp=4 {comm} B={b}", 32768, False, (1, 4), kw, b,
       TRANSFORMS, b)
      for b in (1024, 8192)
      for comm, kw in (("ppermute", STAGE), ("overlap", OVERLAP))),
    ("Ring(4096) dp=4 B=4x8192", 4096, False, (4, 1), {}, 4 * 8192,
     ("ntt",), 8192),
    *((f"Ring(2^16) sp=4 four-step {comm} B=512", 1 << 16, True, (1, 4), kw,
       512, ("ntt", "intt"), 512)
      for comm, kw in (("ppermute", FOUR),
                       ("overlap", dict(FOUR, sp_comm="overlap")))),
)
PLAIN_ROWS = 2
REPS = 3


def log(msg: str) -> None:
    print(f"multihost_probe: {msg}", flush=True)


def _entry(rank: int, world: int, backend: str, tmp: str, one_card: bool,
           fn, args) -> None:
    """One process: start the group, run ``fn(*args)``, keep its result."""
    if one_card:
        os.environ["LOCAL_RANK"] = "0"  # every process on cuda:0
    import torch.distributed as dist

    from ..parallel import multihost

    multihost.init_distributed(f"file://{tmp}/store", world, rank,
                               backend=backend)
    try:
        out = fn(*args)
        Path(tmp, f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    finally:
        dist.destroy_process_group()


def run_world(procs: int, backend: str, fn, *args, one_card: bool = False,
              timeout: float = 600.0) -> list:
    """``fn(*args)`` in each of ``procs`` spawned processes of one group on
    ``backend``; their results in rank order.  A process that fails (its
    traceback on stderr) stops the others, and so does the timeout; then
    this raises.  ``one_card`` puts every process on ``cuda:0``."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        ps = [ctx.Process(target=_entry,
                          args=(r, procs, backend, tmp, one_card, fn, args))
              for r in range(procs)]
        for p in ps:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in ps):
                left = deadline - time.monotonic()
                if left <= 0 or any(p.exitcode not in (None, 0) for p in ps):
                    break
                multiprocessing.connection.wait(
                    [p.sentinel for p in ps if p.is_alive()], min(left, 1.0))
        finally:
            for p in ps:
                if p.is_alive():
                    p.kill()
                p.join()
        codes = [p.exitcode for p in ps]
        if codes != [0] * procs:
            raise RuntimeError(f"{procs} processes on {backend}: exit codes "
                               f"{codes} (timeout {timeout} s)")
        return [pickle.loads(Path(tmp, f"rank{r}.pkl").read_bytes())
                for r in range(procs)]


def expected_launches(op: str, four: bool, axes, kw, batch: int) -> dict:
    """The K1, K2 and K11 launches one process makes for one call."""
    from ..parallel import fourstep_shard, overlap

    dp, sp = axes
    rows = -(-batch // dp)
    fwd, inv = {"ntt": (1, 0), "intt": (0, 1), "polymul": (2, 1)}[op]
    overlapped = kw.get("sp_comm") == "overlap"
    if kw.get("sp_axis") is None:
        return {"fwd": fwd, "inv": inv}
    if four:
        chunks = fourstep_shard._num_chunks(rows) if overlapped else 1
        return {"fwd": 2 * fwd * chunks, "inv": 2 * inv * chunks}
    stages = (sp.bit_length() - 1) * (overlap.num_chunks(rows)
                                      if overlapped else 1)
    return {"fwd": fwd, "inv": inv, "xchg_fwd": fwd * stages,
            "xchg_inv": inv * stages}


def _ring(n: int, four: bool, device):
    from ..api import Ring

    return Ring(n, method="fourstep" if four else None, device=device)


def _operands(ring, batch: int, device):
    import torch

    gen = torch.Generator(device).manual_seed(ring.n + batch)
    return {name: ring.random_coeffs(gen, (batch,)) for name in "xab"}


def _args(op, xs):
    return (xs["a"], xs["b"]) if op == "polymul" else (xs["x"],)


def check_calls(plan) -> dict:
    """Each call of ``plan`` on this process's ``pod_mesh``: its words
    against the unsharded ring on this card and the plain version on the
    first rows, its launches against ``expected_launches`` (on a card).
    Raises on the first difference; returns what it saw."""
    import torch
    import torch.distributed as dist

    from ..ops import ntt_kernel as K
    from ..parallel import ShardedRing, comm, pod_mesh

    rank = dist.get_rank()
    seen = {"rank": rank, "backend": dist.get_backend(), "calls": []}
    for label, n, four, axes, kw, batch, ops in plan:
        mesh = pod_mesh(*axes)
        dev = mesh.home
        seen["device"] = str(dev)
        seen["staged"] = comm.stages_through_host(mesh.process_group, dev)
        ring = _ring(n, four, dev)
        plain = _ring(n, four, "cpu")
        sr = ShardedRing(ring, mesh, **kw)
        xs = _operands(ring, batch, dev)
        for op in ops:
            args = _args(op, xs)
            want = getattr(ring, op)(*args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            for key in K.LAUNCHES:
                K.LAUNCHES[key] = 0
            t0 = time.perf_counter()
            got = getattr(sr, op)(*args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            seconds = time.perf_counter() - t0
            launches = {k: v for k, v in K.LAUNCHES.items() if v}
            what = f"rank {rank} {label} {op} (B={batch})"
            if got.device != dev or not torch.equal(got, want):
                raise AssertionError(f"{what} differs from the unsharded ring")
            first = getattr(plain, op)(*(t[:PLAIN_ROWS].cpu() for t in args))
            if not torch.equal(got[:PLAIN_ROWS].cpu(), first):
                raise AssertionError(f"{what} differs from the plain version")
            want_launches = {k: v for k, v in expected_launches(
                op, four, axes, kw, batch).items() if v}
            if dev.type == "cuda" and launches != want_launches:
                raise AssertionError(f"{what} launched {launches}, not "
                                     f"{want_launches}")
            seen["calls"].append((label, op, batch, launches, seconds))
        del xs, got, want
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return seen


def _host_ms(call, dev) -> float:
    """Median of ``REPS`` host-clock times of ``call()`` (after one
    warm-up), each from a barrier and a synchronized card to every card
    synchronized, the largest over the processes."""
    import torch
    import torch.distributed as dist

    call()
    times = []
    for _ in range(REPS):
        dist.barrier()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize(dev)
        t = torch.tensor([time.perf_counter() - t0], dtype=torch.float64,
                         device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        times.append(t.item())
    return statistics.median(times) * 1e3


def time_calls(plan) -> list:
    """(label, call, sharded ms, transform-alone ms, unsharded ms at the
    plan's one-card batch, that batch) for each call of ``plan``."""
    import torch

    from ..parallel import ShardedRing, pod_mesh

    rows = []
    for label, n, four, axes, kw, batch, ops, one_batch in plan:
        mesh = pod_mesh(*axes)
        dev = mesh.home
        ring = _ring(n, four, dev)
        sr = ShardedRing(ring, mesh, **kw)
        xs = _operands(ring, batch, dev)
        one = _operands(ring, one_batch, dev)
        for op in ops:
            args, one_args = _args(op, xs), _args(op, one)
            full = _host_ms(lambda: getattr(sr, op)(*args), dev)
            alone = None
            if op in ("ntt", "intt"):
                grid = sr._split(xs["x"])
                transform = sr._ntt_grid if op == "ntt" else sr._intt_grid
                alone = _host_ms(lambda: transform(grid), dev)
                del grid
            base = _host_ms(lambda: getattr(ring, op)(*one_args), dev)
            rows.append((label, op, full, alone, base, one_batch))
        del xs, one
        torch.cuda.empty_cache()
    return rows


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def report_checks(results) -> dict:
    """Log each process's calls; returns the launches summed over them."""
    total = {}
    for seen in results:
        log(f"rank {seen['rank']} on {seen['device']} ({seen['backend']}"
            f"{', staged through pinned host memory' if seen['staged'] else ''}):")
        for label, op, batch, launches, seconds in seen["calls"]:
            log(f"  {label} {op} B={batch}: equal to Ring and the plain "
                f"version, launches {launches}, {seconds * 1e3:.3f} ms once "
                "(host clock)")
            for key, count in launches.items():
                total[key] = total.get(key, 0) + count
    return total


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--procs", type=int, default=4,
                        help="processes, one a card when the cards suffice")
    procs = parser.parse_args().procs
    if not torch.cuda.is_available():
        print("multihost_probe: needs a CUDA device", file=sys.stderr)
        return 2
    from ..ops import _build

    cards = torch.cuda.device_count()
    one_card = cards < procs
    backend = "gloo" if one_card else "nccl"
    log(f"card {card_line()}; {cards} card(s), {procs} processes on "
        f"{backend}" + (", every process on cuda:0, transfers staged "
                        "through pinned host memory" if one_card else ""))
    t0 = time.perf_counter()
    _build.build()  # before the processes start, so that they only load it
    log(f"build {time.perf_counter() - t0:.1f} s")
    plan = ONE_CARD_PLAN if one_card else FOUR_CARD_PLAN
    t0 = time.perf_counter()
    results = run_world(procs, backend, check_calls, plan, one_card=one_card)
    log(f"launches over the processes: {report_checks(results)}; checks "
        f"{time.perf_counter() - t0:.1f} s")
    if one_card:
        return 0
    t0 = time.perf_counter()
    rows = run_world(procs, backend, time_calls, TIME_PLAN)[0]
    log(f"times (host clock, barrier and every card synchronized around a "
        f"call, the largest over {procs} processes, median of {REPS}; ms):")
    for label, op, full, alone, base, one_batch in rows:
        log(f"  {label} {op}: {full:.4f}"
            + ("" if alone is None else f", transform alone {alone:.4f}")
            + f"; Ring on one card at B={one_batch} {base:.4f}")
    log(f"timing {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
