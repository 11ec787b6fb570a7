"""The cross-device stage (K11) and the DIT inverse (K12) as the package
ships them, timed on the card so that two checkouts can be timed alike.

On a machine with a card, from the repository root:

    python3 -m agilex_ntt_tpu_torch.utils.xchg_probe [--cards N]

It needs only ``Ring``, ``ShardedRing``, ``make_mesh``,
``ntt_kernel.xchg_step``, ``ntt_kernel.dit_inv_core``,
``parallel/overlap.py::xchg_stage`` and ``ops/dit_inv.py``: a copy of this
file dropped into an older checkout times that checkout's kernels alike.
It prints, beside the card's name and power limit:

  * K11 by its device time (``torch.profiler``, the kernels whose name
    holds ``xchg``): one shard's half (512, 8192) forward and inverse, and
    one cross stage of one sp group of 4 such shards on one card as the
    checkout's ``overlap.xchg_stage`` runs it, with the launches it takes;
  * ``ShardedRing(Ring(32768))`` over dp=2 x sp=4 on one card at B=1024,
    ``ntt`` and ``intt`` with each ``sp_comm``: the call time (CUDA events,
    median of 5 runs of 4 calls), K11's launches a call (``LAUNCHES``) and
    K11's and all kernels' device time a call (``torch.profiler``);
  * K12 (``dit_inv_core``) and ``inv_ntt_dit`` at (8192, 4096) on CUDA
    events, and K12's device time;
  * with ``--cards N`` (N >= 2 cards) the same ``ShardedRing`` over sp=N on
    N distinct cards at B=1024 and 8192 instead: the call time (host clock
    around 4 calls, every card synchronized, median of 5) and K11's
    launches and device time a call, summed over the cards.

The outputs are held against the plain versions (K11, K12) and ``Ring``
(the sharded calls) on the way.
"""

from __future__ import annotations

import argparse
import inspect
import re
import statistics
import subprocess
import sys
import time

ROWS, WIDTH, SP, DP = 512, 8192, 4, 2
SHARD_N, SHARD_BATCH = 32768, 1024
DIT_N, DIT_BATCH = 4096, 8192
XCHG = re.compile(r"xchg")
CARD_BATCHES = (1024, 8192)


def log(msg: str) -> None:
    print(f"xchg_probe: {msg}", flush=True)


def sync_all(torch) -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def profiled(torch, call, pattern=None, reps: int = 10):
    """(device ms a call, launches a call) of the kernels matching
    ``pattern`` (every kernel when None), summed over the cards, over
    ``reps`` calls after a warm-up; (nan, nan) when the profiler records
    no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        call()
    sync_all(torch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        sync_all(torch)
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and (pattern is None or pattern.search(e.key))]
    if not hits:
        return float("nan"), float("nan")
    return (sum(e.self_device_time_total for e in hits) / 1e3 / reps,
            sum(e.count for e in hits) / reps)


def event_ms(torch, call, reps: int = 5, inner: int = 4) -> float:
    """Median time of one call on CUDA events around ``inner`` calls."""
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(inner):
            call()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def host_ms(torch, call, reps: int = 5, inner: int = 4) -> float:
    """Median time of one call on the host's clock around ``inner`` calls,
    every card synchronized."""
    for _ in range(2):
        call()
    sync_all(torch)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            call()
        sync_all(torch)
        times.append((time.perf_counter() - t0) * 1e3 / inner)
    return statistics.median(times)


def sharded_calls(torch, K, ring, mesh, sx, batch, timer, label) -> None:
    """``ShardedRing(ring)`` on ``mesh`` with each ``sp_comm``: ``ntt`` and
    ``intt`` of ``sx`` held against ``ring``'s, timed by ``timer``, with
    K11's launches and device time a call."""
    from agilex_ntt_tpu_torch.parallel import ShardedRing

    want = {"ntt": ring.ntt(sx), "intt": ring.intt(sx)}
    for comm in ("ppermute", "overlap"):
        kw = dict(dp_axis=None) if "dp" not in mesh.shape else {}
        sr = ShardedRing(ring, mesh, sp_axis="sp", sp_comm=comm, **kw)
        for what in ("ntt", "intt"):
            fn = getattr(sr, what)
            sync_all(torch)
            before = dict(K.LAUNCHES)
            out = fn(sx)
            sync_all(torch)
            if not torch.equal(out, want[what]):
                raise AssertionError(f"ShardedRing.{what} ({comm}) differs")
            launches = sum(K.LAUNCHES[k] - before[k]
                           for k in ("xchg_fwd", "xchg_inv"))
            call = timer(torch, lambda: fn(sx))
            x_ms, _ = profiled(torch, lambda: fn(sx), XCHG, reps=5)
            all_ms, all_n = profiled(torch, lambda: fn(sx), reps=5)
            log(f"ShardedRing.{what} ({comm}, {label}, B={batch}): "
                f"{call:.4f} ms a call, {launches} K11 launches, K11 "
                f"{x_ms:.4f} ms of {all_ms:.4f} ms device time "
                f"({all_n:g} kernel launches)")
        del sr


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cards", type=int, default=1,
                        help="time the sharded ring over this many cards")
    cards = parser.parse_args().cards
    if not torch.cuda.is_available() or torch.cuda.device_count() < cards:
        print(f"xchg_probe: needs {cards} CUDA device(s)", file=sys.stderr)
        return 2
    from agilex_ntt_tpu_torch import Ring
    from agilex_ntt_tpu_torch.ops import dit_inv as D
    from agilex_ntt_tpu_torch.ops import ntt_kernel as K
    from agilex_ntt_tpu_torch.ops import plain_ntt as P
    from agilex_ntt_tpu_torch.parallel import make_mesh, overlap

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card {card}; {cards} card(s)")
    gen = torch.Generator(dev).manual_seed(7)

    def rand(bound, shape):
        return torch.randint(0, bound, shape, generator=gen, dtype=torch.int64,
                             device=dev)

    ring = Ring(SHARD_N, device=dev)
    if cards > 1:
        # the sharded ring across distinct cards
        mesh = make_mesh(sp=cards, devices=[f"cuda:{i}" for i in range(cards)])
        for batch in CARD_BATCHES:
            sharded_calls(torch, K, ring, mesh, ring.random_coeffs(
                gen, (batch,)), batch, host_ms, f"sp={cards} on {cards} cards")
        return 0

    # K11: one shard's half, and one stage of a group of SP shards as the
    # checkout's overlap route runs it on one card
    q = ring.q
    xs = [rand(2 * q, (ROWS, WIDTH)) for _ in range(SP)]
    w = rand(q, (WIDTH,))
    wp = (w << 32) // q
    x32 = [v.to(torch.uint32) for v in xs]
    w32, wp32 = w.to(torch.uint32), wp.to(torch.uint32)
    rows = [(w32, wp32)] * SP
    roles = [d % 2 == 0 for d in range(SP)]
    for fwd in (True, False):
        kind = "fwd" if fwd else "inv"
        got = K.xchg_step(x32[0], x32[1], w32, wp32, q=q, fwd=fwd, is_u=False)
        want = (P.fwd_stage_step_plain(xs[0], xs[1], False, w, wp, q) if fwd
                else P.inv_stage_step_plain(xs[0], xs[1], False, w, wp, q))
        if not torch.equal(got.to(torch.int64), want):
            raise AssertionError(f"K11 {kind} differs from its plain version")
        ms, n = profiled(torch, lambda: K.xchg_step(
            x32[0], x32[1], w32, wp32, q=q, fwd=fwd, is_u=False), XCHG)
        log(f"K11 {kind} shard's half ({ROWS}, {WIDTH}): {ms:.4f} ms device "
            f"time, {n:g} launches")
        kw = (dict(kind=kind)
              if "kind" in inspect.signature(overlap.xchg_stage).parameters
              else dict(fwd=fwd))

        def stage():
            overlap.xchg_stage(x32, rows, roles, tdev=1, q=q, **kw)
        ms, n = profiled(torch, stage, XCHG)
        log(f"K11 {kind} overlap stage of {SP} shards ({ROWS}, {WIDTH}): "
            f"{ms:.4f} ms device time, {n:g} launches; "
            f"{event_ms(torch, stage):.4f} ms a call on CUDA events")
    del xs, x32

    # the sharded ring on one card
    sharded_calls(torch, K, ring, make_mesh(dp=DP, sp=SP,
                                            devices=["cuda:0"] * (DP * SP)),
                  ring.random_coeffs(gen, (SHARD_BATCH,)), SHARD_BATCH,
                  event_ms, f"dp={DP} x sp={SP} on one card")

    # K12 and the DIT inverse
    ring = Ring(DIT_N, device=dev)
    y = rand(2 * ring.q, (DIT_BATCH, DIT_N))
    dt = D._dit_tables(ring.params, dev)
    y32 = y.to(torch.uint32)
    if not torch.equal(K.dit_inv_core(y32, dt).to(torch.int64),
                       P.dit_inv_core_plain(y, dt)):
        raise AssertionError("K12 differs from its plain version")
    del y
    core = event_ms(torch, lambda: K.dit_inv_core(y32, dt), inner=10)
    full = event_ms(torch, lambda: D.inv_ntt_dit(y32, ring.params), inner=10)
    dev_ms, _ = profiled(torch, lambda: K.dit_inv_core(y32, dt))
    log(f"K12 ({DIT_BATCH}, {DIT_N}): {core:.4f} ms (CUDA events), "
        f"{dev_ms:.4f} ms device time; inv_ntt_dit {full:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
