"""Timing and tracing on the card.

Counterpart of ``agilex_ntt_tpu/utils/profiling.py``:

  * ``cuda_time_ms(fn)``: the median device time of one ``fn()`` call,
    between CUDA events around back-to-back calls.
  * ``device_time(fn, x)``: seconds a call of ``y = fn(y)`` by the
    chained-call delta method (1 + iters chained calls minus one call).
  * ``trace(log_dir)``: a ``torch.profiler`` trace of the enclosed block,
    exported as a Chrome trace.
  * ``device_time_profiled(fn, x)``: seconds a call of ``y = fn(y)`` from
    the device events of such a trace (``_trace_per_call_seconds``).
  * ``device_breakdown``, ``kernels_seen``, ``kernel_share``: where one
    call's device time goes, by kernel, from ``torch.profiler``.

The JAX module's ``dump_hlo`` and ``under_trace`` have no counterpart: the
port has no XLA and runs eagerly.  Every helper here that times needs a
card and raises without one; none falls back to the CPU.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import re
import statistics
import tempfile
import time
from collections import defaultdict
from typing import Callable, Optional

# names of csrc/ntt_kernels.cu's NTT kernels, demangled or not
OUR_KERNEL = re.compile(
    r"(?<![A-Za-z_])(fwd4|inv4|polymul4|col_fwd4|col_inv4"
    r"|fwd4_cluster|inv4_cluster|polymul4_cluster|col_fwd4_slab"
    r"|col_inv4_slab|polydot_rns_cluster|fwd_rns_cluster|inv_rns_cluster"
    r"|dit_inv_cluster|xchg_group)_kernel")
# the exchange kernel K11
XCHG_KERNEL = re.compile(r"(?<![A-Za-z_])xchg_group_kernel")

# categories of device-side events in torch.profiler's Chrome trace: kernels
# and the copies and fills of memory; everything else there (CPU ops, CUDA
# runtime calls such as cudaLaunchKernel, annotations, flows) is host-side
# or spans other events
DEVICE_CATEGORIES = frozenset(("kernel", "gpu_memcpy", "gpu_memset"))


def _need_card(what: str):
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} needs a CUDA device")
    return torch


def cuda_time_ms(
    fn: Callable[[], object], *, warmup: int = 3, reps: int = 5, inner: int = 10
) -> float:
    """Median device time of one ``fn()`` call in milliseconds.

    Warms ``fn`` up, then times ``reps`` runs of ``inner`` back-to-back
    calls, each run between a pair of CUDA events.  PyTorch returns before
    the device finishes, so a host clock would time the enqueue; the events
    time the device, and back-to-back calls hide the host's launch cost
    behind the previous call's work as a caller's stream of calls would."""
    torch = _need_card("cuda_time_ms")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _chain(fn: Callable, x, k: int):
    v = x
    for _ in range(k):
        v = fn(v)
    return v


def device_time(fn: Callable, x, iters: int = 10, trials: int = 3) -> float:
    """Seconds a call of ``y = fn(y)`` on the card, without the constant
    launch and synchronisation cost: the delta method, (1 + ``iters``
    chained calls minus one call) / ``iters``, each call's input the
    previous output so that nothing overlaps, each run ended by
    ``torch.cuda.synchronize()``.

    Host stalls are one-sided noise, so the one-call and the chained
    samples are each the least of ``trials`` before they are subtracted:
    subtracting one stalled baseline from a clean chained sample would
    understate the time."""
    torch = _need_card("device_time")

    def run(k):
        _chain(fn, x, k)
        torch.cuda.synchronize()

    run(1)  # warm up: the kernels' first-use build and any caches

    def sample(k):
        best = float("inf")
        for _ in range(trials):
            t0 = time.perf_counter()
            run(k)
            best = min(best, time.perf_counter() - t0)
        return best

    t_one = sample(1)
    t_many = sample(1 + iters)
    return max((t_many - t_one) / iters, 1e-9)


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the enclosed block (CPU and, with a
    card, CUDA activity), exported on exit as the Chrome trace
    ``log_dir/trace.json``.  Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _is_device_event(e: dict) -> bool:
    return e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES


def _trace_per_call_seconds(tr: dict, iters: Optional[int] = None
                            ) -> Optional[float]:
    """Seconds a call from a loaded Chrome trace of ``torch.profiler``
    (pure parser, tested on synthetic traces in
    ``tests/test_torch_tooling.py``).  The rules:

    1. **Device events only**, chosen by their category (``kernel``,
       ``gpu_memcpy``, ``gpu_memset``).  The host-side events of the same
       trace (``cudaLaunchKernel`` and the other runtime calls, the aten
       operations, annotations) time the enqueue, not the card.
    2. **Top-level events only**, a stream at a time (the event's pid is the
       device, its tid the stream): an event that an earlier-starting kept
       event on its stream covers is dropped, and identical spans keep one.
       So overlapping events on one stream count once.
    3. **Each name normalised by its captured count**, then summed, so that
       a path of several kernels counts every one of them even when the
       profiler lost trailing events of some.
    4. **Names seen once are per run, not per call**, and are left out; if
       no name repeats, the dominant event is the answer.
    5. **Several launches of one kernel a call**: with ``iters`` (the chained
       calls traced), a second accounting divides the total busy time of
       the repeated names by ``iters``; both accountings are lower bounds,
       and the larger is returned.

    Returns ``None`` when the trace holds no device event: the profiler
    recorded nothing (as it did after a profile of some 76000 launches).
    """
    by_stream: defaultdict[tuple, list] = defaultdict(list)
    for e in tr.get("traceEvents", []):
        if _is_device_event(e):
            by_stream[(e.get("pid"), e.get("tid"))].append(
                (float(e.get("ts", 0.0)), -float(e.get("dur", 0.0)),
                 str(e.get("name", ""))))
    if not by_stream:
        return None
    # per stream, sweep by (start asc, duration desc): an event that ends
    # at or before the latest end of the kept events is covered by one of
    # them (they all started no later) and is dropped
    totals: defaultdict[str, list] = defaultdict(lambda: [0.0, 0])
    for events in by_stream.values():
        events.sort()
        max_end = float("-inf")
        for ts, neg_dur, name in events:
            end = ts - neg_dur
            if end <= max_end:
                continue
            max_end = end
            t = totals[name]
            t[0] += -neg_dur
            t[1] += 1
    per_call = {n: t[0] / t[1] for n, t in totals.items() if t[1] > 1}
    if not per_call:  # nothing repeated: the dominant event
        busy_us, count = max(totals.values(), key=lambda t: t[0])
        return busy_us * 1e-6 / count
    per_name = sum(per_call.values())
    if not iters:
        return per_name * 1e-6
    per_chain = sum(t[0] for t in totals.values() if t[1] > 1) / iters
    return max(per_name, per_chain) * 1e-6


def _load_trace(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def device_time_profiled(fn: Callable, x, iters: int = 8,
                         log_dir: Optional[str] = None) -> Optional[float]:
    """Device seconds a call of ``y = fn(y)`` from a ``torch.profiler``
    trace of ``iters`` chained calls, by the rules of
    ``_trace_per_call_seconds``: the card's own timestamps, which no host
    stall can stretch.  The trace is kept in ``log_dir`` when given.

    Returns ``None`` when the profiler recorded no device event; callers
    report that outcome.  On the H100 machine a process's one-launch
    profiles recorded no kernel once about a minute had passed since its
    first profile, while this one kept recording
    (``utils/profiler_probe.py``)."""
    torch = _need_card("device_time_profiled")
    _chain(fn, x, 1)  # warm up
    torch.cuda.synchronize()
    ctx = (tempfile.TemporaryDirectory() if log_dir is None
           else contextlib.nullcontext(log_dir))
    with ctx as d:
        with trace(d):
            _chain(fn, x, iters)
        tr = _load_trace(os.path.join(d, "trace.json"))
    return _trace_per_call_seconds(tr, iters=iters)


def _profile_once(call):
    """``torch.profiler``'s ``key_averages()`` of one ``call()`` after a
    warm-up call."""
    torch = _need_card("the profiler helpers")
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return prof.key_averages()


def _device_kernels(events):
    from torch.autograd import DeviceType

    return [e for e in events if e.self_device_time_total > 0
            and e.device_type == DeviceType.CUDA]


def device_breakdown(call, what: str, call_ms: float, top: int = 5,
                     log=print):
    """Where one call's device time goes, from ``torch.profiler``: the
    kernels' device time (each kernel counted once, by its own event),
    split into this repository's NTT kernels and the PyTorch operations
    around them, against ``call_ms``, the call's unprofiled time on CUDA
    events; and the PyTorch operations that launched the most of it.
    Returns the names of the kernels that ran."""
    from torch.autograd import DeviceType

    events = [e for e in _profile_once(call) if e.self_device_time_total > 0]
    kernels = _device_kernels(events)
    if not kernels:
        log(f"  {what}: the profiler recorded no device time")
        return []
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
    return [e.key for e in kernels]


def kernels_seen(call):
    """(name, launches, device ms) of each kernel one call launched, from
    ``torch.profiler``; empty when the profiler records no device time."""
    return [(e.key[:70], e.count, e.self_device_time_total / 1e3)
            for e in _device_kernels(_profile_once(call))]


def kernel_share(call, what: str, log=print) -> None:
    """K11's launches and share of one call's device time
    (``torch.profiler``), beside the call's other kernels."""
    kernels = _device_kernels(_profile_once(call))
    if not kernels:
        log(f"  {what}: the profiler recorded no device time")
        return
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    xchg = [e for e in kernels if XCHG_KERNEL.search(e.key)]
    x_ms = sum(e.self_device_time_total for e in xchg) / 1e3
    log(f"  {what}: K11 {sum(e.count for e in xchg)} launches, {x_ms:.4f} ms "
        f"= {x_ms / busy:.1%} of {busy:.4f} ms device time "
        f"({sum(e.count for e in kernels)} kernel launches in all)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]:
        log(f"    {e.key[:60]:60s} {e.count:5d} x, "
            f"{e.self_device_time_total / 1e3:.4f} ms")
