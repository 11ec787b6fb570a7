"""``ShardedRing``, ``ShardedRNSRing`` and the schemes' ``mesh=`` with one
process a card, checked and timed.

On a machine with cards, from the repository root:

    python3 -m agilex_ntt_tpu_torch.utils.multihost_probe [--procs N]

It builds the kernels, then spawns N processes (default 4) that start a
process group (``multihost.init_distributed`` on a ``file://`` store in a
temporary directory) and build ``pod_mesh`` meshes.  With at least N cards
the group runs NCCL, one process a card; with fewer (one card) it runs
gloo with every process on ``cuda:0`` and every transfer staged through
pinned host memory (``comm.stages_through_host``), since NCCL refuses two
processes on one card.  Each process:

  * runs ``check_world``: ``check_calls``, each call of the plan
    (``FOUR_CARD_PLAN``, or ``ONE_CARD_PLAN`` on one card) held word for
    word against the unsharded ``Ring`` on its card and, on the first
    rows, the plain version on the CPU, with its K1, K2 and K11 launches
    asserted; and ``check_rns`` on ``RNS_FOUR_CARD`` (dp=4, dp=2 x sp=2)
    or ``RNS_ONE_CARD`` (dp=2, sp=2): ``ShardedRNSRing``'s ring ops at
    "n4096" (L=3, 2048 rows a dp block), the "n16384" key switch (L=4,
    dnum=4, K=5, B=64), and CKKS multiply + rescale and rotate 1, BGV
    multiply and BFV multiply on that chain (B=64, t=65537) with a
    ``pod_mesh``, each against the unsharded ring or context on its card
    with the same seed, its launches a process recorded, the kernels each
    layout must launch asserted, and no allocation on another card;
  * with NCCL, runs ``time_calls`` on ``TIME_PLAN``: each call's time on
    the host clock, a barrier and ``torch.cuda.synchronize()`` around it,
    the largest over the processes, the median of 3; the transform alone
    (the grid transform, no gather of the result); and the unsharded
    ``Ring``'s call on one card;
  * on either backend, runs ``time_rns`` on the RNS plan: each call timed
    alike, beside the unsharded call on one card (on one card, by rank 0
    alone while the others wait).

``chip_smoke.py`` phase 3k runs ``run_world`` with ``check_world`` on
``ONE_CARD_PLAN`` and ``RNS_ONE_CARD`` (and, with four cards or more,
``FOUR_CARD_PLAN`` and ``RNS_FOUR_CARD``).
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
# ShardedRNSRing and the schemes with one process a card: RNS_OPS on
# RNSRing(RNS_N, RNS_L) at RNS_ROWS rows a dp block (base_convert into the
# next two primes, mod_down by 2), KS_OPS on the n16384 chain's key switch
# (dnum = KS_L, K = KS_L + 1, KS_BATCH rows), SCHEME_OPS on CKKS, BGV and
# BFV contexts of that chain (KS_BATCH ciphertexts, t = SCHEME_T).
# (label, pod_mesh (dp, sp), ShardedRNSRing and context axes, the kernels
# the layout must launch)
RNS_N, RNS_L, RNS_ROWS, RNS_K = 4096, 3, 2048, 2
RNS_OPS = ("ntt", "intt", "polymul", "polydot", "add", "base_convert",
           "rescale", "mod_down")
KS_N, KS_L, KS_BATCH, KS_STEPS = 16384, 4, 64, (5, 25)
KS_OPS = ("keyswitch", "hoisted_keyswitch")
SCHEME_T, SCHEME_SEED = 65537, 20261021
SCHEME_OPS = ("CKKS multiply+rescale", "CKKS rotate 1", "BGV multiply",
              "BFV multiply")
MULTI_PRIME = ("fwd_rns", "inv_rns", "polymul_rns", "polydot_rns")
STAGE_SP = ("fwd", "inv", "xchg_fwd", "xchg_inv")
RNS_ONE_CARD = (
    ("dp=2", (2, 1), {}, MULTI_PRIME),
    ("sp=2", (1, 2), dict(sp_axis="sp"), STAGE_SP),
)
RNS_FOUR_CARD = (
    ("dp=4", (4, 1), {}, MULTI_PRIME),
    ("dp=2 x sp=2", (2, 2), dict(sp_axis="sp"), STAGE_SP),
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


def _host_ms(call, dev, run: bool = True) -> float:
    """Median of ``REPS`` host-clock times of ``call()`` (after one
    warm-up), each from a barrier and a synchronized card to every card
    synchronized, the largest over the processes; a process with ``run``
    False only waits (the call of one process alone)."""
    import torch
    import torch.distributed as dist

    if run:
        call()
    times = []
    for _ in range(REPS):
        dist.barrier()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if run:
            call()
        torch.cuda.synchronize(dev)
        # gloo reduces host tensors
        t = torch.tensor([time.perf_counter() - t0], dtype=torch.float64,
                         device=dev if dist.get_backend() == "nccl" else "cpu")
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


def _channels(gen, qs, mult: int, shape, n: int, dev):
    """(L, *shape, n) uint32, channel l uniform in [0, mult q_l)."""
    import torch

    return torch.stack([
        torch.randint(0, mult * q, tuple(shape) + (n,), generator=gen,
                      device=dev, dtype=torch.int64) for q in qs
    ]).to(torch.uint32)


def _rns_calls(ring, batch: int, dev) -> dict:
    """RNS_OPS on ``ring``'s operands: by op, a function of the target (the
    unsharded ring or its ``ShardedRNSRing``)."""
    import torch

    from ..params import find_primes

    gen = torch.Generator(dev).manual_seed(ring.n + batch)
    qs, n = ring.qs, ring.n
    x, a, b = (_channels(gen, qs, 1, (batch,), n, dev) for _ in range(3))
    y = _channels(gen, qs, 2, (batch,), n, dev)  # the inverse's lazy range
    da, db = (_channels(gen, qs, 1, (batch, RNS_K), n, dev) for _ in range(2))
    dst = find_primes(n, RNS_L + 2)[RNS_L:]
    return {
        "ntt": lambda t: t.ntt(x), "intt": lambda t: t.intt(y),
        "polymul": lambda t: t.polymul(a, b),
        "polydot": lambda t: t.polydot(da, db),
        "add": lambda t: t.add(a, b),
        "base_convert": lambda t: t.base_convert(x, dst),
        "rescale": lambda t: t.rescale(x),
        "mod_down": lambda t: t.mod_down(x, 2),
    }


def _ks_calls(dev):
    """(the chain's ring, KS_OPS by op as functions of the target)."""
    import torch

    from ..api import RNSRing
    from ..params import find_primes

    primes = find_primes(KS_N, KS_L + 1)
    ring = RNSRing(KS_N, qs=primes[:KS_L], device=dev)
    ext = RNSRing(KS_N, qs=primes, device=dev)
    gen = torch.Generator(dev).manual_seed(KS_N + KS_BATCH)
    x = _channels(gen, ring.qs, 1, (KS_BATCH,), KS_N, dev)
    # coefficient-domain key material: (dnum, K, n), (steps, dnum, K, n)
    ksk = _channels(gen, ext.qs, 1, (KS_L,), KS_N, dev).movedim(0, 1)
    ksks = _channels(gen, ext.qs, 1, (len(KS_STEPS), KS_L), KS_N,
                     dev).movedim(0, 2)
    ksk, ksks = ksk.contiguous(), ksks.contiguous()
    return ring, {
        "keyswitch": lambda t: t.keyswitch(x, ksk, ext, KS_L),
        "hoisted_keyswitch": lambda t: t.hoisted_keyswitch(
            x, ksks, KS_STEPS, ext, KS_L),
    }


def _scheme_calls(mesh, sp_axis, dev) -> dict:
    """SCHEME_OPS: by name, (the unsharded context's call, the mesh
    context's).  Both contexts take a Generator of SCHEME_SEED, so every
    process draws the same keys; the mesh context's ciphertexts are the
    unsharded one's encryptions, placed (``place``)."""
    import numpy as np

    from ..schemes import BFVContext, BGVContext, CKKSContext

    calls = {}
    for name, cls, extra in (("CKKS", CKKSContext, {}),
                             ("BGV", BGVContext, dict(t=SCHEME_T)),
                             ("BFV", BFVContext, dict(t=SCHEME_T))):
        one = cls(KS_N, KS_L, rng=np.random.default_rng(SCHEME_SEED),
                  device=dev, **extra)
        sh = cls(KS_N, KS_L, rng=np.random.default_rng(SCHEME_SEED),
                 mesh=mesh, sp_axis=sp_axis, **extra)
        keys = one.keygen(galois_steps=(1,) if name == "CKKS" else ())
        rng = np.random.default_rng(SCHEME_SEED + 1)
        half = KS_N // 2
        if name == "CKKS":
            ms = [rng.uniform(-1, 1, (KS_BATCH, half))
                  + 1j * rng.uniform(-1, 1, (KS_BATCH, half))
                  for _ in range(2)]
        else:
            ms = [rng.integers(0, one.t, size=(KS_BATCH, 2, half))
                  for _ in range(2)]
        ca, cb = (one.encrypt(one.encode(m), keys) for m in ms)
        sa, sb = sh.place(ca), sh.place(cb)
        if name == "CKKS":
            calls["CKKS multiply+rescale"] = tuple(
                lambda c=c, u=u, v=v, k=keys: c.rescale(c.multiply(u, v, k))
                for c, u, v in ((one, ca, cb), (sh, sa, sb)))
            calls["CKKS rotate 1"] = tuple(
                lambda c=c, u=u, k=keys: c.rotate(u, 1, k)
                for c, u in ((one, ca), (sh, sa)))
        else:
            calls[f"{name} multiply"] = tuple(
                lambda c=c, u=u, v=v, k=keys: c.multiply(u, v, k)
                for c, u, v in ((one, ca, cb), (sh, sa, sb)))
    return calls


def _rns_plan_calls(layout, mesh) -> dict:
    """Every call of one layout of the RNS plan on ``mesh``, this process's
    ``pod_mesh`` of the layout: by name, (the unsharded call on this
    process's device, the sharded call)."""
    from ..api import RNSRing
    from ..parallel import ShardedRNSRing

    _, axes, kw, _ = layout
    dev = mesh.home
    ring = RNSRing(RNS_N, RNS_L, device=dev)
    sr = ShardedRNSRing(ring, mesh, **kw)
    calls = {f"RNSRing({RNS_N}, {RNS_L}) {op}": (lambda f=f: f(ring),
                                                 lambda f=f: f(sr))
             for op, f in _rns_calls(ring, RNS_ROWS * axes[0], dev).items()}
    ks_ring, ks = _ks_calls(dev)
    ks_sr = ShardedRNSRing(ks_ring, mesh, **kw)
    calls.update((f"n{KS_N} {op}", (lambda f=f: f(ks_ring),
                                    lambda f=f: f(ks_sr)))
                 for op, f in ks.items())
    calls.update(_scheme_calls(mesh, kw.get("sp_axis"), dev))
    return calls


def _same(got, want) -> bool:
    """Equal words (and, for a ciphertext, level and scale)."""
    import torch

    if isinstance(want, torch.Tensor):
        return bool(torch.equal(got, want))
    return ((got.level, got.scale) == (want.level, want.scale)
            and torch.equal(got.c0, want.c0) and torch.equal(got.c1, want.c1))


def check_rns(layouts) -> dict:
    """Each call of the RNS plan's ``layouts`` on this process's
    ``pod_mesh``: its words against the unsharded ring or context on this
    card, its launches (one call, this process); raises on the first
    difference, when a layout launched none of a kernel it must, and when
    this process allocated on a card other than its own."""
    import torch
    import torch.distributed as dist

    from ..ops import ntt_kernel as K
    from ..parallel import comm, pod_mesh

    rank = dist.get_rank()
    seen = {"rank": rank, "calls": [], "layouts": {}}
    for layout in layouts:
        label, axes, _, must = layout
        mesh = pod_mesh(*axes)
        dev = mesh.home
        calls = _rns_plan_calls(layout, mesh)
        seen["device"] = str(dev)
        seen["staged"] = comm.stages_through_host(mesh.process_group, dev)
        total = dict.fromkeys(K.LAUNCHES, 0)
        for name, (unsharded, sharded) in calls.items():
            want = unsharded()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            for key in K.LAUNCHES:
                K.LAUNCHES[key] = 0
            t0 = time.perf_counter()
            got = sharded()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            seconds = time.perf_counter() - t0
            launches = {k: v for k, v in K.LAUNCHES.items() if v}
            for k, v in launches.items():
                total[k] += v
            if not _same(got, want):
                raise AssertionError(f"rank {rank} {label} {name} differs "
                                     "from the unsharded call")
            seen["calls"].append((label, name, launches, seconds))
            del want, got
        missing = [k for k in must if total[k] < 1]
        if dev.type == "cuda" and missing:
            raise AssertionError(f"rank {rank} {label}: no {missing} launch")
        seen["layouts"][label] = {k: v for k, v in total.items() if v}
        del calls
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if dev.type == "cuda":
        others = [i for i in range(torch.cuda.device_count())
                  if i != dev.index and torch.cuda.max_memory_allocated(i)]
        if others:
            raise AssertionError(f"rank {rank} on {dev} allocated on the "
                                 f"cards {others}")
        seen["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return seen


def check_world(plan, layouts) -> dict:
    """``check_calls(plan)`` and ``check_rns(layouts)`` in one world."""
    return {"ring": check_calls(plan), "rns": check_rns(layouts)}


def time_rns(layouts, one_card: bool) -> list:
    """(layout, call, sharded ms, unsharded ms) for each call of the RNS
    plan's ``layouts``; the unsharded call on one card (with ``one_card``
    rank 0's alone)."""
    import torch
    import torch.distributed as dist

    from ..parallel import pod_mesh

    rows = []
    alone = not one_card or dist.get_rank() == 0
    for layout in layouts:
        mesh = pod_mesh(*layout[1])
        dev = mesh.home
        calls = _rns_plan_calls(layout, mesh)
        for name, (unsharded, sharded) in calls.items():
            full = _host_ms(sharded, dev)
            base = _host_ms(unsharded, dev, run=alone)
            rows.append((layout[0], name, full, base))
        del calls
        torch.cuda.empty_cache()
    return rows


def report_rns(results) -> dict:
    """Log each process's RNS-plan calls; returns the launches summed over
    the processes."""
    total = {}
    for seen in results:
        staged = " (staged through pinned host memory)" if seen["staged"] else ""
        log(f"rank {seen['rank']} on {seen['device']}{staged}, peak "
            f"{seen.get('peak_bytes', 0) / 2**30:.3f} GiB allocated on its "
            "card, none on another:")
        for label, name, launches, seconds in seen["calls"]:
            log(f"  {label} {name}: equal to the unsharded call, launches "
                f"{launches}, {seconds * 1e3:.3f} ms once (host clock)")
        for label, launches in seen["layouts"].items():
            log(f"  {label} launches: {launches}")
            for key, count in launches.items():
                total[key] = total.get(key, 0) + count
    return total


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
    layouts = RNS_ONE_CARD if one_card else RNS_FOUR_CARD
    t0 = time.perf_counter()
    results = run_world(procs, backend, check_world, plan, layouts,
                        one_card=one_card)
    log(f"launches over the processes: "
        f"{report_checks([r['ring'] for r in results])}; RNS plan "
        f"{report_rns([r['rns'] for r in results])}; checks "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows = run_world(procs, backend, time_rns, layouts, one_card,
                     one_card=one_card)[0]
    log(f"RNS plan times (host clock, barrier and every card synchronized "
        f"around a call, the largest over {procs} processes, median of "
        f"{REPS}; ms; the unsharded call on one card"
        + (", rank 0 alone" if one_card else "") + "):")
    for label, name, full, base in rows:
        log(f"  {label} {name}: {full:.4f}; unsharded {base:.4f}")
    log(f"RNS timing {time.perf_counter() - t0:.1f} s")
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
