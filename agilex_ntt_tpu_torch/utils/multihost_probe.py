"""``ShardedRing``, ``ShardedRNSRing`` and the schemes' ``mesh=`` on a mesh
of several processes, checked and timed.

On a machine with cards, from the repository root:

    python3 -m agilex_ntt_tpu_torch.utils.multihost_probe [--procs N]
        [--cards-per-proc C]

It builds the kernels, then spawns N processes (default 4) that start a
process group (``multihost.init_distributed`` on a ``file://`` store in a
temporary directory) and build ``pod_mesh`` and ``make_mesh`` meshes over
their devices (``LOCAL``: C cards a process, default 1).  With at least
N x C cards the group runs NCCL, process r on cards r C .. r C + C - 1;
with fewer (one card) it runs gloo with every process's C devices
``cuda:0`` and every transfer staged through pinned host memory
(``comm.stages_through_host``), since NCCL refuses two processes on one
card.  With C = 1 each process:

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

With N = 4 and four cards the same world then runs ``CH_FOUR_CARD``:
``ShardedRNSRing`` over ``make_mesh(ch=4)`` and ``make_mesh(ch=2, dp=2)``
(the n16384 chain's ring ops and key switch; K4a, K4b, K5 and K6b on each
process's channel block, the key switch's extended ring replicated over
ch) and ``make_mesh(ch=2, sp=2)`` (``RNSRing(2^16, 4)``'s four-step
transforms on ``chsp``), checked, then timed alike.  With C = 2 (N = 2)
the plans are ``PAIR_PLAN`` and ``RNS_PAIR``: ``pod_mesh(dp=2, sp=2)``,
each sp line inside a process (K11 reading its partner on the process's
other card; dp across the two), and on one card ``make_mesh(ch=2, dp=2)``
too.

``chip_smoke.py`` phase 3k runs ``run_world`` with ``check_world`` on
``ONE_CARD_PLAN`` and ``RNS_ONE_CARD``, and on ``PAIR_PLAN`` and
``RNS_PAIR`` with two devices ``cuda:0`` a process (and, with four cards
or more, ``FOUR_CARD_PLAN`` and ``RNS_FOUR_CARD`` + ``CH_FOUR_CARD`` on
four processes, and ``PAIR_PLAN`` and ``RNS_PAIR`` on two processes of
two cards).
"""

from __future__ import annotations

import argparse
import multiprocessing
import multiprocessing.connection
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
    ("dp=2", (2, 1), {}, MULTI_PRIME, "rns"),
    ("sp=2", (1, 2), dict(sp_axis="sp"), STAGE_SP, "rns"),
)
RNS_FOUR_CARD = (
    ("dp=4", (4, 1), {}, MULTI_PRIME, "rns"),
    ("dp=2 x sp=2", (2, 2), dict(sp_axis="sp"), STAGE_SP, "rns"),
)
# ShardedRNSRing's channel layouts across processes, and the layouts of
# two cards a process: (label, mesh: a (dp, sp) pod_mesh or make_mesh's
# axes, ShardedRNSRing and context axes, kernels the layout must launch,
# its calls: "rns" the RNS plan above, "chain" the n16384 chain's ring ops
# (RNS_OPS at KS_BATCH rows) and its key switch, "chsp" CHSP_OPS)
CH_KW = dict(ch_axis="ch", dp_axis=None)
CHSP_N, CHSP_L = 1 << 16, 4
CHSP_OPS = ("ntt", "intt", "polymul")
CH_FOUR_CARD = (
    ("ch=4", dict(ch=4), CH_KW, MULTI_PRIME, "chain"),
    ("ch=2 x dp=2", dict(ch=2, dp=2), dict(ch_axis="ch"), MULTI_PRIME,
     "chain"),
    ("ch=2 x sp=2", dict(ch=2, sp=2), dict(CH_KW, sp_axis="sp"),
     ("fwd_rns", "inv_rns"), "chsp"),
)
PAIR_PLAN = (
    ("Ring(32768) dp=2 x sp=2, each sp line in a process", 32768, False,
     (2, 2), dict(sp_axis="sp"), 1024, TRANSFORMS),
    ("Ring(32768) dp=2 x sp=2 overlap, each sp line in a process", 32768,
     False, (2, 2), dict(sp_axis="sp", sp_comm="overlap"), 1024,
     TRANSFORMS),
)
RNS_PAIR = (("dp=2 x sp=2, two cards a process", (2, 2), dict(sp_axis="sp"),
             STAGE_SP, "rns"),)
RNS_PAIR_ONE_CARD = RNS_PAIR + (
    ("ch=2 x dp=2, two devices a process", dict(ch=2, dp=2),
     dict(ch_axis="ch"), MULTI_PRIME, "chain"),)
PLAIN_ROWS = 2
REPS = 3
# this process's devices (``run_world``'s ``cards``), set in each process
LOCAL = None


def log(msg: str) -> None:
    print(f"multihost_probe: {msg}", flush=True)


def _entry(rank: int, world: int, backend: str, tmp: str, local,
           fn, args) -> None:
    """One process: start the group on its first device ``local[0]``, run
    ``fn(*args)``, keep its result."""
    global LOCAL
    import torch.distributed as dist

    from ..parallel import multihost

    LOCAL = local
    multihost.init_distributed(f"file://{tmp}/store", world, rank,
                               backend=backend, device=local[0])
    try:
        out = fn(*args)
        Path(tmp, f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    finally:
        dist.destroy_process_group()


def run_world(procs: int, backend: str, fn, *args, one_card: bool = False,
              cards: int = 1, timeout: float = 600.0) -> list:
    """``fn(*args)`` in each of ``procs`` spawned processes of one group on
    ``backend``, ``cards`` devices a process (process r on cards r cards ..
    r cards + cards - 1); their results in rank order.  A process that
    fails (its traceback on stderr) stops the others, and so does the
    timeout; then this raises.  ``one_card`` makes every device of every
    process ``cuda:0``."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        ps = [ctx.Process(target=_entry,
                          args=(r, procs, backend, tmp,
                                [f"cuda:{0 if one_card else r * cards + j}"
                                 for j in range(cards)], fn, args))
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


def expected_launches(op: str, four: bool, axes, kw, batch: int,
                      cards: int = 1, distinct: bool = True) -> dict:
    """The K1, K2 and K11 launches one process of ``cards`` devices
    (``distinct`` cards, or one card repeated) makes for one call.  With
    several devices a process, every sp line lies in one process (sp equal
    to ``cards``; the stage transform)."""
    from ..parallel import fourstep_shard, overlap

    dp, sp = axes
    rows = -(-batch // dp)
    fwd, inv = {"ntt": (1, 0), "intt": (0, 1), "polymul": (2, 1)}[op]
    overlapped = kw.get("sp_comm") == "overlap"
    if kw.get("sp_axis") is None:
        return {"fwd": fwd * cards, "inv": inv * cards}
    if cards > 1:
        if sp != cards or four:
            raise ValueError("several devices a process: the stage "
                             "transform, one sp line a process")
        # K1/K2 on each shard; K11 one launch a card a cross stage
        stages = (sp.bit_length() - 1) * (sp if distinct else 1)
        return {"fwd": fwd * sp, "inv": inv * sp, "xchg_fwd": fwd * stages,
                "xchg_inv": inv * stages}
    if four:
        chunks = fourstep_shard._num_chunks(rows) if overlapped else 1
        return {"fwd": 2 * fwd * chunks, "inv": 2 * inv * chunks}
    stages = (sp.bit_length() - 1) * (overlap.num_chunks(rows)
                                      if overlapped else 1)
    return {"fwd": fwd, "inv": inv, "xchg_fwd": fwd * stages,
            "xchg_inv": inv * stages}


def _mesh(spec):
    """A (dp, sp) ``pod_mesh`` or ``make_mesh(**spec)`` over this process's
    devices."""
    from ..parallel import make_mesh, pod_mesh

    if isinstance(spec, tuple):
        return pod_mesh(*spec, local_devices=LOCAL)
    return make_mesh(devices=LOCAL, **spec)


def _own_cards():
    return {int(str(d).split(":")[1]) for d in LOCAL}


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
    from ..parallel import ShardedRing, comm

    rank = dist.get_rank()
    seen = {"rank": rank, "backend": dist.get_backend(), "calls": []}
    for label, n, four, axes, kw, batch, ops in plan:
        mesh = _mesh(axes)
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
                op, four, axes, kw, batch, len(LOCAL),
                len(set(LOCAL)) == len(LOCAL)).items() if v}
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
    warm-up), each from a barrier and this process's synchronized cards
    to every card synchronized, the largest over the processes; a process
    with ``run`` False only waits (the call of one process alone)."""
    import torch
    import torch.distributed as dist

    def synchronize():
        for card in set(LOCAL):
            torch.cuda.synchronize(card)

    if run:
        call()
    times = []
    for _ in range(REPS):
        dist.barrier()
        synchronize()
        t0 = time.perf_counter()
        if run:
            call()
        synchronize()
        # gloo reduces host tensors
        t = torch.tensor([time.perf_counter() - t0], dtype=torch.float64,
                         device=dev if dist.get_backend() == "nccl" else "cpu")
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        times.append(t.item())
    return statistics.median(times) * 1e3


def time_calls(plan) -> list:
    """(label, call, sharded ms, transform-alone ms, unsharded ms at the
    plan's one-card batch, that batch, staging ms) for each call of
    ``plan``; with several cards a process, the staging of a forward
    transform's output blocks onto the process's first card for the
    gather (``Layout.gather``'s device copies), alone."""
    import torch

    from ..parallel import ShardedRing, shards

    rows = []
    for label, n, four, axes, kw, batch, ops, one_batch in plan:
        mesh = _mesh(axes)
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
            staging = None
            if op == "ntt" and len(set(LOCAL)) > 1:
                out = sr._ntt_grid(sr._split(xs["x"]))
                blocks = [b for row in out for b in row if b is not None]
                staging = _host_ms(lambda: torch.stack(
                    [shards.words(b).to(dev) for b in blocks]), dev)
                del out, blocks
            rows.append((label, op, full, alone, base, one_batch, staging))
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
    dst = find_primes(n, ring.L + 2)[ring.L:]
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


def _paired(label, ring, sr, calls) -> dict:
    """Each of ``calls`` (by op, a function of the target) as (the
    unsharded call, the sharded call), by ``label`` and op."""
    return {f"{label} {op}": (lambda f=f: f(ring), lambda f=f: f(sr))
            for op, f in calls.items()}


def _rns_plan_calls(layout, mesh) -> dict:
    """Every call of one layout of the RNS plan on ``mesh``, this process's
    mesh of the layout: by name, (the unsharded call on this process's
    device, the sharded call)."""
    from ..api import RNSRing
    from ..parallel import ShardedRNSRing

    _, spec, kw, _, kind = layout
    dev = mesh.home
    if kind == "chsp":
        ring = RNSRing(CHSP_N, CHSP_L, device=dev, method="fourstep")
        calls = _rns_calls(ring, KS_BATCH, dev)
        return _paired(f"RNSRing(2^16, {CHSP_L})", ring,
                       ShardedRNSRing(ring, mesh, **kw),
                       {op: calls[op] for op in CHSP_OPS})
    ks_ring, ks = _ks_calls(dev)
    ks_sr = ShardedRNSRing(ks_ring, mesh, **kw)
    if kind == "chain":
        calls = _paired(f"n{KS_N}", ks_ring, ks_sr,
                        _rns_calls(ks_ring, KS_BATCH, dev))
        calls.update(_paired(f"n{KS_N}", ks_ring, ks_sr, ks))
        return calls
    ring = RNSRing(RNS_N, RNS_L, device=dev)
    calls = _paired(f"RNSRing({RNS_N}, {RNS_L})", ring,
                    ShardedRNSRing(ring, mesh, **kw),
                    _rns_calls(ring, RNS_ROWS * mesh.shape["dp"], dev))
    calls.update(_paired(f"n{KS_N}", ks_ring, ks_sr, ks))
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
        label, spec, _, must, _ = layout
        mesh = _mesh(spec)
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
        own = _own_cards()
        others = [i for i in range(torch.cuda.device_count())
                  if i not in own and torch.cuda.max_memory_allocated(i)]
        if others:
            raise AssertionError(f"rank {rank} on {sorted(own)} allocated "
                                 f"on the cards {others}")
        seen["peak_bytes"] = sum(torch.cuda.max_memory_allocated(i)
                                 for i in own)
        seen["cards"] = sorted(own)
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

    rows = []
    alone = not one_card or dist.get_rank() == 0
    for layout in layouts:
        mesh = _mesh(layout[1])
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
            f"cards {seen.get('cards')}, none on another:")
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
    parser.add_argument("--cards-per-proc", type=int, default=1,
                        help="cards a process (2 runs PAIR_PLAN, RNS_PAIR)")
    args = parser.parse_args()
    procs, per = args.procs, args.cards_per_proc
    if not torch.cuda.is_available():
        print("multihost_probe: needs a CUDA device", file=sys.stderr)
        return 2
    from ..ops import _build

    cards = torch.cuda.device_count()
    one_card = cards < procs * per
    backend = "gloo" if one_card else "nccl"
    log(f"card {card_line()}; {cards} card(s), {procs} processes of {per} "
        f"device(s) on {backend}"
        + (", every device cuda:0, transfers staged through pinned host "
           "memory" if one_card else ""))
    t0 = time.perf_counter()
    _build.build()  # before the processes start, so that they only load it
    log(f"build {time.perf_counter() - t0:.1f} s")
    if per > 1:
        plan = PAIR_PLAN
        layouts = RNS_PAIR_ONE_CARD if one_card else RNS_PAIR
    else:
        plan = ONE_CARD_PLAN if one_card else FOUR_CARD_PLAN
        layouts = RNS_ONE_CARD if one_card else RNS_FOUR_CARD
        if not one_card and procs == 4:
            layouts += CH_FOUR_CARD
    world = dict(one_card=one_card, cards=per)
    t0 = time.perf_counter()
    results = run_world(procs, backend, check_world, plan, layouts, **world)
    log(f"launches over the processes: "
        f"{report_checks([r['ring'] for r in results])}; RNS plan "
        f"{report_rns([r['rns'] for r in results])}; checks "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows = run_world(procs, backend, time_rns, layouts, one_card, **world)[0]
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
    time_plan = (tuple(entry + (entry[5],) for entry in PAIR_PLAN)
                 if per > 1 else TIME_PLAN)
    rows = run_world(procs, backend, time_calls, time_plan, **world)[0]
    log(f"times (host clock, barrier and every card synchronized around a "
        f"call, the largest over {procs} processes, median of {REPS}; ms):")
    for label, op, full, alone, base, one_batch, staging in rows:
        log(f"  {label} {op}: {full:.4f}"
            + ("" if alone is None else f", transform alone {alone:.4f}")
            + ("" if staging is None else
               f", staging its blocks on its first card {staging:.4f}")
            + f"; Ring on one card at B={one_batch} {base:.4f}")
    log(f"timing {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
