"""Measured choice of a ring's route, with a persisted per-device cache.

Counterpart of ``agilex_ntt_tpu/utils/autotune.py``.  ``Ring`` has a static
default route: the radix-2 kernels (K1, K2, K3) up to n = 32768, the
four-step kernels (K7a, K7b, K8, or K9 and the row pass) above.  Between
n = 2^14 and 2^15 both routes exist, and which is faster is a property of
the card, not of the code.  ``tune()`` times every candidate for an (op, n,
batch) workload on the card and keeps the fastest in a JSON cache keyed by
the card's name, so the timing runs once per kind of card; ``Ring(n,
method="auto")`` reads that cache (``cached_config``) and takes the static
default on a miss.

**The candidate space is the port's routes**: ``{"method": "radix2"}`` for
n <= 32768 and ``{"method": "fourstep"}`` from n = 2^14 (where both factors
of the four-step split reach 128).  The JAX package's other candidates do
not exist here: its ``backend`` (Pallas or XLA) and ``block_rows`` choose
and tile its TPU kernels, and the port has one hand-written kernel a route
with its launch shape fixed by n (``ops/ntt_kernel.py``), so the port's
rings refuse both arguments.  Its ``fourstep_kernel="flat"`` is not a
candidate either: on the card the flat (B, n) and the tiled (B, n1, n2)
layouts are the same bytes and run the same kernels (``api.py``'s
``FLAT_FUSE_MAX_N``), so timing both would time one route twice.

The cache is this package's own (``~/.cache/agilex_ntt_tpu_torch/
autotune.json``, or ``$NTT_TORCH_AUTOTUNE_CACHE``), in the JAX package's
layout: ``{device: {"op|n=N|b=B|qbits=Q": {"config": {...}, "seconds":
t}}}``, written by an atomic replace.

Typical use::

    from agilex_ntt_tpu_torch.utils import autotune
    ring = autotune.tuned_ring(16384, batch=2048, op="ntt")

Command line (one JSON line per op)::

    python -m agilex_ntt_tpu_torch.utils.autotune 16384 2048 --op ntt
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Dict, List, Optional

import torch

from ..api import MAX_RADIX2_N, Ring, RNSRing, _resolve_device
from ..params import find_primes
from .profiling import device_time

#: Ring arguments a candidate or cached config may carry; anything else in
#: a cache entry is ignored.
_CONFIG_KEYS = ("method",)

_OPS = ("ntt", "intt", "polymul")
#: the fused scheme ops ``tune_scheme`` times
_SCHEME_OPS = ("tensor", "keyswitch")

#: the smallest n with a four-step candidate
MIN_FOURSTEP_N = 1 << 14


def default_cache_path() -> str:
    env = os.environ.get("NTT_TORCH_AUTOTUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "agilex_ntt_tpu_torch", "autotune.json")


def device_key(device=None) -> str:
    """The cache's namespace: the card's name (``torch.cuda.
    get_device_name``), so that a config tuned on one H100 serves every
    H100; ``"cpu"`` for a CPU device and on a host without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(dev)


def candidate_configs(n: int) -> List[Dict]:
    """Every route of ``Ring(n)``, the radix-2 one first."""
    out: List[Dict] = []
    if n <= MAX_RADIX2_N:
        out.append({"method": "radix2"})
    if n >= MIN_FOURSTEP_N:
        out.append({"method": "fourstep"})
    return out


def _op_timer(ring: Ring, op: str) -> Callable:
    """``y = f(y)`` form of ``op`` for the delta-method timer (each call's
    input is the previous output, so calls cannot overlap)."""
    if op == "ntt":
        return lambda v: ring.ntt(v)
    if op == "intt":
        return lambda v: ring.intt(v)
    if op == "polymul":
        return lambda v: ring.polymul(v, v)
    raise ValueError(f"unknown op {op!r}; expected one of {_OPS}")


def _load_cache(path: str) -> Dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _store_cache(path: str, cache: Dict) -> None:
    folder = os.path.dirname(path) or "."
    os.makedirs(folder, exist_ok=True)
    # an atomic replace: concurrent tuners never leave half-written JSON
    fd, tmp = tempfile.mkstemp(dir=folder)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(cache, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _cache_key(op: str, n: int, batch: int, q: int) -> str:
    return f"{op}|n={n}|b={batch}|qbits={q.bit_length()}"


def _config(entry: Dict) -> Dict:
    return {k: entry["config"][k] for k in _CONFIG_KEYS if k in entry["config"]}


def cached_config(n: int, q: int, op: str = "ntt", *,
                  cache_path: Optional[str] = None,
                  device=None) -> Optional[Dict]:
    """The cached config for (op, n, bits of q) on ``device``'s kind, or
    None on a miss.  ``Ring(..., method="auto")`` reads this when it is
    built (no timing, no work on the card); the batch is not known then,
    so among cached batches the largest wins.  Entries are written by
    ``tune()``."""
    entries = _load_cache(cache_path or default_cache_path()).get(
        device_key(device), {})
    prefix, suffix = f"{op}|n={n}|b=", f"|qbits={q.bit_length()}"
    best_batch, hit = -1, None
    for key, val in entries.items():
        if not (key.startswith(prefix) and key.endswith(suffix)):
            continue
        try:
            batch = int(key[len(prefix):-len(suffix)])
        except ValueError:
            continue
        if batch > best_batch:
            best_batch, hit = batch, val
    return None if hit is None else _config(hit)


def _default_timer(fn, x, iters):
    return min(device_time(fn, x, iters=iters) for _ in range(3))


def _pick(results: List[Dict], what: str) -> Dict:
    alive = [r for r in results if r["seconds"] is not None]
    if not alive:
        raise RuntimeError(f"no candidate config survived for {what}: "
                           + "; ".join(str(r.get("error")) for r in results))
    return min(alive, key=lambda r: r["seconds"])


def _cached(path: str, dev: str, key: str) -> Optional[Dict]:
    hit = _load_cache(path).get(dev, {}).get(key)
    if hit is None:
        return None
    return {"config": _config(hit), "seconds": hit.get("seconds"),
            "tuned": False, "candidates": []}


def _persist(path: str, dev: str, key: str, best: Dict) -> None:
    cache = _load_cache(path)
    cache.setdefault(dev, {})[key] = {"config": best["config"],
                                      "seconds": best["seconds"]}
    _store_cache(path, cache)


def tune(n: int, batch: int, op: str = "ntt", *, q: Optional[int] = None,
         iters: int = 8, timer: Optional[Callable] = None,
         cache_path: Optional[str] = None, use_cache: bool = True,
         refresh: bool = False, device=None) -> Dict:
    """The fastest route of ``Ring(n, q)`` for (op, batch) on ``device``
    (the card by default)::

        {"config": {"method": ...}, "seconds": t, "tuned": bool,
         "candidates": [{"config": ..., "seconds": ...}, ...]}

    Each of ``candidate_configs(n)`` is timed by ``timer(fn, x, iters)``
    (default: the least of three ``profiling.device_time`` runs, each of
    which warms the call up first, so the kernels' first-use build counts
    in no candidate's time) on a (batch, n) input drawn from a fixed seed.
    The winner is kept under (device, op, n, batch, bits of q); a cache hit
    times nothing (``tuned=False``, no candidates).  A candidate that fails
    is recorded with ``seconds=None`` and its error, and the others decide;
    if all fail, ``RuntimeError``."""
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}; expected one of {_OPS}")
    dev_t = _resolve_device(device)
    q = find_primes(n, 1)[0] if q is None else q
    path = cache_path or default_cache_path()
    dev, key = device_key(dev_t), _cache_key(op, n, batch, q)
    if use_cache and not refresh:
        hit = _cached(path, dev, key)
        if hit is not None:
            return hit
    time_fn = timer or _default_timer
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(0, q, (batch, n), generator=gen, dtype=torch.int64)
    x = x.to(torch.uint32).to(dev_t)
    results = []
    for cfg in candidate_configs(n):
        try:
            ring = Ring(n, q, device=dev_t, **cfg)
            t = float(time_fn(_op_timer(ring, op), x, iters))
        except Exception as e:  # recorded, and the candidate is out
            results.append({"config": cfg, "seconds": None, "error": repr(e)})
            continue
        results.append({"config": cfg, "seconds": t})
    best = _pick(results, f"op={op} n={n} batch={batch}")
    if use_cache:
        _persist(path, dev, key, best)
    return {"config": dict(best["config"]), "seconds": best["seconds"],
            "tuned": True, "candidates": results}


def tune_scheme(op: str, n: int, batch: int, *, L: int = 3, dnum: int = 3,
                iters: int = 8, timer: Optional[Callable] = None,
                cache_path: Optional[str] = None, use_cache: bool = True,
                refresh: bool = False, device=None) -> Dict:
    """The fastest route of an ``RNSRing`` for a fused scheme op at L
    primes: ``"tensor"`` (the ciphertext tensor product) or
    ``"keyswitch"`` (the hybrid key switch of ``dnum`` digits into the
    basis of L + 1 primes), over the same space as ``tune``.  Winners are
    kept under ``op|n=|b=|L=|dnum=``, apart from the single-op entries that
    ``Ring(method="auto")`` reads."""
    import numpy as np

    if op not in _SCHEME_OPS:
        raise ValueError(f"unknown scheme op {op!r}; expected {_SCHEME_OPS}")
    dev_t = _resolve_device(device)
    qs_all = find_primes(n, L + 1)
    path = cache_path or default_cache_path()
    dev, key = device_key(dev_t), f"{op}|n={n}|b={batch}|L={L}|dnum={dnum}"
    if use_cache and not refresh:
        hit = _cached(path, dev, key)
        if hit is not None:
            return hit
    time_fn = timer or _default_timer
    rng = np.random.default_rng(0)
    x_np = rng.integers(0, min(qs_all[:L]), size=(L, batch, n), dtype=np.uint32)
    ksk_np = np.stack([np.stack([rng.integers(0, q, size=n, dtype=np.uint32)
                                 for q in qs_all]) for _ in range(dnum)])
    results = []
    for cfg in candidate_configs(n):
        try:
            rq = RNSRing(n, qs=qs_all[:L], device=dev_t, **cfg)
            x = rq._as_u32(x_np)
            if op == "tensor":
                fn = lambda v: rq.tensor(v, x, x, x)[0]  # noqa: E731
            else:
                rqp = RNSRing(n, qs=qs_all, device=dev_t, **cfg)
                ksk = rqp._as_u32(ksk_np)
                fn = lambda v: rq.keyswitch(v, ksk, rqp, dnum)  # noqa: E731
            t = float(time_fn(fn, x, iters))
        except Exception as e:  # recorded, and the candidate is out
            results.append({"config": cfg, "seconds": None, "error": repr(e)})
            continue
        results.append({"config": cfg, "seconds": t})
    best = _pick(results, f"scheme op={op} n={n} batch={batch}")
    if use_cache:
        _persist(path, dev, key, best)
    return {"config": dict(best["config"]), "seconds": best["seconds"],
            "tuned": True, "candidates": results}


def tuned_ring(n: int, batch: int, op: str = "ntt", *, q: Optional[int] = None,
               cache_path: Optional[str] = None, device=None,
               **tune_kwargs) -> Ring:
    """A ``Ring`` on the measured-best route for (op, n, batch)."""
    picked = tune(n, batch, op, q=q, cache_path=cache_path, device=device,
                  **tune_kwargs)
    return Ring(n, q, device=device, **picked["config"])


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m agilex_ntt_tpu_torch.utils.autotune",
        description="time the candidate routes, print and cache the winners")
    ap.add_argument("n", type=int)
    ap.add_argument("batch", type=int)
    ap.add_argument("--op", default="all",
                    choices=("all", "scheme") + _OPS + _SCHEME_OPS)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--L", type=int, default=3, help="primes (scheme ops)")
    ap.add_argument("--dnum", type=int, default=3,
                    help="key-switch digits (scheme ops)")
    ap.add_argument("--refresh", action="store_true",
                    help="time again on a cache hit")
    ap.add_argument("--cache", default=None,
                    help="cache file (default $NTT_TORCH_AUTOTUNE_CACHE or "
                         "~/.cache/agilex_ntt_tpu_torch/autotune.json)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    ops = {"all": _OPS, "scheme": _SCHEME_OPS}.get(args.op, (args.op,))
    out = []
    for op in ops:
        if op in _SCHEME_OPS:
            r = tune_scheme(op, args.n, args.batch, L=args.L, dnum=args.dnum,
                            iters=args.iters, cache_path=args.cache,
                            refresh=args.refresh, device=args.device)
            extra = {"L": args.L, "dnum": args.dnum}
        else:
            r = tune(args.n, args.batch, op, iters=args.iters,
                     cache_path=args.cache, refresh=args.refresh,
                     device=args.device)
            extra = {}
        line = {"device": device_key(args.device), "op": op, "n": args.n,
                "batch": args.batch, **extra, **r}
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


if __name__ == "__main__":
    main()
