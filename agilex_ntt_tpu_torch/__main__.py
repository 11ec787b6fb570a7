"""Command-line check:
``python -m agilex_ntt_tpu_torch [n] [batch] [--rns L] [--device cpu|cuda]``.

Builds a ring (an ``RNSRing`` of L primes with ``--rns L``; four-step above
n = 32768), runs the forward and inverse NTT and a negacyclic polymul on
the chosen device (default the GPU), and checks them, channel by channel,
against the package's own numpy golden model before printing a summary.
Exits 1 if a check fails.
"""

import argparse
import sys
import time

import numpy as np
import torch


def _golden_checks(a, fa, back, b, prod, params) -> dict:
    """The three checks of one prime: fa = ntt(a), back = intt(fa) and
    prod = a * b, all (batch, n) numpy arrays."""
    from . import golden as G

    q = np.uint64(params.q)
    want_fwd = G.fwd_ntt_u64(a, params).astype(np.uint32)
    pw = G.fwd_ntt_u64(a, params) * G.fwd_ntt_u64(b, params) % q
    want_prod = G.inv_ntt_u64(pw.astype(np.uint32), params).astype(np.uint32)
    return {
        "intt(ntt(a)) == a": bool((back == a).all()),
        "ntt(a) bit-exact vs golden": bool((fa == want_fwd).all()),
        "polymul bit-exact vs golden": bool((prod == want_prod).all()),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m agilex_ntt_tpu_torch")
    ap.add_argument("n", nargs="?", type=int, default=4096)
    ap.add_argument("batch", nargs="?", type=int, default=8)
    ap.add_argument("--rns", type=int, default=0, metavar="L",
                    help="check an RNSRing of L primes (default: one Ring)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    args = ap.parse_args(argv)
    n, batch = args.n, args.batch

    from . import Ring, RNSRing

    if args.rns:
        ring = RNSRing(n, args.rns, device=args.device)
        qs, params = ring.qs, [r.params for r in ring.rings]
        shape = (ring.L, batch, n)
    else:
        ring = Ring(n, device=args.device)
        qs, params = [ring.q], [ring.params]
        shape = (batch, n)
    kind = (
        torch.cuda.get_device_name(ring.device)
        if ring.device.type == "cuda" else "host"
    )
    print(f"device  : {ring.device} ({kind})")
    print(f"ring    : {ring}")

    rng = np.random.default_rng(0)
    bounds = np.array(qs, dtype=np.uint64).reshape((-1,) + (1,) * (len(shape) - 1))
    a = (rng.integers(0, 1 << 62, size=shape, dtype=np.uint64) % bounds).astype(np.uint32)
    b = (rng.integers(0, 1 << 62, size=shape, dtype=np.uint64) % bounds).astype(np.uint32)

    t0 = time.perf_counter()
    ya = ring.ntt(a)
    if ring.device.type == "cuda":
        torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    back = ring.intt(ya).cpu().numpy()
    prod = ring.polymul(a, b).cpu().numpy()
    ya = ya.cpu().numpy()

    if not args.rns:  # one channel, the same checks
        a, b, ya, back, prod = (v[None] for v in (a, b, ya, back, prod))
    ok = True
    for l, p in enumerate(params):
        checks = _golden_checks(a[l], ya[l], back[l], b[l], prod[l], p)
        tag = f" [q={p.q}]" if args.rns else ""
        for name, good in checks.items():
            print(f"check   : {name:32s} {'OK' if good else 'FAIL'}{tag}")
        ok = ok and all(checks.values())
    print(f"timing  : first fwd call (incl. kernel build) {t_fwd*1e3:.1f} ms")
    if not ok:
        sys.exit(1)
    what = f"L={len(qs)} primes" if args.rns else f"q={qs[0]}"
    print(f"all checks passed (n={n}, {what}, batch={batch})")


if __name__ == "__main__":
    main()
