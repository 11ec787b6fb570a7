"""Command-line check: ``python -m agilex_ntt_tpu_torch [n] [batch] [--device cpu|cuda]``.

Builds a ring, runs the forward and inverse NTT and a negacyclic polymul on
the chosen device (default the GPU), and checks them against the package's
own numpy golden model before printing a summary.  Exits 1 if a check fails.
"""

import argparse
import sys
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m agilex_ntt_tpu_torch")
    ap.add_argument("n", nargs="?", type=int, default=4096)
    ap.add_argument("batch", nargs="?", type=int, default=8)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    args = ap.parse_args(argv)
    n, batch = args.n, args.batch

    from . import Ring, golden as G

    ring = Ring(n, device=args.device)
    kind = (
        torch.cuda.get_device_name(ring.device)
        if ring.device.type == "cuda" else "host"
    )
    print(f"device  : {ring.device} ({kind})")
    print(f"ring    : {ring}")

    rng = np.random.default_rng(0)
    a = rng.integers(0, ring.q, size=(batch, n), dtype=np.uint32)
    b = rng.integers(0, ring.q, size=(batch, n), dtype=np.uint32)

    t0 = time.perf_counter()
    ya = ring.ntt(a)
    if ring.device.type == "cuda":
        torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    back = ring.intt(ya).cpu().numpy()
    prod = ring.polymul(a, b).cpu().numpy()
    ya = ya.cpu().numpy()

    want_fwd = G.fwd_ntt_u64(a, ring.params).astype(np.uint32)
    fa = want_fwd.astype(np.uint64)
    fb = G.fwd_ntt_u64(b, ring.params)
    pw = ((fa * fb) % np.uint64(ring.q)).astype(np.uint32)
    want_prod = G.inv_ntt_u64(pw, ring.params).astype(np.uint32)
    checks = {
        "intt(ntt(a)) == a": bool((back == a).all()),
        "ntt(a) bit-exact vs golden": bool((ya == want_fwd).all()),
        "polymul bit-exact vs golden": bool((prod == want_prod).all()),
    }
    for name, ok in checks.items():
        print(f"check   : {name:32s} {'OK' if ok else 'FAIL'}")
    print(f"timing  : first fwd call (incl. kernel build) {t_fwd*1e3:.1f} ms")
    if not all(checks.values()):
        sys.exit(1)
    print(f"all checks passed (n={n}, q={ring.q}, batch={batch})")


if __name__ == "__main__":
    main()
