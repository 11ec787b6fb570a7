"""How long ``torch.profiler`` keeps recording short profiles in a process.

Run on the card: ``python3 -m agilex_ntt_tpu_torch.utils.profiler_probe
[--waits 30 60 120]``.  It profiles one launch of K1 at (8192, 4096) and
one host-to-device copy (``kernels_seen``), and ``device_time_profiled``
of 8 chained ``Ring(4096).ntt`` calls, at once and again after each wait
(seconds since the first profile, the process idle between), and prints
what each recorded.  On the H100 machine the one-launch profiles recorded
nothing after about a minute while the 8-call one kept recording, which is
why ``chip_smoke.py`` opens no profile before phase 4's checks of single
launches.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    import torch

    from ..api import Ring
    from ..ops import ntt_kernel as K
    from .profiling import device_time_profiled, kernels_seen

    ap = argparse.ArgumentParser(prog="python3 -m agilex_ntt_tpu_torch.utils."
                                 "profiler_probe")
    ap.add_argument("--waits", type=float, nargs="*", default=[30, 60, 120])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiler_probe needs a CUDA device")
    ring = Ring(4096)
    x = torch.randint(0, ring.q, (8192, 4096), dtype=torch.int64,
                      device="cuda").to(torch.uint32)
    ring.ntt(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for wait in [0.0] + list(args.waits):
        time.sleep(max(0.0, wait - (time.perf_counter() - t0)))
        k1 = kernels_seen(lambda: K.fwd_ntt(x, ring.tables))
        htod = [k for k, _, _ in kernels_seen(
            lambda: torch.ones(4, dtype=torch.int32).to("cuda")) if "HtoD" in k]
        chained = device_time_profiled(ring.ntt, x, iters=8)
        print(f"t={time.perf_counter() - t0:6.1f} s: one K1 launch -> "
              f"{len(k1)} kernel(s) recorded; one host-to-device copy -> "
              f"{len(htod)}; 8 chained Ring(4096).ntt -> "
              + ("nothing" if chained is None else f"{chained * 1e3:.4f} ms a call"),
              flush=True)


if __name__ == "__main__":
    main()
