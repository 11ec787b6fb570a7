"""Launch variants of the multi-prime transform kernels (K4a, K4b), timed
side by side in one run.

On a machine with a card, from the repository root:

    python3 -m agilex_ntt_tpu_torch.utils.rns_probe
    python3 -m agilex_ntt_tpu_torch.utils.rns_probe --shipped-only

Each variant is a copy of ``csrc/`` with a textual change or two, built by
its own ``nvcc`` (all started together, ``cluster_probe.build_all``):

  * ``rns_shipped``: the sources as they are (one unit, a polynomial or
    4096 / n of them, a cluster, one slab);
  * ``rns_scalar_stores``: the forward's rows stored a word at a time in
    place of two 16-byte stores;
  * ``rns_512_threads``: CTAs of 512 threads (8192 words: n = 4096 two
    polynomials a CTA, n = 16384 a cluster of 2), three an SM;
  * ``rns_three_ctas``, ``rns_four_ctas``, ``rns_five_ctas``: three, four
    or five CTAs of 256 threads an SM in place of six (up to 80, 64 or 48
    registers; six: 40).

It prints each variant's ptxas lines for ``fwd_rns_cluster_kernel`` and
``inv_rns_cluster_kernel`` and the local-memory instructions in their code
(``cuobjdump -sass``: STL stores and LDL loads, the spills' traffic), then
at K4a's and K4b's main shape (3 primes, B = 2048, n = 4096) and at the key
switch's (5 primes, n = 16384: K4a on its digits, B = 256; K4b on its sum,
B = 64) holds every variant's output against the plain version on the
first rows, prints its launch (CTAs a polynomial, CTAs an SM, clusters at
once, clusters a channel) and times it in turns (variants in order,
then in reverse, CUDA events).

``--shipped-only`` builds nothing of its own: it times the package's
kernels as they are at the same shapes, beside the card's name, so that
two checkouts can be timed alike in one call (it needs only ``RNSRing``,
``fwd_ntt_rns`` and ``inv_ntt_rns``).  It measures the design, not the
main path: nothing of the package calls it.
"""

from __future__ import annotations

import subprocess
import sys

from ..ops import _build
from . import cluster_probe, polydot_probe

CU = cluster_probe.CU
RT = "ntt_rns_transform.cuh"
VARIANTS = {
    "rns_shipped": (),
    "rns_scalar_stores": (
        (RT, "if constexpr (K >= 2) {", "if constexpr (false) {"),),
    "rns_512_threads": (
        (CU, "constexpr int kRnsLogThreads = 8;",
         "constexpr int kRnsLogThreads = 9;"),
        (CU, "constexpr int kRnsCtasPerSm = 6;",
         "constexpr int kRnsCtasPerSm = 3;"),),
    **{f"rns_{word}_ctas": (
        (CU, "constexpr int kRnsCtasPerSm = 6;",
         f"constexpr int kRnsCtasPerSm = {ctas};"),)
       for word, ctas in (("three", 3), ("four", 4), ("five", 5))},
}
# (kernel, primes, batch, n): the main shape, then the key switch's
SHAPES = (("fwd_rns", 3, 2048, 4096), ("inv_rns", 3, 2048, 4096),
          ("fwd_rns", 5, 256, 16384), ("inv_rns", 5, 64, 16384))
KERNELS = ("fwd_rns_cluster_kernel", "inv_rns_cluster_kernel")


def main(argv=None) -> int:
    import torch

    from .. import RNSRing
    from ..ops import ntt_kernel as K
    from ..ops import plain_ntt as P
    from .profiling import cuda_time_ms

    shipped_only = "--shipped-only" in (sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        raise SystemExit("rns_probe: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    if shipped_only:
        libs = {"package": (_build.load(), [])}
    else:
        libs = cluster_probe.build_all(VARIANTS, "rns_cluster")
        for name, (_, lines) in libs.items():
            for line in lines:
                print(f"  ptxas {name} {line}")
            so = cluster_probe.VARIANT_DIR / name / "lib.so"
            for kernel in KERNELS:
                sass = polydot_probe.local_memory_ops(so, kernel)
                print(f"  sass {name} {kernel}: {sass}")
    loader = _build.load
    dev = torch.device("cuda")
    try:
        for which, L, batch, n in SHAPES:
            ring = RNSRing(n, L, device=dev)
            tabs = ring.tables
            gen = torch.Generator(dev).manual_seed(n + batch)
            mult = 4 if which == "fwd_rns" else 2
            x = torch.stack([torch.randint(0, mult * q, (batch, n),
                                           generator=gen, dtype=torch.int64,
                                           device=dev) for q in ring.qs])
            if which == "fwd_rns":
                fn, want = K.fwd_ntt_rns, P.fwd_ntt_rns_plain(x[:, :2], tabs)
            else:
                fn, want = K.inv_ntt_rns, P.inv_ntt_rns_plain(x[:, :2], tabs)
            x32 = x.to(torch.uint32)
            del x
            for name in list(libs) + list(libs)[::-1]:
                lib = libs[name][0]
                _build.load = lambda lib=lib: lib
                got = fn(x32, tabs)
                if not torch.equal(got[:, :2].to(torch.int64), want):
                    raise AssertionError(f"{name} disagrees: {which} n={n}")
                ms = cuda_time_ms(lambda: fn(x32, tabs))
                launch = ""
                if not shipped_only:
                    info = K.rns_launch_info(tabs, which, batch)
                    launch = (f" {info['ctas']} CTAs a polynomial x "
                              f"{info['threads']}, {info['registers']} "
                              f"registers, {info['ctas_per_sm']} an SM, "
                              f"{info['max_active_clusters']} clusters at "
                              f"once, {info['clusters']} a channel:")
                print(f"{which} L={L} B={batch} n={n} {name:18s}{launch} "
                      f"{ms:.4f} ms", flush=True)
            del x32, got
            torch.cuda.empty_cache()
    finally:
        _build.load = loader
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
