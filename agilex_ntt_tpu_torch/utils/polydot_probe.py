"""Launch variants of the multi-prime polydot kernel (K5, K6b), timed side
by side in one run, and the single-prime fused kernels (K3, K6a) as the
package ships them.

On a machine with a card, from the repository root:

    python3 -m agilex_ntt_tpu_torch.utils.polydot_probe
    python3 -m agilex_ntt_tpu_torch.utils.polydot_probe --single

Each variant is a copy of ``csrc/`` with a textual change or two, built by
its own ``nvcc`` (all started together, ``cluster_probe.build_all``):

  * ``dot_shipped``: the sources as they are;
  * ``dot_two_ctas_an_sm``: two CTAs of 256 threads an SM (up to 128
    registers) in place of three;
  * ``dot_sum8``: 8 words of the sum a thread, so a CTA holds 2048 words of
    each operand and a polynomial takes twice the CTAs (36 KiB a CTA);
  * ``dot_sum8_four_ctas``: the same with four CTAs an SM (64 registers).

It prints each variant's ptxas lines for ``polydot_rns_cluster_kernel``
and the local-memory instructions in its code (``cuobjdump -sass``: STL
stores and LDL loads, the spills' traffic), then at K6b's shape (the key
switch's dot: 5 primes, B = 64, k = 4, n = 16384) and K5's (3 primes, B =
2048, n = 4096) holds every variant's output against the plain version on
the first rows, prints its launch
(CTAs a polynomial, CTAs an SM, clusters at once) and times it in turns
(variants in order, then in reverse, CUDA events).  It measures the
design, not the main path: nothing of the package calls it.

``--single`` builds nothing of its own: it times the package's K3
(``polymul_fused``) and K6a (``polydot_fused``) as they are at
``SINGLE_SHAPES``, beside the card's name, holding the first rows against
the plain versions, so that two checkouts can be timed alike in one call
(it needs only ``Ring``, the two wrappers and their plain versions).
"""

from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

from ..ops import _build
from . import cluster_probe

H = "ntt_polydot_cluster.cuh"
CU = cluster_probe.CU
SUM8 = ((H, "constexpr int kDotLogSumWords = 4;",
         "constexpr int kDotLogSumWords = 3;"),
        (H, "constexpr int kDotMaxClusterLog = 3;",
         "constexpr int kDotMaxClusterLog = 4;"))
VARIANTS = {
    "dot_shipped": (),
    "dot_two_ctas_an_sm": (
        (CU, "constexpr int kDotCtasPerSm = 3;",
         "constexpr int kDotCtasPerSm = 2;"),),
    "dot_sum8": SUM8,
    "dot_sum8_four_ctas": SUM8 + (
        (CU, "constexpr int kDotCtasPerSm = 3;",
         "constexpr int kDotCtasPerSm = 4;"),),
}
# (primes, batch, k, n): K6b at the key switch's shape, K5
SHAPES = ((5, 64, 4, 16384), (3, 2048, 1, 4096))
KERNEL = "polydot_rns_cluster_kernel"
# (n, batch, k) of --single: K3 and K6a at the main path's shapes, K3 at
# n = 32768 and 32, K6a at n = 16384 and with k = 8 terms
SINGLE_SHAPES = ((4096, 8192, 1), (4096, 2048, 3), (32768, 1024, 1),
                 (32, 65536, 1), (16384, 256, 3), (4096, 512, 8))


def local_memory_ops(lib: Path, kernel: str = KERNEL) -> str:
    """The STL and LDL instructions in ``kernel``'s SASS (by default the
    dot kernel's), counted."""
    nvcc = Path(_build._nvcc())
    cuobjdump = shutil.which("cuobjdump") or str(nvcc.parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    counts, inside = {"STL": 0, "LDL": 0}, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            for op in counts:
                counts[op] += bool(re.search(rf"\b{op}(\.|\s)", line))
    return f"{counts['STL']} STL, {counts['LDL']} LDL"


def single(dev) -> None:
    """K3 and K6a of the package as it is, timed at ``SINGLE_SHAPES``."""
    import torch

    from .. import Ring
    from ..ops import ntt_kernel as K
    from ..ops import plain_ntt as P
    from .profiling import cuda_time_ms

    for n, batch, k in SINGLE_SHAPES:
        ring = Ring(n, device=dev)
        tabs = ring.tables
        gen = torch.Generator(dev).manual_seed(n + k)
        shape = (batch, n) if k == 1 else (batch, k, n)
        a, b = (torch.randint(0, ring.q, shape, generator=gen,
                              dtype=torch.int64, device=dev) for _ in range(2))
        a32, b32 = a.to(torch.uint32), b.to(torch.uint32)
        fused, plain = ((K.polymul_fused, P.polymul_plain) if k == 1
                        else (K.polydot_fused, P.polydot_plain))
        got = fused(a32, b32, tabs)[:2].to(torch.int64)
        if not torch.equal(got, plain(a[:2], b[:2], tabs)):
            raise AssertionError(f"K3/K6a disagree at n={n} k={k}")
        ms = cuda_time_ms(lambda: fused(a32, b32, tabs))
        print(f"{'K3' if k == 1 else 'K6a'} B={batch} k={k} n={n}: "
              f"{ms:.4f} ms", flush=True)
        del a, b, a32, b32, got
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    import sys

    import torch

    from .. import RNSRing
    from ..ops import ntt_kernel as K
    from ..ops import plain_ntt as P
    from .profiling import cuda_time_ms

    if not torch.cuda.is_available():
        raise SystemExit("polydot_probe: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    if "--single" in (sys.argv[1:] if argv is None else argv):
        single(torch.device("cuda"))
        return 0
    libs = cluster_probe.build_all(VARIANTS, "polydot_rns_cluster")
    for name, (_, lines) in libs.items():
        for line in lines:
            print(f"  ptxas {name} {line}")
        sass = local_memory_ops(cluster_probe.VARIANT_DIR / name / "lib.so")
        print(f"  sass {name} {KERNEL}: {sass}")
    loader = _build.load
    dev = torch.device("cuda")
    try:
        for L, batch, k, n in SHAPES:
            ring = RNSRing(n, L, device=dev)
            tabs = ring.tables
            gen = torch.Generator(dev).manual_seed(n + k)
            a = torch.stack([torch.randint(0, q, (batch, k, n), generator=gen,
                                           dtype=torch.int64, device=dev)
                             for q in ring.qs])
            b = torch.stack([torch.randint(0, q, (batch, k, n), generator=gen,
                                           dtype=torch.int64, device=dev)
                             for q in ring.qs])
            want = P.polydot_rns_plain(a[:, :2], b[:, :2], tabs)
            a32, b32 = a.to(torch.uint32), b.to(torch.uint32)
            del a, b
            for name in list(libs) + list(libs)[::-1]:
                lib = libs[name][0]
                _build.load = lambda lib=lib: lib
                info = K.polydot_rns_launch_info(tabs, k)
                got = K.polydot_rns_fused(a32, b32, tabs)
                if not torch.equal(got[:, :2].to(torch.int64), want):
                    raise AssertionError(f"variant {name} disagrees at n={n}")
                ms = cuda_time_ms(lambda: K.polydot_rns_fused(a32, b32, tabs))
                print(f"L={L} B={batch} k={k} n={n} {name:20s} "
                      f"{info['ctas']} CTAs a polynomial x {info['threads']}, "
                      f"{info['ctas_per_sm']} an SM, "
                      f"{info['max_active_clusters']} clusters at once: "
                      f"{ms:.4f} ms", flush=True)
            del a32, b32, got
            torch.cuda.empty_cache()
    finally:
        _build.load = loader
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
