"""Variants of the cluster kernels K7a and K8, timed side by side in one run.

On a machine with a card, from the repository root:

    python3 -m agilex_ntt_tpu_torch.utils.cluster_probe

Each variant is a copy of ``csrc/`` with a textual change or two, built by its
own ``nvcc`` (all started together) into ``build/cluster_variants/<name>``:

  * ``shipped``: the sources as they are (three CTAs of 256 threads an SM
    where slabs of at most 75 KiB take at most 16 CTAs, else one of 512);
  * ``two_ctas_an_sm``: two CTAs of 256 threads an SM (up to 128
    registers, slabs of at most 113 KiB) in place of three;
  * ``one_cta_an_sm``: one CTA of 512 threads an SM at every shape;
  * ``radix16``: local passes of up to 4 stages (``k4RadixLog = 4``);
  * ``t_past_l1``: T and its precon loaded past L1
    (``ld.global.nc.L1::no_allocate``), which three CTAs an SM leave small;
  * ``phases``: the shipped kernels with ``clock64()`` stamps from thread 0
    of every CTA at the boundaries of their phases.

For each shape it holds every variant's output against the plain version
on the first rows, prints each kernel's launch (CTAs a cluster, threads,
clusters at once), times K7a and K8 in turns (variants in order, then in
reverse, CUDA events), and from ``phases`` prints the mean cycles a CTA
spends in each phase.  It measures the design, not the main path: nothing
of the package calls it.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

from ..ops import _build

H = "ntt_fourstep_cluster.cuh"
CU = "ntt_kernels.cu"
VARIANT_DIR = _build.BUILD_DIR.parent / "cluster_variants"
SHAPES = ((1 << 16, 512), (1 << 17, 256), (1 << 18, 128), (1 << 19, 64))

# (file, text, replacement) of each variant
VARIANTS = {
    "shipped": (),
    "two_ctas_an_sm": (
        (CU, "constexpr int k4SmallCtas = 3;", "constexpr int k4SmallCtas = 2;"),
        (CU, "constexpr size_t k4SmallSlabBytes = 76800;",
         "constexpr size_t k4SmallSlabBytes = 115712;"),),
    "one_cta_an_sm": (
        (CU, "if (logc >= 0) return shape_of(mats",
         "if (false) return shape_of(mats"),),
    "radix16": (
        (H, "constexpr int k4RadixLog = 3;", "constexpr int k4RadixLog = 4;"),),
    "t_past_l1": (
        (H, '#include "ntt_arith.cuh"\n',
         '#include "ntt_arith.cuh"\n'
         "__device__ __forceinline__ uint32_t ldg_past_l1(const uint32_t* p) {\n"
         "  uint32_t v;\n"
         '  asm volatile("ld.global.nc.L1::no_allocate.b32 %0, [%1];"\n'
         '               : "=r"(v) : "l"(p));\n'
         "  return v;\n}\n"),
        (H, "__ldg(t.tw + e)", "ldg_past_l1(t.tw + e)"),
        (H, "__ldg(t.tw_precon + e)", "ldg_past_l1(t.tw_precon + e)"),),
}

# the phases variant: (anchor, text inserted after it), in order of the
# anchors' first occurrences in the header
STAMP_EDITS = (
    ('#include "ntt_arith.cuh"\n',
     "__device__ unsigned long long g_stamps[1 << 20];\n"
     "#define STAMP(i) do { if (threadIdx.x == 0) "
     "g_stamps[blockIdx.x * 16 + (i)] = clock64(); } while (0)\n"),
    # the end of the column inverse of K8 (and of K7b and K9b, whose stamps
    # are not read)
    ("    if (hi > 0) __syncthreads();\n  }\n", "  STAMP(7);\n"),
    # the column pass of K7a and K8 (and K9a, whose stamps are not read)
    ("  load_slabs(b0, b1, g0, g1, sl, rank);\n", "  STAMP(1);\n"),
    ("    if (s < sl.logn1) __syncthreads();\n  }\n", "  STAMP(2);\n"),
    ("  cl.sync();\n", "  STAMP(3);\n"),
    # K7a
    ("  const int rank = (int)cl.block_rank();\n", "  STAMP(0);\n"),
    ("    });\n    cl.sync();\n  }\n", "  STAMP(4);\n"),
    ("    s += k;\n    __syncthreads();\n  }\n", "  STAMP(5);\n"),
    ("  store_slab(slab, y, sl, rank);\n", "  STAMP(6);\n"),
    # the inverse half of K8 (and K7b, whose stamps are not read)
    ("  cl.sync();\n", "  STAMP(5);\n"),
    ("    });\n    cl.sync();\n  }\n", "  STAMP(6);\n"),
    # K7b's start, then K8
    ("  const int rank = (int)cl.block_rank();\n", "  STAMP(0);\n"),
    ("  const int rank = (int)cl.block_rank();\n", "  STAMP(0);\n"),
    ("    });\n    cl.sync();\n  }\n", "  STAMP(4);\n"),
)
PHASES = {1: ("load", "column pass", "wait for the cluster", "cross",
              "row passes", "store"),
          2: ("load", "column pass", "wait for the cluster", "cross fwd",
              "rows, product, rows inv", "cross inv",
              "column inverse and store")}
STAMPS_EXPORT = ('\nextern "C" int probe_stamps(unsigned long long* h, int n) {\n'
                 "  return (int)cudaMemcpyFromSymbol(h, g_stamps, (size_t)n * 8);\n"
                 "}\n")


def _insert_after(text: str, edits) -> str:
    pos = 0
    for anchor, ins in edits:
        i = text.index(anchor, pos) + len(anchor)
        text = text[:i] + ins + text[i:]
        pos = i + len(ins)
    return text


def _sources(name: str, edits) -> Path:
    """A copy of csrc/ under the variant's name with its (file, text,
    replacement) edits; ``phases`` also gets the clock64() stamps."""
    d = VARIANT_DIR / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    if name == "phases":
        (d / H).write_text(_insert_after((d / H).read_text(), STAMP_EDITS))
        (d / CU).write_text((d / CU).read_text() + STAMPS_EXPORT)
    for fname, old, new in edits:
        text = (d / fname).read_text()
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} not in {fname}")
        (d / fname).write_text(text.replace(old, new))
    return d


def build_all(variants=None, watch: str = "cluster"):
    """{name: (library, ptxas lines of the kernels whose name holds
    ``watch``)} of ``variants`` (name: edits; default this module's
    variants and ``phases``), built in parallel."""
    if variants is None:
        variants = {**VARIANTS, "phases": ()}
    nvcc = _build._nvcc()
    procs = {}
    for name, edits in variants.items():
        d = _sources(name, edits)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / CU)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{out}")
        kernel, lines = "?", []
        for line in out.splitlines():
            m = re.search(r"\d+([a-z][a-z_]*\d?(?:_[a-z]+)*_kernel)[EI]", line)
            if "Compiling entry" in line and m:
                kernel = m.group(1)
            elif watch in kernel and ("registers" in line or "stack" in line):
                lines.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
        lib = ctypes.CDLL(str(VARIANT_DIR / name / "lib.so"))
        for fn, argtypes in _build.SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.ntt_fourstep_cluster_log.argtypes = [ctypes.c_int] * 3
        lib.ntt_error_string.argtypes = [ctypes.c_int]
        lib.ntt_error_string.restype = ctypes.c_char_p
        libs[name] = (lib, lines)
    return libs


def main() -> int:
    import numpy as np
    import torch

    from .. import Ring
    from ..ops import ntt_kernel as K
    from ..ops import plain_ntt as P
    from .profiling import cuda_time_ms

    if not torch.cuda.is_available():
        raise SystemExit("cluster_probe: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    libs = build_all()
    for name, (_, lines) in libs.items():
        for line in lines:
            print(f"  ptxas {name} {line}")
    loader = _build.load
    dev = torch.device("cuda")
    try:
        for n, batch in SHAPES:
            ring = Ring(n, device=dev)
            ft, q = ring.fourstep, ring.q
            gen = torch.Generator(dev).manual_seed(n)
            shape = (batch, ft.n1, ft.n2)

            def rand(bound):
                return torch.randint(0, bound, shape, generator=gen,
                                     dtype=torch.int64, device=dev)

            x, a, b = rand(4 * q), rand(q), rand(q)
            want_f = P.fwd_ntt_fourstep_plain(x[:2], ft)
            want_p = P.polymul_fourstep_plain(a[:2], b[:2], ft)
            x, a, b = (v.to(torch.uint32) for v in (x, a, b))
            timed = [k for k in libs if k != "phases"]
            for name in timed + timed[::-1] + ["phases"]:
                lib = libs[name][0]
                _build.load = lambda lib=lib: lib
                i7 = K.fourstep_launch_info(ft, "fwd4")
                i8 = K.fourstep_launch_info(ft, "polymul4")
                y = K.fwd_ntt_fourstep(x, ft)
                z = K.polymul_fourstep_fused(a, b, ft)
                exact = (torch.equal(y[:2].to(torch.int64), want_f)
                         and torch.equal(z[:2].to(torch.int64), want_p))
                if not exact:
                    raise AssertionError(f"variant {name} disagrees at n={n}")
                t7 = cuda_time_ms(lambda: K.fwd_ntt_fourstep(x, ft))
                t8 = cuda_time_ms(lambda: K.polymul_fourstep_fused(a, b, ft))
                print(f"n={n} ({ft.n1}x{ft.n2}) B={batch} {name:14s} K7a "
                      f"{i7['ctas']} CTAs x {i7['threads']}, "
                      f"{i7['max_active_clusters']} at once: {t7:.4f} ms; K8 "
                      f"{i8['ctas']} CTAs x {i8['threads']}, "
                      f"{i8['max_active_clusters']} at once: {t8:.4f} ms",
                      flush=True)
                if name != "phases":
                    continue
                lib.probe_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
                for mats, info, call in (
                        (1, i7, lambda: K.fwd_ntt_fourstep(x, ft)),
                        (2, i8, lambda: K.polymul_fourstep_fused(a, b, ft))):
                    if not info["ctas"]:
                        continue
                    call()
                    torch.cuda.synchronize()
                    words = batch * info["ctas"] * 16
                    buf = (ctypes.c_ulonglong * words)()
                    _build.check(lib, lib.probe_stamps(buf, words), "stamps")
                    st = np.frombuffer(buf, dtype=np.uint64).reshape(-1, 16)
                    st = st[:, : len(PHASES[mats]) + 1].astype(np.int64)
                    d, total = np.diff(st, axis=1), st[:, -1] - st[:, 0]
                    print(f"    {'K7a' if mats == 1 else 'K8'} cycles a CTA: "
                          f"{total.mean():.0f} = " + ", ".join(
                              f"{lab} {d[:, j].mean():.0f} "
                              f"({d[:, j].mean() / total.mean():.0%})"
                              for j, lab in enumerate(PHASES[mats])),
                          flush=True)
            del x, a, b, y, z
            torch.cuda.empty_cache()
    finally:
        _build.load = loader
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
