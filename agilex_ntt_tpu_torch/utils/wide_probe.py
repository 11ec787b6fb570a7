"""The wide ring's transforms as the package ships them, timed on the card
so that two checkouts can be timed alike; and its butterfly counted in SASS.

On a machine with a card, from the repository root:

    python3 -m agilex_ntt_tpu_torch.utils.wide_probe [--label NAME] [--sass]

It needs only ``WideRing``, ``ops/wide_kernel.py``'s ``wide_fwd`` and
``wide_inv``, ``ntt_kernel.LAUNCHES``, ``utils/report.py`` and
``utils/profiling.cuda_time_ms``: a copy of this file dropped into an older
checkout times that checkout's kernels alike.  Beside the card's name and
power limit it prints one JSON line a measurement, at (B, n) = (8192, 4096)
with a 62-bit and a 45-bit prime, (256, 32768), (64, 65536) and (32, 2^17):

  * the transform kernels alone (``wide_fwd`` on inputs over [0, 4q),
    ``wide_inv`` over [0, 2q); CUDA events, median of 5 runs of 10 calls)
    beside their bound (``report.bound`` with ``wide_fwd_ops`` /
    ``wide_inv_ops``, 8 bytes a word each way and the two u64 tables);
  * the public calls ``ntt``, ``intt`` and ``polymul`` on (lo, hi) pairs
    (median of 3 runs of 2 calls);
  * each with its kernel launches a call (``LAUNCHES``).

The kernels' outputs are held against the checkout's own plain version
(``wide_fwd_plain``, ``wide_inv_plain``) on the way.  ``--sass`` builds a
probe of 16 chained Cooley-Tukey and Gentleman-Sande butterflies
(``csrc/ntt_wide.cuh``) with ``nvcc -cubin`` for sm_90a and counts their
SASS instructions a butterfly by class with ``cuobjdump -sass``.
``--variants`` builds launch variants of the transforms (``VARIANTS``:
textual substitutions of copies of ``csrc/``, built in parallel under
``build/wide_variants/``; ``--only`` names some) and times them in turns,
each checked against the plain version, at the first and third shapes.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import tempfile
from pathlib import Path

SHAPES = ((8192, 4096, 62), (8192, 4096, 45), (256, 32768, 62),
          (64, 1 << 16, 62), (32, 1 << 17, 62))
CHAIN = 16
# launch variants: name -> (file of csrc/, text, replacement) edits
_CU, _H = "ntt_kernels.cu", "ntt_wide.cuh"
VARIANTS = {
    "shipped": (),
    # two CTAs an SM (128 registers, no spill) to six (40 registers); four
    # ship
    **{f"{word}_an_sm": ((_CU, "constexpr int kWideCtasPerSm = 4;",
                          f"constexpr int kWideCtasPerSm = {count};"),)
       for word, count in (("two", 2), ("three", 3), ("five", 5),
                           ("six", 6))},
    # the cross pass's loop kept rolled (one group's registers live)
    "cross_rolled": ((_H, "  const size_t block = (size_t)u << s.logl;\n"
                          "  for (int i",
                      "  const size_t block = (size_t)u << s.logl;\n"
                      "  NTT_NO_UNROLL\n  for (int i"),),
    # the column and row passes' group loops unrolled (two groups at once),
    # at three and at two CTAs an SM
    "groups_unrolled": ((_H, "  NTT_NO_UNROLL\n  for (int",
                         "  NTT_UNROLL\n  for (int"),),
    "groups_unrolled_two": ((_H, "  NTT_NO_UNROLL\n  for (int",
                             "  NTT_UNROLL\n  for (int"),
                            (_CU, "constexpr int kWideCtasPerSm = 4;",
                             "constexpr int kWideCtasPerSm = 2;")),
}

PROBE_SOURCE = r"""
#include "ntt_wide.cuh"
extern "C" __global__ void probe_io(uint64_t* x, uint64_t* y, uint64_t w,
                                    uint64_t wp, uint64_t q) {
  const unsigned i = threadIdx.x;
  const uint64_t a = x[i], b = y[i];
  x[i] = a ^ w ^ q;
  y[i] = b ^ wp;
}
extern "C" __global__ void probe_ct(uint64_t* x, uint64_t* y, uint64_t w,
                                    uint64_t wp, uint64_t q) {
  const unsigned i = threadIdx.x;
  uint64_t a = x[i], b = y[i];
#pragma unroll
  for (int k = 0; k < CHAIN; ++k) wide_ct_butterfly(a, b, w, wp, q, false);
  x[i] = a;
  y[i] = b;
}
extern "C" __global__ void probe_gs(uint64_t* x, uint64_t* y, uint64_t w,
                                    uint64_t wp, uint64_t q) {
  const unsigned i = threadIdx.x;
  uint64_t a = x[i], b = y[i];
#pragma unroll
  for (int k = 0; k < CHAIN; ++k) wide_gs_butterfly(a, b, w, wp, q);
  x[i] = a;
  y[i] = b;
}
"""

# SASS opcode classes: the FMA pipe's multiplies, its moves, shifts and adds
# (IMAD used for them), compares and selects, the ALU's adds and logic, and
# the rest (memory, control, special registers)
_CLASSES = (
    ("imad_move", re.compile(r"^IMAD\.(MOV|SHL|IADD)")),
    ("multiply", re.compile(r"^(IMAD|IMUL)")),
    ("compare_select", re.compile(r"^(ISETP|SEL|ICMP|PLOP3|FSEL)")),
    ("add_logic", re.compile(r"^(IADD3|IADD|LEA|LOP3|SHF|IABS|IMNMX|POPC)")),
)


def log(msg: str) -> None:
    print(f"wide_probe: {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def _sass_counts(cubin: Path, cuobjdump: str) -> dict:
    """{function: Counter of opcode classes} from ``cuobjdump -sass``."""
    text = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        head = re.search(r"Function : (\w+)", line)
        if head:
            fn = head.group(1)
            out[fn] = collections.Counter()
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                       line)
        if fn is None or not ins:
            continue
        op = ins.group(1)
        kind = next((k for k, pat in _CLASSES if pat.match(op)), "other")
        out[fn][kind] += 1
        out[fn]["op " + op] += 1
    return out


def sass(csrc: Path) -> dict:
    """The SASS instructions a butterfly of the probe's chains, by class:
    (probe_ct - probe_io) / CHAIN and (probe_gs - probe_io) / CHAIN."""
    from ..ops import _build

    nvcc = _build._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "probe.cu"
        src.write_text(PROBE_SOURCE.replace("CHAIN", str(CHAIN)))
        cubin = Path(tmp) / "probe.cubin"
        subprocess.run([nvcc, "-cubin", "-gencode",
                        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        f"-I{csrc}", "-o", str(cubin), str(src)], check=True,
                       capture_output=True, text=True)
        counts = _sass_counts(cubin, cuobjdump)
    base = counts["probe_io"]
    result = {}
    for name in ("probe_ct", "probe_gs"):
        keys = set(counts[name]) | set(base)
        result[name] = {k: (counts[name][k] - base[k]) / CHAIN
                        for k in sorted(keys)
                        if counts[name][k] != base[k]}
    return result


def build_variants(variants) -> dict:
    """{name: (library, ptxas lines of the wide kernels)}, each variant's
    copy of csrc/ built in parallel."""
    import ctypes
    import shutil

    from ..ops import _build

    root = _build.BUILD_DIR.parent / "wide_variants"
    nvcc = _build._nvcc()
    procs = {}
    for name, edits in variants.items():
        d = root / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        for fname, old, new in edits:
            text = (d / fname).read_text()
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in {fname}")
            (d / fname).write_text(text.replace(old, new))
        cmd = [nvcc, *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / _CU)]
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
            elif "wide" in kernel and ("registers" in line or "stack" in line):
                lines.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        for fn, argtypes in _build.SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.ntt_error_string.argtypes = [ctypes.c_int]
        lib.ntt_error_string.restype = ctypes.c_char_p
        libs[name] = (lib, lines)
    return libs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", nargs="*", default=None,
                        help="the variants to time (default: all)")
    parser.add_argument("--label", default="checkout",
                        help="a name for this checkout in the JSON lines")
    parser.add_argument("--sass", action="store_true",
                        help="count the butterfly's SASS instructions")
    parser.add_argument("--variants", action="store_true",
                        help="time the launch variants in turns")
    args = parser.parse_args(argv)

    import torch

    from .. import WideRing, find_primes
    from ..ops import ntt_kernel as K
    from ..ops import wide_kernel as WK
    from .profiling import cuda_time_ms
    from .report import bound, wide_fwd_ops, wide_inv_ops

    if not torch.cuda.is_available():
        log("no card")
        return 1
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")

    def rand(gen, top, shape):
        lo = torch.randint(0, 1 << 32, shape, generator=gen, dtype=torch.int64,
                           device=dev)
        hi = torch.randint(0, top >> 32, shape, generator=gen,
                           dtype=torch.int64, device=dev)
        return lo.to(torch.uint32), hi.to(torch.uint32)

    def launches(call) -> dict:
        before = dict(K.LAUNCHES)
        call()
        torch.cuda.synchronize()
        return {k: v - before[k] for k, v in K.LAUNCHES.items()
                if v != before[k]}

    def emit(**row) -> None:
        print(json.dumps({"label": args.label, "card": card, **row}),
              flush=True)

    if args.variants:
        from ..ops import _build

        libs = build_variants({k: v for k, v in VARIANTS.items()
                               if args.only is None or k in args.only})
        for name, (_, lines) in libs.items():
            for line in lines:
                log(f"ptxas {name} {line}")
        loader = _build.load
        try:
            for batch, n, bits in (SHAPES[0], SHAPES[2]):
                wr = WideRing(n, device=dev)
                gen = torch.Generator(dev).manual_seed(n + bits)
                x = rand(gen, 4 * wr.q, (batch, n))
                y = rand(gen, 2 * wr.q, (batch, n))
                t = wr.tables
                want = (WK.wide_fwd_plain(tuple(v.to(torch.int64) for v in x), t),
                        WK.wide_inv_plain(tuple(v.to(torch.int64) for v in y), t,
                                          wr.n_inv))
                names = list(libs)
                for name in names + names[::-1]:
                    _build.load = lambda lib=libs[name][0]: lib
                    calls = (lambda: WK.wide_fwd(x, t),
                             lambda: WK.wide_inv(y, t, wr.n_inv))
                    for key, call, w in zip(("wide_fwd", "wide_inv"), calls,
                                            want):
                        if not all(torch.equal(g.to(torch.int64), w_)
                                   for g, w_ in zip(call(), w)):
                            raise AssertionError(f"variant {name} {key} "
                                                 "disagrees")
                        emit(what="variant", variant=name, op=key,
                             shape=f"(B={batch}, n={n}) q{bits}",
                             ms=cuda_time_ms(call))
                del wr, x, y, want
                torch.cuda.empty_cache()
        finally:
            _build.load = loader
        return 0
    for batch, n, bits in SHAPES:
        q = None if bits == 62 else find_primes(n, 1, bits=bits)[0]
        wr = WideRing(n, q, device=dev)
        gen = torch.Generator(dev).manual_seed(n + bits)
        x, y = rand(gen, 4 * wr.q, (batch, n)), rand(gen, 2 * wr.q, (batch, n))
        a, b = rand(gen, wr.q, (batch, n)), rand(gen, wr.q, (batch, n))
        t = wr.tables
        shape = f"(B={batch}, n={n}) q{bits}"
        i64 = [tuple(v.to(torch.int64) for v in pair) for pair in (x, y)]
        for key, call, plain, ops in (
            ("wide_fwd", lambda: WK.wide_fwd(x, t),
             lambda: WK.wide_fwd_plain(i64[0], t), wide_fwd_ops(batch, n)),
            ("wide_inv", lambda: WK.wide_inv(y, t, wr.n_inv),
             lambda: WK.wide_inv_plain(i64[1], t, wr.n_inv),
             wide_inv_ops(batch, n)),
        ):
            got, want = call(), plain()
            if not all(torch.equal(g.to(torch.int64), w_)
                       for g, w_ in zip(got, want)):
                raise AssertionError(f"{key} {shape} disagrees with its plain "
                                     "version")
            del got, want
            ms = cuda_time_ms(call)
            bound_ms, bound_by = bound(4 * batch * n + 4 * n, ops)
            emit(what="kernel", op=key, shape=shape, ms=ms, bound_ms=bound_ms,
                 bound_by=bound_by, share=bound_ms / ms,
                 launches=launches(call))
        for op, call in (("ntt", lambda: wr.ntt(x)), ("intt", lambda: wr.intt(y)),
                         ("polymul", lambda: wr.polymul(a, b))):
            ms = cuda_time_ms(call, warmup=1, reps=3, inner=2)
            emit(what="call", op=op, shape=shape, ms=ms,
                 launches=launches(call))
        del wr, x, y, a, b, i64
        torch.cuda.empty_cache()
    if args.sass:
        csrc = Path(__file__).resolve().parents[1] / "csrc"
        emit(what="sass", chain=CHAIN, per_butterfly=sass(csrc))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
