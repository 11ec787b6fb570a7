"""Static per-kernel report, and the bound model of the card.

Counterpart of ``agilex_ntt_tpu/utils/report.py``.  For each transform
size the report gives the forward and inverse transform's operation count,
the bytes it must move, which of the two bounds it on the card and the
speed of light in NTTs a second; on the card, it runs each transform once
and lists, for each kernel it launched, ``ptxas``'s registers, spills and
shared memory (the build runs ``nvcc -Xptxas -v``, ``ops/_build.py``) and
the kernel's launch shape (``ops/ntt_kernel.py``'s ``*_launch_info``).

The bound model (``bound``) is the one every ``bound_ms`` of
``chip_smoke.py`` and ``PERF.md`` comes from: the larger of the bytes a call
must move (each input read once, each output written once) over the memory
rate, and its int32 operations over the rate of the SM pipes they need.
The rates are derivation constants of the H100 SXM at its 700 W power
limit, not measurements.

Run: ``python -m agilex_ntt_tpu_torch.utils.report [n ...] [--batch B]
[--device cpu|cuda] [--out DIR]`` (writes ``DIR/report.txt``, by default
``report_out/torch/report.txt``).
"""

from __future__ import annotations

import argparse
import os
import re
from pathlib import Path
from typing import Dict, List, Optional

# H100 SXM derivation constants (NVIDIA data sheet, at the 700 W power
# limit): HBM3 at 3.35 TB/s.
HBM_BYTES_PER_S = 3.35e12
# int32 rates from the SM's pipes, at the clock behind the data sheet's
# 67 TFLOP/s float32 (132 SMs x 128 FP32 lanes x 2 for an FMA = 1.98 GHz).
# Multiplies issue only on the FMA pipe and compares, selects and min/max
# only on the ALU pipe, each 64 lanes an SM; adds go to either pipe; an SM
# issues at most 128 lane-operations a clock.
INT32_PIPE_PER_S = 67e12 / 4
INT32_ISSUE_PER_S = 67e12 / 2
# int8 dense on the tensor cores (data sheet): 1,979 T operations a second,
# a multiply-add counting as two
INT8_TC_OPS_PER_S = 1979e12

# int32 operations the kernels' arithmetic needs (ntt_arith.cuh) as
# (multiplies, compares or selects, adds), each at its fewest instructions:
# a Shoup product is 3 multiplies (the subtract fused into a multiply-add),
# a conditional subtraction an add and an unsigned min, and x + y - z one
# three-input add.
OPS_BUTTERFLY = (3, 1, 3)  # CT or GS: a Shoup product, a cond_sub, 2 adds
OPS_LAST_INV_BUTTERFLY = (6, 2, 4)  # two scaled products and reductions
OPS_FINAL_REDUCE = (0, 2, 2)  # two conditional subtractions per output word
OPS_MONT = (4, 1, 1)  # 4 multiplies, the carry test, one three-input add
OPS_ACCUMULATE = (0, 1, 2)  # an add and a conditional subtraction
OPS_SHOUP = (3, 0, 0)  # a lazy Shoup product, the subtract fused
OPS_SCALE_REDUCE = (3, 1, 1)  # a Shoup product and a conditional subtraction
# K11 a word: the forward stage's lazy Shoup product, conditional
# subtraction and add (the role is one scalar a shard: no select); the
# inverse v-half's difference and Shoup product
OPS_XCHG_FWD = (3, 1, 2)
OPS_XCHG_INV = (3, 0, 1)
# int32 instructions of the u64 arithmetic (ntt_wide.cuh), as (multiplies,
# compares or selects, adds), counted at their fewest: a 64x64 wide
# product (IMAD.WIDE) counts as two multiplies, a 64-bit add or subtract
# as two adds, a 64-bit compare as two compares and a select as two.  A
# 64-bit low product is one wide and two plain multiplies; __umul64hi four
# wide products and four adds; a Shoup product (16, 0, 6) both lows, the
# high and a subtract; a conditional subtraction (0, 4, 2) a subtract, a
# compare and a select.
OPS_WIDE_BUTTERFLY = (16, 4, 14)  # CT or GS: Shoup, cond_sub, 3 adds
OPS_WIDE_FINAL = (0, 8, 4)  # two conditional subtractions a word
OPS_WIDE_SCALE = (16, 4, 8)  # the inverse's scale: Shoup and cond_sub
OPS_WIDE_MONT = (24, 2, 12)  # a full product, m, its high, the sum
# the matrix-product pass (M1, ntt_mxu.cuh): a data word's split into four
# int8 digits (an add and an xor, and two byte permutes a word into the
# planes), and an output word's reconstruction (seven wide multiply-adds,
# the Barrett high product of four wide multiplies and its adds, the
# quotient times q, the subtract, one conditional subtraction; a wide
# product counts as two multiplies, as above)
OPS_MXU_SPLIT = (0, 0, 4)
OPS_MXU_REDUCE = (24, 1, 9)


def ops_sum(*terms):
    """Sum of (count, (multiplies, compares, adds)) terms."""
    return tuple(sum(c * ops[i] for c, ops in terms) for i in range(3))


def fwd_ops(batch: int, n: int):
    logn = n.bit_length() - 1
    return ops_sum((batch * n // 2 * logn, OPS_BUTTERFLY),
                   (batch * n, OPS_FINAL_REDUCE))


def inv_ops(batch: int, n: int):
    logn = n.bit_length() - 1
    return ops_sum((batch * n // 2 * (logn - 1), OPS_BUTTERFLY),
                   (batch * n // 2, OPS_LAST_INV_BUTTERFLY))


def dot_ops(batch: int, k: int, n: int):
    return ops_sum((2 * k, fwd_ops(batch, n)), (batch * n * k, OPS_MONT),
                   (batch * n * (k - 1), OPS_ACCUMULATE),
                   (1, inv_ops(batch, n)))


def butterflies(batch: int, n: int):
    """log2(n) stages of plain butterflies: no final reduction and no
    scaled last stage."""
    return ops_sum((batch * n // 2 * (n.bit_length() - 1), OPS_BUTTERFLY))


def fwd4_ops(batch: int, n1: int, n2: int, *, rows: bool = True):
    """The forward four-step transform: size-n1 column transforms, the
    twiddle product, and (with ``rows``) size-n2 row transforms.  The lazy
    Shoup twiddle takes any 32-bit word, so the whole transform needs no
    reduction before T; the column pass alone (K9a) does one."""
    n = n1 * n2
    terms = [(1, butterflies(batch * n2, n1)), (batch * n, OPS_SHOUP)]
    if rows:
        terms.append((1, fwd_ops(batch * n1, n2)))
    else:  # the column pass alone returns the reference's lazy words,
        # whose column transform is reduced before T
        terms.append((batch * n, OPS_FINAL_REDUCE))
    return ops_sum(*terms)


def inv4_ops(batch: int, n1: int, n2: int, *, rows: bool = True):
    """The inverse: (with ``rows``) size-n2 row inverses, the inverse
    twiddle, and size-n1 column inverses whose last stage folds the scale.
    One scaled stage is enough for the whole transform, and the inverse
    twiddle takes the rows' unreduced [0, 2q) output."""
    n = n1 * n2
    terms = [(batch * n, OPS_SHOUP), (1, inv_ops(batch * n2, n1))]
    if rows:
        terms.append((1, butterflies(batch * n1, n2)))
    return ops_sum(*terms)


def polymul4_ops(batch: int, n1: int, n2: int):
    return ops_sum((2, fwd4_ops(batch, n1, n2)), (batch * n1 * n2, OPS_MONT),
                   (1, inv4_ops(batch, n1, n2)))


def wide_fwd_ops(batch: int, n: int):
    logn = n.bit_length() - 1
    return ops_sum((batch * n // 2 * logn, OPS_WIDE_BUTTERFLY),
                   (batch * n, OPS_WIDE_FINAL))


def wide_inv_ops(batch: int, n: int):
    logn = n.bit_length() - 1
    return ops_sum((batch * n // 2 * logn, OPS_WIDE_BUTTERFLY),
                   (batch * n, OPS_WIDE_SCALE))


def mxu_pass_cost(batch: int, n1: int, n2: int, *, row: bool):
    """(words moved, int32 operations, int8 multiply-adds) of one pass of
    the matrix-product four-step transform (M1) at (batch, n1, n2): the
    column pass (K = n1: the input reduced from [0, 4q)) or the row pass
    (K = n2: the twiddle, a Shoup product and a conditional subtraction, and
    its two (n1, n2) tables).  Each word read and written once, the (4, K,
    K) int8 digit planes once (K^2 words); 16 digit products of K terms an
    output word."""
    n, k = n1 * n2, (n2 if row else n1)
    words = 2 * batch * n + k * k + (2 * n if row else 0)
    pre = OPS_SCALE_REDUCE if row else OPS_FINAL_REDUCE
    ops = ops_sum((batch * n, pre), (batch * n, OPS_MXU_SPLIT),
                  (batch * n, OPS_MXU_REDUCE))
    return words, ops, 16 * batch * n * k


def scaled(L: int, ops):
    """The operations of L channels."""
    return tuple(L * v for v in ops)


def bound(words_moved: int, ops, int8_macs: int = 0):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    the operations over the rate of the units they need: the int32
    operations over the SM pipes', and ``int8_macs`` int8 multiply-adds
    over the tensor cores' (the matrix-product pass, M1)."""
    mul, cmp, add = ops
    t_bytes = words_moved * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = max(mul / INT32_PIPE_PER_S, cmp / INT32_PIPE_PER_S,
                (mul + cmp + add) / INT32_ISSUE_PER_S,
                2 * int8_macs / INT8_TC_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_lines(build_log) -> Dict[str, List[str]]:
    """Each kernel's ``ptxas -v`` lines (registers, spills, shared memory)
    from the build's log, by the kernel's name (e.g.
    ``fwd_rns_cluster_kernel``), in the log's order."""
    kernel = "?"
    out: Dict[str, List[str]] = {}
    for line in Path(build_log).read_text().splitlines():
        # the length prefix of the mangled name, then e.g. fwd4_cluster_kernel
        entry = re.search(r"\d+([a-z][a-z_]*\d?(?:_[a-z]+)*_kernel)[EI]", line)
        if "Compiling entry" in line and entry:
            kernel = entry.group(1)
        elif "registers" in line or "spill" in line:
            out.setdefault(kernel, []).append(line.split(":", 1)[-1].strip())
    return out


# launch counter -> the CUDA kernel it launches: the cluster or slab kernel,
# and the walking kernel where no cluster or slab holds the matrix
_COUNTED_KERNELS = {
    "fwd": ("fwd_rns_cluster_kernel", None),
    "inv": ("inv_rns_cluster_kernel", None),
    "fwd4": ("fwd4_cluster_kernel", "fwd4_kernel"),
    "inv4": ("inv4_cluster_kernel", "inv4_kernel"),
    "col_fwd": ("col_fwd4_slab_kernel", "col_fwd4_kernel"),
    "col_inv": ("col_inv4_slab_kernel", "col_inv4_kernel"),
}

DEFAULT_OUT = os.path.join("report_out", "torch")
# the JAX package's committed report (report_out/report.txt), which no run of
# this module may overwrite
_JAX_REPORT_DIR = Path(__file__).resolve().parents[2] / "report_out"


def _launched(ring, name: str, batch: int, ptxas: Dict[str, List[str]]):
    """Run ring's ``name`` transform once at (batch, n) on the card and
    describe each kernel it launched: its counter, launches, CUDA kernel,
    launch shape and ptxas lines."""
    import torch

    from ..ops import ntt_kernel as K

    x = torch.zeros((batch, ring.n), dtype=torch.uint32, device=ring.device)
    for key in K.LAUNCHES:
        K.LAUNCHES[key] = 0
    (ring.ntt if name == "fwd" else ring.intt)(x)
    torch.cuda.synchronize(ring.device)
    counts = {k: v for k, v in K.LAUNCHES.items() if v}
    out = []
    for key, launches in counts.items():
        cluster, walking = _COUNTED_KERNELS[key]
        if key in ("fwd", "inv"):
            if ring.fourstep is None:
                info = K.launch_info(ring.tables, key, batch)
            else:  # the four-step row pass: (B n1, n2) rows
                info = K.launch_info(ring.fourstep.row, key,
                                     batch * ring.fourstep.n1)
            kernel = cluster
        else:
            info = K.fourstep_launch_info(ring.fourstep, key)
            kernel = cluster if info["ctas"] else walking
        out.append({"counter": key, "launches": launches, "kernel": kernel,
                    "launch": info,
                    "ptxas": ptxas.get(kernel, ["not in the build log"])})
    return out


def kernel_report(n: int, batch: int = 512, out_dir: str = DEFAULT_OUT,
                  device=None) -> List[dict]:
    """One row each for the forward (``fwd``) and inverse (``inv``)
    transform of ``Ring(n)`` at (batch, n): the operation model, the bytes,
    the bound and the speed of light, and, on the card (the default), the
    kernels each launched with their ptxas lines and launch shapes.  With
    ``device="cpu"`` the model columns compute and ``kernels`` is None: no
    kernel was built.  Creates ``out_dir``, where ``main`` writes the
    report."""
    from ..api import Ring

    ring = Ring(n, device=device)
    os.makedirs(out_dir, exist_ok=True)
    ptxas = None
    if ring.device.type == "cuda":
        from ..ops import _build

        ptxas = ptxas_lines(_build.build().parent / "build.log")
    rows = []
    for name in ("fwd", "inv"):
        if ring.method == "radix2":
            ops = (fwd_ops if name == "fwd" else inv_ops)(batch, n)
        else:
            ops = (fwd4_ops if name == "fwd" else inv4_ops)(
                batch, ring.fourstep.n1, ring.fourstep.n2)
        min_bytes = 2 * 4 * batch * n  # read the input, write the output once
        bound_ms, bound_by = bound(2 * batch * n, ops)
        rows.append(dict(
            name=name, n=n, batch=batch, method=ring.method,
            ops=ops, model_ops=sum(ops), min_bytes=min_bytes,
            intensity=sum(ops) / min_bytes, bound_ms=bound_ms,
            bound="memory" if bound_by == "bytes" else "compute",
            sol_ntts_per_s=batch / (bound_ms * 1e-3),
            device=str(ring.device),
            kernels=(None if ptxas is None
                     else _launched(ring, name, batch, ptxas)),
        ))
    return rows


def _fmt(v: float) -> str:
    for unit in ("", "K", "M", "G", "T", "P"):
        if abs(v) < 1000:
            return f"{v:7.2f}{unit}"
        v /= 1000
    return f"{v:.2f}E"


def format_rows(rows: List[dict]) -> List[str]:
    """The report's lines for ``kernel_report`` rows."""
    hdr = (f"{'kernel':>7} {'n':>7} {'batch':>6} {'method':>9} "
           f"{'mul, cmp, add':>22} {'model ops':>10} {'min bytes':>10} "
           f"{'ops/B':>6} {'bound':>8} {'bound ms':>9} {'SoL NTT/s':>10}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        mul, cmp, add = (_fmt(v).strip() for v in r["ops"])
        lines.append(
            f"{r['name']:>7} {r['n']:>7} {r['batch']:>6} {r['method']:>9} "
            f"{mul + ', ' + cmp + ', ' + add:>22} {_fmt(r['model_ops']):>10} "
            f"{_fmt(r['min_bytes']):>10} {r['intensity']:6.2f} "
            f"{r['bound']:>8} {r['bound_ms']:9.4f} "
            f"{_fmt(r['sol_ntts_per_s']):>10}")
        if r["kernels"] is None:
            lines.append(f"{'':>7} no kernel built (device {r['device']}): "
                         "the model columns only")
            continue
        for k in r["kernels"]:
            info = ", ".join(f"{key}={val}" for key, val in k["launch"].items())
            lines.append(f"{'':>7} {k['counter']} x{k['launches']}: "
                         f"{k['kernel']} ({info})")
            for p in k["ptxas"]:
                lines.append(f"{'':>9} ptxas: {p}")
    return lines


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(
        prog="python -m agilex_ntt_tpu_torch.utils.report",
        description="per-kernel bound report of Ring(n)'s transforms")
    ap.add_argument("sizes", nargs="*", type=int, default=[1024, 4096, 16384])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="directory of report.txt (default %(default)s)")
    args = ap.parse_args(argv)
    if Path(args.out).resolve() == _JAX_REPORT_DIR:
        raise SystemExit(f"--out {args.out}: that directory holds the JAX "
                         "package's committed report.txt")
    rows = []
    for n in args.sizes:
        rows += kernel_report(n, args.batch, args.out, device=args.device)
    text = "\n".join(
        ["per-kernel bound report (H100 SXM derivation constants: "
         f"HBM {HBM_BYTES_PER_S / 1e12:.2f} TB/s, int32 "
         f"{INT32_ISSUE_PER_S / 1e12:.1f} T issues/s, multiplies and "
         f"compares {INT32_PIPE_PER_S / 1e12:.2f} T/s each)"]
        + format_rows(rows))
    print(text)
    with open(os.path.join(args.out, "report.txt"), "w") as f:
        f.write(text + "\n")
    return rows


if __name__ == "__main__":
    main()
