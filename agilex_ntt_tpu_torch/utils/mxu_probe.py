"""The matrix-product four-step passes (M1, ``ops/mxu_ntt.py``) on the
card: their launch shapes, registers and spills, and their times beside
their bounds, beside the 16 digit products done by ``torch._int_mm``, and
beside the four-step route of ``Ring.ntt``.

On a machine with a card, from the repository root:

    python3 -m agilex_ntt_tpu_torch.utils.mxu_probe [--label NAME]
        [--mma-rate] [--clocks]

It needs only ``Ring``, ``ops/mxu_ntt.py``, ``ops/ntt_kernel.py``'s
``LAUNCHES`` and ``fwd_col_fourstep``, ``utils/report.py`` and
``utils/profiling.cuda_time_ms``.  Beside the card's name and power limit
it prints one JSON line a measurement at the shapes of the JAX package's
TPU A/B (``tools/ab_mxu.py``, BASELINE.md "MXU four-step formulation"):
(n, B) = (2^16, 512), (2^18, 128) and (2^20, 32), each with
``fourstep_split(n)``:

  * ``launch``: each pass's launch (tile, threads, shared memory, registers,
    local memory a thread, CTAs an SM, CTAs) and its ptxas lines;
  * ``transform``: ``fwd_ntt_fourstep_mxu`` (two M1 launches) and
    ``Ring(n).ntt`` (the port's four-step route: K7a, or K9a and the row
    pass on K1) in turns (route, matrix, matrix, route; CUDA events, median
    of 5 runs of 10 calls), the matrix form's bound and its ratio to the
    route;
  * ``pass``: the column pass (``fwd_col_pass_mxu``) beside K9a
    (``fwd_col_fourstep``: the column NTTs and the twiddle) and the row pass
    alone, each beside its bound (``report.mxu_pass_cost``) and beside its
    16 digit products by ``torch._int_mm`` alone (null where this torch
    has none or refuses the shape).

Every output is held against the plain version (``mxu_pass`` on the
card's words, ``col_pass_plain``/``row_pass_plain``) and the transform
against ``Ring.ntt``, word for word, on the way.  ``--mma-rate`` adds the
rates of the tensor cores' s8 instructions alone on this card, the ceiling
of M1's products: ``mma.sync`` m16n8k32 (``MMA_SOURCE``: 8 warps a CTA, 8
CTAs an SM, each warp 8 independent accumulators) and ``wgmma`` m64nNk32
from shared memory at N = 64 (M1's shape), 128 and 256 on one operand
pair, and at N = 64 on eight pairs without swizzle (M1's layout) and with
the 32-byte swizzle (``wgmma_source``, ``WGMMA_CASES``: a warpgroup a
CTA, as many CTAs as fit an SM, 8 products a group); no device memory
traffic, CUDA events.  ``--clocks`` builds the library again with
``-DNTT_MXU_CLOCKS`` (``csrc/ntt_mxu.cuh`` MxuClock, beside the package's
build) and gives, for each pass at each shape, the cycles CTA 0's
converter spends waiting for an empty stage, waiting for its raw words
(the copies) and converting, and its first consumer's waits for a full
stage, products (issue to ``wgmma.wait_group``) and epilogue.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

# (n, batch): the TPU A/B's shapes
SHAPES = ((1 << 16, 512), (1 << 18, 128), (1 << 20, 32))


# mma.sync alone: each warp runs `iters` rounds of 8 independent
# m16n8k32 s8 products (4096 multiply-adds each)
MMA_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void mma_loop(int iters, int* sink) {
  const uint32_t t = threadIdx.x;
  const uint32_t a0 = t, a1 = 3 * t, a2 = 5 * t, a3 = 7 * t, b0 = 11 * t,
                 b1 = 13 * t;
  int32_t c[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+r"(c[k][0]), "+r"(c[k][1]), "+r"(c[k][2]), "+r"(c[k][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  int s = 0;
  for (int k = 0; k < 8; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  if (s == 0x12345678) *sink = s;
}
extern "C" int mma_rate(int blocks, int threads, int iters, float* ms) {
  int* sink = nullptr;
  cudaMalloc(&sink, sizeof(int));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  mma_loop<<<blocks, threads>>>(iters, sink);
  cudaEventRecord(e0);
  mma_loop<<<blocks, threads>>>(iters, sink);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  cudaEventElapsedTime(ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  cudaFree(sink);
  return (int)cudaGetLastError();
}
"""


# one wgmma_loop_@NAME@ of wgmma_source: @N@ the width, @REGS@ its
# accumulators a thread, @OUTS@/@CONS@ their asm operands, @BLOCKS@ the
# distinct (A, B) pairs of @PAIR@ bytes the products cycle through,
# @LAYOUT@ the descriptors' layout bits (0: no swizzle, M1's; 3 << 62: the
# 32-byte swizzle)
WGMMA_LOOP = r"""
__global__ void __launch_bounds__(128) wgmma_loop_@NAME@(int iters,
                                                       int* sink) {
  extern __shared__ __align__(1024) uint8_t buf[];
  for (int i = threadIdx.x; i < @BLOCKS@ * @PAIR@; i += 128)
    buf[i] = (uint8_t)(i * 7);
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  int32_t c[@REGS@];
  for (int i = 0; i < @REGS@; ++i) c[i] = 0;
  const uint64_t da = desc(buf) | @LAYOUT@, db = desc(buf + 2048) | @LAYOUT@;
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < 8; ++k)
      asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %@PP@, 0;\n"
                   "wgmma.mma_async.sync.aligned.m64n@N@k32.s32.s8.s8 "
                   "{@OUTS@}, %@PA@, %@PB@, p;\n}\n"
                   : @CONS@
                   : "l"(da + (k % @BLOCKS@) * (@PAIR@ >> 4)),
                     "l"(db + (k % @BLOCKS@) * (@PAIR@ >> 4)), "r"(1));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  int s = 0;
  for (int i = 0; i < @REGS@; ++i) s += c[i];
  if (s == 0x12345678) *sink = s;
}
"""


# (name, N, distinct operand pairs, layout bits): one pair read again and
# again, or eight pairs (32 KiB at N = 64: shared memory's bandwidth
# counts), without swizzle as M1's operands and with the 32-byte swizzle
WGMMA_CASES = (("64", 64, 1, "0ull"), ("128", 128, 1, "0ull"),
               ("256", 256, 1, "0ull"), ("64x8", 64, 8, "0ull"),
               ("64x8_b32", 64, 8, "(3ull << 62)"))


def wgmma_source(cases=WGMMA_CASES) -> str:
    """A CUDA file with ``wgmma_loop_<name>``: a warpgroup's ``iters``
    groups of 8 ``wgmma`` m64nNk32 s32.s8.s8 products on one accumulator,
    both operands from shared memory, cycling through ``blocks`` operand
    pairs, and ``wgmma_rate(case, iters, &ms, &blocks)`` that times one
    launch of as many CTAs as the card holds at once."""
    src = [r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ uint64_t desc(const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | (8ull << 16) | (16ull << 32);
}
"""]
    for name, n, blocks, layout in cases:
        regs = n // 2
        subs = {"@NAME@": name, "@N@": str(n), "@BLOCKS@": str(blocks),
                "@PAIR@": str(2048 + 32 * n), "@LAYOUT@": layout,
                "@REGS@": str(regs),
                "@OUTS@": ", ".join(f"%{i}" for i in range(regs)),
                "@CONS@": ", ".join(f'"+r"(c[{i}])' for i in range(regs)),
                "@PA@": str(regs), "@PB@": str(regs + 1),
                "@PP@": str(regs + 2)}
        loop = WGMMA_LOOP
        for key, val in subs.items():
            loop = loop.replace(key, val)
        src.append(loop)
    kernels = ", ".join(f"(const void*)wgmma_loop_{c[0]}" for c in cases)
    smem = ", ".join(str(c[2] * (2048 + 32 * c[1])) for c in cases)
    src.append(r"""
extern "C" int wgmma_rate(int which, int iters, float* ms, int* blocks) {
  const void* kernels[] = {""" + kernels + r"""};
  const int smem[] = {""" + smem + r"""};
  const void* k = kernels[which];
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, k, 128, smem[which]);
  *blocks = sms * per;
  int* sink = nullptr;
  cudaMalloc(&sink, sizeof(int));
  void* args[] = {&iters, &sink};
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaLaunchKernel(k, dim3(*blocks), dim3(128), args, smem[which], 0);
  cudaEventRecord(e0);
  cudaLaunchKernel(k, dim3(*blocks), dim3(128), args, smem[which], 0);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  cudaEventElapsedTime(ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  cudaFree(sink);
  return (int)cudaGetLastError();
}
""")
    return "".join(src)


def wgmma_rates(iters: int = 4096, cases=WGMMA_CASES) -> list:
    """``wgmma`` m64nNk32 s8's rate alone on this card in each case of
    ``WGMMA_CASES``: its ms, CTAs, int8 multiply-adds and TOPS against the
    dense 1,979."""
    from ..ops import _build
    from .report import INT8_TC_OPS_PER_S

    out = []
    with tempfile.TemporaryDirectory() as tmp:
        src, lib = Path(tmp) / "wgmma.cu", Path(tmp) / "libwgmma.so"
        src.write_text(wgmma_source(cases))
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                        str(src)], check=True, capture_output=True, text=True)
        fn = ctypes.CDLL(str(lib)).wgmma_rate
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        for which, (name, n, blocks, layout) in enumerate(cases):
            ms, ctas = ctypes.c_float(), ctypes.c_int()
            rc = fn(which, iters, ctypes.byref(ms), ctypes.byref(ctas))
            if rc:
                raise RuntimeError(f"wgmma_rate {name}: CUDA error {rc}")
            macs = ctas.value * iters * 8 * 64 * n * 32
            tops = 2 * macs / (ms.value * 1e-3) / 1e12
            out.append({
                "instruction": f"wgmma m64n{n}k32 s8 (shared memory)",
                "operand_pairs": blocks,
                "swizzle": "32B" if layout != "0ull" else "none",
                "ctas": ctas.value, "ms": ms.value, "int8_macs": macs,
                "tops": tops,
                "share_of_dense_peak": tops * 1e12 / INT8_TC_OPS_PER_S})
    return out


CLOCK_SLOTS = ("converter_wait_empty", "converter_wait_copies",
               "converter_convert", "converter_total", "consumer_wait_full",
               "consumer_products", "consumer_epilogue", "consumer_total")


def start_clocks_build():
    """Start ``nvcc`` on the library with ``-DNTT_MXU_CLOCKS`` (into
    build/mxu_clocks/, beside the package's build); ``clocks_lib`` waits."""
    from ..ops import _build

    out = _build.BUILD_DIR.parent / "mxu_clocks"
    out.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DNTT_MXU_CLOCKS", "-o",
           str(out / "libntt_kernels.so"), str(_build.CSRC / "ntt_kernels.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


def clocks_lib(started):
    """The library of ``start_clocks_build``, loaded, with ``ntt_mxu_pass``
    and ``ntt_mxu_clocks`` declared."""
    from ..ops import _build

    proc, out = started
    log_text = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"the clocks build failed:\n{log_text}")
    lib = ctypes.CDLL(str(out / "libntt_kernels.so"))
    lib.ntt_mxu_pass.argtypes = list(_build.SIGNATURES["ntt_mxu_pass"])
    lib.ntt_mxu_pass.restype = ctypes.c_int
    lib.ntt_mxu_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ntt_mxu_clocks.restype = ctypes.c_int
    return lib


def role_clocks(lib, mt, x3, row: bool) -> dict:
    """The cycles of CTA 0's roles in one launch of the clocks build's pass
    (after one launch to warm it), and whether its words equal the
    package's pass."""
    import torch

    from ..ops import mxu_ntt as M
    from ..ops.ntt_kernel import _stream

    y = torch.empty_like(x3)
    tiles = mt.row_tiles if row else mt.col_tiles

    def launch():
        rc = lib.ntt_mxu_pass(
            x3.data_ptr(), y.data_ptr(), tiles.data_ptr(), mt.tw.data_ptr(),
            mt.tw_precon.data_ptr(), x3.shape[0], mt.n1.bit_length() - 1,
            mt.n2.bit_length() - 1, int(row), mt.q, _stream(x3))
        if rc:
            raise RuntimeError(f"clocks build ntt_mxu_pass: CUDA error {rc}")

    launch()
    torch.cuda.synchronize()
    counts = (ctypes.c_longlong * len(CLOCK_SLOTS))()
    lib.ntt_mxu_clocks(counts, 1)
    launch()
    torch.cuda.synchronize()
    lib.ntt_mxu_clocks(counts, 0)
    out = dict(zip(CLOCK_SLOTS, list(counts)))
    for role in ("converter", "consumer"):
        total = max(out[f"{role}_total"], 1)
        for key in CLOCK_SLOTS:
            if key.startswith(role) and key != f"{role}_total":
                out[f"{key}_share"] = out[key] / total
    out["same_words"] = bool(torch.equal(y, M.mxu_pass(x3, mt, row)))
    return out


def mma_rate(sms: int, iters: int = 4096, threads: int = 256,
             ctas_per_sm: int = 8) -> dict:
    """``mma.sync`` m16n8k32 s8's rate alone on this card, built with
    ``nvcc`` from MMA_SOURCE: its ms, int8 multiply-adds and TOPS (a
    multiply-add counting two) against the tensor cores' dense 1,979."""
    from ..ops import _build
    from .report import INT8_TC_OPS_PER_S

    with tempfile.TemporaryDirectory() as tmp:
        src, lib = Path(tmp) / "mma.cu", Path(tmp) / "libmma.so"
        src.write_text(MMA_SOURCE)
        subprocess.run([_build._nvcc(), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
                        str(src)], check=True, capture_output=True, text=True)
        fn = ctypes.CDLL(str(lib)).mma_rate
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        ms = ctypes.c_float()
        blocks = sms * ctas_per_sm
        rc = fn(blocks, threads, iters, ctypes.byref(ms))
        if rc:
            raise RuntimeError(f"mma_rate: CUDA error {rc}")
    macs = blocks * (threads // 32) * iters * 8 * 16 * 8 * 32
    tops = 2 * macs / (ms.value * 1e-3) / 1e12
    return {"ms": ms.value, "int8_macs": macs, "tops": tops,
            "share_of_dense_peak": tops * 1e12 / INT8_TC_OPS_PER_S}


def log(msg: str) -> None:
    print(f"mxu_probe: {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def int_mm_products(mt, x3, row: bool):
    """A call of the 16 digit products of one pass by ``torch._int_mm`` on
    the pass's digit planes (the data's split and laid out as the product
    wants, once, outside the call), or None where this torch has no
    ``_int_mm``.  Column pass: D_i (n1, n1) @ X_j (n1, B n2); row pass:
    G_j (B n1, n2) @ R_i^T (n2, n2)."""
    import torch

    from ..ops import mxu_ntt as M

    mm = getattr(torch, "_int_mm", None)
    if mm is None:
        return None
    b = x3.shape[0]
    digits = M._balanced_digits(x3)  # any words below 2^30: the yardstick
    if row:  # times the products alone, not the words they give
        data = [d.view(b * mt.n1, mt.n2) for d in digits]
        mats = [mt.row[i].t() for i in range(M.DIGITS)]
        return lambda: [mm(x, a) for a in mats for x in data]
    data = [d.permute(1, 0, 2).reshape(mt.n1, b * mt.n2).contiguous()
            for d in digits]
    mats = [mt.col[i] for i in range(M.DIGITS)]
    return lambda: [mm(a, x) for a in mats for x in data]


def library_ms(mt, x3, row: bool):
    """The time of ``int_mm_products`` (CUDA events), or None with the
    reason where there is no such call or this torch refuses it."""
    from .profiling import cuda_time_ms

    call = int_mm_products(mt, x3, row)
    if call is None:
        return None, "torch has no _int_mm"
    try:
        call()
    except RuntimeError as err:
        return None, f"torch._int_mm refused the shape: {err}"
    return cuda_time_ms(call), ""


def measure(dev, shapes=SHAPES, seed: int = 23, emit=print, check=True,
            clocks=None):
    """The A/B at ``shapes`` on device ``dev``; ``emit`` gets one dict a
    measurement; ``clocks``: the clocks build (``clocks_lib``) for the role
    counters of each pass.  Raises if an output differs from the plain
    version's or from ``Ring.ntt``'s."""
    import torch

    from .. import Ring
    from ..ops import _build
    from ..ops import mxu_ntt as M
    from ..ops import ntt_kernel as K
    from .profiling import cuda_time_ms
    from .report import bound, mxu_pass_cost, ptxas_lines

    ptxas = ptxas_lines(_build.build().parent / "build.log")
    for n, batch in shapes:
        ring = Ring(n, device=dev)
        plan, q = ring.plan, ring.q
        n1, n2 = plan.n1, plan.n2
        mt = M.mxu_tables(plan, dev)
        gen = torch.Generator(dev).manual_seed(seed + n)
        x = torch.randint(0, 4 * q, (batch, n), generator=gen,
                          dtype=torch.int64, device=dev).to(torch.uint32)
        g_in = torch.randint(0, q, (batch, n1, n2), generator=gen,
                             dtype=torch.int64, device=dev).to(torch.uint32)
        x3 = x.view(batch, n1, n2)
        shape = f"(B={batch}, n={n}, {n1}x{n2})"
        for row, name in ((False, "mxu_col_kernel"), (True, "mxu_row_kernel")):
            emit({"what": "launch", "pass": "row" if row else "col",
                  "shape": shape, **M.mxu_launch_info(mt, row, batch),
                  "ptxas": ptxas.get(name, ["not in the build log"])})
        if check:
            got = M.fwd_ntt_fourstep_mxu(x, plan)
            if not torch.equal(got, ring.ntt(x)):
                raise AssertionError(f"fwd_ntt_fourstep_mxu {shape} differs "
                                     "from Ring.ntt")
            for row, inp in ((False, x3), (True, g_in)):
                plain = M.row_pass_plain if row else M.col_pass_plain
                want = plain(inp.to(torch.int64), mt)
                if not torch.equal(M.mxu_pass(inp, mt, row).to(torch.int64),
                                   want):
                    raise AssertionError(f"mxu_pass row={row} {shape} differs "
                                         "from its plain version")
            del got, want
        calls = {"matrix": lambda: M.fwd_ntt_fourstep_mxu(x, plan),
                 "route": lambda: ring.ntt(x)}
        times = {"matrix": [], "route": []}
        for which in ("route", "matrix", "matrix", "route"):
            times[which].append(cuda_time_ms(calls[which]))
        before = dict(K.LAUNCHES)
        ring.ntt(x)
        route = {k: v - before[k] for k, v in K.LAUNCHES.items()
                 if v != before[k]}
        costs = [mxu_pass_cost(batch, n1, n2, row=r) for r in (False, True)]
        t_bound = sum(bound(*c)[0] for c in costs)
        emit({"what": "transform", "shape": shape, "matrix_ms": times["matrix"],
              "route_ms": times["route"], "route_launches": route,
              "bound_ms": t_bound,
              "matrix_share_of_bound": t_bound / min(times["matrix"]),
              "matrix_over_route": min(times["route"]) / min(times["matrix"])})
        for row, inp in ((False, x3), (True, g_in)):
            ms = cuda_time_ms(lambda: M.mxu_pass(inp, mt, row))
            b_ms, b_by = bound(*costs[row])
            lib, why = library_ms(mt, inp, row)
            out = {"what": "pass", "pass": "row" if row else "col",
                   "shape": shape, "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                   "share_of_bound": b_ms / ms, "int_mm_ms": lib}
            if why:
                out["int_mm_note"] = why
            if not row:
                ft = ring.fourstep
                out["k9a_ms"] = cuda_time_ms(
                    lambda: K.fwd_col_fourstep(x3, ft))
            emit(out)
            if clocks is not None:
                emit({"what": "clocks", "pass": "row" if row else "col",
                      "shape": shape, **role_clocks(clocks, mt, inp, row)})
        del ring, mt, x, x3, g_in
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="checkout",
                        help="a name for this checkout in the JSON lines")
    parser.add_argument("--mma-rate", action="store_true",
                        help="also time mma.sync m16n8k32 s8 and wgmma "
                        "m64nNk32 s8 alone")
    parser.add_argument("--clocks", action="store_true",
                        help="also count the cycles of CTA 0's roles in "
                        "each pass (a second build, -DNTT_MXU_CLOCKS)")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        log("no card")
        return 1
    card = card_line()
    log(f"card: {card}")

    def emit(row) -> None:
        print(json.dumps({"label": args.label, "card": card, **row}),
              flush=True)

    started = start_clocks_build() if args.clocks else None
    from ..ops import _build

    _build.load()
    lib = clocks_lib(started) if started else None
    measure(torch.device("cuda"), emit=emit, clocks=lib)
    if args.mma_rate:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        emit({"what": "mma_rate", "sms": sms, **mma_rate(sms)})
        for rate in wgmma_rates():
            emit({"what": "wgmma_rate", "sms": sms, **rate})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
