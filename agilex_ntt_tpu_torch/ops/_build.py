"""Build the CUDA kernels at first use and load them with ctypes.

``nvcc`` compiles ``csrc/ntt_kernels.cu`` for ``sm_90a`` into
``build/torch_kernels/libntt_kernels.so`` beside the package.  The library
has a plain C interface and includes no PyTorch header, so a build takes
seconds; it is rebuilt when the hash of the sources and flags changes.
Pointers and the stream cross as ``c_void_p`` (an undeclared pointer
argument would be cut to 32 bits).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("ntt_arith.cuh", "ntt_fourstep_cluster.cuh", "ntt_mxu.cuh",
           "ntt_polydot_cluster.cuh", "ntt_rns_transform.cuh",
           "ntt_wide.cuh", "ntt_xchg.cuh", "ntt_kernels.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libntt_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U = ctypes.c_uint32
_U64 = ctypes.c_uint64
SIGNATURES = {
    # x, y, roots, precon, qs (q at word 0), batch, logn, stream
    "ntt_fwd": (_P, _P, _P, _P, _P, _LL, _I, _P),
    # x, y, iroots, iprecon, qs, scales (su, su', sv, sv'), batch, logn,
    # stream
    "ntt_inv": (_P, _P, _P, _P, _P, _P, _LL, _I, _P),
    # a, b, out, roots, precon, iroots, iprecon, consts (q, -q^-1 and the
    # scale's four words), batch, k, logn, stream
    "ntt_polydot": (_P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _P),
    # x, y, roots, precon, qs, channels, batch, logn, stream
    "ntt_fwd_rns": (_P, _P, _P, _P, _P, _I, _LL, _I, _P),
    # x, y, iroots, iprecon, qs, scales, channels, batch, logn, stream
    "ntt_inv_rns": (_P, _P, _P, _P, _P, _P, _I, _LL, _I, _P),
    # a, b, out, roots, precon, iroots, iprecon, qs, qinvs, scales,
    # channels, batch, k, logn, stream
    "ntt_polydot_rns": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _I, _P,
    ),
    # logn, k, info (6 ints)
    "ntt_polydot_rns_launch_info": (_I, _I, _P),
    # kernel (0 K4a/K1, 1 K4b/K2, 2 K12), logn, channels, batch, info (8
    # ints)
    "ntt_rns_launch_info": (_I, _I, _I, _LL, _P),
    # four-step: tabs is a host array of six device pointers, the scales
    # host arrays of four words.
    # x, y, tabs, batch, logn1, logn2, q, stream
    "ntt_fwd4": (_P, _P, _P, _LL, _I, _I, _U, _P),
    # x, y, tabs, row_scale, col_scale, batch, logn1, logn2, q, stream
    "ntt_inv4": (_P, _P, _P, _P, _P, _LL, _I, _I, _U, _P),
    # a, b, out, scratch, fwd_tabs, inv_tabs, row_scale, col_scale, batch,
    # logn1, logn2, q, qinv_neg, stream
    "ntt_polymul4": (_P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _U, _U, _P),
    # x, y, tabs, batch, logn1, logn2, q, stream
    "ntt_col_fwd4": (_P, _P, _P, _LL, _I, _I, _U, _P),
    # x, y, tabs, col_scale, batch, logn1, logn2, q, stream
    "ntt_col_inv4": (_P, _P, _P, _P, _LL, _I, _I, _U, _P),
    # x, y, roots, precon (the cyclic tables of psi^-2), rows (pre, pre',
    # post, post'), batch, logn, q, stream
    "ntt_dit_inv": (_P, _P, _P, _P, _P, _LL, _I, _U, _P),
    # table (six words an entry: x, partner, out, w, wp, is_u), entries,
    # rows, width, q, fwd, last, s, sp, stream, launches (one int out)
    "ntt_xchg_group": (_P, _I, _LL, _I, _U, _I, _I, _U, _U, _P, _P),
    # device, peer
    "ntt_enable_peer": (_I, _I),
    # kernel (0 K7a, 1 K7b, 2 K8, 3 K9a, 4 K9b), logn1, logn2, info (5 ints)
    "ntt_fourstep_launch_info": (_I, _I, _I, _P),
    # the wide ring: x lo, x hi, y lo, y hi, roots, precon (u64), q, batch,
    # logn, stream, launches (one int out)
    "ntt_wide_fwd": (_P, _P, _P, _P, _P, _P, _U64, _LL, _I, _P, _P),
    # x lo, x hi, y lo, y hi, iroots, iprecon, q, scale, scale precon,
    # batch, logn, stream, launches
    "ntt_wide_inv": (_P, _P, _P, _P, _P, _P, _U64, _U64, _U64, _LL, _I, _P,
                     _P),
    # kernel (0 forward, 1 inverse), logn, batch, info (10 ints)
    "ntt_wide_launch_info": (_I, _I, _LL, _P),
    # a lo, a hi, b lo, b hi, y lo, y hi, count, mode, q, -q^-1 mod 2^64,
    # 2^128 mod q, stream, launches
    "ntt_wide_pointwise": (_P, _P, _P, _P, _P, _P, _LL, _I, _U64, _U64, _U64,
                           _P, _P),
    # the matrix-product four-step pass (M1): x, y, mat (int8 digit blocks
    # in the kernel's order), tw, twp (row pass), batch, logn1, logn2, row,
    # q, stream
    "ntt_mxu_pass": (_P, _P, _P, _P, _P, _LL, _I, _I, _I, _U, _P),
    # row, logn1, logn2, batch, info (14 ints)
    "ntt_mxu_launch_info": (_I, _I, _I, _LL, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash(nvcc: str) -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join((nvcc,) + NVCC_FLAGS).encode())
    return h.hexdigest()


def build() -> Path:
    """Build the library unless an up-to-date one is present; return its path.

    The compiler's output (including ``-Xptxas -v`` register and shared
    memory counts) goes to ``build.log`` beside the library.
    """
    nvcc = _nvcc()
    digest = _source_hash(nvcc)
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a unique name and rename: concurrent builds never load a
    # half-written library
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / "ntt_kernels.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with every signature declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.ntt_fourstep_cluster_log.argtypes = [_I, _I, _I]
    lib.ntt_fourstep_cluster_log.restype = _I
    lib.ntt_error_string.argtypes = [_I]
    lib.ntt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if rc != 0:
        msg = lib.ntt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
