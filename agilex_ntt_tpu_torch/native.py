"""ctypes bindings for the native host core (``csrc/nttcore.c``).

The port's own copy of ``agilex_ntt_tpu/native.py``: the same functions on
the same library, ``libnttcore.so``, which ``make native`` builds into
``build/``.  ``available()`` says whether it was found.  The core is a
C-speed third implementation of the golden model on the host (numpy and
ctypes only), an oracle for tests and test vectors; nothing on the card's
path calls it.

``load(path)`` loads a library built elsewhere (a test builds one into a
temporary directory); without a path the first ``libnttcore.so`` in
``build/``, the repository root or ``csrc/`` is used.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB_NAMES = ("libnttcore.so",)
_lib: Optional[ctypes.CDLL] = None


def _find_lib() -> Optional[str]:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for d in (os.path.join(here, "build"), here, os.path.join(here, "csrc")):
        for name in _LIB_NAMES:
            p = os.path.join(d, name)
            if os.path.exists(p):
                return p
    return None


def load(path: Optional[str] = None) -> Optional[ctypes.CDLL]:
    """The core with every signature declared: the library at ``path``, or
    the one ``make native`` built (None when there is none)."""
    global _lib
    if path is None:
        if _lib is not None:
            return _lib
        path = _find_lib()
        if path is None:
            return None
    lib = ctypes.CDLL(path)
    u64 = ctypes.c_uint64
    u64p = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")
    lib.ntt_is_prime.argtypes = [u64]
    lib.ntt_is_prime.restype = ctypes.c_int
    lib.ntt_find_primes.argtypes = [u64, ctypes.c_int, ctypes.c_int, u64p]
    lib.ntt_find_primes.restype = ctypes.c_int
    lib.ntt_find_psi.argtypes = [u64, u64]
    lib.ntt_find_psi.restype = u64
    lib.ntt_make_tables.argtypes = [u64, u64, u64, u64p, u64p]
    lib.ntt_make_tables.restype = None
    lib.ntt_fwd_u64.argtypes = [u64p, u64, u64, u64, u64p, u64p]
    lib.ntt_fwd_u64.restype = None
    lib.ntt_inv_u64.argtypes = [u64p, u64, u64, u64, u64p, u64p, u64]
    lib.ntt_inv_u64.restype = None
    lib.ntt_pointwise_u64.argtypes = [u64p, u64p, u64p, u64, u64]
    lib.ntt_pointwise_u64.restype = None
    _lib = lib
    return lib


def available() -> bool:
    return load() is not None


def _req() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError(
            "native core not built — run `make native` (builds "
            "build/libnttcore.so from csrc/nttcore.c)"
        )
    return lib


def is_prime(n: int) -> bool:
    return bool(_req().ntt_is_prime(n))


def find_primes(n: int, count: int, bits: int = 30) -> np.ndarray:
    """The ``count`` largest primes q ≡ 1 (mod 2n) below 2**bits."""
    out = np.zeros(count, dtype=np.uint64)
    got = _req().ntt_find_primes(n, count, bits, out)
    if got < count:
        raise ValueError(f"found only {got}/{count} primes")
    return out


def find_psi(n: int, q: int) -> int:
    psi = int(_req().ntt_find_psi(n, q))
    if psi == 0:
        raise ValueError(f"no primitive 2n-th root: is q prime with q % (2*{n}) == 1?")
    return psi


def make_tables(n: int, q: int, psi: int):
    """(roots, precons): psi^bitrev(i) and floor(root * 2**64 / q)."""
    roots = np.zeros(n, dtype=np.uint64)
    precons = np.zeros(n, dtype=np.uint64)
    _req().ntt_make_tables(n, q, psi, roots, precons)
    return roots, precons


def _rows(x: np.ndarray):
    a = np.ascontiguousarray(x, dtype=np.uint64).copy()
    batch, n = (1, a.shape[0]) if a.ndim == 1 else a.shape
    return a, batch, n


def fwd_ntt(x: np.ndarray, q: int, roots: np.ndarray, precons: np.ndarray):
    """Forward NTT of (batch, n) or (n,) uint64, a new array in [0, q)."""
    a, batch, n = _rows(x)
    _req().ntt_fwd_u64(a.reshape(-1), batch, n, q, roots, precons)
    return a


def inv_ntt(x: np.ndarray, q: int, iroots: np.ndarray, iprecons: np.ndarray,
            scale: int = 0):
    """Inverse NTT scaled by n^-1 (or ``scale`` if nonzero), in [0, q)."""
    a, batch, n = _rows(x)
    _req().ntt_inv_u64(a.reshape(-1), batch, n, q, iroots, iprecons, scale)
    return a


def pointwise(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=np.uint64)
    b = np.ascontiguousarray(b, dtype=np.uint64)
    c = np.zeros_like(a)
    _req().ntt_pointwise_u64(a.reshape(-1), b.reshape(-1), c.reshape(-1), a.size, q)
    return c
