"""Primes, roots of unity and twiddle tables (host side, pure Python + numpy).

A copy of the table generation in ``agilex_ntt_tpu/params.py``: the same
primes, the same psi and the same tables, so the two packages agree bit for
bit.  Tables are in HEXL bit-reversed order, ``roots[i] = psi^bitrev(i)``,
so that stage m, butterfly group i reads ``roots[m + i]`` with no runtime
bit reversal; the forward transform then satisfies
``out[k] = A(psi^(2*bitrev(k) + 1))``.

``params_from_numpy`` carries a ring's tables from the JAX package (as numpy
arrays) into this one, checked against what this package builds itself.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import numpy as np

from .config import log2_exact

_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers all 64-bit ints)."""
    if n < 2:
        return False
    for p in _MR_BASES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_BASES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def find_primes(n: int, count: int, bits: int = 30) -> List[int]:
    """`count` NTT-friendly primes q ≡ 1 (mod 2n), q < 2**bits, descending
    from 2**bits (SEAL-Embedded style prime chains)."""
    if bits > 62:
        raise ValueError("Harvey lazy range needs 4q < 2**64, i.e. bits <= 62")
    m = 2 * n
    q = ((1 << bits) - 1) // m * m + 1
    out: List[int] = []
    while len(out) < count and q > m:
        if is_prime(q):
            out.append(q)
        q -= m
    if len(out) < count:
        raise ValueError(f"could not find {count} primes ≡ 1 mod {m} below 2**{bits}")
    return out


def _pollard_rho(n: int) -> int:
    """A nontrivial factor of composite odd n (Brent's cycle variant)."""
    if n % 2 == 0:
        return 2
    seed = 1
    while True:
        seed += 1
        x = y = 2
        c = seed
        d = 1
        while d == 1:
            x = (x * x + c) % n
            y = (y * y + c) % n
            y = (y * y + c) % n
            d = math.gcd(abs(x - y), n)
        if d != n:
            return d


def _factorize(n: int) -> List[int]:
    """Distinct prime factors: trial division, then Pollard rho."""
    fs = []
    d = 2
    while d * d <= n and d < 100_000:
        if n % d == 0:
            fs.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n == 1:
        return fs
    stack = [n]
    found = set()
    while stack:
        m = stack.pop()
        if m == 1:
            continue
        if is_prime(m):
            found.add(m)
            continue
        f = _pollard_rho(m)
        stack.append(f)
        stack.append(m // f)
    return fs + sorted(found)


def primitive_root(q: int) -> int:
    """Smallest generator of Z_q^* (q prime)."""
    phi = q - 1
    factors = _factorize(phi)
    g = 2
    while True:
        if all(pow(g, phi // f, q) != 1 for f in factors):
            return g
        g += 1


def find_psi(n: int, q: int) -> int:
    """A primitive 2n-th root of unity mod q (so psi^n ≡ -1)."""
    g = primitive_root(q)
    psi = pow(g, (q - 1) // (2 * n), q)
    if pow(psi, n, q) != q - 1:
        raise ValueError(f"no primitive 2n-th root found for n={n}, q={q}")
    return psi


def bit_reverse(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def bit_reverse_array(n: int) -> np.ndarray:
    """bit_reverse(i, log2 n) for every i in [0, n), as int64, vectorised."""
    logn = log2_exact(n)
    i = np.arange(n, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        out |= ((i >> b) & 1) << (logn - 1 - b)
    return out


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: identity hash; instances
# are interned by make_params's lru_cache so identity == value identity.
class NTTParams:
    """All precomputed constants for one ring Z_q[X]/(X^n + 1).

    ``roots[i] = psi^bitrev(i, log n)``; inverse tables hold the elementwise
    inverses under the same indexing.  Shoup precons are
    ``floor(W * 2**64 / q)`` (golden uint64 model) and
    ``floor(W * 2**32 / q)`` (the 32-bit kernels).
    """

    n: int
    q: int
    psi: int
    roots: np.ndarray          # uint64 [n]  W[i] = psi^br(i)
    precon64: np.ndarray       # uint64 [n]  floor(W * 2^64 / q)
    inv_roots: np.ndarray      # uint64 [n]  W[i]^-1 mod q
    inv_precon64: np.ndarray   # uint64 [n]
    n_inv: int                 # n^-1 mod q
    roots32: np.ndarray        # uint32 [n]
    precon32: np.ndarray       # uint32 [n]  floor(W * 2^32 / q)
    inv_roots32: np.ndarray    # uint32 [n]
    inv_precon32: np.ndarray   # uint32 [n]

    @property
    def log_n(self) -> int:
        return log2_exact(self.n)


def make_params(n: int, q: int, psi: Optional[int] = None) -> NTTParams:
    """All tables for (n, q); cached.  psi is resolved before the cache so
    ``make_params(n, q)`` and ``make_params(n, q, found_psi)`` share one
    instance."""
    if q % (2 * n) != 1:
        raise ValueError(f"q ≡ 1 (mod 2n) required: q={q} n={n}")
    if not is_prime(q):
        raise ValueError(f"q={q} is not prime")
    if psi is None:
        psi = find_psi(n, q)
    elif pow(psi, n, q) != q - 1:
        raise ValueError("provided psi is not a primitive 2n-th root")
    return _make_params_cached(n, q, psi)


@functools.lru_cache(maxsize=64)
def _make_params_cached(n: int, q: int, psi: int) -> NTTParams:
    logn = log2_exact(n)
    roots_py = [pow(psi, bit_reverse(i, logn), q) for i in range(n)]
    inv_roots_py = [pow(w, q - 2, q) for w in roots_py]
    # a wide-ring modulus (q >= 2**30; ``WideRing`` reads the u64 tables)
    # has no 32-bit tables: they are masked to 32 bits, as the JAX package
    # does, so that every NTTParams has the same fields
    mask32 = (1 << 32) - 1 if q >> 30 else -1

    def u32(words):
        return np.array([w & mask32 for w in words], dtype=np.uint32)

    return NTTParams(
        n=n,
        q=q,
        psi=psi,
        roots=np.array(roots_py, dtype=np.uint64),
        precon64=np.array([(w << 64) // q for w in roots_py], dtype=np.uint64),
        inv_roots=np.array(inv_roots_py, dtype=np.uint64),
        inv_precon64=np.array(
            [(w << 64) // q for w in inv_roots_py], dtype=np.uint64
        ),
        n_inv=pow(n, q - 2, q),
        roots32=u32(roots_py),
        precon32=u32((w << 32) // q for w in roots_py),
        inv_roots32=u32(inv_roots_py),
        inv_precon32=u32((w << 32) // q for w in inv_roots_py),
    )


def params_from_numpy(
    n: int,
    q: int,
    psi: int,
    roots32,
    precon32,
    inv_roots32,
    inv_precon32,
) -> NTTParams:
    """Carry one ring's tables across from numpy arrays (for example those of
    the JAX package's ``NTTParams``) and return this package's ``NTTParams``.

    The tables are the ring's only state.  They must equal what
    ``make_params(n, q, psi)`` builds, elementwise; a table from another
    prime, root or order raises ``ValueError`` naming the first mismatch.
    """
    params = make_params(int(n), int(q), int(psi))
    given = {
        "roots32": roots32,
        "precon32": precon32,
        "inv_roots32": inv_roots32,
        "inv_precon32": inv_precon32,
    }
    for name, arr in given.items():
        arr = np.asarray(arr)
        want = getattr(params, name)
        if arr.shape != want.shape:
            raise ValueError(f"{name}: shape {arr.shape}, expected {want.shape}")
        bad = np.flatnonzero(arr.astype(np.uint64) != want.astype(np.uint64))
        if bad.size:
            i = int(bad[0])
            raise ValueError(
                f"{name}[{i}] = {int(arr[i])}, expected {int(want[i])} "
                f"for n={n}, q={q}, psi={psi}"
            )
    return params


# ---------------------------------------------------------------------------
# Cyclic tables: the row pass of the four-step transform, and CyclicRing
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash, interned by
# make_cyclic_params's lru_cache as NTTParams is
class CyclicParams:
    """Tables for a size-n *cyclic* NTT (root omega of order n).

    The same ``roots32[m + i]`` layout as ``NTTParams``, so the same stage
    loop and kernels run it, with the cyclic twiddles
    ``roots32[m + i] = omega^(bitrev(i, log2 m) * n / 2m)``; the forward
    transform then gives ``out[bitrev(k)] = A(omega^k)``.
    """

    n: int
    q: int
    omega: int
    roots32: np.ndarray        # uint32 [n]
    precon32: np.ndarray       # uint32 [n]  floor(W * 2^32 / q)
    inv_roots32: np.ndarray    # uint32 [n]
    inv_precon32: np.ndarray   # uint32 [n]
    n_inv: int                 # n^-1 mod q

    @property
    def log_n(self) -> int:
        return log2_exact(self.n)


@functools.lru_cache(maxsize=64)
def make_cyclic_params(n: int, q: int, omega: int) -> CyclicParams:
    """Tables for the cyclic size-n NTT with primitive n-th root ``omega``."""
    if pow(omega, n, q) != 1:
        raise ValueError("omega^n != 1")
    if n > 1 and pow(omega, n // 2, q) == 1:
        raise ValueError("omega is not a primitive n-th root")
    logn = log2_exact(n)
    roots_py = [1] * n
    for s in range(logn):
        m = 1 << s
        stride = n // (2 * m)
        for i in range(m):
            roots_py[m + i] = pow(omega, bit_reverse(i, s) * stride, q)
    inv_roots_py = [pow(w, q - 2, q) for w in roots_py]
    return CyclicParams(
        n=n,
        q=q,
        omega=omega,
        roots32=np.array(roots_py, dtype=np.uint32),
        precon32=np.array([(w << 32) // q for w in roots_py], dtype=np.uint32),
        inv_roots32=np.array(inv_roots_py, dtype=np.uint32),
        inv_precon32=np.array(
            [(w << 32) // q for w in inv_roots_py], dtype=np.uint32
        ),
        n_inv=pow(n, q - 2, q),
    )


def fourstep_split(n: int) -> Tuple[int, int]:
    """Balanced power-of-two split n = n1 * n2 with n1 >= n2: n1 is the
    column (negacyclic) size, n2 the row (cyclic) size."""
    logn = log2_exact(n)
    l1 = (logn + 1) // 2
    return 1 << l1, 1 << (logn - l1)
