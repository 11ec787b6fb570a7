"""Public API: the single-prime negacyclic ring on an NVIDIA GPU.

Counterpart of ``agilex_ntt_tpu/api.py::Ring`` for radix-2 sizes
(n <= 32768), with the same public layout: (..., n) in, (..., n) out, and
(..., k, n) for ``polydot``.  Values are ``torch.uint32``.

Typical use::

    ring = Ring(4096)                      # 30-bit prime, on the GPU
    y = ring.ntt(x)                        # x: (..., 4096) uint32, values < q
    z = ring.intt(y)
    c = ring.polymul(a, b)                 # negacyclic convolution mod q

The transforms, the polymul and the polydot run the hand-written CUDA
kernels of ``ops/ntt_kernel.py``.  The elementwise ring operations are plain
PyTorch on int64, as the JAX package leaves them to XLA.  ``Ring(n)`` runs on
the GPU and raises when there is none; ``device="cpu"`` selects the plain
CPU versions (the tests use it).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import NTTConfig, is_power_of_two
from .ops import modmul as mm
from .ops import ntt_kernel
from .ops.plain_ntt import make_tables
from .params import NTTParams, bit_reverse, find_primes, make_params

# Largest size of the radix-2 transforms; larger rings need the four-step
# decomposition, which is not ported yet.
MAX_RADIX2_N = 32768


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' for the plain "
            "PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class Ring:
    """The negacyclic polynomial ring R_q = Z_q[X] / (X^n + 1).

    Args:
      n: a power of two, 8 <= n <= 32768.
      q: a prime q ≡ 1 (mod 2n), q < 2**30; default the largest such prime.
      psi: a primitive 2n-th root of unity mod q; default the one
        ``find_psi`` picks (the JAX package's choice).
      device: ``None`` for the current CUDA device, or ``"cpu"``.
    """

    def __init__(
        self,
        n: int,
        q: Optional[int] = None,
        *,
        psi: Optional[int] = None,
        device=None,
    ):
        if is_power_of_two(n) and n > MAX_RADIX2_N:
            raise NotImplementedError(
                f"n={n} > {MAX_RADIX2_N} needs the four-step transforms, "
                "which come with the four-step slice of the port"
            )
        if q is None:
            q = find_primes(n, 1)[0]
        self.config = NTTConfig(n=n, q=q)
        self.n = n
        self.q = q
        self.device = _resolve_device(device)
        self._params = make_params(n, q, psi)
        self.tables = make_tables(self._params, self.device)
        # Montgomery constants for pointwise products (R = 2**32)
        self.qinv_neg = self.tables.qinv_neg
        self.r2_mod_q = pow(1 << 32, 2, q)
        self.n_inv = self.tables.n_inv
        # folds R out of the Montgomery pointwise product, and n^-1
        self.polymul_scale = self.tables.polymul_scale
        self._cache = {}

    @property
    def params(self) -> NTTParams:
        return self._params

    # -- shape plumbing ------------------------------------------------------

    def _as_u32(self, x) -> torch.Tensor:
        """x as torch.uint32 on the ring's device (a truncating cast; the
        caller guarantees values < 2**32)."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, dtype=np.uint32, copy=True))
        return x.to(device=self.device, dtype=torch.uint32)

    def _flatten(self, x: torch.Tensor) -> Tuple[torch.Tensor, tuple]:
        if x.dim() == 0 or x.shape[-1] != self.n:
            raise ValueError(f"last dim must be n={self.n}, got {tuple(x.shape)}")
        lead = tuple(x.shape[:-1])
        if x.numel() == 0:
            raise ValueError(f"empty batch: shape {tuple(x.shape)}")
        return x.reshape(-1, self.n).contiguous(), lead

    def _i64(self, x) -> torch.Tensor:
        return self._as_u32(x).to(torch.int64)

    @staticmethod
    def _u32(x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.uint32)

    # -- transforms ----------------------------------------------------------

    def ntt(self, x) -> torch.Tensor:
        """Forward negacyclic NTT, (..., n) in [0, 4q) -> (..., n) in [0, q)."""
        flat, lead = self._flatten(self._as_u32(x))
        return ntt_kernel.fwd_ntt(flat, self.tables).view(lead + (self.n,))

    def intt(self, x, *, scale: Optional[int] = None) -> torch.Tensor:
        """Inverse negacyclic NTT, (..., n) in [0, 2q) -> (..., n) in [0, q).

        ``scale`` replaces the final n^-1 factor."""
        flat, lead = self._flatten(self._as_u32(x))
        y = ntt_kernel.inv_ntt(flat, self.tables, scale=scale)
        return y.view(lead + (self.n,))

    # -- ring arithmetic -----------------------------------------------------

    def polymul(self, a, b) -> torch.Tensor:
        """Negacyclic product a*b mod (X^n + 1, q), coefficients in and out,
        in one fused kernel.  Leading dimensions broadcast."""
        a, b = torch.broadcast_tensors(self._as_u32(a), self._as_u32(b))
        af, lead = self._flatten(a)
        bf, _ = self._flatten(b)
        out = ntt_kernel.polymul_fused(af, bf, self.tables)
        return out.view(lead + (self.n,))

    def polydot(self, a, b) -> torch.Tensor:
        """Inner product sum_i a_i * b_i mod (X^n + 1, q) of (..., k, n)
        vectors -> (..., n), in one fused kernel: 2k forward transforms, the
        lazy sum of the Montgomery products, one inverse."""
        a, b = self._as_u32(a), self._as_u32(b)
        if a.shape != b.shape or a.dim() < 2 or a.shape[-1] != self.n:
            raise ValueError(
                f"polydot expects matching (..., k, n={self.n}) shapes, got "
                f"{tuple(a.shape)} and {tuple(b.shape)}"
            )
        lead, k = tuple(a.shape[:-2]), a.shape[-2]
        if a.numel() == 0:
            raise ValueError(f"empty operands: shape {tuple(a.shape)}")
        af = a.reshape(-1, k, self.n).contiguous()
        bf = b.reshape(-1, k, self.n).contiguous()
        out = ntt_kernel.polydot_fused(af, bf, self.tables)
        return out.view(lead + (self.n,))

    def _mont_lazy(self, a: torch.Tensor, b) -> torch.Tensor:
        return mm.mont_mul_lazy(a, b, self.q, self.qinv_neg)

    def pointwise_mul_lazy(self, a, b) -> torch.Tensor:
        """Elementwise a*b*2^-32 mod q in [0, 2q) (NTT-domain Hadamard);
        operands below 2**31."""
        return self._u32(self._mont_lazy(self._i64(a), self._i64(b)))

    def pointwise_mul(self, a, b) -> torch.Tensor:
        """Elementwise exact a*b mod q in [0, q): mont(mont(a, b), R^2)."""
        t = self._mont_lazy(self._i64(a), self._i64(b))
        t = self._mont_lazy(t, self.r2_mod_q)
        return self._u32(mm.cond_sub(t, self.q))

    def add(self, a, b) -> torch.Tensor:
        return self._u32(mm.add_mod(self._i64(a), self._i64(b), self.q))

    def sub(self, a, b) -> torch.Tensor:
        return self._u32(mm.sub_mod(self._i64(a), self._i64(b), self.q))

    def neg(self, a) -> torch.Tensor:
        return self._u32(mm.neg_mod(self._i64(a), self.q))

    def tensor(self, a0, a1, b0, b1):
        """RLWE tensor product (d0, d1, d2) = (a0 b0, a0 b1 + a1 b0, a1 b1)
        with 4 forward and 3 inverse transforms (Karatsuba on the
        transforms: the cross term is (A0+A1)(B0+B1) - D0 - D2)."""
        q = self.q
        fa0, fa1, fb0, fb1 = (
            self.ntt(v).to(torch.int64) for v in (a0, a1, b0, b1)
        )
        sa = mm.cond_sub(fa0 + fa1, q)
        sb = mm.cond_sub(fb0 + fb1, q)
        d0 = mm.cond_sub(self._mont_lazy(fa0, fb0), q)
        d2 = mm.cond_sub(self._mont_lazy(fa1, fb1), q)
        cr = mm.cond_sub(self._mont_lazy(sa, sb), q)
        d1 = mm.cond_sub(mm.cond_sub(cr - d0 + q, q) - d2 + q, q)
        # every term carries one R^-1 from the lazy Hadamard;
        # polymul_scale (= n^-1 R) folds it into the inverse
        sc = self.polymul_scale
        return tuple(self.intt(self._u32(d), scale=sc) for d in (d0, d1, d2))

    def tensor_square(self, a0, a1):
        """Tensor square (a0^2, 2 a0 a1, a1^2): 2 forward and 3 inverse
        transforms (see ``tensor``)."""
        q = self.q
        fa0, fa1 = (self.ntt(v).to(torch.int64) for v in (a0, a1))
        d0 = mm.cond_sub(self._mont_lazy(fa0, fa0), q)
        d2 = mm.cond_sub(self._mont_lazy(fa1, fa1), q)
        x = mm.cond_sub(self._mont_lazy(fa0, fa1), q)
        d1 = mm.cond_sub(x + x, q)
        sc = self.polymul_scale
        return tuple(self.intt(self._u32(d), scale=sc) for d in (d0, d1, d2))

    # -- permutations ----------------------------------------------------------

    def _on_device(self, key, build):
        """Per-ring cache of index tables, built on the host once per key."""
        hit = self._cache.get(key)
        if hit is None:
            hit = tuple(torch.from_numpy(t).to(self.device) for t in build())
            self._cache[key] = hit
        return hit

    def _gather_signed(self, x: torch.Tensor, src, neg) -> torch.Tensor:
        g = x.to(torch.int64).index_select(-1, src)
        return self._u32(torch.where(neg, mm.neg_mod(g, self.q), g))

    def rotate(self, x, k: int) -> torch.Tensor:
        """Multiply by X^k (negacyclic rotation); k may be any integer."""
        x = self._as_u32(x)
        if x.dim() == 0 or x.shape[-1] != self.n:
            raise ValueError(f"last dim must be n={self.n}, got {tuple(x.shape)}")
        n = self.n
        k %= 2 * n

        def build():
            src = (np.arange(n) - k) % (2 * n)
            neg = src >= n
            return np.where(neg, src - n, src).astype(np.int64), neg

        src, neg = self._on_device(("rotate", k), build)
        return self._gather_signed(x, src, neg)

    def _auto_tables(self, k: int):
        """Gather indices and signs of tau_k: a(X) -> a(X^k) mod (X^n + 1).

        Coefficient domain: output position p takes source j = p * k^-1 mod
        2n (sign +), or j - n with sign - when j >= n.  NTT domain: slot p
        holds A(psi^(2 br(p) + 1)), so tau_k moves slot p' to p with
        2 br(p') + 1 = (2 br(p) + 1) k mod 2n.
        """
        n = self.n
        logn = n.bit_length() - 1

        def build():
            j = np.arange(n) * pow(k, -1, 2 * n) % (2 * n)
            neg = j >= n
            br = np.array([bit_reverse(i, logn) for i in range(n)])
            e = (2 * br + 1) * k % (2 * n)
            ntt_src = br[(e - 1) // 2]
            return np.where(neg, j - n, j).astype(np.int64), neg, ntt_src

        return self._on_device(("auto", k), build)

    def automorphism(self, x, k: int, *, domain: str = "coeff") -> torch.Tensor:
        """Galois automorphism tau_k: a(X) -> a(X^k) mod (X^n + 1), k odd.

        domain="coeff": x holds coefficients in [0, q).
        domain="ntt":   x holds NTT-domain values (any); the automorphism is
        then a pure slot permutation.
        """
        if k % 2 == 0:
            raise ValueError(f"k must be odd (unit mod 2n), got {k}")
        if domain not in ("coeff", "ntt"):
            raise ValueError(f"unknown domain {domain!r}")
        k %= 2 * self.n
        x = self._as_u32(x)
        if x.dim() == 0 or x.shape[-1] != self.n:
            raise ValueError(f"last dim must be n={self.n}, got {tuple(x.shape)}")
        src, neg, ntt_src = self._auto_tables(k)
        if domain == "ntt":
            return x.to(torch.int64).index_select(-1, ntt_src).to(torch.uint32)
        return self._gather_signed(x, src, neg)

    # -- validation and sampling ---------------------------------------------

    def check(self, x, *, bound: Optional[int] = None) -> torch.Tensor:
        """Raise if any value is outside [0, bound) (default q); return x as
        uint32.  The kernels take lazy inputs up to 4q (forward) and 2q
        (inverse) and give wrong results beyond; this finds such inputs."""
        x = self._as_u32(x)
        b = self.q if bound is None else bound
        wide = x.to(torch.int64)
        bad = int((wide >= b).sum())
        if bad:
            raise ValueError(
                f"{bad} coefficient(s) outside [0, {b}); max value "
                f"{int(wide.max())}"
            )
        return x

    def random_coeffs(self, generator: torch.Generator, shape=()) -> torch.Tensor:
        """Uniform random ring elements of shape (*shape, n), drawn from
        ``generator`` (which must live on the ring's device)."""
        x = torch.randint(
            0, self.q, tuple(shape) + (self.n,), generator=generator,
            dtype=torch.int64, device=self.device,
        )
        return self._u32(x)

    def __repr__(self):
        return f"Ring(n={self.n}, q={self.q}, device={str(self.device)!r})"
