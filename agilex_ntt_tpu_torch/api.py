"""Public API: the negacyclic and cyclic rings on an NVIDIA GPU.

Counterpart of ``agilex_ntt_tpu/api.py::Ring``, ``CyclicRing`` and
``RNSRing``, with the same public layout: (..., n) in, (..., n) out, and
(..., k, n) for ``polydot``; an ``RNSRing`` puts its L prime channels
first, (L, ..., n).  Values are ``torch.uint32``.  Sizes up to 32768 run the
radix-2 transform (K1, K2 on register-radix passes); larger ones (and
``method="fourstep"`` at any size) the
four-step kernels of ``ops/fourstep.py``, with the tiled (..., n1, n2) API
beside the flat one.

Typical use::

    ring = Ring(4096)                      # 30-bit prime, on the GPU
    y = ring.ntt(x)                        # x: (..., 4096) uint32, values < q
    z = ring.intt(y)
    c = ring.polymul(a, b)                 # negacyclic convolution mod q

The transforms, the polymul and the polydot run the hand-written CUDA
kernels of ``ops/ntt_kernel.py`` (one launch for all channels of a radix-2
``RNSRing``; a four-step ``RNSRing`` loops over its channels' rings).  The
elementwise ring operations are plain PyTorch on int64, as the JAX package
leaves them to XLA.  ``Ring(n)``, ``CyclicRing(n)`` and ``RNSRing(n, L)``
run on the GPU and raise when there is none; ``device="cpu"`` selects the
plain CPU versions (the tests use it).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import NTTConfig
from .ops import basechange, gadget
from .ops import fourstep
from .ops import modmul as mm
from .ops import ntt_kernel, wide, wide_kernel
from .ops.plain_ntt import make_fourstep_tables, make_rns_tables, make_tables
from .params import (
    CyclicParams,
    NTTParams,
    bit_reverse_array,
    find_primes,
    is_prime,
    make_cyclic_params,
    make_params,
    primitive_root,
)
from .utils.crt import crt_compose

# Largest size of the radix-2 transforms; larger rings use the four-step
# decomposition.
MAX_RADIX2_N = 32768
# Largest n of fourstep_kernel="flat", the JAX package's bound
# (agilex_ntt_tpu/ops/flat_fuse.py).  On the card the flat and the tiled
# layouts are the same bytes and run the same kernels.
FLAT_FUSE_MAX_N = 1 << 17


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


# Constructor arguments of the JAX package's rings that choose or tune its
# TPU kernels: the Pallas or XLA backend, the kernels' block rows, Pallas's
# interpret mode.  No kernel of the port has them, so the port refuses them
# rather than ignore them.
TPU_ONLY_ARGS = ("backend", "block_rows", "interpret")


def _refuse_unknown(owner: str, names) -> None:
    """Raise ``TypeError`` for keyword arguments ``owner`` does not take,
    naming the JAX package's TPU-only ones as such."""
    for name in names:
        if name in TPU_ONLY_ARGS:
            raise TypeError(
                f"{owner}: {name}= is one of the JAX package's TPU-only "
                f"options {TPU_ONLY_ARGS}; the port's kernels have none"
            )
        raise TypeError(f"{owner}() got an unexpected keyword argument {name!r}")


def _resolve_method(n: int, method: Optional[str]) -> str:
    """"radix2" or "fourstep"; default four-step above ``MAX_RADIX2_N``."""
    if method is None:
        method = "fourstep" if n > MAX_RADIX2_N else "radix2"
    if method not in ("radix2", "fourstep"):
        raise ValueError(f"unknown method {method!r}")
    if method == "radix2" and n > MAX_RADIX2_N:
        raise ValueError(
            f"radix2 supports n <= {MAX_RADIX2_N}; use method='fourstep'"
        )
    return method


class _TransformRing:
    """The transforms and the fused product shared by ``Ring`` and
    ``CyclicRing``: a subclass sets ``n``, ``device``, ``method`` and either
    ``tables`` (radix-2) or ``plan`` and ``fourstep`` (four-step), and the
    twiddles in those tables make the ring negacyclic or cyclic."""

    n: int
    device: torch.device
    method: str
    tables: Optional[object]
    plan: Optional[fourstep.FourStepPlan]
    fourstep: Optional[object]

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

    @property
    def tile_shape(self) -> Tuple[int, int]:
        """(n1, n2) of the four-step decomposition."""
        self._require_fourstep("tile_shape")
        return (self.plan.n1, self.plan.n2)

    def _require_fourstep(self, what: str) -> None:
        if self.method != "fourstep":
            raise ValueError(
                f"{what} is only available on four-step rings "
                f"(method='fourstep'); this ring is method={self.method!r}"
            )

    def _tile(self, flat: torch.Tensor) -> torch.Tensor:
        """(B, n) -> (B, n1, n2), a view of the same bytes."""
        return flat.view((flat.shape[0],) + self.tile_shape)

    # -- transforms ----------------------------------------------------------

    def ntt(self, x) -> torch.Tensor:
        """Forward NTT, (..., n) in [0, 4q) -> (..., n) in [0, q):
        negacyclic on a ``Ring``, cyclic (out[bitrev(k)] = A(omega^k)) on a
        ``CyclicRing``."""
        flat, lead = self._flatten(self._as_u32(x))
        if self.fourstep is not None:
            y = fourstep.fwd_ntt_fourstep_tiled(self._tile(flat), self.fourstep)
        else:
            y = ntt_kernel.fwd_ntt(flat, self.tables)
        return y.view(lead + (self.n,))

    def intt(self, x, *, scale: Optional[int] = None) -> torch.Tensor:
        """Inverse NTT, (..., n) in [0, 2q) -> (..., n) in [0, q).

        ``scale`` replaces the final n^-1 factor."""
        flat, lead = self._flatten(self._as_u32(x))
        if self.fourstep is not None:
            y = fourstep.inv_ntt_fourstep_tiled(
                self._tile(flat), self.fourstep, scale=scale
            )
        else:
            y = ntt_kernel.inv_ntt(flat, self.tables, scale=scale)
        return y.view(lead + (self.n,))

    def polymul(self, a, b) -> torch.Tensor:
        """Product a*b in the ring (mod X^n + 1 on a ``Ring``, X^n - 1 on a
        ``CyclicRing``), coefficients in and out, in one fused kernel (K3;
        K8 on a four-step ring up to n = 2^19, the composed transforms
        beyond).  Leading dimensions broadcast."""
        a, b = torch.broadcast_tensors(self._as_u32(a), self._as_u32(b))
        af, lead = self._flatten(a)
        bf, _ = self._flatten(b)
        if self.fourstep is not None:
            out = fourstep.polymul_fourstep_tiled(
                self._tile(af), self._tile(bf), self.fourstep
            )
        else:
            out = ntt_kernel.polymul_fused(af, bf, self.tables)
        return out.view(lead + (self.n,))


class Ring(_TransformRing):
    """The negacyclic polynomial ring R_q = Z_q[X] / (X^n + 1).

    Args:
      n: a power of two >= 8.
      q: a prime q ≡ 1 (mod 2n), q < 2**30; default the largest such prime.
      psi: a primitive 2n-th root of unity mod q; default the one
        ``find_psi`` picks (the JAX package's choice).
      method: "radix2" (n <= 32768) or "fourstep"; default four-step above
        32768.  "auto" takes the route that ``utils/autotune.py`` measured
        fastest for this n and q's bit length on this device's kind (its
        cache, at the largest tuned batch), and the default on a miss.
      fourstep_kernel: "tiled" (the default of a four-step ring) or "flat"
        (n <= ``FLAT_FUSE_MAX_N``).  "flat" is an alias kept for parity with
        the JAX package's API: on the card (B, n) and (B, n1, n2) are the
        same bytes, so both values run the same kernels.
      device: ``None`` for the current CUDA device, or ``"cpu"``.

    The JAX package's ``backend``, ``block_rows`` and ``interpret`` tune its
    TPU kernels; they raise ``TypeError`` here.
    """

    def __init__(
        self,
        n: int,
        q: Optional[int] = None,
        *,
        psi: Optional[int] = None,
        method: Optional[str] = None,
        fourstep_kernel: Optional[str] = None,
        device=None,
        **unknown,
    ):
        _refuse_unknown("Ring", unknown)
        if q is None:
            q = find_primes(n, 1)[0]
        self.config = NTTConfig(n=n, q=q)
        self.n = n
        self.q = q
        if method == "auto":
            # the persisted autotune cache (utils/autotune.py); a miss takes
            # the default.  It is only read here.
            from .utils.autotune import cached_config  # lazy: import cycle

            method = (cached_config(n, q, device=device) or {}).get("method")
        self.method = _resolve_method(n, method)
        if fourstep_kernel not in (None, "tiled", "flat"):
            raise ValueError(
                f"unknown fourstep_kernel {fourstep_kernel!r}; "
                "expected 'tiled' or 'flat'"
            )
        if fourstep_kernel is not None and self.method != "fourstep":
            raise ValueError("fourstep_kernel requires method='fourstep'")
        if fourstep_kernel == "flat" and n > FLAT_FUSE_MAX_N:
            raise ValueError(
                f"fourstep_kernel='flat' supports n <= {FLAT_FUSE_MAX_N} "
                "(the JAX package's bound)"
            )
        self.fourstep_kernel = fourstep_kernel or (
            "tiled" if self.method == "fourstep" else None
        )
        self.device = _resolve_device(device)
        if self.method == "fourstep":
            # O(sqrt n) bignum work; the full-size NTTParams (O(n) pows) is
            # built only if .params is touched
            self.plan: Optional[fourstep.FourStepPlan] = fourstep.make_plan(
                n, q, psi
            )
            self._psi = self.plan.psi
            self.fourstep = make_fourstep_tables(self.plan, self.device)
            self.tables = None
        else:
            params = make_params(n, q, psi)
            self.plan, self._psi, self.fourstep = None, params.psi, None
            self.tables = make_tables(params, self.device)
        # Montgomery constants for pointwise products (R = 2**32)
        self.qinv_neg = mm.mont_qinv_neg(q)
        self.r2_mod_q = pow(1 << 32, 2, q)
        self.n_inv = pow(n, q - 2, q)
        # folds R out of the Montgomery pointwise product, and n^-1
        self.polymul_scale = self.n_inv * ((1 << 32) % q) % q
        self._cache = {}

    @property
    def params(self) -> NTTParams:
        """The full-size tables (lazy for a four-step ring: O(n) bignum
        work, used by the golden model)."""
        return make_params(self.n, self.q, self._psi)

    def _i64(self, x) -> torch.Tensor:
        return self._as_u32(x).to(torch.int64)

    @staticmethod
    def _u32(x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.uint32)

    # -- tiled-domain API (four-step rings) ----------------------------------
    #
    # (..., n) and (..., n1, n2) are the same bytes on the card, so to_tiled
    # and from_tiled are views of contiguous input; the tiled calls exist so
    # that code written for the JAX package's tiled API runs unchanged.

    def _tiled_batch(self, x: torch.Tensor) -> Tuple[torch.Tensor, tuple]:
        n1, n2 = self.tile_shape
        if x.dim() < 2 or tuple(x.shape[-2:]) != (n1, n2):
            raise ValueError(
                f"tiled operands must end in (n1, n2)=({n1}, {n2}), "
                f"got {tuple(x.shape)}"
            )
        if x.numel() == 0:
            raise ValueError(f"empty batch: shape {tuple(x.shape)}")
        lead = tuple(x.shape[:-2])
        return x.reshape((-1, n1, n2)).contiguous(), lead

    def to_tiled(self, x) -> torch.Tensor:
        """(..., n) -> (..., n1, n2)."""
        self._require_fourstep("to_tiled")
        x = self._as_u32(x)
        if x.dim() == 0 or x.shape[-1] != self.n:
            raise ValueError(f"last dim must be n={self.n}, got {tuple(x.shape)}")
        return x.reshape(tuple(x.shape[:-1]) + self.tile_shape)

    def from_tiled(self, xt) -> torch.Tensor:
        """(..., n1, n2) -> (..., n)."""
        self._require_fourstep("from_tiled")
        xt = self._as_u32(xt)
        n1, n2 = self.tile_shape
        if xt.dim() < 2 or tuple(xt.shape[-2:]) != (n1, n2):
            raise ValueError(
                f"expected trailing (n1, n2)=({n1}, {n2}), got {tuple(xt.shape)}"
            )
        return xt.reshape(tuple(xt.shape[:-2]) + (self.n,))

    def ntt_tiled(self, xt) -> torch.Tensor:
        """Forward NTT on the tiled layout, (..., n1, n2) -> (..., n1, n2),
        equal to ``to_tiled(ntt(from_tiled(xt)))``."""
        self._require_fourstep("ntt_tiled")
        x3, lead = self._tiled_batch(self._as_u32(xt))
        y = fourstep.fwd_ntt_fourstep_tiled(x3, self.fourstep)
        return y.view(lead + self.tile_shape)

    def intt_tiled(self, xt, *, scale: Optional[int] = None) -> torch.Tensor:
        """Inverse NTT on the tiled layout (lazy [0, 2q) input)."""
        self._require_fourstep("intt_tiled")
        x3, lead = self._tiled_batch(self._as_u32(xt))
        y = fourstep.inv_ntt_fourstep_tiled(x3, self.fourstep, scale=scale)
        return y.view(lead + self.tile_shape)

    def polymul_tiled(self, a, b) -> torch.Tensor:
        """Negacyclic product on the tiled layout, (..., n1, n2) in and out;
        the same kernels as ``polymul``.  Leading dimensions broadcast."""
        self._require_fourstep("polymul_tiled")
        a, b = torch.broadcast_tensors(self._as_u32(a), self._as_u32(b))
        a3, lead = self._tiled_batch(a)
        b3, _ = self._tiled_batch(b)
        out = fourstep.polymul_fourstep_tiled(a3, b3, self.fourstep)
        return out.view(lead + self.tile_shape)

    # -- ring arithmetic -----------------------------------------------------

    def polydot(self, a, b) -> torch.Tensor:
        """Inner product sum_i a_i * b_i mod (X^n + 1, q) of (..., k, n)
        vectors -> (..., n), in one fused kernel: 2k forward transforms, the
        lazy sum of the Montgomery products, one inverse.  A four-step ring
        composes the same steps from its transforms, as the JAX package
        does."""
        a, b = self._as_u32(a), self._as_u32(b)
        if a.shape != b.shape or a.dim() < 2 or a.shape[-1] != self.n:
            raise ValueError(
                f"polydot expects matching (..., k, n={self.n}) shapes, got "
                f"{tuple(a.shape)} and {tuple(b.shape)}"
            )
        lead, k = tuple(a.shape[:-2]), a.shape[-2]
        if a.numel() == 0:
            raise ValueError(f"empty batch: shape {tuple(a.shape)}")
        af = a.reshape(-1, k, self.n).contiguous()
        bf = b.reshape(-1, k, self.n).contiguous()
        if self.fourstep is not None:
            terms = self._mont_lazy(
                self.ntt(af).to(torch.int64), self.ntt(bf).to(torch.int64)
            )
            acc = terms[:, 0]
            for i in range(1, k):  # lazy in [0, 2q), the fused kernel's order
                acc = mm.cond_sub(acc + terms[:, i], 2 * self.q)
            out = self.intt(self._u32(acc), scale=self.polymul_scale)
        else:
            out = ntt_kernel.polydot_fused(af, bf, self.tables)
        return out.view(lead + (self.n,))

    def _mont_lazy(self, a: torch.Tensor, b) -> torch.Tensor:
        return mm.mont_mul_lazy(a, b, self.q, self.qinv_neg)

    def pointwise_mul_lazy(self, a, b) -> torch.Tensor:
        """Elementwise a*b*2^-32 mod q (NTT-domain Hadamard), in [0, 2q)
        for lazy [0, 2q) operands; any uint32 words, as in the JAX
        package."""
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
        k %= 2 * self.n
        src, neg = self._rotate_tables(k)
        return self._gather_signed(x, src, neg)

    def _rotate_tables(self, k: int):
        """Gather indices and signs of multiplication by X^k, k in [0, 2n)."""
        n = self.n

        def build():
            src = (np.arange(n) - k) % (2 * n)
            neg = src >= n
            return np.where(neg, src - n, src).astype(np.int64), neg

        return self._on_device(("rotate", k), build)

    def _auto_tables(self, k: int):
        """Gather indices and signs of tau_k: a(X) -> a(X^k) mod (X^n + 1).

        Coefficient domain: output position p takes source j = p * k^-1 mod
        2n (sign +), or j - n with sign - when j >= n.  NTT domain: slot p
        holds A(psi^(2 br(p) + 1)), so tau_k moves slot p' to p with
        2 br(p') + 1 = (2 br(p) + 1) k mod 2n.
        """
        n = self.n

        def build():
            j = np.arange(n) * pow(k, -1, 2 * n) % (2 * n)
            neg = j >= n
            br = bit_reverse_array(n)
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

    # -- gadget ----------------------------------------------------------------

    def digit_decompose(self, x, base_bits: int, *, balanced: bool = False) -> torch.Tensor:
        """Base-2^w gadget split: (..., n) in [0, q) -> (ndig, ..., n), with
        sum_j d_j 2^(w j) == x exactly; ``balanced=True`` centers the digits
        (held mod q; see ``ops/gadget.py``).  Elementwise PyTorch."""
        digits = gadget.digit_decompose(
            self._i64(x), self.q, int(base_bits), balanced=bool(balanced)
        )
        return self._u32(digits)

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
        return (
            f"Ring(n={self.n}, q={self.q}, method={self.method!r}, "
            f"device={str(self.device)!r})"
        )


class CyclicRing(_TransformRing):
    """The cyclic ring Z_q[X] / (X^n - 1): plain cyclic convolution.

    Counterpart of ``agilex_ntt_tpu/api.py::CyclicRing``: the same kernels
    as ``Ring`` with cyclic twiddle tables (radix-2: K1, K2 and the fused
    polymul K3), and above 32768 the all-cyclic four-step plan.  Requires
    q ≡ 1 (mod n).

    Args:
      n: a power of two >= 2.
      q: a prime q ≡ 1 (mod n), q < 2**30; default the largest q ≡ 1
        (mod 2n).
      omega: a primitive n-th root of unity mod q; default g^((q-1)/n) for
        the smallest generator g.
      method: "radix2" (n <= 32768) or "fourstep"; default four-step above
        32768.  The JAX package's ``CyclicRing`` has no "auto", and neither
        has this one.
      device: ``None`` for the current CUDA device, or ``"cpu"``.

    ``backend``, ``block_rows`` and ``interpret`` raise ``TypeError``, as on
    ``Ring``.
    """

    def __init__(
        self,
        n: int,
        q: Optional[int] = None,
        *,
        omega: Optional[int] = None,
        method: Optional[str] = None,
        device=None,
        **unknown,
    ):
        _refuse_unknown("CyclicRing", unknown)
        if q is None:
            q = find_primes(n, 1)[0]
        if q % n != 1:
            raise ValueError(f"q ≡ 1 (mod n) required: q={q} n={n}")
        if q >= (1 << 30):
            raise ValueError(
                f"q must be < 2**30 for uint32 lazy arithmetic, got {q}"
            )
        if not is_prime(q):
            raise ValueError(f"q={q} is not prime")
        if omega is None:
            omega = pow(primitive_root(q), (q - 1) // n, q)
        self.method = _resolve_method(n, method)
        self.device = _resolve_device(device)
        self.n, self.q, self.omega = n, q, omega
        if self.method == "fourstep":
            self.plan = fourstep.make_cyclic_plan(n, q, omega)
            self.params: Optional[CyclicParams] = None
            self.fourstep = make_fourstep_tables(self.plan, self.device)
            self.tables = None
        else:
            self.plan, self.fourstep = None, None
            self.params = make_cyclic_params(n, q, omega)
            self.tables = make_tables(self.params, self.device)
        self.qinv_neg = mm.mont_qinv_neg(q)
        self.n_inv = pow(n, q - 2, q)
        self.polymul_scale = self.n_inv * ((1 << 32) % q) % q

    def __repr__(self):
        return (
            f"CyclicRing(n={self.n}, q={self.q}, method={self.method!r}, "
            f"device={str(self.device)!r})"
        )


def _prime_tuple(basis) -> Tuple[int, ...]:
    """The primes of an RNSRing or of a sequence of primes."""
    if isinstance(basis, RNSRing):
        return tuple(basis.qs)
    return tuple(int(q) for q in basis)


class RNSRing:
    """Residue-number-system ring: L prime channels of one n.

    Counterpart of ``agilex_ntt_tpu/api.py::RNSRing``: data is (L, ..., n)
    with the prime channel first, values ``torch.uint32`` below each
    channel's q.  Up to n = 32768 the transforms, polymul and polydot run
    one multi-prime kernel launch for all channels (``ops/ntt_kernel.py``:
    ``fwd_ntt_rns``, ``inv_ntt_rns``, ``polymul_rns_fused``,
    ``polydot_rns_fused``); above it each channel's four-step ``Ring`` runs
    them in turn, as the JAX package maps its per-channel rings.  The
    elementwise, channel-mixing and permutation steps (base conversion,
    rescaling, Montgomery products, automorphisms) are plain PyTorch on
    int64, as the JAX package leaves them to XLA.

    Args:
      n: a power of two >= 8.
      num_primes: L, when ``qs`` is not given: ``find_primes(n, L)``.
      qs: the primes, each ≡ 1 (mod 2n) and below 2**30.
      device: ``None`` for the current CUDA device, or ``"cpu"``.
      ring_kwargs: passed to every channel's ``Ring`` (``method``, ``psi``,
        ``fourstep_kernel``), as the JAX package passes them; the TPU-only
        ``backend``, ``block_rows`` and ``interpret`` raise ``TypeError``.
    """

    def __init__(
        self,
        n: int,
        num_primes: int = 3,
        qs: Optional[Sequence[int]] = None,
        *,
        device=None,
        **ring_kwargs,
    ):
        _refuse_unknown("RNSRing", [k for k in ring_kwargs if k in TPU_ONLY_ARGS])
        if qs is None:
            qs = find_primes(n, num_primes)
        self.device = _resolve_device(device)
        self.rings: List[Ring] = [
            Ring(n, int(q), device=self.device, **ring_kwargs) for q in qs
        ]
        if not self.rings:
            raise ValueError("an RNSRing needs at least one prime")
        self.n = n
        self.qs = [r.q for r in self.rings]
        self.modulus = 1
        for q in self.qs:
            self.modulus *= q
        # the multi-prime kernels' tables where every channel is radix-2 (the
        # JAX package's _uniform_pallas); else None, and each channel's ring
        # runs in turn
        self.tables = (
            make_rns_tables([r.tables for r in self.rings])
            if all(r.method == "radix2" for r in self.rings) else None
        )
        self.polymul_scale = tuple(r.polymul_scale for r in self.rings)
        # per-channel q and -q^-1 mod 2**32 as int64, for the PyTorch steps
        self._q64 = torch.tensor(self.qs, dtype=torch.int64, device=self.device)
        self._qinv64 = torch.tensor(
            [r.qinv_neg for r in self.rings], dtype=torch.int64, device=self.device
        )
        # extended-basis rings built by the key switch, keyed by prime tuple
        self._ext_rings: Dict[tuple, "RNSRing"] = {}

    @property
    def L(self) -> int:
        return len(self.rings)

    # -- shape plumbing ------------------------------------------------------

    def _as_u32(self, x) -> torch.Tensor:
        return self.rings[0]._as_u32(x)

    def _check(self, x: torch.Tensor) -> None:
        if x.dim() < 2 or x.shape[0] != self.L or x.shape[-1] != self.n:
            raise ValueError(
                f"expected shape (L={self.L}, ..., n={self.n}), got "
                f"{tuple(x.shape)}"
            )
        if x.numel() == 0:  # one channel's shape, as the JAX package names it
            raise ValueError(f"empty batch: shape {tuple(x.shape[1:])}")

    def _col(self, values: torch.Tensor, ndim: int) -> torch.Tensor:
        """An (L,) tensor of per-channel constants as an (L, 1, ..., 1)
        column that broadcasts against an (L, ...) tensor of ``ndim`` dims."""
        return values.view((self.L,) + (1,) * (ndim - 1))

    def _qcol(self, ndim: int) -> torch.Tensor:
        return self._col(self._q64, ndim)

    def _mont_lazy(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Per-channel Montgomery product a b 2^-32 mod q_l in [0, 2 q_l) of
        int64 (L, ...) operands."""
        nd = max(a.dim(), b.dim())
        return mm.mont_mul_lazy(
            a, b, self._qcol(nd), self._col(self._qinv64, nd)
        )

    # -- transforms ----------------------------------------------------------

    def _flat(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(self.L, -1, self.n).contiguous()

    def ntt(self, x) -> torch.Tensor:
        """Forward NTT of every channel: (L, ..., n) in [0, 4 q_l) ->
        [0, q_l), in one launch."""
        x = self._as_u32(x)
        self._check(x)
        if self.tables is None:
            return torch.stack([r.ntt(x[l]) for l, r in enumerate(self.rings)])
        return ntt_kernel.fwd_ntt_rns(self._flat(x), self.tables).view(x.shape)

    def intt(self, x) -> torch.Tensor:
        """Inverse NTT of every channel: (L, ..., n) in [0, 2 q_l) ->
        [0, q_l), in one launch."""
        return self._intt_scaled(self._as_u32(x), None)

    def _intt_scaled(self, x: torch.Tensor, scales) -> torch.Tensor:
        """Inverse NTT with channel l's n^-1 replaced by ``scales[l]``."""
        self._check(x)
        if self.tables is None:
            scales = (None,) * self.L if scales is None else scales
            return torch.stack([
                r.intt(x[l], scale=s)
                for l, (r, s) in enumerate(zip(self.rings, scales))
            ])
        y = ntt_kernel.inv_ntt_rns(self._flat(x), self.tables, scales=scales)
        return y.view(x.shape)

    # -- ring arithmetic -----------------------------------------------------

    def polymul(self, a, b) -> torch.Tensor:
        """Negacyclic product of every channel, in one fused launch.

        The lead dims between the channel axis and n broadcast, right-aligned
        after the channel axis: a bare (L, n) operand never lines its L up
        with a batch axis (keygen multiplies (K, dnum, n) by (K, 1, n))."""
        a, b = self._as_u32(a), self._as_u32(b)
        self._check(a)
        self._check(b)
        lead = torch.broadcast_shapes(a.shape[1:-1], b.shape[1:-1])
        full = (self.L,) + tuple(lead) + (self.n,)

        def spread(v):
            pad = (1,) * (len(lead) - (v.dim() - 2))
            return v.reshape(v.shape[:1] + pad + v.shape[1:]).expand(full)

        af, bf = self._flat(spread(a)), self._flat(spread(b))
        if self.tables is None:
            out = torch.stack([
                r.polymul(af[l], bf[l]) for l, r in enumerate(self.rings)
            ])
        else:
            out = ntt_kernel.polymul_rns_fused(af, bf, self.tables)
        return out.view(full)

    def polydot(self, a, b) -> torch.Tensor:
        """Per-channel inner product sum_i a_i * b_i of (L, ..., k, n)
        operands -> (L, ..., n), in one fused launch."""
        a, b = self._as_u32(a), self._as_u32(b)
        if a.shape != b.shape or a.dim() < 3 or a.shape[-1] != self.n:
            raise ValueError(
                f"polydot expects matching (L, ..., k, n={self.n}) shapes, "
                f"got {tuple(a.shape)} and {tuple(b.shape)}"
            )
        self._check(a)
        k = a.shape[-2]
        af = a.reshape(self.L, -1, k, self.n).contiguous()
        bf = b.reshape(self.L, -1, k, self.n).contiguous()
        if self.tables is None:
            out = torch.stack([
                r.polydot(af[l], bf[l]) for l, r in enumerate(self.rings)
            ])
        else:
            out = ntt_kernel.polydot_rns_fused(af, bf, self.tables)
        return out.view(a.shape[:-2] + (self.n,))

    def polydot_multi(self, a, ws_ntt) -> torch.Tensor:
        """Inner products out[j] = sum_i a_i * w_{j,i} against g weight
        bundles, with the bundle ``a`` transformed once (the BSGS matvec's
        giant steps share their baby bundle).

        a: (L, ..., k, n) coefficients.
        ws_ntt: (L, g, k, n) evaluation-domain weights (``ntt`` once, ahead).
        One forward launch of ``a``, per bundle the lazy Montgomery dot in
        ascending term order, one inverse launch for all g sums scaled by
        ``polymul_scale``.  Returns (g, L, ..., n).
        """
        a, ws = self._as_u32(a), self._as_u32(ws_ntt)
        self._check(a)
        if a.dim() < 3:
            raise ValueError(f"a must be (L, ..., k, n), got {tuple(a.shape)}")
        if (ws.dim() != 4 or ws.shape[0] != self.L
                or tuple(ws.shape[2:]) != tuple(a.shape[-2:])):
            raise ValueError(
                f"ws_ntt must be (L={self.L}, g, k={a.shape[-2]}, "
                f"n={self.n}), got {tuple(ws.shape)}"
            )
        k, g = a.shape[-2], ws.shape[1]
        fa = self.ntt(a).to(torch.int64)  # (L, ..., k, n)
        wshape = (self.L,) + (1,) * (fa.dim() - 3) + (k, self.n)
        two_q = 2 * self._qcol(fa.dim() - 1)
        sums = []
        for j in range(g):
            t = self._mont_lazy(fa, ws[:, j].reshape(wshape).to(torch.int64))
            acc = t[..., 0, :]
            for i in range(1, k):
                acc = mm.cond_sub(acc + t[..., i, :], two_q)
            sums.append(acc)
        # one stray R^-1 from the Montgomery dot: polymul_scale folds it
        out = self._intt_scaled(
            torch.stack(sums, dim=1).to(torch.uint32), self.polymul_scale
        )
        return out.movedim(1, 0)

    def _i64(self, x) -> torch.Tensor:
        x = self._as_u32(x)
        self._check(x)
        return x.to(torch.int64)

    def add(self, a, b) -> torch.Tensor:
        a, b = self._i64(a), self._i64(b)
        return mm.add_mod(a, b, self._qcol(max(a.dim(), b.dim()))).to(torch.uint32)

    def sub(self, a, b) -> torch.Tensor:
        a, b = self._i64(a), self._i64(b)
        return mm.sub_mod(a, b, self._qcol(max(a.dim(), b.dim()))).to(torch.uint32)

    def neg(self, a) -> torch.Tensor:
        a = self._i64(a)
        return mm.neg_mod(a, self._qcol(a.dim())).to(torch.uint32)

    def _inverse_of_products(self, terms) -> tuple:
        """One scaled inverse launch for several (L, ...) NTT-domain products,
        each carrying one stray R^-1: polymul_scale folds it out."""
        stacked = torch.stack(terms, dim=1).to(torch.uint32)
        out = self._intt_scaled(stacked, self.polymul_scale)
        return tuple(out.unbind(1))

    def tensor(self, a0, a1, b0, b1):
        """Per-channel RLWE tensor product (a0 b0, a0 b1 + a1 b0, a1 b1):
        one forward launch for the four operands, Karatsuba on the
        transforms (see ``Ring.tensor``), one inverse launch for the three
        results."""
        ops = [self._as_u32(v) for v in (a0, a1, b0, b1)]
        for v in ops:
            self._check(v)
        f = self.ntt(torch.stack(ops, dim=1)).to(torch.int64)
        fa0, fa1, fb0, fb1 = f.unbind(1)
        q = self._qcol(fa0.dim())
        sa = mm.cond_sub(fa0 + fa1, q)
        sb = mm.cond_sub(fb0 + fb1, q)
        d0 = mm.cond_sub(self._mont_lazy(fa0, fb0), q)
        d2 = mm.cond_sub(self._mont_lazy(fa1, fb1), q)
        cr = mm.cond_sub(self._mont_lazy(sa, sb), q)
        d1 = mm.cond_sub(mm.cond_sub(cr - d0 + q, q) - d2 + q, q)
        return self._inverse_of_products([d0, d1, d2])

    def tensor_square(self, a0, a1):
        """Per-channel tensor square (a0^2, 2 a0 a1, a1^2): one forward and
        one inverse launch (see ``Ring.tensor_square``)."""
        ops = [self._as_u32(v) for v in (a0, a1)]
        for v in ops:
            self._check(v)
        fa0, fa1 = self.ntt(torch.stack(ops, dim=1)).to(torch.int64).unbind(1)
        q = self._qcol(fa0.dim())
        d0 = mm.cond_sub(self._mont_lazy(fa0, fa0), q)
        d2 = mm.cond_sub(self._mont_lazy(fa1, fa1), q)
        x = mm.cond_sub(self._mont_lazy(fa0, fa1), q)
        d1 = mm.cond_sub(x + x, q)
        return self._inverse_of_products([d0, d1, d2])

    # -- permutations ----------------------------------------------------------

    def _gather_signed(self, x: torch.Tensor, src, neg) -> torch.Tensor:
        g = x.to(torch.int64).index_select(-1, src)
        g = torch.where(neg, mm.neg_mod(g, self._qcol(g.dim())), g)
        return g.to(torch.uint32)

    def automorphism(self, x, k: int, *, domain: str = "coeff") -> torch.Tensor:
        """tau_k: a(X) -> a(X^k) on every channel, k odd; the index tables
        are q-independent (see ``Ring.automorphism``)."""
        if k % 2 == 0:
            raise ValueError(f"k must be odd (unit mod 2n), got {k}")
        if domain not in ("coeff", "ntt"):
            raise ValueError(f"unknown domain {domain!r}")
        x = self._as_u32(x)
        self._check(x)
        src, neg, ntt_src = self.rings[0]._auto_tables(k % (2 * self.n))
        if domain == "ntt":
            return x.to(torch.int64).index_select(-1, ntt_src).to(torch.uint32)
        return self._gather_signed(x, src, neg)

    def rotate(self, x, k: int) -> torch.Tensor:
        """Multiply every channel by X^k."""
        x = self._as_u32(x)
        self._check(x)
        src, neg = self.rings[0]._rotate_tables(k % (2 * self.n))
        return self._gather_signed(x, src, neg)

    # -- basis changes -------------------------------------------------------

    def base_convert(self, x, dst, *, correction: str = "none") -> torch.Tensor:
        """Fast base conversion (L, ..., n) -> (K, ..., n) into ``dst`` (an
        RNSRing or primes): "none" is BEHZ (x + e Q mod p_j, 0 <= e < L),
        "float" subtracts the HPS float32 estimate of e Q.  Coefficient
        domain; inputs in [0, q_l)."""
        y = basechange.base_convert(
            self._i64(x), self.qs, _prime_tuple(dst), correction=correction
        )
        return y.to(torch.uint32)

    def rescale(self, x) -> torch.Tensor:
        """Divide and round by the last prime: (L, ..., n) -> (L-1, ..., n)
        in the basis ``qs[:-1]`` (pair with ``drop_prime()``)."""
        return basechange.rescale(self._i64(x), self.qs).to(torch.uint32)

    def rescale_bgv(self, x, t: int) -> torch.Tensor:
        """BGV modulus switch by the last prime, keeping the phase mod t."""
        return basechange.rescale_bgv(self._i64(x), self.qs, int(t)).to(torch.uint32)

    def _count(self, count: int) -> int:
        """``count`` of ``mod_down``/``mod_down_bgv``, checked with the JAX
        package's message."""
        c = int(count)
        if not 1 <= c <= self.L - 1:
            raise ValueError(f"count must be in [1, {self.L - 1}], got {c}")
        return c

    def mod_down(self, x, count: int = 1) -> torch.Tensor:
        """Drop the last ``count`` primes by iterated centered rounding:
        (L, ..., n) -> (L-count, ..., n)."""
        x = self._i64(x)
        y = basechange.mod_down(x, self.qs, self._count(count))
        return y.to(torch.uint32)

    def mod_down_bgv(self, x, t: int, count: int = 1) -> torch.Tensor:
        """Iterated t-correcting divide, the BGV ModDown."""
        x = self._i64(x)
        y = basechange.mod_down_bgv(x, self.qs, int(t), self._count(count))
        return y.to(torch.uint32)

    def gadget_decompose(
        self, x, dst, dnum: int, *, correction: str = "float"
    ) -> torch.Tensor:
        """Hybrid key-switch gadget split (L, ..., n) -> (dnum, K, ..., n):
        digit d is group d's residues converted into ``dst``."""
        y = gadget.gadget_decompose(
            self._i64(x), self.qs, _prime_tuple(dst), int(dnum),
            correction=correction,
        )
        return y.to(torch.uint32)

    def drop_prime(self, count: int = 1) -> "RNSRing":
        """The ring over ``qs[:-count]``, on the same device."""
        if not 1 <= count <= self.L - 1:
            raise ValueError(
                f"count must be in [1, L-1={self.L - 1}], got {count}"
            )
        return RNSRing(self.n, qs=self.qs[:-count], device=self.device)

    def to_rns(self, coeffs) -> torch.Tensor:
        """Big-integer coefficients (..., n), any Python ints, -> residues
        (L, ..., n) as uint32 on the ring's device (reduced on the host)."""
        arr = np.asarray(coeffs, dtype=object)
        res = np.stack([(arr % q).astype(np.uint32) for q in self.qs])
        return torch.from_numpy(res).to(self.device)

    def from_rns(self, residues) -> np.ndarray:
        """Host CRT reconstruction -> big-integer (..., n) object array in
        [0, modulus)."""
        if isinstance(residues, torch.Tensor):
            residues = residues.cpu().numpy()
        return crt_compose(np.asarray(residues), self.qs)

    # -- key switching -------------------------------------------------------

    def _ext(self, ext) -> "RNSRing":
        """The extended-basis ring of ``ext`` (an RNSRing or primes), built
        once per prime tuple on this ring's device."""
        qs_ext = _prime_tuple(ext)
        ring = self._ext_rings.get(qs_ext)
        if ring is None:
            if isinstance(ext, RNSRing) and ext.device == self.device:
                ring = ext
            else:
                ring = RNSRing(self.n, qs=qs_ext, device=self.device)
            self._ext_rings[qs_ext] = ring
        return ring

    def _check_ext(self, ext) -> Tuple[int, ...]:
        qs_ext = _prime_tuple(ext)
        if qs_ext[: self.L] != tuple(self.qs):
            raise ValueError(
                "ext basis must extend this ring's (first L primes equal); "
                f"got ext={qs_ext[:self.L]}... vs qs={tuple(self.qs)}"
            )
        if len(qs_ext) <= self.L:
            raise ValueError("ext basis must add at least one special prime")
        return qs_ext

    def _down(self, prod: torch.Tensor, qs_ext, plain_mod) -> torch.Tensor:
        """ModDown of an extended-basis int64 product back to this basis."""
        spec = len(qs_ext) - self.L
        if plain_mod is None:
            return basechange.mod_down(prod, qs_ext, spec)
        return basechange.mod_down_bgv(prod, qs_ext, int(plain_mod), spec)

    def _decompose(self, x: torch.Tensor, qs_ext, dnum: int, correction):
        """(dnum, K, ..., n) int64 digits of x in the extended basis."""
        return gadget.gadget_decompose(
            x.to(torch.int64), self.qs, qs_ext, dnum, correction=correction
        )

    @staticmethod
    def _evaldot_intt(ext_ring: "RNSRing", fx: torch.Tensor, fk: torch.Tensor,
                      d: int) -> torch.Tensor:
        """The polydot's arithmetic on transformed operands: per channel the
        Montgomery products of fx (K, d, ..., n) and fk (K, d, [1s,] n),
        summed lazily in ascending digit order ([0, 2q), one conditional
        subtraction a term, as the fused kernel sums), then one inverse
        launch scaled by ``polymul_scale``.  Returns (K, ..., n) int64 in
        [0, q)."""
        t = ext_ring._mont_lazy(fx, fk)
        two_q = 2 * ext_ring._qcol(t.dim() - 1)
        acc = t[:, 0]
        for dd in range(1, d):
            acc = mm.cond_sub(acc + t[:, dd], two_q)
        out = ext_ring._intt_scaled(
            acc.to(torch.uint32), ext_ring.polymul_scale
        )
        return out.to(torch.int64)

    def keyswitch(
        self, x, ksk, ext, dnum: int, *, correction: str = "float",
        ksk_domain: str = "coeff", plain_mod: Optional[int] = None,
    ) -> torch.Tensor:
        """Hybrid key switch: gadget-decompose x into ``dnum`` digits in the
        extended basis ``ext``, dot them with the key, ModDown back here.

        x: (L, ..., n) residues in this basis.
        ksk: (dnum, K, n), shared over the batch, or (dnum, K, ..., n)
          matching x's lead dims; generated in ``ext``, whose first L primes
          must be this ring's.
        ksk_domain: "coeff" dots in one fused launch (K6b); "ntt" takes keys
          transformed once by ``ksk_to_ntt``: the digits take one forward
          launch (K4a), the dot is a lazy Montgomery sum and one scaled
          inverse launch (K4b).  Both give the same words.
        plain_mod: the BGV plaintext modulus t: the ModDown then keeps the
          phase mod t (key noise must be a t-multiple).
        Returns (L, ..., n) residues of round(sum_d t_d ksk_d / P).
        """
        x = self._as_u32(x)
        self._check(x)
        ksk = self._as_u32(ksk)
        if ksk_domain not in ("coeff", "ntt"):
            raise ValueError(f"unknown ksk_domain {ksk_domain!r}")
        qs_ext = self._check_ext(ext)
        K, d = len(qs_ext), int(dnum)
        if tuple(ksk.shape[:2]) != (d, K) or ksk.shape[-1] != self.n:
            raise ValueError(
                f"ksk must be (dnum={d}, K={K}, [...,] n={self.n}), "
                f"got {tuple(ksk.shape)}"
            )
        shared = ksk.dim() == 3
        ext_ring = self._ext(ext)
        dig = self._decompose(x, qs_ext, d, correction)  # (d, K, ..., n)
        if ksk_domain == "ntt":
            fx = ext_ring.ntt(dig.movedim(0, 1).to(torch.uint32))  # (K, d, ..., n)
            kb = ksk.movedim(0, 1)  # (K, d, [...,] n), evaluation domain
            if shared:
                kb = kb.reshape((K, d) + (1,) * (fx.dim() - 3) + (self.n,))
            prod = self._evaldot_intt(
                ext_ring, fx.to(torch.int64), kb.to(torch.int64), d
            )
        else:
            dig = dig.movedim(0, -2)  # (K, ..., d, n)
            kb = ksk.movedim(0, -2)   # (K, [...,] d, n)
            if shared:
                kb = kb.reshape(
                    (K,) + (1,) * (dig.dim() - 3) + tuple(kb.shape[-2:])
                ).expand(dig.shape)
            prod = ext_ring.polydot(dig.to(torch.uint32), kb).to(torch.int64)
        return self._down(prod, qs_ext, plain_mod).to(torch.uint32)

    def ksk_to_ntt(self, ksk, ext, *, ch_axis: int = 1) -> torch.Tensor:
        """Evaluation-domain key material: the per-channel NTT of coefficient
        keys, done once at key setup.  ``ch_axis`` is the extended-basis
        channel axis: 1 for ``keyswitch``'s (dnum, K, n), 2 for
        ``hoisted_keyswitch``'s (nk, dnum, K, n)."""
        ext_ring = self._ext(ext)
        arr = self._as_u32(ksk).movedim(ch_axis, 0)
        return ext_ring.ntt(arr).movedim(0, ch_axis)

    def hoisted_keyswitch(
        self, x, ksks, ks, ext, dnum: int, *, correction: str = "float",
        ksk_domain: str = "coeff", plain_mod: Optional[int] = None,
    ) -> torch.Tensor:
        """Hoisted rotation batch: one gadget decomposition and one forward
        launch of the digits, shared by every Galois step; each step k then
        costs a slot permutation (tau_k is a gather in the evaluation
        domain), the lazy Montgomery dot, one inverse launch and the ModDown.

        x: (L, ..., n) residues (the c1 part).
        ksks: (nk, dnum, K, n) rotation keys in ``ext``, one per step,
          shared over the batch; ksk_domain="ntt" takes
          ``ksk_to_ntt(ksks, ext, ch_axis=2)``.
        ks: odd Galois exponents.
        Returns (nk, L, ..., n): entry j is keyswitch(tau_{ks[j]}(x),
        ksks[j]) with tau applied to the digits.
        """
        x = self._as_u32(x)
        self._check(x)
        ksks = self._as_u32(ksks)
        if ksk_domain not in ("coeff", "ntt"):
            raise ValueError(f"unknown ksk_domain {ksk_domain!r}")
        ks = tuple(int(k) % (2 * self.n) for k in ks)
        for k in ks:
            if k % 2 == 0:
                raise ValueError(f"Galois exponents must be odd, got {k}")
        qs_ext = self._check_ext(ext)
        K, d = len(qs_ext), int(dnum)
        if tuple(ksks.shape) != (len(ks), d, K, self.n):
            raise ValueError(
                f"ksks must be (nk={len(ks)}, dnum={d}, K={K}, "
                f"n={self.n}), got {tuple(ksks.shape)}"
            )
        ext_ring = self._ext(ext)
        dig = self._decompose(x, qs_ext, d, correction)
        dnt = ext_ring.ntt(dig.movedim(0, 1).to(torch.uint32)).to(torch.int64)
        kt = ksks.movedim(2, 0)  # (K, nk, d, n)
        knt = kt if ksk_domain == "ntt" else ext_ring.ntt(kt)
        knt = knt.to(torch.int64)
        mid = dnt.dim() - 3  # x's lead dims after the channel
        outs = []
        for j, k in enumerate(ks):
            perm = ext_ring.rings[0]._auto_tables(k)[2]
            pd = dnt.index_select(-1, perm)
            kj = knt[:, j].reshape((K, d) + (1,) * mid + (self.n,))
            prod = self._evaldot_intt(ext_ring, pd, kj, d)
            outs.append(self._down(prod, qs_ext, plain_mod))
        return torch.stack(outs).to(torch.uint32)

    def hoisted_linear_sum(
        self, c0, c1, pts, ksks_b, ksks_a, ks, ext, dnum: int, *,
        correction: str = "float", ksk_domain: str = "coeff",
        pt_domain: str = "coeff", plain_mod: Optional[int] = None,
    ):
        """The BSGS linear transform sum_j pt_j * tau_{k_j}(ct) of a
        ciphertext ct = (c0, c1), with the key switch hoisted and the ModDown
        deferred: one gadget decomposition and one forward launch of the
        digits for every term; per term the slot permutation, the two lazy
        digit dots and the plaintext's Montgomery product, summed in the
        extended basis; then one inverse launch and one ModDown for both
        sums.  The c0 part runs on this ring at ``polymul_scale``.

        c0, c1: (L, ..., n) coefficients.
        pts: (nk, K, n) weights in the extended basis (the first L rows
          serve the c0 part); pt_domain="ntt" takes
          ``ksk_to_ntt(pts, ext, ch_axis=1)``.
        ksks_b, ksks_a: (nk, dnum, K, n) rotation-key halves; ksk_domain="ntt"
          takes ``ksk_to_ntt(..., ch_axis=2)``.
        ks: odd Galois exponents, one a term.
        Returns (out0, out1), each (L, ..., n).
        """
        c0, c1 = self._as_u32(c0), self._as_u32(c1)
        self._check(c0)
        self._check(c1)
        pts = self._as_u32(pts)
        ksks_b, ksks_a = self._as_u32(ksks_b), self._as_u32(ksks_a)
        for name, dom in (("ksk_domain", ksk_domain), ("pt_domain", pt_domain)):
            if dom not in ("coeff", "ntt"):
                raise ValueError(f"unknown {name} {dom!r}")
        ks = tuple(int(k) % (2 * self.n) for k in ks)
        for k in ks:
            if k % 2 == 0:
                raise ValueError(f"Galois exponents must be odd, got {k}")
        qs_ext = self._check_ext(ext)
        K, d, nk, n = len(qs_ext), int(dnum), len(ks), self.n
        for name, arr in (("ksks_b", ksks_b), ("ksks_a", ksks_a)):
            if tuple(arr.shape) != (nk, d, K, n):
                raise ValueError(
                    f"{name} must be (nk={nk}, dnum={d}, K={K}, n={n}), got "
                    f"{tuple(arr.shape)}"
                )
        if tuple(pts.shape) != (nk, K, n):
            raise ValueError(
                f"pts must be (nk={nk}, K={K}, n={n}), got {tuple(pts.shape)}"
            )
        ext_ring = self._ext(ext)
        dig = self._decompose(c1, qs_ext, d, correction)
        dnt = ext_ring.ntt(dig.movedim(0, 1).to(torch.uint32)).to(torch.int64)
        keys = torch.stack([ksks_b, ksks_a]).movedim(3, 0)  # (K, 2, nk, d, n)
        if ksk_domain == "coeff":
            keys = ext_ring.ntt(keys)
        keys = keys.to(torch.int64)
        ptt = pts.movedim(1, 0)  # (K, nk, n)
        if pt_domain == "coeff":
            ptt = ext_ring.ntt(ptt)
        ptt = ptt.to(torch.int64)
        c0nt = self.ntt(c0).to(torch.int64)
        mid = dnt.dim() - 3  # the ciphertext's lead dims after the channel
        kshape = (K, d) + (1,) * mid + (n,)
        pshape = (K,) + (1,) * mid + (n,)
        two_q = 2 * ext_ring._qcol(mid + 2)
        acc_b = acc_a = acc_c = None
        for j, k in enumerate(ks):
            perm = ext_ring.rings[0]._auto_tables(k)[2]
            pd = dnt.index_select(-1, perm)  # (K, d, ..., n)
            pj = ptt[:, j].reshape(pshape)
            sums = []
            for half in range(2):
                t = ext_ring._mont_lazy(pd, keys[:, half, j].reshape(kshape))
                dot = t[:, 0]
                for dd in range(1, d):
                    dot = mm.cond_sub(dot + t[:, dd], two_q)
                sums.append(ext_ring._mont_lazy(pj, dot))
            vc = self._mont_lazy(pj[: self.L], c0nt.index_select(-1, perm))
            if acc_b is None:
                acc_b, acc_a, acc_c = sums[0], sums[1], vc
            else:
                acc_b = mm.cond_sub(acc_b + sums[0], two_q)
                acc_a = mm.cond_sub(acc_a + sums[1], two_q)
                acc_c = mm.cond_sub(acc_c + vc, two_q[: self.L])
        # two stray R^-1 (the digit dot and the weight's product): n^-1 R^2
        scales = tuple(r.n_inv * r.r2_mod_q % r.q for r in ext_ring.rings)
        ext_sums = ext_ring._intt_scaled(
            torch.stack([acc_b, acc_a], dim=1).to(torch.uint32), scales
        )
        down = self._down(ext_sums.to(torch.int64), qs_ext, plain_mod)
        # one stray R^-1 in the c0 part: polymul_scale
        csum = self._intt_scaled(acc_c.to(torch.uint32), self.polymul_scale)
        out0 = mm.cond_sub(csum.to(torch.int64) + down[:, 0], self._qcol(mid + 2))
        return out0.to(torch.uint32), down[:, 1].to(torch.uint32)

    def __repr__(self):
        return (
            f"RNSRing(n={self.n}, qs={self.qs}, device={str(self.device)!r})"
        )


class WideRing:
    """R_q = Z_q[X]/(X^n + 1) at the reference's full u64 word width.

    Counterpart of ``agilex_ntt_tpu/api.py::WideRing``: one prime up to the
    Harvey bound q < 2**62 (4q < 2**64), where ``Ring`` takes q < 2**30 and
    reaches larger moduli through ``RNSRing``.  On the card the transforms
    and the elementwise calls run the u64 kernels of ``csrc/ntt_wide.cuh``
    (``ops/wide_kernel.py``); on the CPU the plain limb-pair version of
    ``ops/wide.py``.

    Args:
      n: a power of two.
      q: a prime q ≡ 1 (mod 2n), q < 2**62; default the largest such prime
        below 2**62.
      psi: a primitive 2n-th root of unity mod q; default ``find_psi``'s.
      device: ``None`` for the current CUDA device, or ``"cpu"``.

    I/O: a method takes numpy uint64 arrays (or ints), split into limbs and
    joined again on the host, and returns numpy uint64; or a ``(lo, hi)``
    pair of uint32 tensors (or numpy uint32 arrays), and returns a pair of
    ``torch.uint32`` tensors on the ring's device.  The output kind matches
    the input kind; shapes are (..., n).
    """

    def __init__(self, n: int, q: Optional[int] = None, *,
                 psi: Optional[int] = None, device=None):
        if q is None:
            q = find_primes(n, 1, bits=62)[0]
        if q >= (1 << 62):
            raise ValueError(
                f"q must be < 2**62 (Harvey lazy range 4q < 2**64), got {q}"
            )
        self.device = _resolve_device(device)
        self.n = n
        self.q = q
        self.params = make_params(n, q, psi)  # the u64 tables
        self.n_inv = self.params.n_inv
        self.qinv_neg = wide.mont_qinv_neg64(q)
        self.r_mod_q = (1 << 64) % q
        # folds the Montgomery product's 2**-64 out, with n^-1
        self.polymul_scale = self.n_inv * self.r_mod_q % q
        self.tables = wide_kernel.make_wide_tables(self.params, self.device)

    # -- I/O plumbing ---------------------------------------------------------

    def _limb(self, t) -> torch.Tensor:
        if isinstance(t, torch.Tensor):
            return t.to(device=self.device, dtype=torch.uint32)
        return torch.from_numpy(np.array(t, dtype=np.uint32)).to(self.device)

    def _ingest(self, x):
        """-> ((lo, hi) uint32 tensors, was_numpy).  Takes numpy uint64 (or
        ints) or a (lo, hi) pair."""
        if isinstance(x, tuple):
            lo, hi = (self._limb(t) for t in x)
            if lo.shape != hi.shape:
                raise ValueError(f"lo {tuple(lo.shape)} and hi "
                                 f"{tuple(hi.shape)} differ")
            if lo.dim() == 0 or lo.shape[-1] != self.n:
                raise ValueError(
                    f"last dim must be n={self.n}, got {tuple(lo.shape)}"
                )
            return (lo, hi), False
        arr = np.asarray(x, dtype=np.uint64)
        if arr.shape[-1] != self.n:
            raise ValueError(f"last dim must be n={self.n}, got {arr.shape}")
        lo, hi = wide.split_u64_np(arr)
        return (torch.from_numpy(lo).to(self.device),
                torch.from_numpy(hi).to(self.device)), True

    def _egest(self, pair, shape, was_numpy: bool):
        lo, hi = (t.reshape(shape) for t in pair)
        if was_numpy:
            return wide.join_u64_np(lo.cpu().numpy(), hi.cpu().numpy())
        return lo, hi

    def _rows(self, pair):
        """(..., n) -> (B, n), contiguous."""
        return tuple(t.reshape(-1, self.n).contiguous() for t in pair)

    def _run(self, body, shape, host: bool, *pairs):
        """``body(*(B, n) pairs)``, the result in ``shape`` and the input's
        kind; an empty batch gives its empty result without a launch, as
        the JAX package's ``WideRing`` does."""
        if 0 in shape:
            out = tuple(torch.empty(shape, dtype=torch.uint32,
                                    device=self.device) for _ in range(2))
        else:
            out = body(*(self._rows(p) for p in pairs))
        return self._egest(out, shape, host)

    def _binary(self, a, b):
        """Both operands broadcast to one shape: ((lo, hi), (lo, hi), shape,
        was_numpy of a)."""
        pa, host = self._ingest(a)
        pb, _ = self._ingest(b)
        shape = torch.broadcast_shapes(pa[0].shape, pb[0].shape)
        pa, pb = (tuple(t.expand(shape).contiguous() for t in p)
                  for p in (pa, pb))
        return pa, pb, shape, host

    # -- transforms -----------------------------------------------------------

    def ntt(self, x):
        """Forward negacyclic NTT, [0, 4q) in, [0, q) out (HEXL order)."""
        pair, host = self._ingest(x)
        return self._run(lambda p: wide_kernel.wide_fwd(p, self.tables),
                         pair[0].shape, host, pair)

    def intt(self, x, *, scale: Optional[int] = None):
        """Inverse negacyclic NTT, lazy [0, 2q) in, [0, q) out; ``scale``
        replaces the final n^-1."""
        pair, host = self._ingest(x)
        sc = self.n_inv if scale is None else scale
        return self._run(lambda p: wide_kernel.wide_inv(p, self.tables, sc),
                         pair[0].shape, host, pair)

    # -- ring arithmetic --------------------------------------------------------

    def polymul(self, a, b):
        """Negacyclic a*b mod (X^n + 1, q): both forward transforms, the
        Montgomery product (R = 2**64), the inverse with R^-1 folded into
        its n^-1 scale."""
        pa, pb, shape, host = self._binary(a, b)
        tabs = self.tables

        def body(ra, rb):
            fa = wide_kernel.wide_fwd(ra, tabs)
            fb = wide_kernel.wide_fwd(rb, tabs)
            prod = wide_kernel.wide_pointwise(fa, fb, tabs, "mont")
            return wide_kernel.wide_inv(prod, tabs, self.polymul_scale)

        return self._run(body, shape, host, pa, pb)

    def _elementwise(self, a, b, mode: str):
        pa, pb, shape, host = self._binary(a, b)
        return self._run(
            lambda ra, rb: wide_kernel.wide_pointwise(ra, rb, self.tables,
                                                      mode),
            shape, host, pa, pb)

    def pointwise_mul(self, a, b):
        """Exact elementwise a*b mod q in [0, q) for NTT-domain operands."""
        return self._elementwise(a, b, "exact")

    def add(self, a, b):
        return self._elementwise(a, b, "add")

    def sub(self, a, b):
        return self._elementwise(a, b, "sub")

    def __repr__(self):
        return f"WideRing(n={self.n}, q={self.q})"
