"""32-bit-word modular arithmetic on int64 tensors.

Counterpart of ``agilex_ntt_tpu/ops/modmul.py``.  PyTorch on the CPU has no
add, shift or compare for ``torch.uint32``, so every helper here takes int64
tensors holding uint32 values and returns int64 tensors holding the uint32
value the JAX helper returns: results wrap mod 2**32 exactly as uint32 words
do, so lazy outputs match bit for bit, not only mod q.

Products stay below 2**63: a 32x32-bit product is split into 16-bit halves
of one operand (``mulhi_u32``, ``mullo_u32``), so every partial product is
below 2**49 for any two uint32 operands.

These are also the host oracle for the CUDA arithmetic in
``csrc/ntt_arith.cuh`` (``tests/test_torch_arith_host.py``).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF


def mont_qinv_neg(q: int) -> int:
    """-q^{-1} mod 2**32 (host-side precomputation for mont_mul_lazy)."""
    return (-pow(q, -1, 1 << 32)) % (1 << 32)


def mulhi_u32(a: torch.Tensor, b) -> torch.Tensor:
    """High 32 bits of a*b for a, b in [0, 2**32): the 16-bit halves of b
    keep every partial product below 2**49."""
    b_lo = b & _MASK16
    b_hi = b >> 16
    return (((a * b_lo) >> 16) + a * b_hi) >> 16


def mullo_u32(a: torch.Tensor, b) -> torch.Tensor:
    """Low 32 bits of a*b for a, b in [0, 2**32), without int64 overflow."""
    b_lo = b & _MASK16
    b_hi = b >> 16
    return (a * b_lo + (((a * b_hi) & _MASK16) << 16)) & MASK32


def cond_sub(x: torch.Tensor, bound) -> torch.Tensor:
    """x - bound if x >= bound else x (lazy reduction step)."""
    return torch.where(x >= bound, x - bound, x)


def shoup_mulmod_lazy(a: torch.Tensor, w, w_precon, q: int) -> torch.Tensor:
    """W * a mod q in [0, 2q) by Shoup's trick: w < q,
    w_precon = floor(w * 2**32 / q), any a in [0, 2**32)."""
    return (mullo_u32(a, w) - mullo_u32(mulhi_u32(a, w_precon), q)) & MASK32


def ct_butterfly(x: torch.Tensor, y: torch.Tensor, w, w_precon, q: int):
    """Harvey's lazy Cooley-Tukey butterfly: x, y in [0, 4q) -> (x + W y,
    x - W y) as values in [0, 4q), congruent mod q."""
    two_q = 2 * q
    tx = cond_sub(x, two_q)
    qq = shoup_mulmod_lazy(y, w, w_precon, q)
    return (tx + qq) & MASK32, (tx + two_q - qq) & MASK32


def gs_butterfly(x: torch.Tensor, y: torch.Tensor, w, w_precon, q: int):
    """Harvey's lazy Gentleman-Sande butterfly: x, y in [0, 2q) ->
    (x + y, W (x - y)) as values in [0, 2q), congruent mod q."""
    two_q = 2 * q
    s = cond_sub((x + y) & MASK32, two_q)
    d = (x + two_q - y) & MASK32
    return s, shoup_mulmod_lazy(d, w, w_precon, q)


def mont_mul_lazy(a: torch.Tensor, b, q: int, qinv_neg: int) -> torch.Tensor:
    """a * b * 2**-32 mod q: Montgomery REDC with R = 2**32, for any uint32
    words a and b; in [0, 2q) when a * b < 2**32 q.

    The JAX helper's word: hi(a b) + hi(m q) + (lo(a b) != 0) wrapped to
    32 bits, m = lo(a b) (-q^-1) mod R.  That is (a b + m q) / R mod 2**32,
    an exact quotient (the low words cancel), computed here from the 16-bit
    halves of b so that every int64 intermediate stays below 2**63
    (m q < 2**62 as q < 2**30).  The CUDA kernels compute the same word.
    """
    b = torch.as_tensor(b, dtype=torch.int64, device=a.device)
    p_lo, p_hi = a * (b & _MASK16), a * (b >> 16)  # a b = p_lo + p_hi 2**16
    m = mullo_u32((p_lo + ((p_hi & _MASK16) << 16)) & MASK32, qinv_neg)
    # (a b + m q) / 2**32, the p_hi 2**16 term added after the first shift
    return ((((p_lo + m * q) >> 16) + p_hi) >> 16) & MASK32


def add_mod(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    """(a + b) mod q for a, b in [0, q), with uint32 wraparound."""
    return cond_sub((a + b) & MASK32, q)


def sub_mod(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    """(a - b) mod q for a, b in [0, q), with uint32 wraparound."""
    return cond_sub((a - b + q) & MASK32, q)


def neg_mod(a: torch.Tensor, q: int) -> torch.Tensor:
    """(-a) mod q for a in [0, q), with uint32 wraparound."""
    return torch.where(a == 0, torch.zeros_like(a), (q - a) & MASK32)
