"""Gadget decomposition, the noise-control half of key switching.

Counterpart of ``agilex_ntt_tpu/ops/gadget.py`` on int64 tensors holding
uint32 words:

* ``gadget_decompose`` (RNS, hybrid): the L source primes fall into
  ``dnum`` contiguous groups; digit d is the base conversion of group d's
  residues into the destination basis (typically Q u P).  With
  ``correction="float"`` the digit is exactly t_d = [x]_{Q_d}, and
  x = sum_d t_d (Q/Q_d) [(Q/Q_d)^-1]_{Q_d} (mod Q); the gadget factors live
  in the key.
* ``digit_decompose`` (base 2^w): x = sum_j d_j 2^(w j) with unsigned
  digits in [0, 2^w), or balanced digits in [-2^(w-1)+1, 2^(w-1)] held mod
  q, the top digit unsigned and absorbing the last carry.

Both return a new leading digit axis.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .basechange import base_convert


def gadget_groups(L: int, dnum: int) -> List[Tuple[int, int]]:
    """Contiguous [start, stop) prime-index ranges of the dnum digits, of
    size alpha = ceil(L / dnum) (the last may be smaller); 1 <= dnum <= L."""
    if not 1 <= dnum <= L:
        raise ValueError(f"dnum must be in [1, L={L}], got {dnum}")
    alpha = -(-L // dnum)
    groups = []
    for d in range(dnum):
        lo = d * alpha
        hi = min(lo + alpha, L)
        if lo >= hi:
            raise ValueError(
                f"dnum={dnum} leaves digit {d} empty for L={L}; "
                f"use dnum <= ceil(L/alpha) groups that all receive primes"
            )
        groups.append((lo, hi))
    return groups


def gadget_decompose(
    x: torch.Tensor,
    qs_src: Sequence[int],
    qs_dst: Sequence[int],
    dnum: int,
    *,
    correction: str = "float",
) -> torch.Tensor:
    """Residues (L, ..., n) -> digits (dnum, K, ..., n) in basis qs_dst.

    Digit d is ``base_convert`` of group d's residues into qs_dst (which may
    overlap qs_src).  Inputs in [0, q_l); outputs in [0, p_j).
    """
    qs_src = tuple(int(q) for q in qs_src)
    qs_dst = tuple(int(q) for q in qs_dst)
    groups = gadget_groups(len(qs_src), dnum)
    return torch.stack([
        base_convert(x[lo:hi], qs_src[lo:hi], qs_dst, correction=correction)
        for lo, hi in groups
    ])


def digit_count(q: int, base_bits: int) -> int:
    """Digits needed to cover [0, q) in base 2^base_bits."""
    if not 1 <= base_bits <= 30:
        raise ValueError(f"base_bits must be in [1, 30], got {base_bits}")
    return -(-int(q).bit_length() // base_bits)


def digit_decompose(
    x: torch.Tensor, q: int, base_bits: int, *, balanced: bool = False
) -> torch.Tensor:
    """Positional split (..., n) in [0, q) -> (ndig, ..., n) digits mod q.

    Unsigned: d_j = (x >> w j) & (2^w - 1).  Balanced: d_j centered with
    ripple carries, a negative digit held as q - |d|; the top digit stays
    unsigned in [0, 2^w] and absorbs the final carry.
    """
    q, w = int(q), int(base_bits)
    ndig = digit_count(q, w)
    mask = (1 << w) - 1
    if not balanced:
        return torch.stack([(x >> (w * j)) & mask for j in range(ndig)])
    half = 1 << (w - 1)
    digits = []
    carry = torch.zeros_like(x)
    for j in range(ndig):
        d = ((x >> (w * j)) & mask) + carry  # <= 2^w
        if j == ndig - 1:
            up = torch.zeros_like(d)  # the top digit keeps the carry
        else:
            up = (d > half).to(d.dtype)
        # centered digit mod q: d - 2^w when carrying, wrapped by + q
        digits.append(torch.where(up == 1, d + (q - (mask + 1)), d))
        carry = up
    return torch.stack(digits)
