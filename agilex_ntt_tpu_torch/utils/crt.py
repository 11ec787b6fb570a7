"""Chinese-remainder reconstruction of RNS residues (host side, numpy).

A copy of ``agilex_ntt_tpu/utils/crt.py``: Python big integers in numpy
object arrays.  It is the host oracle for ``RNSRing.from_rns`` and for the
key-switch tests; the device never holds a wide integer.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def crt_compose(residues: np.ndarray, qs: Sequence[int]) -> np.ndarray:
    """residues: (L, ...) unsigned arrays; returns a (...) object array of
    ints in [0, prod(qs))."""
    L = len(qs)
    if residues.shape[0] != L:
        raise ValueError(f"leading axis {residues.shape[0]} != len(qs) {L}")
    modulus = 1
    for q in qs:
        modulus *= q
    acc = np.zeros(residues.shape[1:], dtype=object)
    for i, q in enumerate(qs):
        mi = modulus // q
        inv = pow(mi % q, -1, q)
        term = (residues[i].astype(object) * (mi * inv)) % modulus
        acc = (acc + term) % modulus
    return acc


def crt_centered(residues: np.ndarray, qs: Sequence[int]) -> np.ndarray:
    """Like crt_compose, mapped to the centered range (-M/2, M/2]."""
    M = 1
    for q in qs:
        M *= q
    vals = crt_compose(residues, qs)
    return np.where(vals > M // 2, vals - M, vals)
