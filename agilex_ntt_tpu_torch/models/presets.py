"""Preset rings for the transform sizes the reference supports.

Counterpart of ``agilex_ntt_tpu/models/presets.py``, with the same six
names, sizes, prime counts and notes.  The reference hard-codes its size
menu as a compile-time lookup table (``FPGA_NTT_SIZE`` in {32, 1024, 8192,
16384, 32768}) and ships with a dummy modulus (65537); here each size is a
named preset with a chain of 30-bit NTT primes, the largest primes
≡ 1 (mod 2n) below 2^30 (``find_primes``), built on demand.

The deeper RNS chains (3 primes at n = 4096 and up) match the modulus
budgets of SEAL-Embedded's small-device parameter sets.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from ..api import Ring, RNSRing


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    n: int
    num_primes: int
    note: str


PRESETS: Dict[str, Preset] = {
    p.name: p
    for p in [
        Preset("tiny", 32, 1, "reference's smallest config (ntt.h:12)"),
        Preset("n1024", 1024, 1, "SEAL-Embedded n=1024 single prime"),
        Preset("n4096", 4096, 3, "SEAL-Embedded n=4096, 3-prime RNS chain"),
        Preset("n8192", 8192, 3, "reference size menu entry (ntt.h:16)"),
        Preset("n16384", 16384, 4, "reference default FPGA_NTT_SIZE (main.cpp:9)"),
        Preset("n32768", 32768, 4, "reference's largest config (ntt.h:22)"),
    ]
}


def preset_ring(name: str, **ring_kwargs) -> Ring:
    """Single-prime ring of a named preset (the first prime of its chain);
    ``ring_kwargs`` (``device``, ``method``, ...) go to ``Ring``."""
    p = PRESETS[name]
    return Ring(p.n, **ring_kwargs)


def preset_rns(name: str, **ring_kwargs) -> RNSRing:
    """RNS ring of all the primes of a preset's chain; ``ring_kwargs``
    (``device``, ``method``, ...) go to ``RNSRing``."""
    p = PRESETS[name]
    return RNSRing(p.n, num_primes=p.num_primes, **ring_kwargs)
