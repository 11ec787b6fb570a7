"""Ring configuration: one negacyclic ring Z_q[X]/(X^n + 1).

Counterpart of ``agilex_ntt_tpu/config.py`` without the TPU lane constants
(``LANES``, ``SUBLANES``, ``lane_batch``): the Hopper kernels hold one
polynomial per thread block and need no lane packing.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Transform sizes the original FPGA design supports at compile time; every
# power of two >= 8 is accepted, this tuple is the menu for parity tests.
REFERENCE_SIZES: Tuple[int, ...] = (32, 1024, 8192, 16384, 32768)


def is_power_of_two(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def log2_exact(x: int) -> int:
    if not is_power_of_two(x):
        raise ValueError(f"{x} is not a power of two")
    return x.bit_length() - 1


@dataclasses.dataclass(frozen=True)
class NTTConfig:
    """Static configuration for one negacyclic NTT ring.

    Attributes:
      n: transform size, a power of two >= 8.
      q: the NTT-friendly prime, q ≡ 1 (mod 2n) and q < 2**30, so that the
         lazy Harvey butterfly range [0, 4q) fits in 32-bit words.
    """

    n: int
    q: int

    def __post_init__(self):
        if not is_power_of_two(self.n) or self.n < 8:
            raise ValueError(f"n must be a power of two >= 8, got {self.n}")
        if self.q >= (1 << 30):
            raise ValueError(
                f"q must be < 2**30 for uint32 lazy arithmetic, got {self.q}"
            )
        if self.q % (2 * self.n) != 1:
            raise ValueError(
                f"q must satisfy q ≡ 1 (mod 2n): q={self.q}, n={self.n}"
            )

    @property
    def log_n(self) -> int:
        return log2_exact(self.n)
