"""agilex_ntt_tpu_torch — the negacyclic NTT framework on PyTorch and CUDA.

The port of ``agilex_ntt_tpu`` (JAX/Pallas on a TPU) to an NVIDIA H100: the
same rings, tables and outputs, with hand-written Hopper kernels in place of
the Pallas ones.  It imports neither JAX nor the JAX package.
"""

from .api import CyclicRing, Ring, RNSRing, WideRing
from .config import NTTConfig, REFERENCE_SIZES
from .params import NTTParams, find_primes, find_psi, make_params, params_from_numpy

__version__ = "0.1.0"

__all__ = [
    "CyclicRing",
    "Ring",
    "RNSRing",
    "WideRing",
    "NTTConfig",
    "NTTParams",
    "REFERENCE_SIZES",
    "find_primes",
    "find_psi",
    "make_params",
    "params_from_numpy",
]
