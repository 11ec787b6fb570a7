"""Scheme layer on the port's ring stack: the RNS-CKKS evaluator.

Counterpart of ``agilex_ntt_tpu/schemes``.  BGV and BFV, which build on
``CKKSContext``, are not ported yet.
"""

from .ckks import (
    CKKSContext,
    Ciphertext,
    KeySet,
    LinearOp,
    MatVecOp,
    Plaintext,
)

__all__ = ["CKKSContext", "Ciphertext", "KeySet", "LinearOp", "MatVecOp",
           "Plaintext"]
