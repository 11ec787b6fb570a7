"""Scheme layer on the port's ring stack: the RNS-CKKS, RNS-BGV and RNS-BFV
evaluators.

Counterpart of ``agilex_ntt_tpu/schemes``.  ``BGVContext`` builds on
``CKKSContext`` through its hooks, ``BFVContext`` on ``BGVContext``.
"""

from .bfv import BFVContext
from .bgv import BGVContext
from .ckks import (
    CKKSContext,
    Ciphertext,
    KeySet,
    LinearOp,
    MatVecOp,
    Plaintext,
)

__all__ = ["BFVContext", "BGVContext", "CKKSContext", "Ciphertext",
           "KeySet", "LinearOp", "MatVecOp", "Plaintext"]
