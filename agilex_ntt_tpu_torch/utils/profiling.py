"""Kernel timing on the card with CUDA events.

Counterpart of the timing half of ``agilex_ntt_tpu/utils/profiling.py``.
``cuda_time_ms`` warms a callable up, then times ``reps`` runs of ``inner``
back-to-back calls, each run between a pair of CUDA events, and returns the
median time of one call in milliseconds.  PyTorch returns before the device
finishes, so a host clock would time the enqueue; the events time the
device, and back-to-back calls hide the host's launch cost behind the
previous call's work as a caller's stream of calls would.  A process with no
card gets a RuntimeError.
"""

from __future__ import annotations

import statistics
from typing import Callable


def cuda_time_ms(
    fn: Callable[[], object], *, warmup: int = 3, reps: int = 5, inner: int = 10
) -> float:
    """Median device time of one ``fn()`` call in milliseconds."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)
