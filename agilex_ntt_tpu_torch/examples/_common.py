"""What the examples share: the ``--device`` argument, the check that
raises, and the devices of a mesh."""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch


def device_from(argv: Optional[List[str]], doc: str) -> torch.device:
    """The ``--device`` of the command line (default the card)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the rings run (default: the card)")
    return torch.device(ap.parse_args(argv).device)


def check(ok, what: str) -> None:
    """Raise ``AssertionError(what)`` unless ``ok`` (also under -O)."""
    if not bool(ok):
        raise AssertionError(what)


def host(x) -> np.ndarray:
    """A tensor (or array) as a numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def mesh_devices(device: torch.device, count: int) -> list:
    """``count`` devices for ``make_mesh``: that many distinct cards when
    the host has them, else ``device`` repeated (the port's sharded rings
    take a device more than once)."""
    if device.type == "cuda" and torch.cuda.device_count() >= count:
        return [torch.device("cuda", i) for i in range(count)]
    return [device] * count
