"""Multi-process setup over ``torch.distributed``.

Counterpart of ``agilex_ntt_tpu/parallel/multihost.py``.  There every host
runs the same program, ``jax.distributed.initialize`` wires the control
plane and the mesh spans all hosts' devices; XLA routes the collectives,
so the sharded transforms run unchanged.  Here every process runs the same
program too: ``init_distributed`` starts the process group, and
``make_mesh`` (or ``pod_mesh``, its (dp, sp) form) gives a ``Mesh`` over
every process's devices in rank order, one card a process or several,
that records which rank owns each position.  ``ShardedRing`` and
``ShardedRNSRing`` on such a mesh run SPMD: each process transforms the
blocks of its own positions (a process holds a block of every mesh axis
the ring does not name, as JAX replicates over such an axis), blocks of
one process meet by device copies, and the blocks move between processes
through ``comm.py`` (the cross stages' exchanges, the four-step retiles,
the gather of the result).

Axis order (the JAX module's rule): sp is the innermost axis, so that the
per-stage exchanges and the retiles run between consecutive positions:
inside one process when an sp line is no longer than its card count, else
between consecutive ranks, on one host; dp is outermost.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh
from .mesh import local_devices as mesh_local_devices

# the environment that marks a cluster, the JAX module's list;
# TPU_WORKER_HOSTNAMES counts only with more than one host, and torch's
# launcher (``torchrun``) counts when WORLD_SIZE > 1
CLUSTER_ENV = (
    "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
    "MEGASCALE_COORDINATOR_ADDRESS",
    "SLURM_JOB_NUM_NODES", "OMPI_COMM_WORLD_SIZE",
)


def _cluster_env() -> bool:
    env = os.environ
    hosts = [h for h in env.get("TPU_WORKER_HOSTNAMES", "").split(",") if h]
    return (any(env.get(v) for v in CLUSTER_ENV) or len(hosts) > 1
            or int(env.get("WORLD_SIZE") or 1) > 1)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    force: bool = False,
    backend: Optional[str] = None,
    device=None,
) -> None:
    """Start the process group (a no-op for a single process).

    ``coordinator_address`` is "host:port" (``tcp://`` is added) or an
    init method with its scheme (``tcp://...``, ``file://...``);
    ``num_processes`` and ``process_id`` are the world size and this
    process's rank.  Under ``torchrun`` they default to ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.  With no arguments and no
    cluster environment this is a no-op (a lone process would wait for
    peers that never come); ``force=True`` starts the group anyway from
    the environment.  ``backend`` defaults to "nccl" on a machine with a
    card and "gloo" otherwise.  With a card, the process takes ``device``
    as its current card (the first of its mesh devices; NCCL runs the
    process's transfers there), by default card ``LOCAL_RANK`` (else its
    rank modulo the cards it sees), so that each process owns one card.
    Must run on every process before any ``make_mesh`` or ``pod_mesh``."""
    if num_processes is not None and num_processes <= 1:
        return
    if (coordinator_address is None and num_processes is None
            and not _cluster_env() and not force):
        return
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if device is not None:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device))
    elif torch.cuda.is_available():
        local = env.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local else
                              (process_id or 0) % torch.cuda.device_count())
    kwargs = dict(backend=backend)
    if coordinator_address is not None:
        kwargs["init_method"] = (coordinator_address
                                 if "://" in coordinator_address
                                 else f"tcp://{coordinator_address}")
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(**kwargs)


def process_count() -> int:
    """The number of processes: the group's world size, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank, 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def pod_mesh(dp: int = 1, sp: int = 1, *, local_devices=None) -> Mesh:
    """Global (dp, sp) mesh over every device of every process:
    ``make_mesh(dp=dp, sp=sp, devices=local_devices)``.

    sp is placed on the innermost axis so that coefficient-sharded
    exchanges (the stage exchanges, the four-step retiles) run between
    neighbouring positions, inside a process where its devices cover an sp
    line; dp spans the rest.  ``local_devices`` are this process's
    devices: by default its card (``cuda:<current device>``, the CPU
    without one) in a world of several processes, and every visible card
    in one; a process may pass several (every process as many)."""
    world = process_count()
    local = local_devices
    if local is None:
        local = mesh_local_devices() if world > 1 else [
            torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    count = len(local) * world
    if dp * sp != count:
        raise ValueError(
            f"mesh dp*sp = {dp * sp} must equal global device count {count}"
        )
    return make_mesh(dp=dp, sp=sp, devices=local)


def process_local_batch(global_batch: int) -> slice:
    """The slice of a (process-partitioned) global batch this process
    feeds: each process materializes only its slice of the batch."""
    n_proc = process_count()
    if global_batch % n_proc:
        raise ValueError(
            f"global batch {global_batch} must divide over {n_proc} processes"
        )
    per = global_batch // n_proc
    i = process_index()
    return slice(i * per, (i + 1) * per)
