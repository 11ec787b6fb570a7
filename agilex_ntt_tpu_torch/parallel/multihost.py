"""Multi-process setup: one process a card, over ``torch.distributed``.

Counterpart of ``agilex_ntt_tpu/parallel/multihost.py``.  There every host
runs the same program, ``jax.distributed.initialize`` wires the control
plane and the mesh spans all hosts' devices; XLA routes the collectives,
so the sharded transforms run unchanged.  Here every process runs the same
program too: ``init_distributed`` starts the process group,
``pod_mesh`` gives a ``Mesh`` over every process's card in rank order that
records which rank owns each position, and ``ShardedRing`` on such a mesh
runs SPMD: each process transforms its own block, and the blocks move
between processes through ``comm.py`` (the cross stages' pair exchanges,
the four-step retiles, the gather of the result).

Axis order (the JAX module's rule): sp is the innermost axis, so that the
per-stage exchanges and the retiles run between consecutive ranks, on one
host; dp is outermost.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import comm
from .mesh import Mesh, make_mesh

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
    card and "gloo" otherwise.  With a card, the process takes card
    ``LOCAL_RANK`` (else its rank modulo the cards it sees) first, so that
    each process owns one card.  Must run on every process before any
    ``pod_mesh``."""
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
    if torch.cuda.is_available():
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


def _local_devices(world: int):
    if world > 1:
        if torch.cuda.is_available():
            return [torch.device("cuda", torch.cuda.current_device())]
        return [torch.device("cpu")]
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return []


def pod_mesh(dp: int = 1, sp: int = 1, *, local_devices=None) -> Mesh:
    """Global (dp, sp) mesh over every device of every process.

    sp is placed on the innermost axis so that coefficient-sharded
    exchanges (the stage exchanges, the four-step retiles) run between
    neighbouring ranks; dp spans the rest.  The devices are each process's
    ``local_devices`` in rank order, filled row-major.  They default to
    this process's card (``cuda:<current device>``, the CPU without one)
    in a world of several processes, and to every visible card in one.

    In a world of several processes every process passes one device, and
    the mesh records the rank that owns each position, the world group and
    the groups of each dp and sp line (``Mesh.owners``,
    ``Mesh.process_group``, ``Mesh.axis_groups``).  Under NCCL two
    processes may not share a card (``comm.check_cards``)."""
    world = process_count()
    local = [torch.device(d) for d in (_local_devices(world)
                                       if local_devices is None
                                       else local_devices)]
    count = len(local) * world if world > 1 else len(local)
    if dp * sp != count:
        raise ValueError(
            f"mesh dp*sp = {dp * sp} must equal global device count {count}"
        )
    if world == 1:
        return make_mesh(dp=dp, sp=sp, devices=local)
    if len(local) != 1:
        raise ValueError(
            f"a mesh of {world} processes takes one device a process, got "
            f"{len(local)} ({local})")
    placed = [None] * world
    dist.all_gather_object(placed, (str(local[0]), comm.card_id(local[0])))
    comm.check_cards(dist.get_backend(), [card for _, card in placed])
    devices = np.empty(world, dtype=object)
    devices[:] = [torch.device(d) for d, _ in placed]
    owners = np.arange(world).reshape(dp, sp)
    # every rank creates every group, in one order
    axis_groups = {
        "dp": {tuple(line): dist.new_group(line)
               for line in owners.T.tolist()},
        "sp": {tuple(line): dist.new_group(line) for line in owners.tolist()},
    }
    return Mesh(devices.reshape(dp, sp), ("dp", "sp"), owners=owners,
                rank=dist.get_rank(), process_group=dist.group.WORLD,
                axis_groups=axis_groups)


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
