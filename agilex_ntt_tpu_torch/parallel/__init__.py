"""Batch (dp), coefficient (sp) and prime-channel (ch) sharding over a mesh
of devices.

Counterpart of ``agilex_ntt_tpu/parallel`` for one process driving every
device of the mesh (``make_mesh(devices=...)``; a device may repeat, so the
sharded paths also run on one card): ``ShardedRing``, the stage-sharded
transform whose cross stages run on the exchange kernel K11, the four-step
sharded transform, and ``ShardedRNSRing`` with the channel x coefficient
four-step transform (``chsp.py``).  ``multihost.py`` starts a process
group; ``make_mesh`` and ``pod_mesh`` then build the global mesh over
every process's devices (one card a process or several), on which
``ShardedRing`` and ``ShardedRNSRing`` (with the schemes' ``mesh=``) run
SPMD, each process on its own blocks (the moves in ``comm.py``).
"""

from .fourstep_shard import fourstep_sharded_fwd, fourstep_sharded_inv
from .mesh import (
    Mesh, ShardedRing, ShardedRNSRing, dp_shard_batch, make_mesh,
)
from .multihost import init_distributed, pod_mesh, process_local_batch
from .stage_shard import stage_sharded_fwd, stage_sharded_inv
