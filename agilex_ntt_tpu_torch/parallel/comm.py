"""The moves of the sharded ring between processes, in one place.

A mesh of several processes (``make_mesh`` or ``multihost.pod_mesh`` in a
world of processes) gives each process one or more positions (cards, or
the CPU): the process holds those positions' blocks of every grid and
nothing else (``shards.Layout``).  The sharded transforms then run SPMD,
every process on its own blocks.  Moves between two blocks of one
process are device copies (or K11 reading its partner on a peer card) and
never come here; the blocks move between processes only here:

- ``exchange``: the partner's whole shard of a cross stage (``copy_`` when
  the partner is in this process, one ``batch_isend_irecv`` pair with the
  partner's process when not); ``post_exchange`` posts one batch chunk of
  it and returns at once (``sp_comm="overlap"``);
- ``all_to_all``: the four-step retile, ``all_to_all_single`` on one
  contiguous buffer over the sp group;
- ``transfer``: any set of point-to-point moves posted as one batch, for
  an sp line whose processes hold several shards each or hold them at
  different replicas (``shards.Fetch``);
- ``all_gather``: every process's blocks, for ``shards.join``.

The first two serve meshes of one position a process, where every sp
line's shards sit in distinct processes.

Every transfer moves int32 views of the uint32 words (gloo refuses
``torch.uint32``).  Under NCCL the tensors go on the wire from the card and
NCCL orders its stream after the launches that wrote them; ``wait`` makes
the current stream wait for the transfer.  A process with several cards
puts what it sends and receives on its first card, ``mesh.home`` (a device
copy, never through the host): NCCL runs a process's transfers on the
card the process took as its current device (``init_distributed``).
Under gloo a CUDA tensor is staged through pinned host memory
(``stages_through_host``): that is the route of several processes sharing
one card, which NCCL refuses (``check_cards`` raises for it).  Nothing
falls back from one route to the other.
"""

from __future__ import annotations

import dataclasses
import socket
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Line:
    """The processes of one sp group: ``ranks[d]`` owns shard d, ``index``
    is this process's shard and ``group`` the group of ``ranks``."""

    ranks: tuple
    group: object
    index: int

    def __post_init__(self):
        # all_to_all_single deals its chunks in group-rank order, which is
        # ascending global rank
        if list(self.ranks) != sorted(self.ranks):
            raise ValueError(f"an sp group's ranks must ascend with the "
                             f"shard index, got {self.ranks}")

    @property
    def size(self) -> int:
        return len(self.ranks)


def stages_through_host(group, device) -> bool:
    """Whether transfers of tensors on ``device`` over ``group`` go through
    pinned host memory: CUDA tensors under gloo."""
    return (torch.device(device).type == "cuda"
            and dist.get_backend(group) == dist.Backend.GLOO)


def card_id(device) -> Optional[tuple]:
    """(host, card) of a CUDA device, None for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    props = torch.cuda.get_device_properties(device)
    return (socket.gethostname(), str(getattr(props, "uuid", device.index)))


def check_cards(backend: str, cards: Sequence[Sequence[Optional[tuple]]]
                ) -> None:
    """Raise when NCCL is asked for and two processes share a card
    (``cards[r]``: the ``card_id`` of each of rank r's devices; a process
    may name one card several times)."""
    if backend != dist.Backend.NCCL:
        return
    seen = {}
    for rank, mine in enumerate(cards):
        for card in mine:
            if card is None:
                raise ValueError(f"NCCL needs a card in every process; rank "
                                 f"{rank} has a device that is none")
            if seen.setdefault(card, rank) != rank:
                raise ValueError(
                    f"NCCL takes one process a card, but ranks {seen[card]} "
                    f"and {rank} share {card}; run several processes on one "
                    "card over gloo (host-staged) instead")


def _words(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.uint32)


def _pinned(like: torch.Tensor) -> torch.Tensor:
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of ``t``, complete on return."""
    host = _pinned(t)
    host.copy_(t)
    return host


class Pending:
    """A transfer in flight: ``wait()`` returns the uint32 tensor that
    arrived, on the device it was asked for.  The tensors on the wire are
    held until then, so that no buffer in flight is freed or reused."""

    def __init__(self, works, recv: torch.Tensor, wire, host=None):
        self._works = works
        self._recv = recv
        self._wire = wire
        self._host = host

    def wait(self) -> torch.Tensor:
        for work in self._works:
            work.wait()
        if self._host is not None:
            self._recv.copy_(self._host)
        self._works = self._wire = self._host = None
        return _u32(self._recv)


def post_exchange(x: torch.Tensor, line: Line, peer: int,
                  rows: slice = slice(None), tag: int = 0) -> Pending:
    """Send rows ``rows`` of this process's shard ``x`` to the process of
    shard ``peer`` and receive the same rows of that shard, one
    ``batch_isend_irecv`` pair (the partner posts the mirror pair)."""
    send = _words(x)[rows]
    recv = torch.empty_like(send)
    host = None
    wire_send, wire_recv = send, recv
    if stages_through_host(line.group, x.device):
        wire_send, host = _to_host(send), _pinned(recv)
        wire_recv = host
    rank = line.ranks[peer]
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, wire_send, rank, line.group, tag),
        dist.P2POp(dist.irecv, wire_recv, rank, line.group, tag),
    ])
    return Pending(works, recv, (wire_send, wire_recv, send), host)


def exchange(x: torch.Tensor, peer, line: Optional[Line] = None) -> torch.Tensor:
    """The partner's whole shard beside this shard ``x``: ``peer`` is the
    partner's tensor when it is in this process (copied, ``copy_``), or
    the partner's shard index in ``line`` when another process owns it."""
    if line is None:
        out = torch.empty_like(x)
        _words(out).copy_(_words(peer))
        return out
    return post_exchange(x, line, peer).wait()


def all_to_all(blocks: Sequence[torch.Tensor], line: Line) -> Pending:
    """Block e of ``blocks`` (all one shape) to the process of shard e;
    ``wait()`` gives a (P, ...) tensor whose entry e came from shard e.
    One ``all_to_all_single`` on one contiguous buffer, posted at once."""
    send = torch.stack([_words(b) for b in blocks])
    recv = torch.empty_like(send)
    host = None
    wire_send, wire_recv = send, recv
    if stages_through_host(line.group, send.device):
        wire_send, host = _to_host(send), _pinned(recv)
        wire_recv = host
    work = dist.all_to_all_single(wire_recv, wire_send, group=line.group,
                                  async_op=True)
    return Pending([work], recv, (wire_send, wire_recv), host)


def transfer(sends, recvs, group, home) -> List[torch.Tensor]:
    """Point-to-point moves posted as one batch and waited for.  ``sends``
    lists (tensor, peer rank, tag), ``recvs`` (a tensor shaped like the
    one that arrives, peer rank, tag); returns what arrived, uint32 on
    ``home`` in the order of ``recvs``.  What goes on the wire sits on
    ``home`` (in pinned host memory under gloo for a card).  Both sides
    must list the moves between them in one order, with one tag each."""
    staged = stages_through_host(group, home)
    ops, wire, outs = [], [], []
    for t, peer, tag in sends:
        w = _words(t)
        w = _to_host(w) if staged else w.to(home).contiguous()
        wire.append(w)
        ops.append(dist.P2POp(dist.isend, w, peer, group, tag))
    for like, peer, tag in recvs:
        buf = (_pinned(_words(like)) if staged else
               torch.empty(like.shape, dtype=torch.int32, device=home))
        outs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, peer, group, tag))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [_u32(o.to(home) if staged else o) for o in outs]


def all_gather(block: torch.Tensor, group) -> List[torch.Tensor]:
    """Every process's block (all one shape) on this block's device, in
    rank order of ``group``."""
    send = _words(block).contiguous()
    staged = stages_through_host(group, block.device)
    wire = _to_host(send) if staged else send
    outs = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(outs, wire, group=group)
    if staged:
        outs = [o.to(block.device) for o in outs]
    return [_u32(o) for o in outs]
