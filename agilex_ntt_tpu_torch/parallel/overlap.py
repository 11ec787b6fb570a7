"""Cross-device butterfly stage with the partner's shard read in place.

Counterpart of ``agilex_ntt_tpu/parallel/overlap.py``.  There one Pallas
kernel a stage issues a remote DMA of each batch chunk of the partner's
shard up front and computes chunk c while later chunks are on the wire.
Here the stage kernel (K11, ``ntt_kernel.xchg_group``) reads the partner's
shard through its device pointer, so nothing is copied and there are no
chunks to overlap.  Two routes of that kernel, chosen by where the shards
sit:

- every shard of the sp group on one device (the card, or the CPU): one
  launch for the stage, one entry a butterfly pair, which reads both shards
  once and writes both new halves;
- shards on distinct cards (P2P): ``launch_by_device``, one launch a card,
  each of its shards an entry that writes its own half from its partner's
  words on the peer card.  Each card waits on an event recorded on the
  partner's card after the stage before, and the partner's shard is marked
  as read by the reader's stream (``record_stream``) so that its memory is
  not reused before that launch ends.

Every output is a new buffer, so no shard overwrites words that another
launch of the same stage still reads.  Selected with ``sp_comm="overlap"``;
bit-identical to the whole-shard copy of ``comm="ppermute"``.

Across processes (a mesh of ``multihost.pod_mesh``) the partner's shard is
in another process and cannot be read in place.  There ``xchg_remote``
runs the JAX kernel's design with ``torch.distributed`` for its DMAs: it
cuts the shard into up to ``MAX_CHUNKS`` row chunks (``num_chunks``),
posts every chunk's exchange at once (``comm.post_exchange``), then, chunk
by chunk, waits for that chunk and launches K11 on it, so that the later
chunks are on the wire while the earlier ones compute.
"""

from __future__ import annotations

import torch

from ..ops import ntt_kernel as K
from . import comm

# chunks a shard across processes (the JAX module's rule): at most 8, each
# a multiple of 8 rows, else fewer; a shard of under 16 rows is one chunk
MAX_CHUNKS = 8


def num_chunks(batch: int) -> int:
    c = MAX_CHUNKS
    while c > 1 and batch % (c * 8):
        c //= 2
    return c


def launch_by_device(xs, partners, rows, roles, *, fwd: bool, q: int,
                     last: bool = False, scale=None):
    """Shard d's own half of one stage, from ``xs[d]`` and ``partners[d]``
    with twiddle rows ``rows[d]`` = (w, w') and role ``roles[d]`` (u-half
    or not): one ``xchg_group`` launch for the shards of each device.  A
    partner on another card is read in place once that card's work so far
    is done.  Returns the new shards."""
    done = {}  # an event a partner's card, after the stage before
    for x, p in zip(xs, partners):
        if p.device != x.device and p.device not in done:
            done[p.device] = torch.cuda.Event()
            done[p.device].record(torch.cuda.current_stream(p.device))
    outs = [torch.empty_like(x) for x in xs]
    by_device = {}
    for d, x in enumerate(xs):
        by_device.setdefault(x.device, []).append(d)
    for device, group in by_device.items():
        remote = [partners[d] for d in group if partners[d].device != device]
        if remote:
            stream = torch.cuda.current_stream(device)
            for dev in {p.device for p in remote}:
                stream.wait_event(done[dev])
        K.xchg_group([K.half_entry(xs[d], partners[d], *rows[d], roles[d],
                                   outs[d]) for d in group],
                     q=q, fwd=fwd, last=last, scale=scale)
        for p in remote:  # keep the partner's memory until this stream read it
            p.record_stream(stream)
    return outs


def xchg_stage(xs, rows, roles, *, tdev: int, fwd: bool, q: int,
               last: bool = False, scale=None):
    """One cross-device stage of the P shards ``xs`` of one sp group, shard
    d with partner d ^ tdev, twiddle rows ``rows[d]`` = (w, w') (the same
    for both shards of a pair) and role ``roles[d]`` (u-half or not).
    Bit-identical to copying the partner's shard and then running the
    stage step.  Returns the new shards."""
    if len({x.device for x in xs}) > 1:
        return launch_by_device(xs, [xs[d ^ tdev] for d in range(len(xs))],
                                rows, roles, fwd=fwd, q=q, last=last,
                                scale=scale)
    outs = [torch.empty_like(x) for x in xs]
    K.xchg_group([(xs[d], xs[d ^ tdev], *rows[d], outs[d], outs[d ^ tdev])
                  for d in range(len(xs)) if roles[d]],
                 q=q, fwd=fwd, last=last, scale=scale)
    return outs


def xchg_remote(x, line, peer: int, row, is_u: bool, *, fwd: bool, q: int,
                last: bool = False, scale=None):
    """This process's half of one cross stage: its shard ``x`` and the
    shard ``peer`` of ``line`` (another process's), twiddle row ``row`` =
    (w, w') and role ``is_u``.  Every chunk's exchange is posted first,
    then each chunk is waited for and computed (one K11 launch a chunk).
    Bit-identical to the whole-shard exchange.  Returns the new shard."""
    step = x.shape[0] // num_chunks(x.shape[0])
    chunks = [slice(r, r + step) for r in range(0, x.shape[0], step)]
    posted = [comm.post_exchange(x, line, peer, rows, tag)
              for tag, rows in enumerate(chunks)]
    out = torch.empty_like(x)
    for rows, pending in zip(chunks, posted):
        K.xchg_group([K.half_entry(x[rows], pending.wait(), *row, is_u,
                                   out[rows])],
                     q=q, fwd=fwd, last=last, scale=scale)
    return out
