"""Cross-device butterfly stage with the partner's shard read in chunks.

Counterpart of ``agilex_ntt_tpu/parallel/overlap.py``.  There one Pallas
kernel a stage issues a remote DMA of each batch chunk of the partner's
shard up front and computes chunk c while later chunks are on the wire.
Here the stage kernel (K11, ``ntt_kernel.xchg_step``) reads the partner's
shard through its device pointer (the same card, or a peer card with P2P
access), so its loads stream behind the arithmetic by construction; the
host launches it once a batch chunk, ``_num_chunks`` chunks as the TPU
kernel has them.

Ordering across cards replaces the TPU kernel's barrier and ``wait_send``:

- chunk c of shard d waits on an event recorded after chunk c of its
  partner's previous stage (``ready``), or after all the partner's work so
  far when the previous step was not chunked;
- the kernel writes a separate output buffer, so no shard overwrites words
  that its partner's launch of the same stage still reads;
- each partner shard is marked as read by the reader's stream
  (``record_stream``), so its memory is not reused before that launch ends.

On one card every shard runs on its current stream in launch order, and no
event is needed.  Selected with ``sp_comm="overlap"``; bit-identical to the
whole-shard copy of ``comm="ppermute"``.
"""

from __future__ import annotations

import torch

from ..ops import ntt_kernel as K

# chunks a shard: as in the JAX package (whose shards with fewer than 2 * 8
# rows run unchunked)
MAX_CHUNKS = 8


def _num_chunks(batch: int) -> int:
    c = MAX_CHUNKS
    while c > 1 and batch % (c * 8):
        c //= 2
    return c


def _stream_order(src: torch.device, dst: torch.device) -> None:
    """Make ``dst``'s current stream wait for the work enqueued so far on
    ``src``'s."""
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(src))
    torch.cuda.current_stream(dst).wait_event(ev)


def xchg_stage(xs, rows, roles, *, tdev: int, kind: str, q: int,
               last: bool = False, scale=None, ready=None):
    """One cross-device stage of the P shards ``xs`` of one sp group, shard
    d with partner d ^ tdev, twiddle rows ``rows[d]`` = (w, w') and role
    ``roles[d]`` (u-half or not).  Bit-identical to copying the partner's
    shard and then running the stage step.

    ``ready``: per-chunk events of the stage that produced ``xs`` (from an
    earlier call), or None.  Returns (outputs, their per-chunk events; None
    on a single card)."""
    batch = xs[0].shape[0]
    nch = _num_chunks(batch)
    step = batch // nch
    multi = len({x.device for x in xs}) > 1 and xs[0].device.type == "cuda"
    outs = [torch.empty_like(x) for x in xs]
    events = [[None] * nch for _ in xs] if multi else None
    for d, x in enumerate(xs):
        p = d ^ tdev
        partner = xs[p]
        cross = multi and partner.device != x.device
        if cross and ready is None:
            _stream_order(partner.device, x.device)
        for c in range(nch):
            sl = slice(c * step, (c + 1) * step)
            if cross and ready is not None:
                torch.cuda.current_stream(x.device).wait_event(ready[p][c])
            K.xchg_step(
                x[sl], partner[sl], *rows[d], q=q, fwd=kind == "fwd",
                is_u=roles[d], last=last, scale=scale, out=outs[d][sl],
            )
            if multi:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(x.device))
                events[d][c] = ev
        if cross:  # keep the partner's memory until this stream read it
            partner.record_stream(torch.cuda.current_stream(x.device))
    return outs, events
