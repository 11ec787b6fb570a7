#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``agilex_ntt_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package.  Phases, each of which
fails the run (non-zero exit, no result line) when it goes wrong:

1. Build: ``nvcc`` compiles the kernels from ``agilex_ntt_tpu_torch/csrc``
   for ``sm_90a`` (``ops/_build.py``).
2. Kernels: each of the single- and multi-prime, four-step, DIT and
   exchange kernels against its plain PyTorch version
   on the same inputs on the card, bit for bit over the whole output
   (tolerance 0: integer arithmetic).  Single prime: at the main path's
   shapes (n=4096, batch 8192; polydot k=3, batch 2048), at n=32768 and
   n=32, and at two shapes that reach the kernels' other branches; the
   transforms (K1, K2), which run the multi-prime transform kernels at one
   channel, also on their other callers' tables (``TRANSFORM_MORE``:
   ``CyclicRing``'s at n = 2, 4 and 32768, the stage-shard tables of the
   sharded ring, the four-step row pass's at 2^20 and 2^21, the sharded
   four-step's column tables, and BGV's and BFV's plaintext rings
   ``Ring(n, q=t)`` at (16384, 65537) and (4096, 40961)) with each scale
   those callers pass; the
   fused polymul (K3) and polydot (K6a), which run the multi-prime polydot
   kernel at one channel, with a first operand over the lazy [0, 4q) and
   the edge words 4q - 1, q - 1 and 0, also on ``CyclicRing``'s tables at
   n = 2, 4 and 32768 and with k = 8 terms.  L
   primes: the "n4096" chain (L=3, batch 2048), the key-switch dot of the
   "n16384" chain (K=5 primes, batch 64, k=dnum=4), n=8192 and n=32768,
   n=32 (L=3, batch 4096) and a ragged batch: K4a, K4b, K5 and K6b at
   every launch shape of their kernels (clusters of 1, 2, 4 and 8 CTAs, 16
   and 128 polynomials a CTA), each check line naming it; K4a and K4b also
   on BFV's union basis of the "n16384" chain (Q + B + {m_sk}, 11
   channels) at its tensor's launch shapes (4 x 64 and 2 x 64 forward,
   3 x 64 inverse at the product scale), and on the stacked four-step
   column (negacyclic, n1) and cyclic row (n2) tables of a channel block
   of ``RNSRing(2^16, 4)`` at phase 3h's block shape, the inverse with each
   scale ``parallel/chsp.py`` passes.  The first rows
   are also held against the package's numpy golden model, channel by
   channel.
   Four-step (K7a, K7b, K8, K9a and K9b everywhere): n=2^16 (B=512), 2^18
   (B=128), 2^19 (B=64), 2^20 (B=32), 2^21 (B=16; where the route takes
   the two-kernel transforms, the public ``Ring`` also through the row pass
   on K1/K2), the unbalanced 2^17 (512 x 256, B=64) and a ragged batch
   (2^16, B=7); K7a and K7b on their cluster kernels up to 2^19 and K8 up
   to 2^18 (clusters of 2 to 16 CTAs) and on the walking kernels above, K9a
   and K9b on their slab kernels; K9a and K9b also at n1 = 2^11 .. 2^15
   (n2 = 64, 32 MiB an operand: slabs of 32 down to 2 columns, then the
   walking kernels), K9b on any 32-bit words with both scales; the first 2
   rows at n=2^16 against the golden model.  The
   DIT inverse K12 (``dit_inv_cluster_kernel``, K1's launch) at n=4096
   (B=8192), 32, 32768 and a ragged batch at 256, with ``inv_ntt_dit``
   (direct and factored) equal to K2; the cross-device stage K11 (forward
   and inverse, each role, with and without ``last``) on one shard's half
   of the sharded path, (512, 8192), and as group launches of 2, 4 and 8
   entries of such shards (``xchg_group``; an entry writes both halves of
   its butterfly pair or one of them), every half held.
3. Main paths, each with the launch counters set to 0 just before and read
   just after; every kernel of the path must have launched:
   a. ``Ring(4096)`` ntt -> intt -> polymul -> polydot at the main shapes,
      outputs against the golden model;
   b. the key switch of the "n16384" CKKS chain (4 primes and the largest
      of ``find_primes(16384, 5)`` as the special prime, dnum = 4):
      ``RNSRing.keyswitch`` of (4, 64, 16384) residues with coefficient-
      and evaluation-domain keys, ``hoisted_keyswitch`` over 3 Galois
      steps, then ``RNSRing(4096, 3)`` ntt -> intt -> polymul -> polydot at
      batch 2048.  The first rows must equal the port's own CPU plain
      composition, the two key domains each other, and the 4096 outputs
      the golden model;
   c. the four-step path: ``Ring`` at n=2^16 (B=512; polydot B=128, k=3),
      2^18 (B=128), 2^20 (B=32) and 2^21 (B=16) ntt -> intt -> polymul,
      ``CyclicRing(2^16)`` and ``RNSRing(2^16, 3)`` (B=64); every output
      checked, the first rows against the plain versions (and the golden
      model at 2^16), and ``Ring(32768, method="fourstep")`` equal word
      for word to the radix-2 kernels at B=1024;
   d. the flat layout, ``Ring(2^16, fourstep_kernel="flat")`` (B=512):
      the same kernels (K10a-c on K7a, K7b, K8), equal to the tiled ring;
   e. the sharded ring on one card (``make_mesh(devices=["cuda:0"] * 8)``):
      ``ShardedRing(Ring(32768))`` over dp=2 x sp=4 at B=1024, ntt, intt
      and polymul with ``sp_comm`` "ppermute" and "overlap" (cross stages
      on K11, local stages on K1/K2), ``ShardedRing(Ring(2^16))`` over sp=4
      (four-step, B=512), the dp=8 polydot at n=4096 (K6a a shard), and
      ``inv_ntt_dit`` (K12) direct and factored at n=4096, B=8192; each
      equal word for word to the unsharded ring.  Then each sharded
      ``ntt`` and ``intt`` alone, counted: K11 launches once a cross stage
      and sp group on one card, 4 a call with either ``sp_comm``;
   f. RNS-CKKS through ``agilex_ntt_tpu_torch.schemes.CKKSContext`` on the
      "n16384" chain (L=4, one special prime) from a seed: keygen, encode
      and encrypt of 64 ciphertexts ((4, 64, 16384) a part), multiply,
      rescale, rotate by 1 and -3, conjugate, a four-term
      ``apply_linear``, ``poly_eval`` in both bases at the highest degree
      the chain reaches (printed), and ``make_matvec``/``apply_matvec`` on
      the "n4096" chain (L=3) with its full 2048 x 2048 slot matrix and
      the default BSGS split.  K4a, K4b and K5 must launch; the first
      ciphertexts decode within the JAX tests' tolerances of numpy (their
      largest, 5e-2, where a key switch's noise is not rescaled away); a
      second context on the CPU, same seeds and calls, holds the same key
      words, encryptions and, on the first ciphertext, every op's words;
   g. RNS-BGV and RNS-BFV through ``BGVContext`` and ``BFVContext`` on the
      same chain at t = 65537 from a seed: for each, keygen (rows rotated
      by 1, -1 and 2, the row swap), encode and encrypt of 64 ciphertexts,
      multiply (BFV's through the HPS pipeline on the 11-channel union
      basis), square, rescale, rotate by 1 and -1, the row swap, a
      four-term ``apply_linear``; BGV's ``poly_eval`` in both bases at the
      highest degree whose result lands at level 2 or above (printed),
      BFV's ``mod_down_to``, and the BGV matvec on the "n4096" chain (L=3,
      t = 40961) with its full 2048 x 2048 row matrix; the first
      ciphertexts decrypted and decoded.  K1, K2 (the plaintext ring's
      transforms), K4a, K4b and K5 must launch; the first ciphertexts of
      every output decode exactly to numpy's slotwise results; a CPU twin
      holds the same key words, encryptions and each op's first-ciphertext
      words;
   h. the sharded RNS ring on one card (``make_mesh(devices=["cuda:0"] *
      k)``): ``ShardedRNSRing`` over the "n4096" chain at dp=4 (B=2048 and a
      remainder batch of 2047: K4a, K4b, K5, K6b a rows block), the
      "n16384" chain (L=4) at ch=2 x dp=4 (B=64: a launch a channel block),
      ``RNSRing(2^16, 4)`` at ch=2 x sp=2 x dp=2 (B=64, 64 MiB an operand:
      ``parallel/chsp.py``, K4a/K4b on the four-step tables of a channel
      block) and ``RNSRing(32768, 3)`` at dp=2 x sp=4 with both
      ``sp_comm`` (B=256: a ``ShardedRing`` a channel, K1/K2 and K11):
      ntt, intt, polymul, polydot (k=2), each equal word for word to the
      unsharded ring on the card; the n16384 key switch's operands of
      phase b at dp=4 through ``keyswitch``, ``hoisted_keyswitch``,
      ``hoisted_linear_sum``, ``gadget_decompose``, ``mod_down`` and
      ``hps_scale_sk``, each equal to the unsharded ring's; and CKKS, BGV
      and BFV (t = 65537) with ``mesh=make_mesh(dp=4)`` from phases f's and
      g's seeds, keys and first encryptions: multiply, square, rotate 1,
      rescale and the four-term ``apply_linear``, each equal to the
      unsharded context's words, the first ciphertexts decoding (BGV and
      BFV exactly);
   i. the wide-modulus ring (``WideRing``, u64 kernels of
      ``csrc/ntt_wide.cuh``): ``WideRing(4096)`` at its default 62-bit
      prime and at a 45-bit one (B=8192, a row a CTA), ``WideRing(32768)``
      (B=256, a cluster of 8 CTAs), ``WideRing(65536)`` (B=64, a cluster
      of 16) and ``WideRing(2^17)`` (B=32, a pass in device memory before
      the cluster body), ntt, intt, polymul, pointwise_mul, add and sub on
      (lo, hi) pair I/O, inputs over [0, 4q) forward and [0, 2q) inverse;
      then the KAT vectors w45 and w62 at n = 1024 (four rows a CTA) on
      numpy uint64 I/O.  Each call's launches are asserted (a transform one
      launch through n = 65536, two at 2^17); every output equals the
      plain limb-pair version
      (``ops/wide.py``) run on the card word for word (the polymul's
      Montgomery product also alone), its first rows the golden model,
      and the KAT vectors their known answers;
   j. the tooling and entry points: every preset's ``Ring`` and
      ``RNSRing`` (``models/presets.py``) ntt, intt and polymul at B=64, the
      first rows of each channel against the golden model;
      ``utils/autotune.tune`` for ntt, intt and polymul at (4096, 8192),
      (16384, 2048), (32768, 1024) and (65536, 512) into a temporary cache
      (every candidate's time printed, none may fail), then
      ``Ring(n, method="auto")`` on that cache: the winner's route, its
      kernel by the counters (K1 or K7a) and its words equal to the
      default ring's (``Ring(4096).ntt`` at B=8192 by ``device_time``,
      ``device_time_profiled`` and ``cuda_time_ms`` is phase 4's, after its
      profiler checks: a short profile can record nothing once about a
      minute has passed since the process's first one); ``utils/report``'s
      rows at (8192, 4096) and (1024, 32768) with each launched kernel's
      ptxas lines and launch shape; and the ten examples
      (``agilex_ntt_tpu_torch/examples``) through their ``main`` on the
      card, each with its wall seconds;
   k. the sharded rings on a mesh of several processes
      (``utils/multihost_probe.py``): the kernels built, two spawned
      processes on ``cuda:0`` over gloo (NCCL refuses two processes on
      one card, so every transfer is staged through pinned host memory,
      and the phase says so), each calling ``init_distributed`` and
      ``pod_mesh``: ``ShardedRing(Ring(32768))`` over sp=2 at B=1024 with
      both ``sp_comm`` (ntt, intt, polymul), ``Ring(4096)`` over dp=2 at
      B=8191 (a remainder batch) and ``Ring(2^16)`` over sp=2 (four-step,
      B=512), each process's global result equal word for word to the
      unsharded ring on its card and, on the first rows, to the plain
      version, its K1, K2 and K11 launches a call asserted; in the same
      world ``ShardedRNSRing`` over dp=2 and sp=2 (``MP.RNS_ONE_CARD``):
      ``RNSRing(4096, 3)``'s ntt, intt, polymul, polydot (k=2), add,
      base_convert, rescale and mod_down at 2048 rows a dp block, the
      n16384 key switch (keyswitch, hoisted_keyswitch; L=4, dnum=4, K=5,
      B=64) and CKKS multiply + rescale and rotate 1, BGV multiply and BFV
      multiply with ``mesh=pod_mesh(...)`` on the n16384 chain (B=64,
      t=65537), each process's words equal to the unsharded ring's or
      context's on its card, every multi-prime kernel (K4a, K4b, K5, K6b)
      launched at dp=2 and K1, K2 and K11 at sp=2, no allocation on
      another card; a second gloo world of two processes, each owning
      ``["cuda:0", "cuda:0"]``: ``pod_mesh(dp=2, sp=2)`` (each sp line
      inside a process; ``ShardedRing(Ring(32768))`` at B=1024 with both
      ``sp_comm``, the RNS plan as above) and ``make_mesh(ch=2, dp=2)``
      (the n16384 chain's ring ops and key switch on ``ShardedRNSRing``
      with a ch axis, K4a, K4b, K5 and K6b launched); on a machine with
      four cards or more the same on NCCL, one process a card (sp=4 at
      B=1024 and 8192, dp=4, dp=2 x sp=2, four-step sp=4; the RNS plan at
      dp=4 and dp=2 x sp=2; ``make_mesh(ch=4)`` and ``make_mesh(ch=2,
      dp=2)`` on the n16384 chain, ntt, intt, polymul, polydot (k=2),
      base_convert, rescale, mod_down, keyswitch and hoisted_keyswitch at
      B=64, K4a, K4b, K5 and K6b launched on each process's channel
      block; ``make_mesh(ch=2, sp=2)`` on ``RNSRing(2^16, 4)``'s four-step
      transforms, K4a and K4b on ``chsp``), and two processes of two
      cards each, ``pod_mesh(dp=2, sp=2)`` with each sp line inside a
      process (one K11 launch a card a cross stage, reading the partner
      on the process's other card; the RNS plan);
   l. the matrix-product four-step transform (``ops/mxu_ntt.py``, M1 on
      the int8 tensor cores): ``fwd_ntt_fourstep_mxu``,
      ``fwd_col_pass_mxu`` and the row pass alone at the shapes of the
      JAX package's TPU A/B (2^16 at B=512, 2^18 at 128, 2^20 at 32) and
      at n = 4096, 2^21 (n1 = 2048, the partials' bound), on
      ``CyclicRing(2^16)``'s plan and at a ragged batch (2^16, B=7), every
      input over the lazy [0, 4q) with its edge words; four M1 launches a
      shape asserted; each pass against its plain version and each
      transform against ``Ring.ntt`` (the four-step route), word for word.
4. Timing: each kernel and its plain version (CUDA events) at its main
   path's shape, beside the least time the card could take
   (``bound_ms``), K4a and K4b also at the key switch's shapes (n =
   16384, K = 5 primes), K3 and K6a also at n = 32768, 32 and 16384 and
   with k = 8; the cluster and slab kernels' launch shapes (CTAs a
   cluster or slab width, shared memory, CTAs an SM,
   ``cudaOccupancyMaxActiveClusters``, registers and spills; K3's, K4a's,
   K4b's, K5's, K6a's and K6b's cluster or polynomials a CTA, K4a's and
   K4b's clusters a channel, K1's and K2's at their callers' shapes), the
   row pass alone at 2^20 and 2^21, and
   the kernels ``torch.profiler`` sees run at 2^16 and 2^18 and for K1,
   K2 (also on the row pass), K3, K4a, K4b, K5, K6a and K6b, with no
   host-to-device copy in a ``Ring.intt(scale=...)`` call after the first
   with that scale (nor in ``Ring(2^21)``'s transforms); the fused
   four-step kernels beside the two-kernel transforms and the composed
   polymul at 2^16 to 2^20 (128 MiB an operand), with the crossovers that
   set ``ops/fourstep.py``'s caps, and ``Ring.ntt``/``intt`` there through
   the caps; K11 by its device time (``torch.profiler``) at one shard's
   half and at one cross stage of a group of 4 shards in one launch as
   each ``sp_comm`` takes it on one card (two butterfly pairs, or four
   halves from copies); K12's launch shape; the DIT inverse beside K2 and
   its bit-reversals, the sharded calls beside the unsharded ones with
   K11's share of their device time, the public calls' throughput, the
   key switch and the CKKS ops end to end (NTT-kernel launches a call,
   device busy and idle share by ``torch.profiler``, which must see K4a,
   K4b and the polydot kernel in them), and the BGV and BFV ops alike, BFV's
   multiply also stage by stage (lift, tensor, scale and return,
   relinearization); phase 3h's calls beside the unsharded ones (CUDA
   events, median of 3, launches by the counters), and the mesh
   multiplies' device busy and idle share (``torch.profiler``); the wide
   kernels at (8192, 4096) with their ptxas lines, and phase 3i's
   ``WideRing`` calls end to end with their launches; M1's launch shapes
   and ptxas lines, its column pass in the kernels line (``library_ms``:
   its 16 digit products by ``torch._int_mm``), and the A/B of
   ``utils/mxu_probe.py`` at 2^16, 2^18 and 2^20: the transform beside
   ``Ring.ntt`` in turns, each pass beside its bound and its
   ``torch._int_mm`` products, the column pass beside K9a.  One card
   measures the sharded path's
   correctness and its cost on one card; the sharded ring across cards is
   timed by ``utils/xchg_probe.py --cards 4`` (one process) and
   ``utils/multihost_probe.py --procs 4`` (one process a card; also the
   ch layouts) and ``--procs 2 --cards-per-proc 2`` (two cards a
   process).

Output: the card's name and power limit as ``nvidia-smi`` prints them, a
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
# the profiler helpers and the bound model (PERF.md section 2)
from agilex_ntt_tpu_torch.utils.profiling import (  # noqa: E402
    XCHG_KERNEL, device_breakdown, kernel_share, kernels_seen,
)
from agilex_ntt_tpu_torch.utils.report import (  # noqa: E402
    HBM_BYTES_PER_S, OPS_SCALE_REDUCE, OPS_SHOUP, OPS_WIDE_MONT,
    OPS_XCHG_FWD, OPS_XCHG_INV, bound, butterflies, dot_ops, fwd4_ops,
    fwd_ops, inv4_ops, inv_ops, mxu_pass_cost, ops_sum, polymul4_ops,
    ptxas_lines, scaled, wide_fwd_ops, wide_inv_ops,
)

MAIN_N, MAIN_BATCH, MAIN_K, MAIN_DOT_BATCH = 4096, 8192, 3, 2048
# (n, batch, polydot k, polydot batch)
CHECK_SHAPES = (
    (MAIN_N, MAIN_BATCH, MAIN_K, MAIN_DOT_BATCH),
    (32768, 1024, MAIN_K, 1024),
    (32, 65536, MAIN_K, 65536),
    (16384, 256, MAIN_K, 256),  # K3/K6a on clusters of 4 CTAs
    (256, 1001, 2, 333),  # several polynomials a block, a ragged last block
)
# K3 and K6a beyond CHECK_SHAPES: (n, batch, k, cyclic): CyclicRing's
# rows of 2 and 4 words and its tables on clusters of 8 CTAs, and k = 8
# terms through the polydot's cp.async pipeline
FUSED_MORE_SHAPES = ((2, 65536, 1, True), (4, 65536, 1, True),
                     (32768, 1024, 1, True), (MAIN_N, 512, 8, False))
# K3 and K6a timed beyond the main shapes: (n, batch, k)
FUSED_TIMED_SHAPES = ((32768, 1024, 1), (32, 65536, 1), (16384, 256, MAIN_K),
                      (MAIN_N, 512, 8))
# K1 and K2 on their other callers' tables beyond CHECK_SHAPES: (what, n,
# batch); "cyclic": CyclicRing's rows of 2 and 4 words (2048 and 1024
# polynomials a CTA) and a cluster of 8; "shard": the stage-shard tables of
# the sharded ring's shards (Ring(SHARD_N) over SHARD_SP, every d); "row":
# the four-step row pass's cyclic tables of Ring(n) at (B n1, n2); "col":
# the sharded four-step's column tables of Ring(n) at its (B n2 / sp, n1);
# "plain": the BGV and BFV plaintext ring Ring(n, q=PLAIN_T[n]) at (B, n)
TRANSFORM_MORE = (("cyclic", 2, 1 << 21), ("cyclic", 4, 1 << 20),
                  ("cyclic", 32768, 256), ("shard", 32768, 512),
                  ("row", 1 << 20, 32), ("row", 1 << 21, 16),
                  ("col", 1 << 16, 512), ("plain", 16384, 64),
                  ("plain", 4096, 64))
GOLDEN_ROWS = 8
DEVICE = "cuda"

# (n, L, batch, polydot k, polydot batch) of the multi-prime checks
RNS_N, RNS_L, RNS_BATCH, RNS_K = 4096, 3, 2048, 3
KS_N, KS_L, KS_BATCH = 16384, 4, 64  # the key switch: dnum = L, K = L + 1
KS_STEPS = (5, 25, 2 * KS_N - 1)  # rotations by 1 and 2 slots, conjugation
RNS_CHECK_SHAPES = (
    (RNS_N, RNS_L, RNS_BATCH, 4, 256),  # the "n4096" chain, 96 MiB an operand
    (KS_N, KS_L + 1, KS_BATCH, KS_L, KS_BATCH),  # the key-switch dot, 80 MiB
    (8192, 3, 512, 2, 256),  # K5/K6b on clusters of 2 CTAs
    (32768, 4, 64, 2, 64),  # clusters of 8 CTAs
    (32, 3, 4096, 3, 4096),  # 32 polynomials a block
    (256, 3, 1001, 2, 333),  # a ragged last block
)

# the four-step checks: (n, batch); the split is fourstep_split(n)
FS_CHECK_SHAPES = (
    (1 << 16, 512), (1 << 18, 128), (1 << 20, 32), (1 << 21, 16),
    (1 << 17, 64),  # 512 x 256
    (1 << 19, 64),  # K7a/K7b on clusters of 16 CTAs, K8 walking
    (1 << 16, 7),  # a ragged batch
)
FS_GOLDEN_ROWS = 2
# K9a and K9b at n1 = 2^11 .. 2^15 with n2 = 64, 32 MiB an operand
COL_LOGN1, COL_N2, COL_WORDS = range(11, 16), 64, 1 << 23
# the four-step main path: (n, batch)
FS_PATH = ((1 << 16, 512), (1 << 18, 128), (1 << 20, 32), (1 << 21, 16))
# the fused kernels beside the routes the caps choose between: (n, batch),
# 128 MiB an operand
FS_ROUTE_SHAPES = ((1 << 16, 512), (1 << 17, 256), (1 << 18, 128),
                   (1 << 19, 64), (1 << 20, 32))
# where torch.profiler must see the cluster and slab kernels
FS_PROFILE_NS = (1 << 16, 1 << 18)
FS_DOT_BATCH, FS_DOT_K = 128, 3
FS_RNS_L, FS_SMALL_BATCH = 3, 64
FS_CROSS_N, FS_CROSS_BATCH = 32768, 1024

# the DIT inverse (K12): (n, batch) of the checks; the main shape first,
# then 128 polynomials a CTA, clusters of 8 and a ragged last CTA
DIT_CHECK_SHAPES = ((MAIN_N, MAIN_BATCH), (32, 65536), (32768, 1024),
                    (256, 1001))
# the cross-device stage (K11): one shard (B_loc, S) of the sharded path
XCHG_ROWS, XCHG_WIDTH = 512, 8192
# K11's group launches checked: entries a table, and what entry d writes
# (XCHG_HALVES[d % 3]: both halves of its pair, the u-half, the v-half)
XCHG_GROUPS = (2, 4, 8)
XCHG_HALVES = ("uv", "u", "v")
# the sharded path on one card: Ring(32768) over dp=2 x sp=4 (a shard is
# (512, 8192)), Ring(65536) over sp=4 (four-step), the dp-only polydot
SHARD_N, SHARD_BATCH, SHARD_DP, SHARD_SP = 32768, 1024, 2, 4
SHARD_FS_N, SHARD_FS_BATCH = 1 << 16, 512
SHARD_DOT_DP = 8

KERNEL_SOURCE = "agilex_ntt_tpu_torch/csrc/ntt_kernels.cu"
# rows whose kernel body lives in a header beside it
BODY_SOURCE = {
    **{key: "agilex_ntt_tpu_torch/csrc/ntt_rns_transform.cuh"
       for key in ("fwd", "inv", "fwd_rns", "inv_rns", "dit_inv")},
    **{key: "agilex_ntt_tpu_torch/csrc/ntt_xchg.cuh"
       for key in ("xchg_fwd", "xchg_inv")},
    **{key: "agilex_ntt_tpu_torch/csrc/ntt_polydot_cluster.cuh"
       for key in ("polymul", "polydot", "polymul_rns", "polydot_rns")},
    **{key: "agilex_ntt_tpu_torch/csrc/ntt_fourstep_cluster.cuh"
       for key in ("fwd4", "inv4", "polymul4", "col_fwd", "col_inv",
                   "flat_fwd", "flat_inv", "flat_polymul")},
    **{key: "agilex_ntt_tpu_torch/csrc/ntt_wide.cuh"
       for key in ("wide_fwd", "wide_inv", "wide_pointwise")},
    "mxu": "agilex_ntt_tpu_torch/csrc/ntt_mxu.cuh",
}
KERNELS = {  # row -> (name, TPU kernel replaced)
    "fwd": ("fwd_ntt", "agilex_ntt_tpu/ops/ntt_kernel.py:97"),
    "inv": ("inv_ntt", "agilex_ntt_tpu/ops/ntt_kernel.py:110"),
    "polymul": ("polymul_fused", "agilex_ntt_tpu/ops/ntt_kernel.py:241"),
    "polydot": ("polydot_fused", "agilex_ntt_tpu/ops/ntt_kernel.py:760"),
    "fwd_rns": ("fwd_ntt_rns", "agilex_ntt_tpu/ops/ntt_kernel.py:340"),
    "inv_rns": ("inv_ntt_rns", "agilex_ntt_tpu/ops/ntt_kernel.py:350"),
    "polymul_rns": ("polymul_rns_fused", "agilex_ntt_tpu/ops/ntt_kernel.py:360"),
    "polydot_rns": ("polydot_rns_fused", "agilex_ntt_tpu/ops/ntt_kernel.py:646"),
    "fwd4": ("fwd_ntt_fourstep", "agilex_ntt_tpu/ops/fourstep.py:345"),
    "inv4": ("inv_ntt_fourstep", "agilex_ntt_tpu/ops/fourstep.py:362"),
    "polymul4": ("polymul_fourstep_fused", "agilex_ntt_tpu/ops/fourstep.py:449"),
    "col_fwd": ("fwd_col_fourstep", "agilex_ntt_tpu/ops/fourstep.py:194"),
    "col_inv": ("inv_col_fourstep", "agilex_ntt_tpu/ops/fourstep.py:208"),
    # the flat layout: the same bytes, the same kernels (wrapper counters
    # fwd4, inv4, polymul4 of the flat path)
    "flat_fwd": ("fwd_ntt_fourstep (flat)", "agilex_ntt_tpu/ops/flat_fuse.py:196"),
    "flat_inv": ("inv_ntt_fourstep (flat)", "agilex_ntt_tpu/ops/flat_fuse.py:209"),
    "flat_polymul": ("polymul_fourstep_fused (flat)",
                     "agilex_ntt_tpu/ops/flat_fuse.py:326"),
    "dit_inv": ("dit_inv_core", "agilex_ntt_tpu/ops/dit_inv.py:121"),
    "xchg_fwd": ("xchg_group (fwd)", "agilex_ntt_tpu/parallel/overlap.py:89"),
    "xchg_inv": ("xchg_group (inv)", "agilex_ntt_tpu/parallel/overlap.py:89"),
    # the wide ring: no Pallas kernel, the JAX package's plain jnp stages
    # and WideRing's elementwise bodies
    "wide_fwd": ("wide_fwd", "agilex_ntt_tpu/ops/wide.py:203"),
    "wide_inv": ("wide_inv", "agilex_ntt_tpu/ops/wide.py:240"),
    "wide_pointwise": ("wide_pointwise", "agilex_ntt_tpu/api.py:2024"),
    # the matrix-product four-step pass (M1): no Pallas kernel, the JAX
    # package's jnp dot_general digit products
    "mxu": ("mxu_pass", "agilex_ntt_tpu/ops/mxu_ntt.py:149"),
}
# the CKKS phase (3f): the "n16384" chain (KS_N, KS_L, one special prime) at
# CKKS_BATCH ciphertexts, rotations by CKKS_ROT, a linear transform of the
# steps CKKS_LIN; the matvec on the "n4096" chain (L = 3) with its full
# 2048 x 2048 slot matrix and the default BSGS split
CKKS_BATCH, CKKS_SEED = 64, 20261019
CKKS_ROT = (1, -3)
CKKS_LIN = (0, 1, -3, 2)
CKKS_STEPS = (1, -3, 2)
MV_N, MV_L = RNS_N, RNS_L
CKKS_TOL = 1e-3  # tests/test_ckks.py
CKKS_POLY_TOL = {"power": 2e-2, "chebyshev": 5e-2}  # tests/test_polyeval.py
# rotate, conjugate and apply_linear's rotated terms carry a key switch's
# noise that no rescale divides (apply_linear's rescale takes back only its
# weights' scale).  TOL was set at n = 256, where a switch adds about 1e-5
# to a slot; at n = 16384 it adds 3e-3 to 1.1e-2 (the CPU plain versions,
# whose words the card's equal), so these are held to the JAX tests'
# largest atol
CKKS_KS_TOL = 5e-2
CKKS_DECODED = 2  # ciphertexts of each output decoded (host CRT)
# the BGV and BFV phase (3g): the "n16384" chain at t = 65537 (t_bits=17:
# no prime ≡ 1 mod 2^15 lies below 2^16, so the default t_bits=16 raises),
# INT_BATCH ciphertexts, the row rotations by 1 and -1 and the row swap, a
# linear transform of the steps INT_LIN; the BGV matvec on the "n4096"
# chain (L = 3) at its default t = 40961 with its full 2048 x 2048 row
# matrix and the default BSGS split
INT_T, INT_BATCH, INT_SEED = 65537, 64, 20261020
INT_STEPS = (1, -1, 2)
INT_LIN = (0, 1, -1, 2)
INT_DECODED = 2  # ciphertexts of each output decoded (host CRT)
MV_T = 40961
# the plaintext rings Ring(n, q=t) whose tables K1 and K2 take in phase 3g
PLAIN_T = {KS_N: INT_T, MV_N: MV_T}
# phase 3h: ShardedRNSRing on one card (mesh devices ["cuda:0"] * k), each
# layout at a real size, nothing cut: (name, n, L, mesh axes,
# ShardedRNSRing arguments, batch); the dp ring also takes the remainder
# batch SHARD_RNS_REMAINDER; every polydot k = SHARD_RNS_K
SHARD_RNS = (
    ("n4096 dp=4", RNS_N, RNS_L, dict(dp=4), {}, RNS_BATCH),
    ("n16384 ch=2 x dp=4", KS_N, KS_L, dict(ch=2, dp=4), dict(ch_axis="ch"),
     KS_BATCH),
    ("2^16 ch=2 x sp=2 x dp=2", 1 << 16, 4, dict(ch=2, sp=2, dp=2),
     dict(sp_axis="sp", ch_axis="ch"), 64),
    ("32768 dp=2 x sp=4 ppermute", 32768, 3, dict(dp=2, sp=4),
     dict(sp_axis="sp"), 256),
    ("32768 dp=2 x sp=4 overlap", 32768, 3, dict(dp=2, sp=4),
     dict(sp_axis="sp", sp_comm="overlap"), 256),
)
SHARD_RNS_REMAINDER, SHARD_RNS_K = RNS_BATCH - 1, 2
# the key switch and the schemes on a dp mesh of one card
SHARD_KS_DP = 4
# the wide ring (phase 3i): WideRing(n, q) as (n, bits of q, batch): the
# default 62-bit prime and a 45-bit one at the main path's shape (a row a
# CTA), n = 32768 and 65536 (one cluster launch of 8 and 16 CTAs) and 2^17,
# the first n past the largest cluster (a pass in device memory, then the
# cluster body); then the known-answer vectors w45 and w62 at n = 1024
WIDE_RINGS = ((MAIN_N, 62, MAIN_BATCH), (MAIN_N, 45, MAIN_BATCH),
              (32768, 62, 256), (1 << 16, 62, 64), (1 << 17, 62, 32))
WIDE_KAT = Path(__file__).resolve().parent / "tests" / "vectors" / "ntt_kat.npz"
WIDE_GOLDEN_ROWS = 4
WIDE_OPS = ("ntt", "intt", "polymul", "pointwise_mul", "add", "sub")
# phase 3l: the matrix-product four-step transform (M1) as (plan, n, batch):
# the main path at the TPU A/B's shapes (tools/ab_mxu.py), then the checks
MXU_PATH = (("negacyclic", 1 << 16, 512), ("negacyclic", 1 << 18, 128),
            ("negacyclic", 1 << 20, 32))
MXU_CHECKS = (("negacyclic", MAIN_N, 64), ("negacyclic", 1 << 21, 4),
              ("cyclic", 1 << 16, 16), ("negacyclic", 1 << 16, 7))
MXU_KERNELS = ("mxu_col_kernel", "mxu_row_kernel")
# phase 3j: the presets' batch, the autotuner's (n, batch), the report's
TUNE_SHAPES = ((4096, 8192), (16384, 2048), (32768, 1024), (65536, 512))
PRESET_BATCH = 64
REPORT_SHAPES = ((MAIN_N, MAIN_BATCH), (32768, 1024))
SINGLE = ("fwd", "inv", "polymul", "polydot")
MULTI = ("fwd_rns", "inv_rns", "polymul_rns", "polydot_rns")
FOURSTEP = ("fwd4", "inv4", "polymul4", "col_fwd", "col_inv")
FLAT = {"flat_fwd": "fwd4", "flat_inv": "inv4", "flat_polymul": "polymul4"}
SLICE = ("dit_inv", "xchg_fwd", "xchg_inv")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    if len(out) < 1:
        raise RuntimeError("nvidia-smi listed no card")
    return out[0]


# wrapper counter -> (TPU kernel, its cluster or slab kernel)
CLUSTER_KERNELS = {"fwd4": ("K7a", "fwd4_cluster_kernel"),
                   "inv4": ("K7b", "inv4_cluster_kernel"),
                   "polymul4": ("K8", "polymul4_cluster_kernel"),
                   "col_fwd": ("K9a", "col_fwd4_slab_kernel"),
                   "col_inv": ("K9b", "col_inv4_slab_kernel")}
# K5 and K6b, and K3 and K6a (the same kernel launched at one channel)
DOT_KERNEL = "polydot_rns_cluster_kernel"
# K4a and K4b, and K1 and K2 (the same kernels launched at one channel)
RNS_KERNELS = {"fwd_rns": ("K4a", "fwd_rns_cluster_kernel"),
               "inv_rns": ("K4b", "inv_rns_cluster_kernel")}
ONE_KERNELS = {"fwd": ("K1", "fwd_rns_cluster_kernel"),
               "inv": ("K2", "inv_rns_cluster_kernel")}
DIT_KERNEL = "dit_inv_cluster_kernel"
WIDE_KERNELS = ("wide_fwd_cluster_kernel", "wide_fwd_pass_kernel",
                "wide_inv_cluster_kernel", "wide_inv_pass_kernel",
                "wide_pointwise_kernel")


def ckks_path(np, CKKSContext, device, rows=None) -> dict:
    """The CKKS main path (phase 3f) on ``device`` through the public calls:
    keygen, encode, encrypt of CKKS_BATCH ciphertexts, then multiply,
    rescale, rotations, conjugate, a four-term linear transform, poly_eval
    in both bases at the highest degree the chain reaches, and the full
    matvec of the "n4096" chain.  ``rows`` keeps the first ``rows``
    ciphertexts for the ops after encryption (the CPU twin's B = 1).
    Returns the contexts, keys, inputs, outputs, the expected slots and the
    calls (for timing)."""
    from fractions import Fraction

    from agilex_ntt_tpu_torch.schemes.ckks import Ciphertext

    def first(ct):
        if rows is None:
            return ct
        return Ciphertext(ct.c0[:, :rows], ct.c1[:, :rows], ct.level, ct.scale)

    data = np.random.default_rng(CKKS_SEED + 1)  # slots and weights

    def slots(n_slots, lo, hi, cplx=True):
        z = data.uniform(lo, hi, (CKKS_BATCH, n_slots))
        return z + 1j * data.uniform(lo, hi, (CKKS_BATCH, n_slots)) if cplx else z + 0j

    S = KS_N // 2
    ctx = CKKSContext(KS_N, num_primes=KS_L,
                      rng=np.random.default_rng(CKKS_SEED), device=device)
    keys = ctx.keygen(galois_steps=CKKS_STEPS)
    z1, z2 = slots(S, -0.8, 0.8), slots(S, -0.8, 0.8)
    z3 = slots(S, -0.95, 0.95, cplx=False)  # the Chebyshev domain
    ws = [data.uniform(-1, 1, S) + 1j * data.uniform(-1, 1, S) for _ in CKKS_LIN]
    degree = {}
    for basis in ("power", "chebyshev"):
        d = 0
        while True:  # the highest dense degree the plan lets the chain reach
            try:
                ctx.poly_eval_plan(KS_L, [0.5] * (d + 2), basis=basis)
            except ValueError:
                break
            d += 1
        degree[basis] = d
    pcoef = list(data.uniform(-0.4, 0.4, degree["power"] + 1))
    ccoef = list(data.uniform(-0.4, 0.4, degree["chebyshev"] + 1))
    pt1 = ctx.encode(z1)
    c1, c2, c3 = (ctx.encrypt(pt, keys) for pt in (pt1, ctx.encode(z2),
                                                   ctx.encode(z3)))
    e1, e2, e3 = first(c1), first(c2), first(c3)
    lin = ctx.make_linear_op(list(zip(CKKS_LIN, ws)), keys, KS_L)
    calls = {
        "multiply": lambda: ctx.multiply(e1, e2, keys),
        "rotate 1": lambda: ctx.rotate(e1, 1, keys),
        "rotate -3": lambda: ctx.rotate(e1, -3, keys),
        "conjugate": lambda: ctx.conjugate(e1, keys),
        "apply_linear": lambda: ctx.apply_linear(e1, lin),
        "poly_eval power": lambda: ctx.poly_eval(e1, pcoef, keys),
        "poly_eval chebyshev": lambda: ctx.poly_eval(e3, ccoef, keys,
                                                     basis="chebyshev"),
    }
    outs = {name: call() for name, call in calls.items()}
    prod = outs["multiply"]
    calls["rescale"] = lambda: ctx.rescale(prod)
    outs["rescale"] = calls["rescale"]()
    # added after the outputs: a call draws from the context's generator
    calls["encrypt"] = lambda: ctx.encrypt(pt1, keys)
    # the matvec: the "n4096" chain, its full slot matrix, the default split
    MS = MV_N // 2
    mctx = CKKSContext(MV_N, num_primes=MV_L,
                       rng=np.random.default_rng(CKKS_SEED + 2), device=device)
    mkeys = mctx.keygen(galois_steps=mctx.bsgs_steps())
    zm = slots(MS, -1, 1)
    M = (data.uniform(-1, 1, (MS, MS)) + 1j * data.uniform(-1, 1, (MS, MS))) / MS
    mv = mctx.make_matvec(M, mkeys, MV_L)
    cm = mctx.encrypt(mctx.encode(zm), mkeys)
    em = first(cm)
    calls["apply_matvec"] = lambda: mctx.apply_matvec(em, mv)
    outs["apply_matvec"] = calls["apply_matvec"]()
    outs.update(enc1=c1, enc2=c2, enc3=c3, encm=cm)
    delta = Fraction(ctx.delta)

    def ref_poly(cs, z):
        acc = np.zeros_like(z)
        for c in reversed(cs):
            acc = acc * z + c
        return acc

    # (output, context, keys, rescaled first?, expected slots, atol): the
    # tolerances of tests/test_ckks.py (TOL, 5 TOL for the matvec) and
    # tests/test_polyeval.py (degree 4: 2e-2; Chebyshev: 5e-2); the
    # rotations and the linear transform CKKS_KS_TOL
    expect = {
        "enc1": (ctx, keys, False, z1, CKKS_TOL),
        "rescale": (ctx, keys, False, z1 * z2, CKKS_TOL),
        "rotate 1": (ctx, keys, False, np.roll(z1, -1, axis=-1), CKKS_KS_TOL),
        "rotate -3": (ctx, keys, False, np.roll(z1, 3, axis=-1), CKKS_KS_TOL),
        "conjugate": (ctx, keys, False, np.conj(z1), CKKS_KS_TOL),
        "apply_linear": (ctx, keys, True, sum(
            w * np.roll(z1, -t, axis=-1) for t, w in zip(CKKS_LIN, ws)),
            CKKS_KS_TOL),
        "poly_eval power": (ctx, keys, False, ref_poly(pcoef, z1),
                            CKKS_POLY_TOL["power"]),
        "poly_eval chebyshev": (ctx, keys, False,
                                np.polynomial.chebyshev.chebval(z3, ccoef),
                                CKKS_POLY_TOL["chebyshev"]),
        "apply_matvec": (mctx, mkeys, True, zm @ M.T, 5 * CKKS_TOL),
    }
    scales = {"poly_eval power": delta ** 2, "poly_eval chebyshev": delta ** 2}
    return {"ctx": ctx, "keys": keys, "mctx": mctx, "mkeys": mkeys,
            "outs": outs, "calls": calls, "expect": expect, "scales": scales,
            "degree": degree, "mv": mv, "lin_terms": list(zip(CKKS_LIN, ws))}


def key_words(tagged) -> dict:
    """Every key tensor of the key sets ``tagged``, (tag, KeySet) pairs, by
    name."""
    out = {}
    for tag, keys in tagged:
        out[tag + "sk_rns"] = keys.sk_rns
        for name, pair in (("pk", keys.pk), ("rlk", keys.rlk),
                           ("rlk_coeff", keys.rlk_coeff)):
            out[f"{tag}{name} b"], out[f"{tag}{name} a"] = pair
        for table in ("gk", "gk_coeff"):
            for g, pair in getattr(keys, table).items():
                out[f"{tag}{table}[{g}] b"], out[f"{tag}{table}[{g}] a"] = pair
    return out


def ckks_decoded(np, torch, ck) -> None:
    """Raise unless every output of ``ckks_path`` has its shape and its
    first CKKS_DECODED ciphertexts decode within their tolerance of numpy,
    and poly_eval's results sit at Delta^2."""
    for name, (ctx, keys, rescale, want, atol) in ck["expect"].items():
        ct = ck["outs"][name]
        if rescale:
            ct = ctx.rescale(ct)
        if ct.c0.dtype != torch.uint32 or tuple(ct.c0.shape) != (
                ct.level, CKKS_BATCH, ctx.n):
            raise AssertionError(f"CKKS {name}: {ct.c0.dtype} "
                                 f"{tuple(ct.c0.shape)} at level {ct.level}")
        head = type(ct)(ct.c0[:, :CKKS_DECODED], ct.c1[:, :CKKS_DECODED],
                        ct.level, ct.scale)
        got = ctx.decode(ctx.decrypt(head, keys))
        err = float(np.abs(got - want[:CKKS_DECODED]).max())
        log(f"  CKKS {name:20s} level {ct.level}, decoded max error {err:.3e} "
            f"(atol {atol:g}, {CKKS_DECODED} of {CKKS_BATCH} ciphertexts)")
        if not np.isfinite(err) or err > atol:
            raise AssertionError(f"CKKS {name} decodes {err:.3e} from numpy "
                                 f"(atol {atol:g})")
    for name, scale in ck["scales"].items():
        if ck["outs"][name].scale != scale:
            raise AssertionError(f"CKKS {name} at scale {ck['outs'][name].scale}")


def ckks_same_words(torch, ck, twin) -> int:
    """Raise unless the card's keys and encryptions equal the CPU twin's, and
    every op's first ciphertext the twin's op; return the key tensors
    compared."""
    card_keys, cpu_keys = (key_words((("", c["keys"]), ("mv ", c["mkeys"])))
                           for c in (ck, twin))
    if sorted(card_keys) != sorted(cpu_keys):
        raise AssertionError("the CPU twin holds other keys")
    for name, words in card_keys.items():
        if not torch.equal(words.cpu(), cpu_keys[name]):
            raise AssertionError(f"CKKS key {name}: the card's words differ "
                                 "from the CPU plain versions'")
    for name, ct in ck["outs"].items():
        want = twin["outs"][name]
        rows = slice(None) if name.startswith("enc") else slice(0, 1)
        for part in ("c0", "c1"):
            if not torch.equal(getattr(ct, part)[:, rows].cpu(),
                               getattr(want, part)):
                raise AssertionError(f"CKKS {name}.{part}: the card's words "
                                     "differ from the CPU plain versions'")
        if (ct.level, ct.scale) != (want.level, want.scale):
            raise AssertionError(f"CKKS {name}: level or scale differs on the "
                                 "CPU")
    return len(card_keys)


def int_path(np, BGVContext, BFVContext, device, rows=None) -> dict:
    """The BGV and BFV main path (phase 3g) on ``device`` through the public
    calls: for each scheme keygen, encode and encrypt of INT_BATCH
    ciphertexts, multiply, square, rescale, the row rotations, the row swap
    and a four-term linear transform; BGV's ``poly_eval`` in both bases at
    the highest degree whose result lands at level 2 or above (at level 1
    the noise of n = 16384 with 30-bit primes and t = 65537 leaves no
    headroom: measured on the CPU plain versions, degree 5 / Chebyshev 4
    there does not decode), BFV's ``mod_down_to``, and the BGV matvec on
    the "n4096" chain.  ``rows`` keeps the first ``rows`` ciphertexts for
    the ops after encryption (the CPU twin's B = 1); on the card the first
    INT_DECODED ciphertexts of each output are decrypted and decoded.
    Returns the contexts, keys, inputs, outputs, decodes, the expected slots
    and the calls (for timing)."""
    from agilex_ntt_tpu_torch.schemes.ckks import Ciphertext

    def first(ct):
        if rows is None:
            return ct
        return Ciphertext(ct.c0[:, :rows], ct.c1[:, :rows], ct.level, ct.scale)

    data = np.random.default_rng(INT_SEED + 1)  # slots and weights
    S = KS_N // 2
    t = INT_T
    out = {"outs": {}, "calls": {}, "expect": {}, "keys": {}, "ctx": {},
           "lin_terms": {}}
    for scheme, C in (("BGV", BGVContext), ("BFV", BFVContext)):
        ctx = C(KS_N, num_primes=KS_L, t=t, rng=np.random.default_rng(INT_SEED),
                device=device)
        keys = ctx.keygen(galois_steps=INT_STEPS)
        out["ctx"][scheme], out["keys"][scheme] = ctx, keys
        m1, m2 = (data.integers(0, t, (INT_BATCH, 2, S)) for _ in range(2))
        ws = [data.integers(0, t, (2, S)) for _ in INT_LIN]
        pt1 = ctx.encode(m1)
        c1, c2 = ctx.encrypt(pt1, keys), ctx.encrypt(ctx.encode(m2), keys)
        e1, e2 = first(c1), first(c2)
        out["lin_terms"][scheme] = list(zip(INT_LIN, ws))
        lin = ctx.make_linear_op(out["lin_terms"][scheme], keys, KS_L)
        calls = {
            "multiply": lambda c=ctx, k=keys, a=e1, b=e2: c.multiply(a, b, k),
            "square": lambda c=ctx, k=keys, a=e1: c.square(a, k),
            "rotate 1": lambda c=ctx, k=keys, a=e1: c.rotate(a, 1, k),
            "rotate -1": lambda c=ctx, k=keys, a=e1: c.rotate(a, -1, k),
            "row swap": lambda c=ctx, k=keys, a=e1: c.conjugate(a, k),
            "apply_linear": lambda c=ctx, a=e1, op=lin: c.apply_linear(a, op),
        }
        expect = {
            "enc1": m1, "multiply": m1 * m2, "square": m1 * m1,
            "rotate 1": np.roll(m1, -1, axis=-1),
            "rotate -1": np.roll(m1, 1, axis=-1), "row swap": m1[:, ::-1],
            "apply_linear": sum(w * np.roll(m1, -s_, axis=-1)
                                for s_, w in zip(INT_LIN, ws)),
            "rescale": m1 * m2,
        }
        if scheme == "BGV":
            degree, coeffs = {}, {}
            for basis in ("power", "chebyshev"):
                d = 1
                while True:  # the plan of degree d + 1, before any work
                    try:
                        if ctx.poly_eval_plan(KS_L, [1] * (d + 2),
                                              basis=basis)[3] < 2:
                            break
                    except ValueError:
                        break
                    d += 1
                degree[basis] = d
                coeffs[basis] = [int(v) for v in data.integers(0, t, d + 1)]
            out["degree"] = degree
            for basis, name in (("power", "poly_eval power"),
                                ("chebyshev", "poly_eval chebyshev")):
                cs = coeffs[basis]
                calls[name] = (lambda c=ctx, k=keys, a=e1, cs=cs, b=basis:
                               c.poly_eval(a, cs, k, basis=b))
                pw = [np.ones_like(m1), m1 % t]
                for _ in range(2, len(cs)):
                    pw.append((pw[-1] * m1 if basis == "power"
                               else 2 * m1 * pw[-1] - pw[-2]) % t)
                expect[name] = sum(cf * p_ for cf, p_ in zip(cs, pw))
        else:
            calls["mod_down_to 2"] = lambda c=ctx, a=e1: c.mod_down_to(a, 2)
            expect["mod_down_to 2"] = m1
        outs = {name: call() for name, call in calls.items()}
        prod = outs["multiply"]
        calls["rescale"] = lambda c=ctx, p_=prod: c.rescale(p_)
        outs["rescale"] = calls["rescale"]()
        # added after the outputs: a call draws from the context's generator
        calls["encrypt"] = lambda c=ctx, k=keys, p_=pt1: c.encrypt(p_, k)
        outs.update(enc1=c1, enc2=c2)
        if scheme == "BFV":
            out["bfv_operands"] = (ctx, keys, e1, e2)
        for name, call in calls.items():
            out["calls"][f"{scheme} {name}"] = call
        for name, ct in outs.items():
            out["outs"][f"{scheme} {name}"] = ct
        for name, want in expect.items():
            out["expect"][f"{scheme} {name}"] = (scheme, want % t)
    # the matvec: the "n4096" chain at its default t, its full row matrix
    MS = MV_N // 2
    mctx = BGVContext(MV_N, num_primes=MV_L,
                      rng=np.random.default_rng(INT_SEED + 2), device=device)
    mkeys = mctx.keygen(galois_steps=mctx.bsgs_steps())
    zm = data.integers(0, mctx.t, (INT_BATCH, 2, MS))
    M = data.integers(0, mctx.t, (MS, MS))
    mv = mctx.make_matvec(M, mkeys, MV_L)
    cm = mctx.encrypt(mctx.encode(zm), mkeys)
    em = first(cm)
    out["calls"]["BGV apply_matvec"] = lambda: mctx.apply_matvec(em, mv)
    out["outs"]["BGV apply_matvec"] = out["calls"]["BGV apply_matvec"]()
    out["outs"]["BGV encm"] = cm
    out["expect"]["BGV apply_matvec"] = ("matvec", (zm @ M.T) % mctx.t)
    out["ctx"]["matvec"], out["keys"]["matvec"] = mctx, mkeys
    out.update(mctx=mctx, mv=mv)
    if rows is None:
        out["decoded"] = {}
        for name, (which, _) in out["expect"].items():
            ct = out["outs"][name]
            ctx, keys = out["ctx"][which], out["keys"][which]
            head = Ciphertext(ct.c0[:, :INT_DECODED], ct.c1[:, :INT_DECODED],
                              ct.level, ct.scale)
            out["decoded"][name] = ctx.decode(ctx.decrypt(head, keys))
    return out


def bfv_stage_calls(ik) -> dict:
    """BFV's multiply in ``int_path`` stage by stage, as calls to time: the
    lift of the four parts, the union basis's tensor, the scale and return
    of the three products, the relinearization and its two adds."""
    ctx, keys, a, b = ik["bfv_operands"]
    _, rbig = ctx._aux(KS_L)
    lifted = [ctx._lift(c, KS_L) for c in (a.c0, a.c1, b.c0, b.c1)]
    parts = rbig.tensor(*lifted)
    downs = [ctx._scale_down(d, KS_L) for d in parts]
    r = ctx.ring(KS_L)

    def relinearize():
        hs = ctx._keyswitch_pair(downs[2], ctx._key_pair(keys), KS_L, 1)
        return r.add(downs[0], hs[0]), r.add(downs[1], hs[1])

    return {
        "BFV multiply: lift": lambda: [ctx._lift(c, KS_L)
                                       for c in (a.c0, a.c1, b.c0, b.c1)],
        "BFV multiply: tensor": lambda: rbig.tensor(*lifted),
        "BFV multiply: scale and return": lambda: [ctx._scale_down(d, KS_L)
                                                   for d in parts],
        "BFV multiply: relinearize": relinearize,
    }


def int_decoded(np, torch, ik) -> None:
    """Raise unless every output of ``int_path`` has its shape and its first
    INT_DECODED ciphertexts decode exactly to numpy's slotwise result."""
    for name, (which, want) in ik["expect"].items():
        ct, ctx = ik["outs"][name], ik["ctx"][which]
        if ct.c0.dtype != torch.uint32 or tuple(ct.c0.shape) != (
                ct.level, INT_BATCH, ctx.n):
            raise AssertionError(f"{name}: {ct.c0.dtype} {tuple(ct.c0.shape)} "
                                 f"at level {ct.level}")
        got = ik["decoded"][name]
        bad = int((got != want[:INT_DECODED]).sum())
        log(f"  {name:24s} level {ct.level}, scale {ct.scale}: {bad} of "
            f"{got.size} slots differ from numpy ({INT_DECODED} of "
            f"{INT_BATCH} ciphertexts decoded)")
        if bad:
            raise AssertionError(f"{name} does not decode to numpy's slots")


def int_same_words(torch, ik, twin) -> int:
    """Raise unless the card's keys and encryptions equal the CPU twin's, and
    every op's first ciphertext the twin's op; return the key tensors
    compared."""
    card_keys, cpu_keys = (key_words((f"{which} ", keys)
                                     for which, keys in c["keys"].items())
                           for c in (ik, twin))
    if sorted(card_keys) != sorted(cpu_keys):
        raise AssertionError("the BGV/BFV CPU twin holds other keys")
    for name, words in card_keys.items():
        if not torch.equal(words.cpu(), cpu_keys[name]):
            raise AssertionError(f"key {name}: the card's words differ from "
                                 "the CPU plain versions'")
    for name, ct in ik["outs"].items():
        want = twin["outs"][name]
        enc = name.split()[1].startswith("enc")
        rows = slice(None) if enc else slice(0, 1)
        for part in ("c0", "c1"):
            if not torch.equal(getattr(ct, part)[:, rows].cpu(),
                               getattr(want, part)):
                raise AssertionError(f"{name}.{part}: the card's words differ "
                                     "from the CPU plain versions'")
        if (ct.level, ct.scale) != (want.level, want.scale):
            raise AssertionError(f"{name}: level or scale differs on the CPU")
    return len(card_keys)


def mesh_schemes(np, schemes, ck, ik, mesh, device) -> dict:
    """Phase 3h's scheme part: CKKS, BGV and BFV contexts with ``mesh=`` at
    phases 3f's and 3g's chain and seeds, each with the unsharded
    context's keys and first two encryptions placed on the mesh.  Returns,
    by name, (the mesh call, the unsharded context's output of that call,
    the context, its keys) for multiply, square, rotate 1, rescale (of the
    product) and the four-term apply_linear (its LinearOp built again in
    the coefficient domain)."""
    CKKSContext, BGVContext, BFVContext = schemes
    out = {}
    for scheme, C, base, keys, seed, extra in (
        ("CKKS", CKKSContext, ck["ctx"], ck["keys"], CKKS_SEED, {}),
        ("BGV", BGVContext, ik["ctx"]["BGV"], ik["keys"]["BGV"], INT_SEED,
         dict(t=INT_T)),
        ("BFV", BFVContext, ik["ctx"]["BFV"], ik["keys"]["BFV"], INT_SEED,
         dict(t=INT_T)),
    ):
        ctx = C(KS_N, num_primes=KS_L, rng=np.random.default_rng(seed),
                device=device, mesh=mesh, **extra)
        if scheme == "CKKS":
            outs, terms = ck["outs"], ck["lin_terms"]
            e1, e2 = outs["enc1"], outs["enc2"]
            square = base.square(e1, keys)
        else:
            outs = {name.split(" ", 1)[1]: ct for name, ct in ik["outs"].items()
                    if name.startswith(scheme + " ")}
            terms, e1, e2 = ik["lin_terms"][scheme], outs["enc1"], outs["enc2"]
            square = outs["square"]
        s1, s2 = ctx.place(e1), ctx.place(e2)
        lin = ctx.make_linear_op(terms, keys, KS_L)
        prod = ctx.multiply(s1, s2, keys)
        calls = {
            "multiply": (lambda c=ctx, k=keys, a=s1, b=s2: c.multiply(a, b, k),
                         outs["multiply"]),
            "square": (lambda c=ctx, k=keys, a=s1: c.square(a, k), square),
            "rotate 1": (lambda c=ctx, k=keys, a=s1: c.rotate(a, 1, k),
                         outs["rotate 1"]),
            "rescale": (lambda c=ctx, p_=prod: c.rescale(p_), outs["rescale"]),
            "apply_linear": (lambda c=ctx, a=s1, op=lin: c.apply_linear(a, op),
                             outs["apply_linear"]),
        }
        for name, (call, want) in calls.items():
            out[f"{scheme} {name}"] = (call, want, base, keys)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 2
    import numpy as np

    from agilex_ntt_tpu_torch import (
        CyclicRing, RNSRing, Ring, find_primes, golden as G,
    )
    from agilex_ntt_tpu_torch.ops import _build
    from agilex_ntt_tpu_torch.ops import fourstep as FS
    from agilex_ntt_tpu_torch.ops import ntt_kernel as K
    from agilex_ntt_tpu_torch.ops import plain_ntt as P
    from agilex_ntt_tpu_torch.utils.profiling import (
        cuda_time_ms, device_time, device_time_profiled,
    )
    from agilex_ntt_tpu_torch.utils.xchg_probe import profiled

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    log(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    ptxas = ptxas_lines(lib_path.parent / "build.log")  # kernel -> its lines
    for kernel, lines in ptxas.items():
        for line in lines:
            log(f"  ptxas {kernel}: {line}")

    # -- 2. each kernel against its plain version ------------------------------
    def rand(gen, bound_, shape):
        return torch.randint(0, bound_, shape, generator=gen,
                             dtype=torch.int64, device=dev)

    worst = {key: 0 for key in KERNELS}
    mismatched = {key: 0 for key in KERNELS}

    def compare(name, got, want, shape_note):
        diff = (got.to(torch.int64) - want).abs()
        err, bad = int(diff.max()), int((diff != 0).sum())
        worst[name] = max(worst[name], err)
        mismatched[name] += bad
        log(f"  {name:11s} {shape_note:34s} max_abs_err={err} mismatches={bad}")
        if bad:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at {shape_note}")

    def golden_fwd(rows, params):
        return G.fwd_ntt_u64(rows.cpu().numpy(), params)

    def golden_dot(a_rows, b_rows, params):
        """sum_i a_i * b_i by the golden transforms; a, b: (rows, k, n)."""
        q = np.uint64(params.q)
        fa, fb = golden_fwd(a_rows, params), golden_fwd(b_rows, params)
        return G.inv_ntt_u64((fa * fb % q).sum(axis=-2) % q, params)

    def same_as_golden(got_rows, want, what):
        if not np.array_equal(got_rows.cpu().numpy().astype(np.uint64), want):
            raise AssertionError(f"{what} disagrees with the golden model")

    def lazy_pair(gen, q, shape):
        """K3's and K6a's operands: a over the lazy [0, 4q) with 4q - 1 on
        the first half of its first polynomial and 0 on the rest, b over
        [0, q) with q - 1 and 0 alike."""
        a, b = rand(gen, 4 * q, shape), rand(gen, q, shape)
        half = shape[-1] // 2
        a[0, ..., :half], a[0, ..., half:] = 4 * q - 1, 0
        b[0, ..., :half], b[0, ..., half:] = q - 1, 0
        return a, b

    def one_shape(tabs, which, batch):
        """Which launch shape K1 ("fwd") or K2 ("inv") takes at (batch, n)."""
        info = K.launch_info(tabs, which, batch)
        if info["ctas"] > 1:
            return f"cluster {info['ctas']}"
        return f"{info['polys']} a CTA"

    def one_dot_shape(tabs, k):
        """Which launch shape K3 (k = 1) and K6a take at this n."""
        info = K.polydot_launch_info(tabs, k)
        if info["ctas"] > 1:
            return f"cluster {info['ctas']}"
        return f"{info['polys']} a CTA"

    log("kernels vs plain versions (tolerance 0: bit-exact), first rows vs golden:")
    for n, batch, k, dot_batch in CHECK_SHAPES:
        ring = Ring(n, device=dev)
        q, tabs, params = ring.q, ring.tables, ring.params
        gen = torch.Generator(dev).manual_seed(n)
        g = GOLDEN_ROWS

        x = rand(gen, 4 * q, (batch, n))  # lazy forward range [0, 4q)
        got = K.fwd_ntt(x.to(torch.uint32), tabs)
        compare("fwd", got, P.fwd_ntt_plain(x, tabs),
                f"n={n} B={batch} {one_shape(tabs, 'fwd', batch)}")
        same_as_golden(got[:g], golden_fwd(x[:g], params), "fwd_ntt")
        del x, got

        y = rand(gen, 2 * q, (batch, n))  # lazy inverse range [0, 2q)
        got = K.inv_ntt(y.to(torch.uint32), tabs)
        compare("inv", got, P.inv_ntt_plain(y, tabs),
                f"n={n} B={batch} {one_shape(tabs, 'inv', batch)}")
        same_as_golden(got[:g], G.inv_ntt_u64(y[:g].cpu().numpy(), params),
                       "inv_ntt")
        got = K.inv_ntt(y.to(torch.uint32), tabs, scale=ring.polymul_scale)
        compare("inv", got, P.inv_ntt_plain(y, tabs, ring.polymul_scale),
                f"n={n} B={batch} polymul_scale")
        del y, got

        a, b = lazy_pair(gen, q, (batch, n))
        got = K.polymul_fused(a.to(torch.uint32), b.to(torch.uint32), tabs)
        compare("polymul", got, P.polymul_plain(a, b, tabs),
                f"n={n} B={batch} {one_dot_shape(tabs, 1)}")
        same_as_golden(got[:g], golden_dot(a[:g, None], b[:g, None], params),
                       "polymul_fused")
        if n <= 256:  # the schoolbook product, an oracle sharing no transform
            want = G.negacyclic_convolution(a[0].tolist(), b[0].tolist(), q)
            if got[0].to(torch.int64).tolist() != want:
                raise AssertionError("polymul_fused disagrees with schoolbook")
        del a, b, got

        a, b = lazy_pair(gen, q, (dot_batch, k, n))
        got = K.polydot_fused(a.to(torch.uint32), b.to(torch.uint32), tabs)
        compare("polydot", got, P.polydot_plain(a, b, tabs),
                f"n={n} B={dot_batch} k={k} {one_dot_shape(tabs, k)}")
        same_as_golden(got[:g], golden_dot(a[:g], b[:g], params),
                       "polydot_fused")
        del a, b, got
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    for n, batch, k, cyclic in FUSED_MORE_SHAPES:
        ring = (CyclicRing if cyclic else Ring)(n, device=dev)
        q, tabs = ring.q, ring.tables
        gen = torch.Generator(dev).manual_seed(n + k + 5)
        a, b = lazy_pair(gen, q, (batch, k, n))
        note = (f"n={n} B={batch} k={k}{' cyclic' if cyclic else ''} "
                f"{one_dot_shape(tabs, k)}")
        if k == 1:
            got = K.polymul_fused(a[:, 0].to(torch.uint32),
                                  b[:, 0].to(torch.uint32), tabs)
            compare("polymul", got, P.polymul_plain(a[:, 0], b[:, 0], tabs),
                    note)
        else:
            got = K.polydot_fused(a.to(torch.uint32), b.to(torch.uint32), tabs)
            compare("polydot", got, P.polydot_plain(a, b, tabs), note)
        if cyclic and n <= 4:  # the schoolbook cyclic product of two rows
            for row in (0, 1):
                u, v = a[row, 0].tolist(), b[row, 0].tolist()
                want = [sum(u[j] * v[(i - j) % n] for j in range(n)) % q
                        for i in range(n)]
                if got[row].to(torch.int64).tolist() != want:
                    raise AssertionError(f"CyclicRing({n}) polymul disagrees "
                                         "with schoolbook")
        del a, b, got
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # K1 and K2 on their other callers' tables, each scale its callers pass
    from agilex_ntt_tpu_torch.parallel import stage_shard as SS

    def transform_tables(what, n, batch):
        """[(note, RingTables, rows, inverse scales)] of a TRANSFORM_MORE
        row."""
        if what == "cyclic":
            t = CyclicRing(n, device=dev).tables
            return [(f"cyclic n={n}", t, batch, (None, t.polymul_scale))]
        if what == "plain":
            t = Ring(n, q=PLAIN_T[n], device=dev).tables
            return [(f"plaintext ring n={n} q={t.q}", t, batch, (None,))]
        ring_ = Ring(n, device=dev)
        if what == "shard":
            return [(f"shard {d} of {SHARD_SP}, n={n}",
                     SS._shard_tables(ring_.params, SHARD_SP, d, dev), batch,
                     (1, None)) for d in range(SHARD_SP)]
        ft = ring_.fourstep
        if what == "row":
            return [(f"row pass of n={n}", ft.row, batch * ft.n1, (None,))]
        return [(f"columns of n={n} sp={SHARD_SP}", ft.col,
                 batch * ft.n2 // SHARD_SP,
                 (ft.col_scale(), ft.col_scale(ft.polymul_scale)))]

    for what, n, batch in TRANSFORM_MORE:
        for note, t, rows_, scales in transform_tables(what, n, batch):
            q = t.q
            gen = torch.Generator(dev).manual_seed(t.n + rows_)
            x = rand(gen, 4 * q, (rows_, t.n))
            y = rand(gen, 2 * q, (rows_, t.n))
            # the tops of the lazy ranges on the first quarter, 0 last
            x.view(-1)[: x.numel() // 4], x.view(-1)[-t.n:] = 4 * q - 1, 0
            y.view(-1)[: y.numel() // 4], y.view(-1)[-t.n:] = 2 * q - 1, 0
            compare("fwd", K.fwd_ntt(x.to(torch.uint32), t),
                    P.fwd_ntt_plain(x, t),
                    f"{note} B={rows_} {one_shape(t, 'fwd', rows_)}")
            for sc in scales:
                compare("inv", K.inv_ntt(y.to(torch.uint32), t, scale=sc),
                        P.inv_ntt_plain(y, t, sc),
                        f"{note} B={rows_} scale "
                        f"{'n^-1' if sc is None else sc}")
            del x, y
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def channels(gen, qs, mult, shape):
        """(L, *shape) int64, channel l uniform in [0, mult * q_l)."""
        return torch.stack([rand(gen, mult * q, shape) for q in qs])

    def golden_channels(got, want_fn, rings, what):
        """Each channel's first rows against the golden model of its prime."""
        for l, r in enumerate(rings):
            same_as_golden(got[l, :GOLDEN_ROWS], want_fn(l, r.params),
                           f"{what} channel {l}")

    def dot_shape(tabs):
        """Which launch shape K5 and K6b take at this n."""
        info = K.polydot_rns_launch_info(tabs)
        if info["ctas"] > 1:
            return f"cluster {info['ctas']}"
        return f"{info['polys']} a CTA"

    def rns_shape(tabs, which, batch):
        """Which launch shape K4a or K4b takes at (L, batch, n)."""
        info = K.rns_launch_info(tabs, which, batch)
        if info["ctas"] > 1:
            return f"cluster {info['ctas']}"
        return f"{info['polys']} a CTA"

    g = GOLDEN_ROWS
    for n, L, batch, k, dot_batch in RNS_CHECK_SHAPES:
        ring = RNSRing(n, L, device=dev)
        tabs, qs = ring.tables, ring.qs
        gen = torch.Generator(dev).manual_seed(n + L)
        note = f"n={n} L={L} B={batch}"
        dshape = dot_shape(tabs)

        x = channels(gen, qs, 4, (batch, n))
        got = K.fwd_ntt_rns(x.to(torch.uint32), tabs)
        compare("fwd_rns", got, P.fwd_ntt_rns_plain(x, tabs),
                f"{note} {rns_shape(tabs, 'fwd_rns', batch)}")
        golden_channels(got, lambda l, p: golden_fwd(x[l, :g], p), ring.rings,
                        "fwd_ntt_rns")
        del x, got

        y = channels(gen, qs, 2, (batch, n))
        ishape = rns_shape(tabs, "inv_rns", batch)
        got = K.inv_ntt_rns(y.to(torch.uint32), tabs)
        compare("inv_rns", got, P.inv_ntt_rns_plain(y, tabs),
                f"{note} {ishape}")
        golden_channels(
            got, lambda l, p: G.inv_ntt_u64(y[l, :g].cpu().numpy(), p),
            ring.rings, "inv_ntt_rns")
        got = K.inv_ntt_rns(y.to(torch.uint32), tabs, scales=tabs.polymul_scale)
        compare("inv_rns", got, P.inv_ntt_rns_plain(y, tabs, tabs.polymul_scale),
                f"{note} {ishape} polymul_scale")
        del y, got

        a, b = channels(gen, qs, 1, (batch, n)), channels(gen, qs, 1, (batch, n))
        got = K.polymul_rns_fused(a.to(torch.uint32), b.to(torch.uint32), tabs)
        compare("polymul_rns", got, P.polymul_rns_plain(a, b, tabs),
                f"{note} {dshape}")
        golden_channels(
            got, lambda l, p: golden_dot(a[l, :g, None], b[l, :g, None], p),
            ring.rings, "polymul_rns_fused")
        del a, b, got

        a = channels(gen, qs, 1, (dot_batch, k, n))
        b = channels(gen, qs, 1, (dot_batch, k, n))
        got = K.polydot_rns_fused(a.to(torch.uint32), b.to(torch.uint32), tabs)
        compare("polydot_rns", got, P.polydot_rns_plain(a, b, tabs),
                f"n={n} L={L} B={dot_batch} k={k} {dshape}")
        golden_channels(got, lambda l, p: golden_dot(a[l, :g], b[l, :g], p),
                        ring.rings, "polydot_rns_fused")
        del a, b, got
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # K4a and K4b on BFV's union basis Q + B + {m_sk} of the n16384 chain at
    # its top level (11 channels) at the tensor's launch shapes: the forward
    # transform of the four lifted parts, the inverse of the three products
    # at polymul_scale, and the square's forward of two
    from agilex_ntt_tpu_torch.schemes import BFVContext

    _, ubig = BFVContext(KS_N, KS_L, t=INT_T, device=dev)._aux(KS_L)
    utabs = ubig.tables
    gen = torch.Generator(dev).manual_seed(KS_N + ubig.L)
    for parts in (4, 2):
        x = channels(gen, ubig.qs, 4, (parts * INT_BATCH, KS_N))
        compare("fwd_rns", K.fwd_ntt_rns(x.to(torch.uint32), utabs),
                P.fwd_ntt_rns_plain(x, utabs),
                f"BFV union L={ubig.L} B={parts}x{INT_BATCH} n={KS_N} "
                f"{rns_shape(utabs, 'fwd_rns', parts * INT_BATCH)}")
        del x
    y = channels(gen, ubig.qs, 2, (3 * INT_BATCH, KS_N))
    compare("inv_rns", K.inv_ntt_rns(y.to(torch.uint32), utabs,
                                     scales=utabs.polymul_scale),
            P.inv_ntt_rns_plain(y, utabs, utabs.polymul_scale),
            f"BFV union L={ubig.L} B=3x{INT_BATCH} n={KS_N} "
            f"{rns_shape(utabs, 'inv_rns', 3 * INT_BATCH)} polymul_scale")
    del y, ubig, utabs
    # K4a and K4b on the stacked four-step tables of a channel block
    # (phase 3h's ch x sp path, parallel/chsp.py): the negacyclic column
    # tables (size n1) and the cyclic row tables (size n2) of RNSRing(2^16,
    # 4)'s first two channels, at a (ch, dp, sp) block's launch shape (32
    # polynomials x 128 columns or rows), the inverse with the row's n2^-1
    # and the column's scale * n2 for n^-1 and for polymul_scale
    from agilex_ntt_tpu_torch.parallel import chsp as CS

    _, h_n, h_L, h_axes, _, h_b = SHARD_RNS[2]
    h_rings = RNSRing(h_n, h_L, device=dev).rings[: h_L // h_axes["ch"]]
    h_plans = tuple(r.plan for r in h_rings)
    col_t, row_t, _ = CS._tables(h_plans, dev)
    h_rows = h_b // h_axes["dp"] * (h_plans[0].n2 // h_axes["sp"])
    col_scales = [tuple(s_ * p_.n2 % p_.q for p_, s_ in zip(h_plans, sc))
                  for sc in ([p_.n_inv for p_ in h_plans],
                             [r.polymul_scale for r in h_rings])]
    gen = torch.Generator(dev).manual_seed(h_n + h_L)
    for what, tabs_, inv_scales in (("column", col_t, col_scales),
                                    ("cyclic row", row_t, [None])):
        note = (f"four-step {what} L={tabs_.L} B={h_rows} n={tabs_.n} "
                f"{rns_shape(tabs_, 'fwd_rns', h_rows)}")
        x = channels(gen, tabs_.qs, 4, (h_rows, tabs_.n))
        compare("fwd_rns", K.fwd_ntt_rns(x.to(torch.uint32), tabs_),
                P.fwd_ntt_rns_plain(x, tabs_), note)
        y = channels(gen, tabs_.qs, 2, (h_rows, tabs_.n))
        for sc in inv_scales:
            compare("inv_rns", K.inv_ntt_rns(y.to(torch.uint32), tabs_,
                                             scales=sc),
                    P.inv_ntt_rns_plain(y, tabs_, sc),
                    note + (f" scales {sc}" if sc else ""))
        del x, y
    del h_rings, h_plans, col_t, row_t
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the four-step kernels, at the shapes of the four-step path
    def tiled(v, ft):
        return v.view(v.shape[0], ft.n1, ft.n2)

    def body(ft, mats):
        """Which kernel K7a and K7b (mats=1) or K8 (2) run at this shape."""
        logc = K.fourstep_cluster(ft, mats)
        return f"cluster {1 << logc}" if logc >= 0 else "walking"

    def slabs(ft, key="col_fwd"):
        """Which kernel K9a (or K9b) runs at this shape."""
        w = K.fourstep_launch_info(ft, key)["width"]
        return f"slabs of {w}" if w else "walking"

    for n, batch in FS_CHECK_SHAPES:
        ring = Ring(n, device=dev)
        ft, q = ring.fourstep, ring.q
        gen = torch.Generator(dev).manual_seed(n + batch)
        note = f"n={n} ({ft.n1}x{ft.n2}) B={batch}"
        shape = (batch, ft.n1, ft.n2)
        x = rand(gen, 4 * q, shape)
        y = rand(gen, 2 * q, shape)
        got = K.fwd_col_fourstep(x.to(torch.uint32), ft)
        compare("col_fwd", got, P.fwd_col_fourstep_plain(x, ft),
                f"{note} {slabs(ft)}")
        got = K.inv_col_fourstep(y.to(torch.uint32), ft)
        compare("col_inv", got, P.inv_col_fourstep_plain(y, ft),
                f"{note} {slabs(ft, 'col_inv')}")
        want_f = P.fwd_ntt_fourstep_plain(x, ft)
        got = K.fwd_ntt_fourstep(x.to(torch.uint32), ft)
        compare("fwd4", got, want_f, f"{note} {body(ft, 1)}")
        for sc in (None, ft.polymul_scale):
            got = K.inv_ntt_fourstep(y.to(torch.uint32), ft, scale=sc)
            compare("inv4", got, P.inv_ntt_fourstep_plain(y, ft, sc),
                    f"{note} {body(ft, 1)}" + (" polymul_scale" if sc else ""))
        if not FS.use_full_fuse(ft):  # the column kernels and the row pass
            got = tiled(ring.ntt(x.view(batch, n).to(torch.uint32)), ft)
            compare("col_fwd", got, want_f, note + " + rows")
            got = tiled(ring.intt(y.view(batch, n).to(torch.uint32)), ft)
            compare("col_inv", got, P.inv_ntt_fourstep_plain(y, ft),
                    note + " + rows")
        if n == 1 << 16 and batch >= FS_GOLDEN_ROWS:
            rows_ = x[:FS_GOLDEN_ROWS].reshape(FS_GOLDEN_ROWS, n)
            same_as_golden(want_f[:FS_GOLDEN_ROWS].reshape(FS_GOLDEN_ROWS, n),
                           golden_fwd(rows_, ring.params), "fwd_ntt_fourstep")
        del x, y, got, want_f
        # the edge words q - 1 and 0 in the first operands
        a, b = rand(gen, q, shape), rand(gen, q, shape)
        a[0].view(-1)[: n // 2] = q - 1
        b[0].view(-1)[: n // 4] = q - 1
        b[0].view(-1)[n // 2:] = 0
        got = K.polymul_fourstep_fused(a.to(torch.uint32), b.to(torch.uint32),
                                       ft)
        compare("polymul4", got, P.polymul_fourstep_plain(a, b, ft),
                f"{note} {body(ft, 2)}")
        if n == 1 << 16 and batch >= FS_GOLDEN_ROWS:
            g2 = FS_GOLDEN_ROWS
            same_as_golden(
                got[:g2].reshape(g2, n),
                golden_dot(a[:g2].reshape(g2, 1, n), b[:g2].reshape(g2, 1, n),
                           ring.params),
                "polymul_fourstep_fused")
        del a, b, got
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    # K9a and K9b alone at n1 = 2^11 .. 2^15: the slabs narrow to 2 columns,
    # then the walking kernels; K9b on any 32-bit words, both scales
    for logn1 in COL_LOGN1:
        n1 = 1 << logn1
        n = n1 * COL_N2
        q = find_primes(n, 1)[0]
        ft = P.make_fourstep_tables(FS.make_plan(n, q, None, n1), dev)
        batch = COL_WORDS // n
        shape = (batch, n1, COL_N2)
        gen = torch.Generator(dev).manual_seed(logn1)
        note = f"n1={n1} n2={COL_N2} B={batch}"
        x = rand(gen, 4 * q, shape)
        compare("col_fwd", K.fwd_col_fourstep(x.to(torch.uint32), ft),
                P.fwd_col_fourstep_plain(x, ft), f"{note} {slabs(ft)}")
        z = rand(gen, 1 << 32, shape)
        z[0].view(-1)[:4] = torch.tensor([2**32 - 1, 4 * q - 1, 2 * q - 1, 0])
        for sc in (None, ft.polymul_scale):
            got = K.inv_col_fourstep(z.to(torch.uint32), ft, scale=sc)
            compare("col_inv", got, P.inv_col_fourstep_plain(z, ft, sc),
                    f"{note} {slabs(ft, 'col_inv')}"
                    + (" polymul_scale" if sc else ""))
        del x, z, got
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    # the DIT inverse (K12) and the cross-device stage (K11)
    from agilex_ntt_tpu_torch.ops import dit_inv as D

    for n, batch in DIT_CHECK_SHAPES:
        ring = Ring(n, device=dev)
        gen = torch.Generator(dev).manual_seed(3 * n + batch)
        y = rand(gen, 2 * ring.q, (batch, n))  # bit-reversed, in [0, 2q)
        dt = D._dit_tables(ring.params, dev)
        got = K.dit_inv_core(y.to(torch.uint32), dt)
        compare("dit_inv", got, P.dit_inv_core_plain(y, dt), f"n={n} B={batch}")
        y32 = y.to(torch.uint32)
        want = ring.intt(y32)
        logn = n.bit_length() - 1
        for fac in (False, True) if logn % 2 == 0 else (False,):
            if not torch.equal(D.inv_ntt_dit(y32, ring.params, factored=fac), want):
                raise AssertionError(f"inv_ntt_dit (factored={fac}) differs from "
                                     f"K2 at n={n}")
        same_as_golden(want[:GOLDEN_ROWS],
                       G.inv_ntt_u64(y[:GOLDEN_ROWS].cpu().numpy(), ring.params),
                       "inv_ntt_dit")
        del y, y32, got, want
    q = Ring(SHARD_N, device=dev).q
    gen = torch.Generator(dev).manual_seed(89)
    shape = (XCHG_ROWS, XCHG_WIDTH)
    for fwd in (True, False):
        key = "xchg_fwd" if fwd else "xchg_inv"
        x = rand(gen, (4 if fwd else 2) * q, shape)
        part = rand(gen, (4 if fwd else 2) * q, shape)
        w = rand(gen, q, (XCHG_WIDTH,))
        wp = (w << 32) // q
        scale = Ring(SHARD_N, device=dev).n_inv
        x32, p32, w32, wp32 = (t.to(torch.uint32) for t in (x, part, w, wp))
        for last in (False, True):
            for is_u in (True, False):
                got = K.xchg_step(x32, p32, w32, wp32, q=q, fwd=fwd, is_u=is_u,
                                  last=last, scale=scale)
                if fwd:
                    want = P.fwd_stage_step_plain(x, part, is_u, w, wp, q, last)
                else:
                    want = P.inv_stage_step_plain(
                        x, part, is_u, w, wp, q,
                        (scale, (scale << 32) // q) if last else None)
                compare(key, got, want, f"(B={XCHG_ROWS}, S={XCHG_WIDTH}) "
                        f"{'u' if is_u else 'v'}{' last' if last else ''}")
        # group launches: P entries a table, each with its own pair of
        # shards and twiddle row, writing both halves or one
        for P_ in XCHG_GROUPS:
            ug = [rand(gen, (4 if fwd else 2) * q, shape) for _ in range(P_)]
            vg = [rand(gen, (4 if fwd else 2) * q, shape) for _ in range(P_)]
            wg = [rand(gen, q, (XCHG_WIDTH,)) for _ in range(P_)]
            wpg = [(v << 32) // q for v in wg]
            halves = [XCHG_HALVES[d % 3] for d in range(P_)]
            for last in (False, True):
                outs = [[torch.empty(shape, dtype=torch.uint32, device=dev)
                         if h in halves[d] else None for h in "uv"]
                        for d in range(P_)]
                entries = [tuple(t.to(torch.uint32)
                                 for t in (ug[d], vg[d], wg[d], wpg[d]))
                           + tuple(outs[d]) for d in range(P_)]
                before = K.LAUNCHES[key]
                K.xchg_group(entries, q=q, fwd=fwd, last=last, scale=scale)
                if K.LAUNCHES[key] != before + 1:
                    raise AssertionError(f"{key}: a group of {P_} took "
                                         f"{K.LAUNCHES[key] - before} launches")
                for d in range(P_):
                    for h, got in zip("uv", outs[d]):
                        if got is None:
                            continue
                        mine, other = (ug[d], vg[d]) if h == "u" else (vg[d], ug[d])
                        args = (mine, other, h == "u", wg[d], wpg[d], q)
                        want = (P.fwd_stage_step_plain(*args, last) if fwd else
                                P.inv_stage_step_plain(
                                    *args, (scale, (scale << 32) // q) if last
                                    else None))
                        compare(key, got, want, f"group of {P_} (B={XCHG_ROWS}, "
                                f"S={XCHG_WIDTH}) entry {d} {h}-half"
                                f"{' last' if last else ''}")
            del ug, vg, entries, outs
    del x, part, x32, p32, got, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 2 done at {time.perf_counter() - t_start:.1f} s")

    # -- 3a. the single-prime main path, counted ------------------------------
    ring = Ring(MAIN_N, device=dev)
    gen = torch.Generator(dev).manual_seed(20261016)
    x = ring.random_coeffs(gen, (MAIN_BATCH,))
    a = ring.random_coeffs(gen, (MAIN_BATCH,))
    b = ring.random_coeffs(gen, (MAIN_BATCH,))
    da = ring.random_coeffs(gen, (MAIN_DOT_BATCH, MAIN_K))
    db = ring.random_coeffs(gen, (MAIN_DOT_BATCH, MAIN_K))
    torch.cuda.synchronize()
    for key in K.LAUNCHES:
        K.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    y = ring.ntt(x)
    z = ring.intt(y)
    c = ring.polymul(a, b)
    d = ring.polydot(da, db)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    log(f"main path: Ring({MAIN_N}) ntt+intt+polymul (B={MAIN_BATCH}) + "
        f"polydot (B={MAIN_DOT_BATCH}, k={MAIN_K}) in {main_s * 1e3:.3f} ms "
        f"(host clock); launches {launches}")
    missing = [key for key in SINGLE if launches[key] < 1]
    if missing:
        raise AssertionError(f"main path launched no {missing} kernel")
    params, g = ring.params, GOLDEN_ROWS
    for out, shape in ((y, (MAIN_BATCH, MAIN_N)), (z, (MAIN_BATCH, MAIN_N)),
                       (c, (MAIN_BATCH, MAIN_N)), (d, (MAIN_DOT_BATCH, MAIN_N))):
        if out.dtype != torch.uint32 or tuple(out.shape) != shape:
            raise AssertionError(f"main path output {out.dtype} "
                                 f"{tuple(out.shape)}, expected {shape}")
        if int(out.to(torch.int64).max()) >= ring.q:
            raise AssertionError("main path output not reduced below q")
    if not torch.equal(z, x):
        raise AssertionError("intt(ntt(x)) != x on the main path")
    same_as_golden(y[:g], golden_fwd(x[:g], params), "main path ntt")
    same_as_golden(c[:g], golden_dot(a[:g, None], b[:g, None], params),
                   "main path polymul")
    same_as_golden(d[:g], golden_dot(da[:g], db[:g], params),
                   "main path polydot")
    log("main path: outputs agree with the golden model")

    # -- 3b. the key switch of the n16384 chain, and RNSRing(4096), counted ----
    primes = find_primes(KS_N, KS_L + 1)
    special, ks_qs = primes[0], primes[1:]  # the largest is the special prime
    ext_qs = ks_qs + [special]
    dnum, ext_k = KS_L, KS_L + 1
    ks_ring = RNSRing(KS_N, qs=ks_qs, device=dev)
    ext_ring = RNSRing(KS_N, qs=ext_qs, device=dev)
    rns = RNSRing(RNS_N, RNS_L, device=dev)
    gen = torch.Generator(dev).manual_seed(20261017)
    ks_x = channels(gen, ks_qs, 1, (KS_BATCH, KS_N)).to(torch.uint32)
    ksk = channels(gen, ext_qs, 1, (dnum, KS_N)).movedim(0, 1)
    ksk = ksk.to(torch.uint32).contiguous()  # (dnum, K, n), shared
    ksks = channels(gen, ext_qs, 1, (len(KS_STEPS), dnum, KS_N)).movedim(0, 2)
    ksks = ksks.to(torch.uint32).contiguous()  # (steps, dnum, K, n)
    rx = channels(gen, rns.qs, 1, (RNS_BATCH, RNS_N)).to(torch.uint32)
    ra = channels(gen, rns.qs, 1, (RNS_BATCH, RNS_N)).to(torch.uint32)
    rb = channels(gen, rns.qs, 1, (RNS_BATCH, RNS_N)).to(torch.uint32)
    rda = channels(gen, rns.qs, 1, (RNS_BATCH, RNS_K, RNS_N)).to(torch.uint32)
    rdb = channels(gen, rns.qs, 1, (RNS_BATCH, RNS_K, RNS_N)).to(torch.uint32)
    torch.cuda.synchronize()
    for key in K.LAUNCHES:
        K.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    ks_coeff = ks_ring.keyswitch(ks_x, ksk, ext_ring, dnum)
    ksk_ntt = ks_ring.ksk_to_ntt(ksk, ext_ring)
    ks_ntt = ks_ring.keyswitch(ks_x, ksk_ntt, ext_ring, dnum, ksk_domain="ntt")
    ksks_ntt = ks_ring.ksk_to_ntt(ksks, ext_ring, ch_axis=2)
    hoisted = ks_ring.hoisted_keyswitch(ks_x, ksks_ntt, KS_STEPS, ext_ring, dnum,
                                        ksk_domain="ntt")
    ry = rns.ntt(rx)
    rz = rns.intt(ry)
    rc = rns.polymul(ra, rb)
    rd = rns.polydot(rda, rdb)
    torch.cuda.synchronize()
    rns_s = time.perf_counter() - t0
    rns_launches = dict(K.LAUNCHES)
    log(f"main path: RNSRing({KS_N}, L={KS_L}) keyswitch coeff + ntt keys "
        f"(B={KS_BATCH}, dnum={dnum}, K={ext_k}) + hoisted over {len(KS_STEPS)} "
        f"steps, RNSRing({RNS_N}, L={RNS_L}) ntt+intt+polymul+polydot "
        f"(B={RNS_BATCH}, k={RNS_K}) in {rns_s * 1e3:.3f} ms (host clock); "
        f"launches {rns_launches}")
    missing = [key for key in MULTI if rns_launches[key] < 1]
    if missing:
        raise AssertionError(f"key-switch path launched no {missing} kernel")
    for out, shape, qs in (
        (ks_coeff, (KS_L, KS_BATCH, KS_N), ks_qs),
        (ks_ntt, (KS_L, KS_BATCH, KS_N), ks_qs),
        (hoisted[0], (KS_L, KS_BATCH, KS_N), ks_qs),
        (ry, (RNS_L, RNS_BATCH, RNS_N), rns.qs),
        (rz, (RNS_L, RNS_BATCH, RNS_N), rns.qs),
        (rc, (RNS_L, RNS_BATCH, RNS_N), rns.qs),
        (rd, (RNS_L, RNS_BATCH, RNS_N), rns.qs),
    ):
        if out.dtype != torch.uint32 or tuple(out.shape) != shape:
            raise AssertionError(f"key-switch path output {out.dtype} "
                                 f"{tuple(out.shape)}, expected {shape}")
        top = out.to(torch.int64).amax(dim=tuple(range(1, out.dim())))
        if any(int(t) >= q for t, q in zip(top.tolist(), qs)):
            raise AssertionError("key-switch path output not reduced below q")
    if tuple(hoisted.shape) != (len(KS_STEPS), KS_L, KS_BATCH, KS_N):
        raise AssertionError(f"hoisted_keyswitch shape {tuple(hoisted.shape)}")
    if not torch.equal(ks_coeff, ks_ntt):
        raise AssertionError("keyswitch: the two key domains disagree")
    if not torch.equal(rz, rx):
        raise AssertionError("RNSRing intt(ntt(x)) != x")
    # the first rows through the port's own CPU plain composition
    cpu_ring = RNSRing(KS_N, qs=ks_qs, device="cpu")
    rows = ks_x[:, :2].cpu()
    want = cpu_ring.keyswitch(rows, ksk.cpu(), ext_qs, dnum)
    if not torch.equal(ks_coeff[:, :2].cpu(), want):
        raise AssertionError("keyswitch disagrees with the CPU plain composition")
    want = cpu_ring.hoisted_keyswitch(rows, ksks.cpu(), KS_STEPS, ext_qs, dnum)
    if not torch.equal(hoisted[:, :, :2].cpu(), want):
        raise AssertionError("hoisted_keyswitch disagrees with the CPU plain "
                             "composition")
    golden_channels(ry, lambda l, p: golden_fwd(rx[l, :g], p), rns.rings,
                    "RNSRing.ntt")
    golden_channels(rc, lambda l, p: golden_dot(ra[l, :g, None],
                                                rb[l, :g, None], p),
                    rns.rings, "RNSRing.polymul")
    golden_channels(rd, lambda l, p: golden_dot(rda[l, :g], rdb[l, :g], p),
                    rns.rings, "RNSRing.polydot")
    log("key-switch path: both key domains agree, the first rows equal the "
        "CPU plain composition, RNSRing outputs agree with the golden model")

    # -- 3c. the four-step path, counted --------------------------------------
    gen = torch.Generator(dev).manual_seed(20261018)
    fs_rings = [Ring(n, device=dev) for n, _ in FS_PATH]
    fs_in = []
    for r, (n, bsz) in zip(fs_rings, FS_PATH):
        fs_in.append((r.random_coeffs(gen, (bsz,)), r.random_coeffs(gen, (bsz,)),
                      r.random_coeffs(gen, (bsz,))))
    big = fs_rings[0]
    fda = big.random_coeffs(gen, (FS_DOT_BATCH, FS_DOT_K))
    fdb = big.random_coeffs(gen, (FS_DOT_BATCH, FS_DOT_K))
    cyc = CyclicRing(1 << 16, device=dev)
    cx = rand(gen, cyc.q, (FS_SMALL_BATCH, 1 << 16)).to(torch.uint32)
    cb = rand(gen, cyc.q, (FS_SMALL_BATCH, 1 << 16)).to(torch.uint32)
    frns = RNSRing(1 << 16, FS_RNS_L, device=dev)
    fr = channels(gen, frns.qs, 1, (FS_SMALL_BATCH, 1 << 16)).to(torch.uint32)
    fr2 = channels(gen, frns.qs, 1, (FS_SMALL_BATCH, 1 << 16)).to(torch.uint32)
    torch.cuda.synchronize()
    for key in K.LAUNCHES:
        K.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    fs_out = []
    for r, (x_, a_, b_) in zip(fs_rings, fs_in):
        y_ = r.ntt(x_)
        fs_out.append((y_, r.intt(y_), r.polymul(a_, b_)))
    fdot = big.polydot(fda, fdb)
    cy = cyc.ntt(cx)
    cz = cyc.intt(cy)
    cc = cyc.polymul(cx, cb)
    ry4 = frns.ntt(fr)
    rz4 = frns.intt(ry4)
    rc4 = frns.polymul(fr, fr2)
    torch.cuda.synchronize()
    fs_s = time.perf_counter() - t0
    fs_launches = dict(K.LAUNCHES)
    log(f"main path: four-step Ring n=2^16..2^21 "
        f"{[(n, b) for n, b in FS_PATH]} ntt+intt+polymul, polydot "
        f"(B={FS_DOT_BATCH}, k={FS_DOT_K}, n=2^16), CyclicRing(2^16) and "
        f"RNSRing(2^16, {FS_RNS_L}) (B={FS_SMALL_BATCH}) in "
        f"{fs_s * 1e3:.3f} ms (host clock); launches "
        f"{ {k: v for k, v in fs_launches.items() if v} }")
    missing = [key for key in FOURSTEP + ("fwd", "inv") if fs_launches[key] < 1]
    if missing:
        raise AssertionError(f"four-step path launched no {missing} kernel")
    for r, (x_, a_, b_), outs in zip(fs_rings, fs_in, fs_out):
        ft = r.fourstep
        for out in outs:
            if out.dtype != torch.uint32 or out.shape != x_.shape:
                raise AssertionError(f"four-step output {out.dtype} "
                                     f"{tuple(out.shape)} at n={r.n}")
            if int(out.to(torch.int64).max()) >= r.q:
                raise AssertionError(f"four-step output not below q at n={r.n}")
        if not torch.equal(outs[1], x_):
            raise AssertionError(f"intt(ntt(x)) != x at n={r.n}")
        g2 = min(FS_GOLDEN_ROWS, x_.shape[0])
        x2 = tiled(x_[:g2].to(torch.int64), ft)
        if not torch.equal(outs[0][:g2], P.fwd_ntt_fourstep_plain(
                x2, ft).view(g2, r.n).to(torch.uint32)):
            raise AssertionError(f"four-step ntt disagrees at n={r.n}")
        want = P.polymul_fourstep_plain(tiled(a_[:g2].to(torch.int64), ft),
                                        tiled(b_[:g2].to(torch.int64), ft), ft)
        if not torch.equal(outs[2][:g2], want.view(g2, r.n).to(torch.uint32)):
            raise AssertionError(f"four-step polymul disagrees at n={r.n}")
    x_, a_, b_ = fs_in[0]
    same_as_golden(fs_out[0][0][:FS_GOLDEN_ROWS],
                   golden_fwd(x_[:FS_GOLDEN_ROWS], big.params), "Ring(2^16).ntt")
    same_as_golden(fdot[:FS_GOLDEN_ROWS],
                   golden_dot(fda[:FS_GOLDEN_ROWS], fdb[:FS_GOLDEN_ROWS],
                              big.params), "Ring(2^16).polydot")
    cft = cyc.fourstep
    if not (torch.equal(cz, cx) and torch.equal(
            cy, P.fwd_ntt_fourstep_plain(tiled(cx.to(torch.int64), cft), cft)
            .view(cx.shape).to(torch.uint32))):
        raise AssertionError("CyclicRing(2^16) ntt disagrees with its plain version")
    want = P.polymul_fourstep_plain(tiled(cx.to(torch.int64), cft),
                                    tiled(cb.to(torch.int64), cft), cft)
    if not torch.equal(cc, want.view(cx.shape).to(torch.uint32)):
        raise AssertionError("CyclicRing(2^16) polymul disagrees with its plain "
                             "version")
    if not torch.equal(rz4, fr):
        raise AssertionError("RNSRing(2^16) intt(ntt(x)) != x")
    for l, r in enumerate(frns.rings):
        ft = r.fourstep
        if not torch.equal(ry4[l], P.fwd_ntt_fourstep_plain(
                tiled(fr[l].to(torch.int64), ft), ft).view(fr[l].shape)
                .to(torch.uint32)):
            raise AssertionError(f"RNSRing(2^16).ntt channel {l} disagrees")
        want = P.polymul_fourstep_plain(tiled(fr[l].to(torch.int64), ft),
                                        tiled(fr2[l].to(torch.int64), ft), ft)
        if not torch.equal(rc4[l], want.view(fr[l].shape).to(torch.uint32)):
            raise AssertionError(f"RNSRing(2^16).polymul channel {l} disagrees")
    # the four-step transform at n = 32768 against the radix-2 kernels
    r2 = Ring(FS_CROSS_N, device=dev)
    r4 = Ring(FS_CROSS_N, method="fourstep", device=dev)
    xc = rand(gen, 4 * r2.q, (FS_CROSS_BATCH, FS_CROSS_N)).to(torch.uint32)
    yc = rand(gen, 2 * r2.q, (FS_CROSS_BATCH, FS_CROSS_N)).to(torch.uint32)
    if not (torch.equal(r4.ntt(xc), r2.ntt(xc))
            and torch.equal(r4.intt(yc), r2.intt(yc))):
        raise AssertionError("four-step n=32768 differs from the radix-2 kernels")
    del xc, yc
    log("four-step path: every output reduced, intt(ntt(x)) == x, the first rows "
        "equal the plain versions and at 2^16 the golden model; n=32768 "
        "four-step equals radix-2 at B=1024")

    # -- 3d. the flat layout, counted ------------------------------------------
    flat = Ring(1 << 16, fourstep_kernel="flat", device=dev)
    x_, a_, b_ = fs_in[0]
    torch.cuda.synchronize()
    for key in K.LAUNCHES:
        K.LAUNCHES[key] = 0
    fly = flat.ntt(x_)
    flz = flat.intt(fly)
    flc = flat.polymul(a_, b_)
    torch.cuda.synchronize()
    flat_launches = dict(K.LAUNCHES)
    log(f"main path: Ring(2^16, fourstep_kernel='flat') ntt+intt+polymul "
        f"(B={x_.shape[0]}); launches "
        f"{ {k: v for k, v in flat_launches.items() if v} }")
    missing = [key for key, c in FLAT.items() if flat_launches[c] < 1]
    if missing:
        raise AssertionError(f"flat path launched no {missing} kernel")
    ft = flat.fourstep
    x64, a64, b64 = (tiled(v.to(torch.int64), ft) for v in (x_, a_, b_))
    for key, got, tiled_out, want in (
        ("flat_fwd", fly, fs_out[0][0], P.fwd_ntt_fourstep_plain(x64, ft)),
        ("flat_inv", flz, fs_out[0][1],
         P.inv_ntt_fourstep_plain(tiled(fly.to(torch.int64), ft), ft)),
        ("flat_polymul", flc, fs_out[0][2],
         P.polymul_fourstep_plain(a64, b64, ft)),
    ):
        compare(key, tiled(got, ft), want, f"n=2^16 B={x_.shape[0]} flat")
        if not torch.equal(got, tiled_out):
            raise AssertionError(f"{key}: the flat ring differs from the tiled")
    del x64, a64, b64

    # -- 3e. the sharded ring and the DIT inverse, counted ---------------------
    from agilex_ntt_tpu_torch.parallel import ShardedRing, make_mesh

    sring = Ring(SHARD_N, device=dev)
    gen = torch.Generator(dev).manual_seed(20261019)
    sx, sa, sb = (sring.random_coeffs(gen, (SHARD_BATCH,)) for _ in range(3))
    # the unsharded ring's words (K1, K2, K3), before the counters start
    s_want = (sring.ntt(sx), sring.intt(sx), sring.polymul(sa, sb))
    one_card = [DEVICE + ":0"] * (SHARD_DP * SHARD_SP)
    srs = {comm: ShardedRing(sring, make_mesh(dp=SHARD_DP, sp=SHARD_SP,
                                              devices=one_card),
                             sp_axis="sp", sp_comm=comm)
           for comm in ("ppermute", "overlap")}
    fs_sr = ShardedRing(big, make_mesh(sp=SHARD_SP, devices=one_card),
                        dp_axis=None, sp_axis="sp")
    dot_sr = ShardedRing(ring, make_mesh(dp=SHARD_DOT_DP, devices=one_card))
    x_ = fs_in[0][0]
    torch.cuda.synchronize()
    for key in K.LAUNCHES:
        K.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    s_out = {comm: (sr.ntt(sx), sr.intt(sx), sr.polymul(sa, sb))
             for comm, sr in srs.items()}
    fs_sy = fs_sr.ntt(x_)
    fs_sz = fs_sr.intt(fs_sy)
    sdot = dot_sr.polydot(da, db)
    dits = [D.inv_ntt_dit(y, ring.params, factored=f) for f in (False, True)]
    torch.cuda.synchronize()
    slice_s = time.perf_counter() - t0
    slice_launches = dict(K.LAUNCHES)
    log(f"main path: ShardedRing(Ring({SHARD_N}), dp={SHARD_DP} x "
        f"sp={SHARD_SP} on one card) ntt+intt+polymul (B={SHARD_BATCH}) with "
        f"sp_comm ppermute and overlap, ShardedRing(Ring({SHARD_FS_N}), "
        f"sp={SHARD_SP}) ntt+intt (B={x_.shape[0]}, four-step), dp={SHARD_DOT_DP} "
        f"polydot (B={MAIN_DOT_BATCH}, k={MAIN_K}, n={MAIN_N}), inv_ntt_dit "
        f"direct and factored (B={MAIN_BATCH}, n={MAIN_N}) in "
        f"{slice_s * 1e3:.3f} ms (host clock); launches "
        f"{ {k: v for k, v in slice_launches.items() if v} }")
    missing = [key for key in SLICE + ("fwd", "inv", "polydot")
               if slice_launches[key] < 1]
    if missing:
        raise AssertionError(f"sharded path launched no {missing} kernel")
    for comm, outs in s_out.items():
        for what, got, want in zip(("ntt", "intt", "polymul"), outs, s_want):
            if not torch.equal(got, want):
                raise AssertionError(f"ShardedRing {what} ({comm}) differs "
                                     f"from Ring({SHARD_N})")
    if not (torch.equal(fs_sy, fs_out[0][0]) and torch.equal(fs_sz, x_)):
        raise AssertionError(f"four-step ShardedRing differs from "
                             f"Ring({SHARD_FS_N})")
    if not torch.equal(sdot, d):
        raise AssertionError("dp ShardedRing.polydot differs from Ring.polydot")
    for f, got in zip((False, True), dits):
        if not torch.equal(got, z):
            raise AssertionError(f"inv_ntt_dit (factored={f}) differs from "
                                 f"Ring.intt")
    del s_want, s_out, fs_sy, fs_sz, sdot, dits
    torch.cuda.empty_cache()
    log("sharded path: every ShardedRing output equals the unsharded ring's "
        "words (K1, K2, K3, K7, K6a), inv_ntt_dit equals Ring.intt")
    # K11 on one card: one launch a cross stage and sp group
    want_xchg = SHARD_DP * (SHARD_SP.bit_length() - 1)
    for comm, sr in srs.items():
        for what, call in (("ntt", lambda: sr.ntt(sx)),
                           ("intt", lambda: sr.intt(sx))):
            torch.cuda.synchronize()
            for key in K.LAUNCHES:
                K.LAUNCHES[key] = 0
            call()
            torch.cuda.synchronize()
            got = K.LAUNCHES["xchg_fwd"] + K.LAUNCHES["xchg_inv"]
            log(f"  ShardedRing.{what} ({comm}): {got} K11 launches "
                f"(dp={SHARD_DP} x {SHARD_SP.bit_length() - 1} cross stages)")
            if got != want_xchg:
                raise AssertionError(f"ShardedRing.{what} ({comm}) made {got} "
                                     f"K11 launches, not {want_xchg}")

    # -- 3f. RNS-CKKS on the n16384 chain, counted -----------------------------
    from agilex_ntt_tpu_torch.schemes import CKKSContext

    t3f = time.perf_counter()
    torch.cuda.synchronize()
    for key in K.LAUNCHES:
        K.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    ck = ckks_path(np, CKKSContext, dev)
    torch.cuda.synchronize()
    ckks_s = time.perf_counter() - t0
    ckks_launches = dict(K.LAUNCHES)
    log(f"main path: CKKSContext({KS_N}, L={KS_L}) keygen (steps {CKKS_STEPS}), "
        f"encode + encrypt of 3 x {CKKS_BATCH} ciphertexts, multiply, rescale, "
        f"rotate {CKKS_ROT}, conjugate, apply_linear over {CKKS_LIN}, "
        f"poly_eval power (degree {ck['degree']['power']}) and chebyshev "
        f"(degree {ck['degree']['chebyshev']}), and CKKSContext({MV_N}, "
        f"L={MV_L}) keygen, make_matvec ({ck['mv'].b} x {ck['mv'].g}) and "
        f"apply_matvec in {ckks_s:.3f} s (host clock); launches "
        f"{ {k: v for k, v in ckks_launches.items() if v} }")
    log(f"  the highest degree poly_eval reaches on {KS_L} levels (result at "
        f"level >= 2): power {ck['degree']['power']}, chebyshev "
        f"{ck['degree']['chebyshev']}")
    missing = [key for key in ("fwd_rns", "inv_rns", "polymul_rns")
               if ckks_launches[key] < 1]
    if missing:
        raise AssertionError(f"the CKKS path launched no {missing} kernel")
    ckks_decoded(np, torch, ck)
    t0 = time.perf_counter()
    twin = ckks_path(np, CKKSContext, "cpu", rows=1)
    twin_s = time.perf_counter() - t0
    n_keys = ckks_same_words(torch, ck, twin)
    log(f"CKKS path: {len(ck['expect'])} outputs decode within their "
        f"tolerances; {n_keys} key tensors, the encryptions and every op's "
        f"first ciphertext equal the CPU plain versions' word for word (CPU "
        f"twin {twin_s:.1f} s); phase 3f took {time.perf_counter() - t3f:.1f} s")
    del twin

    # -- 3g. RNS-BGV and RNS-BFV on the n16384 chain, counted ------------------
    from agilex_ntt_tpu_torch.schemes import BGVContext

    t3g = time.perf_counter()
    torch.cuda.synchronize()
    for key in K.LAUNCHES:
        K.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    ik = int_path(np, BGVContext, BFVContext, dev)
    torch.cuda.synchronize()
    int_s = time.perf_counter() - t0
    int_launches = dict(K.LAUNCHES)
    log(f"main path: BGVContext and BFVContext({KS_N}, L={KS_L}, t={INT_T}) "
        f"keygen (steps {INT_STEPS}), encode + encrypt of 2 x {INT_BATCH} "
        f"ciphertexts, multiply, square, rescale, rotate 1 and -1, the row "
        f"swap, apply_linear over {INT_LIN}; BGV poly_eval power (degree "
        f"{ik['degree']['power']}) and chebyshev (degree "
        f"{ik['degree']['chebyshev']}); BFV mod_down_to; BGVContext({MV_N}, "
        f"L={MV_L}, t={ik['mctx'].t}) keygen, make_matvec ({ik['mv'].b} x "
        f"{ik['mv'].g}) and apply_matvec; decrypt and decode of the first "
        f"{INT_DECODED} ciphertexts of each output, in {int_s:.3f} s (host "
        f"clock); launches { {k: v for k, v in int_launches.items() if v} }")
    missing = [key for key in ("fwd", "inv", "fwd_rns", "inv_rns",
                               "polymul_rns") if int_launches[key] < 1]
    if missing:
        raise AssertionError(f"the BGV/BFV path launched no {missing} kernel")
    int_decoded(np, torch, ik)
    t0 = time.perf_counter()
    itwin = int_path(np, BGVContext, BFVContext, "cpu", rows=1)
    itwin_s = time.perf_counter() - t0
    n_keys = int_same_words(torch, ik, itwin)
    log(f"BGV/BFV path: {len(ik['expect'])} outputs decode exactly to numpy's "
        f"slotwise results; {n_keys} key tensors, the encryptions and every "
        f"op's first ciphertext equal the CPU plain versions' word for word "
        f"(CPU twin {itwin_s:.1f} s); phase 3g took "
        f"{time.perf_counter() - t3g:.1f} s")
    del itwin

    # -- 3h. the sharded RNS ring and the schemes on a mesh, counted ---------
    from agilex_ntt_tpu_torch.parallel import ShardedRNSRing

    t3h = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(20261021)
    h_rings, h_layouts = {}, []
    for name, n_, L_, axes, skw, b_ in SHARD_RNS:
        if (n_, L_) not in h_rings:  # the two comms share a ring
            r_ = RNSRing(n_, L_, device=dev)
            qs_ = r_.qs
            ins = {  # the forward over [0, 4q), the inverse over [0, 2q)
                "ntt": (channels(gen, qs_, 4, (b_, n_)),),
                "intt": (channels(gen, qs_, 2, (b_, n_)),),
                "polymul": tuple(channels(gen, qs_, 1, (b_, n_))
                                 for _ in range(2)),
                "polydot": tuple(channels(gen, qs_, 1, (b_, SHARD_RNS_K, n_))
                                 for _ in range(2)),
            }
            ins = {op: tuple(v.to(torch.uint32) for v in vs)
                   for op, vs in ins.items()}
            if skw == {}:  # the dp ring: a remainder batch too
                for op in list(ins):
                    ins[op + " remainder"] = tuple(
                        v[:, :SHARD_RNS_REMAINDER] for v in ins[op])
            # the unsharded ring's words, before the counters start
            wants = {op: getattr(r_, op.split()[0])(*vs)
                     for op, vs in ins.items()}
            h_rings[(n_, L_)] = (r_, ins, wants)
        r_, ins, wants = h_rings[(n_, L_)]
        mesh_ = make_mesh(devices=[DEVICE + ":0"] * int(np.prod(
            list(axes.values()))), **axes)
        h_layouts.append((name, r_, ShardedRNSRing(r_, mesh_, **skw), ins,
                          wants))
    # the key switch of the n16384 chain (phase 3b's operands), dp=4
    kmesh = make_mesh(dp=SHARD_KS_DP, devices=[DEVICE + ":0"] * SHARD_KS_DP)
    sks = ShardedRNSRing(ks_ring, kmesh)
    sext = ShardedRNSRing(ext_ring, kmesh)
    bfv = ik["ctx"]["BFV"]
    hps_qs, hps_aux = bfv.qs[:KS_L], bfv._aux(KS_L)[0]
    hd = channels(gen, tuple(hps_qs) + hps_aux, 1,
                  (KS_BATCH, KS_N)).to(torch.uint32)
    xe = channels(gen, ext_qs, 1, (KS_BATCH, KS_N)).to(torch.uint32)
    lc1 = channels(gen, ks_qs, 1, (KS_BATCH, KS_N)).to(torch.uint32)
    lpts = channels(gen, ext_qs, 1, (len(KS_STEPS), KS_N)).movedim(0, 1)
    lka = channels(gen, ext_qs, 1, (len(KS_STEPS), dnum, KS_N)).movedim(0, 2)
    lpts, lka = (v.to(torch.uint32).contiguous() for v in (lpts, lka))
    ks_calls = {  # each a call on (the chain's ring, the ext basis's ring)
        "keyswitch": lambda r, e: r.keyswitch(ks_x, ksk, ext_ring, dnum),
        "hoisted_keyswitch": lambda r, e: r.hoisted_keyswitch(
            ks_x, ksks, KS_STEPS, ext_ring, dnum),
        "hoisted_linear_sum": lambda r, e: torch.stack(r.hoisted_linear_sum(
            ks_x, lc1, lpts, ksks, lka, KS_STEPS, ext_ring, dnum)),
        "gadget_decompose": lambda r, e: r.gadget_decompose(ks_x, ext_qs, dnum),
        "mod_down": lambda r, e: e.mod_down(xe, 1),
        "hps_scale_sk": lambda r, e: (
            r.hps_scale_sk(hd, hps_qs, hps_aux, INT_T) if r is sks
            else bfv._scale_down(hd, KS_L)),
    }
    ks_want = {name: call(ks_ring, ext_ring) for name, call in ks_calls.items()}
    from agilex_ntt_tpu_torch.schemes import BGVContext, CKKSContext

    smesh = make_mesh(dp=SHARD_KS_DP, devices=[DEVICE + ":0"] * SHARD_KS_DP)
    sch = mesh_schemes(np, (CKKSContext, BGVContext, BFVContext), ck, ik,
                       smesh, dev)
    torch.cuda.synchronize()
    for key in K.LAUNCHES:
        K.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    h_out = {(name, op): getattr(sr, op.split()[0])(*vs)
             for name, _, sr, ins, _ in h_layouts for op, vs in ins.items()}
    ks_out = {name: call(sks, sext) for name, call in ks_calls.items()}
    sch_out = {name: call() for name, (call, _, _, _) in sch.items()}
    torch.cuda.synchronize()
    h_s = time.perf_counter() - t0
    h_launches = dict(K.LAUNCHES)
    log(f"main path: ShardedRNSRing on one card: "
        + "; ".join(f"{name} (B={ins['ntt'][0].shape[1]})"
                    for name, _, _, ins, _ in h_layouts)
        + f", ntt, intt, polymul, polydot (k={SHARD_RNS_K}); the n16384 key "
        f"switch (dnum={dnum}, K={ext_k}, B={KS_BATCH}) at dp={SHARD_KS_DP}: "
        f"{', '.join(ks_calls)}; CKKS, BGV and BFV (t={INT_T}) with "
        f"mesh=make_mesh(dp={SHARD_KS_DP}): multiply, square, rotate 1, "
        f"rescale, apply_linear over {CKKS_LIN} / {INT_LIN}; in {h_s:.3f} s "
        f"(host clock); launches "
        f"{ {k: v for k, v in h_launches.items() if v} }")
    missing = [key for key in ("fwd_rns", "inv_rns", "polymul_rns",
                               "polydot_rns", "fwd", "inv", "xchg_fwd",
                               "xchg_inv") if h_launches[key] < 1]
    if missing:
        raise AssertionError(f"the sharded RNS path launched no {missing} "
                             "kernel")
    for name, _, _, ins, wants in h_layouts:
        for op in ins:
            if not torch.equal(h_out[(name, op)], wants[op]):
                raise AssertionError(f"ShardedRNSRing {name} {op} differs "
                                     "from the unsharded RNSRing's words")
    for name, want in ks_want.items():
        if not torch.equal(ks_out[name], want):
            raise AssertionError(f"ShardedRNSRing.{name} (dp={SHARD_KS_DP}) "
                                 "differs from RNSRing's words")
    for name, (_, want, _, _) in sch.items():
        got = sch_out[name]
        if not (torch.equal(got.c0, want.c0) and torch.equal(got.c1, want.c1)
                and (got.level, got.scale) == (want.level, want.scale)):
            raise AssertionError(f"{name} on the mesh differs from the "
                                 "unsharded context's words")
    # the first ciphertexts decode (BGV and BFV exactly)
    from agilex_ntt_tpu_torch.schemes.ckks import Ciphertext

    for name, (_, _, base, keys) in sch.items():
        scheme, op = name.split(" ", 1)
        ct = sch_out[name]
        head = Ciphertext(ct.c0[:, :INT_DECODED], ct.c1[:, :INT_DECODED],
                          ct.level, ct.scale)
        got = base.decode(base.decrypt(head, keys))
        if scheme == "CKKS":
            if op not in ("rescale", "rotate 1"):
                continue
            _, _, _, want, tol = ck["expect"][op]
            err = float(np.abs(got - want[:INT_DECODED]).max())
            log(f"  {name} on the mesh: max error {err:.3g} (tolerance {tol})")
            if err > tol:
                raise AssertionError(f"{name} on the mesh does not decode")
        else:
            want = ik["expect"][name][1][:INT_DECODED]
            bad = int((got != want).sum())
            log(f"  {name} on the mesh: {bad} of {got.size} slots differ "
                "from numpy")
            if bad:
                raise AssertionError(f"{name} on the mesh does not decode")
    log(f"sharded RNS path: every ShardedRNSRing output ({len(h_out)} ring "
        f"calls, {len(ks_out)} key-switch calls) equals the unsharded "
        f"RNSRing's words, every scheme op on the mesh ({len(sch_out)}) the "
        f"unsharded context's; phase 3h took {time.perf_counter() - t3h:.1f} s")
    del h_out, ks_out, sch_out
    torch.cuda.empty_cache()

    # -- 3i. the wide ring (q < 2^62 on u64 kernels) ---------------------------
    t3i = time.perf_counter()
    from agilex_ntt_tpu_torch import WideRing
    from agilex_ntt_tpu_torch.ops import wide as WD
    from agilex_ntt_tpu_torch.ops import wide_kernel as WK

    def wide_rand(gen, top, shape):
        """(lo, hi) uint32 words below ``top`` (< 2^64): hi below top >> 32,
        with top - 1 at word 0 and 0 at word 1."""
        lo = torch.randint(0, 1 << 32, shape, generator=gen,
                           dtype=torch.int64, device=dev)
        hi = torch.randint(0, top >> 32, shape, generator=gen,
                           dtype=torch.int64, device=dev)
        lo.view(-1)[0], hi.view(-1)[0] = (top - 1) & 0xFFFFFFFF, (top - 1) >> 32
        lo.view(-1)[1] = hi.view(-1)[1] = 0
        return lo.to(torch.uint32), hi.to(torch.uint32)

    def wide_pair(words):
        """numpy uint64 -> (lo, hi) uint32 words on the card."""
        return tuple(torch.from_numpy(t).to(dev) for t in WD.split_u64_np(words))

    def wide_u64(pair, rows=None):
        """(lo, hi) words -> numpy uint64 (the first ``rows`` rows)."""
        lo, hi = (t[:rows] if rows else t for t in pair)
        return WD.join_u64_np(lo.cpu().numpy(), hi.cpu().numpy())

    def i64(pair):
        return tuple(t.to(torch.int64) for t in pair)

    def wide_calls(wr, ins):
        """WideRing's public calls of the wide path on pair I/O."""
        return {"ntt": lambda: wr.ntt(ins["x"]),
                "intt": lambda: wr.intt(ins["y"]),
                "polymul": lambda: wr.polymul(ins["a"], ins["b"]),
                "pointwise_mul": lambda: wr.pointwise_mul(ins["a"], ins["b"]),
                "add": lambda: wr.add(ins["a"], ins["b"]),
                "sub": lambda: wr.sub(ins["a"], ins["b"])}

    def wide_plain(wr, ins):
        """The same calls by the plain version (ops/wide.py) on the card."""
        tabs = wr.tables
        a, b = i64(ins["a"]), i64(ins["b"])
        fa, fb = (WK.wide_fwd_plain(v, tabs) for v in (a, b))
        mont = WK.wide_pointwise_plain(fa, fb, tabs, "mont")
        return {"ntt": WK.wide_fwd_plain(i64(ins["x"]), tabs),
                "intt": WK.wide_inv_plain(i64(ins["y"]), tabs, wr.n_inv),
                "polymul": WK.wide_inv_plain(mont, tabs, wr.polymul_scale),
                "pointwise_mul": WK.wide_pointwise_plain(a, b, tabs, "exact"),
                "add": WK.wide_pointwise_plain(a, b, tabs, "add"),
                "sub": WK.wide_pointwise_plain(a, b, tabs, "sub")}

    def wide_compare(key, got, want, note):
        """Kernel words against the plain version's, every word."""
        diff = [(g.to(torch.int64) - w).abs() for g, w in zip(got, want)]
        bad_words = (diff[0] != 0) | (diff[1] != 0)
        bad = int(bad_words.sum())
        err = 0
        if bad:
            g_, w_ = (WD.join_u64_np(*(t[bad_words].cpu().numpy().astype(
                np.uint32) for t in pair)) for pair in (got, want))
            err = max(abs(int(u) - int(v)) for u, v in zip(g_, w_))
        worst[key] = max(worst[key], err)
        mismatched[key] += bad
        log(f"  {key:14s} {note:44s} max_abs_err={err} mismatches={bad}")
        if bad:
            raise AssertionError(f"{key} disagrees with its plain version at "
                                 f"{note}")

    def wide_path():
        """Phase 3i's main path and checks, in a scope of their own (the
        later phases read names of the earlier ones): the rings and their
        inputs, and the launches of the counted run."""
        wide_cases = []  # (label, ring, inputs, KAT words or None)
        for n_, bits, b_ in WIDE_RINGS:
            wr = WideRing(n_, None if bits == 62 else
                          find_primes(n_, 1, bits=bits)[0], device=dev)
            gen = torch.Generator(dev).manual_seed(n_ + bits)
            q_ = wr.q
            ins = {"x": wide_rand(gen, 4 * q_, (b_, n_)),  # the lazy forward range
                   "y": wide_rand(gen, 2 * q_, (b_, n_)),  # the lazy inverse range
                   "a": wide_rand(gen, q_, (b_, n_)),
                   "b": wide_rand(gen, q_, (b_, n_))}
            wide_cases.append((f"n={n_} {q_.bit_length()}-bit q B={b_}", wr, ins,
                               None))
        kat = np.load(WIDE_KAT)
        for bits in (45, 62):
            wr = WideRing(1024, int(kat[f"w{bits}_q"]),
                          psi=int(kat[f"w{bits}_psi"]), device=dev)
            words = {k: kat[f"w{bits}_{k}"][None]
                     for k in ("input", "ntt", "pm_a", "pm_b", "pm_c")}
            ins = {"x": wide_pair(words["input"]), "y": wide_pair(words["ntt"]),
                   "a": wide_pair(words["pm_a"]), "b": wide_pair(words["pm_b"])}
            wide_cases.append((f"KAT w{bits} n=1024", wr, ins, words))
        torch.cuda.synchronize()
        for key in K.LAUNCHES:
            K.LAUNCHES[key] = 0
        t0 = time.perf_counter()
        wide_out, ran = [], []  # ran: (label, op, that call's launches)

        def counted(label, op, call):
            before = dict(K.LAUNCHES)
            out = call()
            ran.append((label, op, {k: v - before[k]
                                    for k, v in K.LAUNCHES.items()
                                    if v != before[k]}))
            return out

        for label, wr, ins, _ in wide_cases:
            wide_out.append({op: counted(label, op, call)
                             for op, call in wide_calls(wr, ins).items()})
        # the numpy uint64 I/O of the known-answer vectors, split and joined on
        # the host
        kat_out = {label: (wr.ntt(words["input"]), wr.intt(words["ntt"]),
                           wr.polymul(words["pm_a"], words["pm_b"]))
                   for label, wr, _, words in wide_cases if words is not None}
        torch.cuda.synchronize()
        wide_s = time.perf_counter() - t0
        wide_launches = dict(K.LAUNCHES)
        log(f"main path: WideRing {', '.join(WIDE_OPS)} on pair I/O at "
            + "; ".join(label for label, _, _, _ in wide_cases)
            + f", and the KAT vectors on numpy uint64 I/O; in {wide_s:.3f} s "
            f"(host clock); launches {({k: v for k, v in wide_launches.items() if v})}")
        missing = [key for key in ("wide_fwd", "wide_inv", "wide_pointwise")
                   if wide_launches[key] < 1]
        if missing:
            raise AssertionError(f"the wide path launched no {missing} kernel")
        # each call's launches: a transform is one cluster launch through n =
        # 65536 and one pass in device memory more at 2^17; polymul is two
        # forward transforms, the Montgomery product and the inverse
        rings = {label: wr for label, wr, _, _ in wide_cases}
        for label, op, got in ran:
            wr = rings[label]
            t = 1 + (wr.n > 1 << 16)
            want = {"ntt": {"wide_fwd": t}, "intt": {"wide_inv": t},
                    "polymul": {"wide_fwd": 2 * t, "wide_pointwise": 1,
                                "wide_inv": t}}.get(op, {"wide_pointwise": 1})
            info = WK.wide_launch_info(wr.tables, "wide_fwd", 1)
            if got != want or info["passes"] != t - 1:
                raise AssertionError(f"WideRing {label} {op}: launches {got}, "
                                     f"expected {want} ({info['passes']} "
                                     "passes in device memory)")
        log(f"wide launches asserted for each of the {len(ran)} calls: a "
            "transform one launch through n = 65536, two at 2^17")
        log("wide kernels vs plain versions (tolerance 0), first rows vs golden:")
        for (label, wr, ins, words), outs in zip(wide_cases, wide_out):
            want = wide_plain(wr, ins)
            for op in WIDE_OPS:
                key = {"ntt": "wide_fwd", "intt": "wide_inv"}.get(op,
                                                                  "wide_pointwise")
                wide_compare(key, outs[op], want[op], f"{label} {op}")
            del want
            # the polymul's Montgomery product alone, on the plain transforms
            tabs = wr.tables
            fa, fb = (WK.wide_fwd_plain(i64(ins[v]), tabs) for v in ("a", "b"))
            got = WK.wide_pointwise(tuple(t.to(torch.uint32) for t in fa),
                                    tuple(t.to(torch.uint32) for t in fb), tabs,
                                    "mont")
            wide_compare("wide_pointwise", got,
                         WK.wide_pointwise_plain(fa, fb, tabs, "mont"),
                         f"{label} mont")
            del fa, fb, got
            g = WIDE_GOLDEN_ROWS
            x_, y_, a_, b_ = (wide_u64(ins[v], g) for v in ("x", "y", "a", "b"))
            q_obj = wr.q
            fa_g = G.fwd_ntt_u64(a_, wr.params).astype(object)
            fb_g = G.fwd_ntt_u64(b_, wr.params).astype(object)
            golden = {
                "ntt": G.fwd_ntt_u64(x_, wr.params),
                "intt": G.inv_ntt_u64(y_, wr.params),
                "polymul": G.inv_ntt_u64((fa_g * fb_g % q_obj).astype(np.uint64),
                                         wr.params),
                "pointwise_mul": (a_.astype(object) * b_.astype(object)
                                  % q_obj).astype(np.uint64),
                "add": ((a_.astype(object) + b_.astype(object))
                        % q_obj).astype(np.uint64),
                "sub": ((a_.astype(object) - b_.astype(object))
                        % q_obj).astype(np.uint64),
            }
            for op, want_rows in golden.items():
                if not np.array_equal(wide_u64(outs[op], g), want_rows):
                    raise AssertionError(f"WideRing {label} {op} disagrees with "
                                         "the golden model")
            if words is not None:
                for what, got_, want_ in zip(
                        ("ntt", "intt", "polymul"), kat_out[label],
                        (words["ntt"], words["input"], words["pm_c"])):
                    if got_.dtype != np.uint64 or not np.array_equal(got_, want_):
                        raise AssertionError(f"WideRing {label} {what} disagrees "
                                             "with the known-answer vector")
                    if not np.array_equal(wide_u64(outs[what]), got_):
                        raise AssertionError(f"WideRing {label} {what}: numpy "
                                             "and pair I/O differ")
        log(f"wide path: every WideRing output equals the plain version's words "
            f"and, on {WIDE_GOLDEN_ROWS} rows, the golden model's; the KAT "
            f"vectors match; phase 3i took {time.perf_counter() - t3i:.1f} s")
        return wide_cases, wide_launches

    wide_cases, wide_launches = wide_path()
    torch.cuda.empty_cache()

    # -- 3j. the tooling and entry points -------------------------------------
    def tooling_path():
        """Phase 3j: the presets against the golden model, the autotuner
        into a temporary cache and ``Ring(method="auto")`` reading it, the
        three timers side by side, the report's rows, and every example."""
        from agilex_ntt_tpu_torch import examples
        from agilex_ntt_tpu_torch.models import PRESETS, preset_ring, preset_rns
        from agilex_ntt_tpu_torch.utils import autotune, report

        t3j = time.perf_counter()
        g = GOLDEN_ROWS
        log(f"presets: Ring and RNSRing of each on the card, ntt, intt and "
            f"polymul at B={PRESET_BATCH}, the first {g} rows (each channel's) "
            "against the golden model:")
        for name, p in PRESETS.items():
            one, rns_ = preset_ring(name, device=dev), preset_rns(name, device=dev)
            gen = torch.Generator(dev).manual_seed(p.n)
            for label, ring_, chans in (
                    (f"Ring q={one.q}", one, [one.params]),
                    (f"RNSRing L={rns_.L}", rns_, [r.params for r in rns_.rings])):
                shape = (len(chans), PRESET_BATCH, p.n)
                a_, b_ = (torch.stack([rand(gen, c.q, shape[1:]) for c in chans])
                          .to(torch.uint32).view(shape[1:] if ring_ is one else shape)
                          for _ in range(2))
                fa = ring_.ntt(a_)
                outs = {"ntt": fa, "intt": ring_.intt(fa),
                        "polymul": ring_.polymul(a_, b_)}

                def rows(t, ch):  # channel ch's first g rows on the host
                    return t.reshape(shape)[ch, :g].cpu().numpy().astype(np.uint64)

                for ch, params in enumerate(chans):
                    q64 = np.uint64(params.q)
                    want_f = G.fwd_ntt_u64(rows(a_, ch), params)
                    want = {"ntt": want_f,
                            "intt": G.inv_ntt_u64(want_f, params),
                            "polymul": G.inv_ntt_u64(
                                want_f * G.fwd_ntt_u64(rows(b_, ch), params) % q64,
                                params)}
                    for what, got_ in outs.items():
                        if not np.array_equal(rows(got_, ch), want[what]):
                            raise AssertionError(
                                f"preset {name} {label} channel {ch} {what} "
                                "disagrees with the golden model")
            log(f"  {name:7s} n={p.n:5d} L={p.num_primes} ({p.note}): Ring and "
                f"RNSRing ntt, intt, polymul equal the golden model")

        with tempfile.TemporaryDirectory() as td:
            cache = os.path.join(td, "autotune.json")
            os.environ["NTT_TORCH_AUTOTUNE_CACHE"] = cache
            try:
                log("autotune.tune into a temporary cache (default timer: the "
                    "least of 3 device_time runs; ms a call):")
                winners = {}
                for n_, b_ in TUNE_SHAPES:
                    for op in autotune._OPS:
                        r = autotune.tune(n_, b_, op, cache_path=cache,
                                          device=dev)
                        cands = "; ".join(
                            f"{c['config']['method']} "
                            + (f"{c['seconds'] * 1e3:.4f}" if c["seconds"]
                               is not None else f"FAILED {c['error']}")
                            for c in r["candidates"])
                        log(f"  {op:7s} n={n_:5d} B={b_:4d}: {cands} -> "
                            f"{r['config']['method']}")
                        failed = [c for c in r["candidates"]
                                  if c["seconds"] is None]
                        if failed:
                            raise AssertionError(f"autotune candidates failed "
                                                 f"at {op} n={n_}: {failed}")
                        winners[(op, n_)] = r["config"]["method"]
                log('Ring(n, method="auto") on that cache: its route, its '
                    "launches of one ntt, its words against the default ring's:")
                for n_, b_ in TUNE_SHAPES:
                    auto = Ring(n_, method="auto", device=dev)
                    if auto.method != winners[("ntt", n_)]:
                        raise AssertionError(
                            f"Ring({n_}, method='auto') took {auto.method}, the "
                            f"cache's winner is {winners[('ntt', n_)]}")
                    plain_ring = Ring(n_, device=dev)
                    x_ = rand(torch.Generator(dev).manual_seed(n_), auto.q,
                              (b_, n_)).to(torch.uint32)
                    torch.cuda.synchronize()
                    for key in K.LAUNCHES:
                        K.LAUNCHES[key] = 0
                    y_auto = auto.ntt(x_)
                    torch.cuda.synchronize()
                    seen = {k: v for k, v in K.LAUNCHES.items() if v}
                    want_keys = ({"fwd"} if auto.method == "radix2"
                                 else {"fwd4"})
                    if set(seen) != want_keys:
                        raise AssertionError(
                            f"Ring({n_}, method='auto') ({auto.method}) "
                            f"launched {seen}, not {want_keys}")
                    if not torch.equal(y_auto, plain_ring.ntt(x_)):
                        raise AssertionError(
                            f"Ring({n_}, method='auto').ntt differs from the "
                            "default ring's")
                    log(f"  n={n_:5d}: {auto.method} (default "
                        f"{plain_ring.method}), launches {seen} "
                        f"({'K1' if auto.method == 'radix2' else 'K7a'}), "
                        "words equal to the default ring's")
            finally:
                del os.environ["NTT_TORCH_AUTOTUNE_CACHE"]

            log("report.kernel_report (H100 SXM derivation constants):")
            for n_, b_ in REPORT_SHAPES:
                for line in report.format_rows(
                        report.kernel_report(n_, b_, out_dir=td, device=dev)):
                    log(f"  {line}")

        log("examples, each through its main on the card (wall seconds, its "
            "last line):")
        for name in examples.NAMES:
            mod = importlib.import_module(f"agilex_ntt_tpu_torch.examples.{name}")
            out = io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(out):
                    mod.main(["--device", "cuda"])
                torch.cuda.synchronize()
            except BaseException:
                log(f"  example {name} failed; its output:\n{out.getvalue()}")
                raise
            last = out.getvalue().strip().splitlines()[-1]
            log(f"  {name:22s} rc 0 in {time.perf_counter() - t0:.2f} s: {last}")
        log(f"phase 3j took {time.perf_counter() - t3j:.1f} s")

    tooling_path()
    torch.cuda.empty_cache()

    # -- 3k. the sharded ring with one process a card ------------------------
    def multihost_path():
        """Phase 3k in its own scope; returns the launches summed over
        the processes."""
        from agilex_ntt_tpu_torch.utils import multihost_probe as MP

        t3k = time.perf_counter()
        # (processes, backend, ShardedRing plan, RNS layouts, every device
        # cuda:0?, devices a process)
        worlds = [(2, "gloo", MP.ONE_CARD_PLAN, MP.RNS_ONE_CARD, True, 1),
                  (2, "gloo", MP.PAIR_PLAN, MP.RNS_PAIR_ONE_CARD, True, 2)]
        if torch.cuda.device_count() >= 4:
            worlds += [(4, "nccl", MP.FOUR_CARD_PLAN,
                        MP.RNS_FOUR_CARD + MP.CH_FOUR_CARD, False, 1),
                       (2, "nccl", MP.PAIR_PLAN, MP.RNS_PAIR, False, 2)]
        k_launches = dict.fromkeys(K.LAUNCHES, 0)
        for procs, backend, plan, layouts, one_card, per in worlds:
            tw = time.perf_counter()
            log(f"backend {backend}")
            log(f"world size {procs}, {per} device(s) a process: layouts "
                f"{[layout[0] for layout in layouts]}")
            log(card)
            if one_card:
                log("every device of every process cuda:0: gloo, each "
                    "transfer staged through pinned host memory "
                    "(comm.stages_through_host)")
            # check_calls raises when a call's K1, K2 or K11 launches are
            # not the expected ones (with two cards a process, one K11
            # launch a card a cross stage: K11 reading its partner on the
            # process's other card); check_rns raises when a call differs
            # from the unsharded one, when a layout launched none of its
            # kernels (MP.MULTI_PRIME at dp and on the ch blocks, K4a and
            # K4b on chsp, MP.STAGE_SP under sp) and when a process
            # allocated on a card not its own
            results = MP.run_world(procs, backend, MP.check_world, plan,
                                   layouts, one_card=one_card, cards=per)
            ring_seen = [r["ring"] for r in results]
            rns_seen = [r["rns"] for r in results]
            if one_card and not all(
                    r["staged"] and r["device"] == DEVICE + ":0"
                    for r in ring_seen + rns_seen):
                raise AssertionError("the one-card world did not run on "
                                     "cuda:0 with its transfers staged "
                                     "through the host")
            for key, count in MP.report_checks(ring_seen).items():
                k_launches[key] += count
            k_rns = MP.report_rns(rns_seen)
            log(f"ShardedRNSRing and the schemes ({procs} processes of "
                f"{per} device(s), {backend}): launches over the processes "
                f"{k_rns}; world {time.perf_counter() - tw:.1f} s")
            for key, count in k_rns.items():
                k_launches[key] += count
        missing = [key for key in ("fwd", "inv", "xchg_fwd", "xchg_inv")
                   + MP.MULTI_PRIME if k_launches[key] < 1]
        if missing:
            raise AssertionError(f"the processes launched no {missing} "
                                 "kernel")
        log(f"phase 3k: every process's global result equals the unsharded "
            f"ring's or context's words (and, for ShardedRing, the plain "
            f"version's first rows); launches over the processes "
            f"{({k: v for k, v in k_launches.items() if v})}; "
            f"phase 3k took {time.perf_counter() - t3k:.1f} s")
        return k_launches

    k_launches = multihost_path()

    # -- 3l. the matrix-product four-step transform (M1) ----------------------
    from agilex_ntt_tpu_torch.ops import mxu_ntt as MX
    from agilex_ntt_tpu_torch.utils import mxu_probe as MXP

    def mxu_path():
        """Phase 3l in its own scope: ``fwd_ntt_fourstep_mxu``,
        ``fwd_col_pass_mxu`` and the row pass at MXU_PATH and MXU_CHECKS,
        counted; every pass against its plain version and every transform
        against ``Ring.ntt``.  Returns the counted run's launches and the
        main shape's ring and input for phase 4."""
        t3l = time.perf_counter()
        cases = []  # (label, ring, x (B, n) over [0, 4q), g (B, n1, n2) < q)
        for kind, n_, b_ in MXU_PATH + MXU_CHECKS:
            r_ = (CyclicRing if kind == "cyclic" else Ring)(
                n_, method="fourstep", device=dev)
            gen = torch.Generator(dev).manual_seed(n_ + b_)
            x_ = rand(gen, 4 * r_.q, (b_, n_))
            x_[0, 0], x_[0, 1], x_[-1, -1] = 4 * r_.q - 1, 0, r_.q
            g_ = rand(gen, r_.q, (b_, r_.plan.n1, r_.plan.n2))
            g_[0, 0, 0] = r_.q - 1
            cases.append((f"{kind} n={n_} ({r_.plan.n1}x{r_.plan.n2}) "
                          f"B={b_}", r_, x_.to(torch.uint32),
                          g_.to(torch.uint32)))
        tables = [MX.mxu_tables(r_.plan, dev) for _, r_, _, _ in cases]
        torch.cuda.synchronize()
        for key in K.LAUNCHES:
            K.LAUNCHES[key] = 0
        t0 = time.perf_counter()
        outs = [(MX.fwd_ntt_fourstep_mxu(x_, r_.plan),
                 MX.fwd_col_pass_mxu(x_.view(g_.shape), r_.plan),
                 MX.mxu_pass(g_, mt, row=True))
                for (_, r_, x_, g_), mt in zip(cases, tables)]
        torch.cuda.synchronize()
        mxu_s = time.perf_counter() - t0
        mxu_launches = dict(K.LAUNCHES)
        log(f"main path: fwd_ntt_fourstep_mxu, fwd_col_pass_mxu and the row "
            f"pass at " + "; ".join(c[0] for c in cases) + f" in {mxu_s:.3f} "
            f"s (host clock); launches "
            f"{({k: v for k, v in mxu_launches.items() if v})}")
        want = {"mxu": 4 * len(cases)}
        if {k: v for k, v in mxu_launches.items() if v} != want:
            raise AssertionError(f"the matrix-product path launched "
                                 f"{mxu_launches}, expected {want}: two M1 "
                                 "launches a transform, one a pass")
        log("M1 vs its plain version (tolerance 0), the transforms vs "
            "Ring.ntt:")
        for (label, r_, x_, g_), mt, (full, col, row) in zip(cases, tables,
                                                             outs):
            x3 = x_.view(g_.shape).to(torch.int64)
            col_want = MX.col_pass_plain(x3, mt)
            compare("mxu", col, col_want, f"{label} col")
            compare("mxu", row, MX.row_pass_plain(g_.to(torch.int64), mt),
                    f"{label} row")
            compare("mxu", full, MX.row_pass_plain(col_want, mt).view(
                x_.shape), f"{label} transform")
            if not torch.equal(full, r_.ntt(x_)):
                raise AssertionError(f"fwd_ntt_fourstep_mxu {label} differs "
                                     "from Ring.ntt")
            del x3, col_want
        log(f"matrix-product path: every M1 pass equals its plain version "
            f"and every transform Ring.ntt's words; phase 3l took "
            f"{time.perf_counter() - t3l:.1f} s")
        return mxu_launches, cases[0][1:3]

    mxu_launches, mxu_main = mxu_path()
    torch.cuda.empty_cache()
    log(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")

    # -- 4. timing at the main shapes -----------------------------------------
    tabs = ring.tables
    x64, c64 = x.to(torch.int64), c.to(torch.int64)
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    da64, db64 = da.to(torch.int64), db.to(torch.int64)
    n, bsz, k, dbsz = MAIN_N, MAIN_BATCH, MAIN_K, MAIN_DOT_BATCH
    timed = {
        "fwd": (lambda: K.fwd_ntt(x, tabs),
                lambda: P.fwd_ntt_plain(x64, tabs),
                2 * bsz * n, fwd_ops(bsz, n), f"(B={bsz}, n={n})"),
        "inv": (lambda: K.inv_ntt(c, tabs),
                lambda: P.inv_ntt_plain(c64, tabs),
                2 * bsz * n, inv_ops(bsz, n), f"(B={bsz}, n={n})"),
        "polymul": (lambda: K.polymul_fused(a, b, tabs),
                    lambda: P.polymul_plain(a64, b64, tabs),
                    3 * bsz * n, dot_ops(bsz, 1, n), f"(B={bsz}, n={n}) x2"),
        "polydot": (lambda: K.polydot_fused(da, db, tabs),
                    lambda: P.polydot_plain(da64, db64, tabs),
                    (2 * k + 1) * dbsz * n, dot_ops(dbsz, k, n),
                    f"(B={dbsz}, k={k}, n={n}) x2"),
    }
    rtabs, etabs = rns.tables, ext_ring.tables
    rx64, rc64 = rx.to(torch.int64), rc.to(torch.int64)
    ra64, rb64 = ra.to(torch.int64), rb.to(torch.int64)
    # the key-switch dot's operands: (K, B, dnum, n) digits against the key
    dig = channels(gen, ext_qs, 1, (KS_BATCH, dnum, KS_N))
    kdot = ksk.to(torch.int64).movedim(0, -2)[:, None].expand(
        ext_k, KS_BATCH, dnum, KS_N).contiguous()
    dig32, kdot32 = dig.to(torch.uint32), kdot.to(torch.uint32)
    L, rb_, rn = RNS_L, RNS_BATCH, RNS_N
    # a transform reads two twiddle tables of n words a channel (roots and
    # their Shoup words, or the inverse's), the polymul both transforms' four
    tab_words = 2 * rn
    timed.update({
        "fwd_rns": (lambda: K.fwd_ntt_rns(rx, rtabs),
                    lambda: P.fwd_ntt_rns_plain(rx64, rtabs),
                    L * (2 * rb_ * rn + tab_words), scaled(L, fwd_ops(rb_, rn)),
                    f"(L={L}, B={rb_}, n={rn})"),
        "inv_rns": (lambda: K.inv_ntt_rns(rc, rtabs),
                    lambda: P.inv_ntt_rns_plain(rc64, rtabs),
                    L * (2 * rb_ * rn + tab_words), scaled(L, inv_ops(rb_, rn)),
                    f"(L={L}, B={rb_}, n={rn})"),
        "polymul_rns": (lambda: K.polymul_rns_fused(ra, rb, rtabs),
                        lambda: P.polymul_rns_plain(ra64, rb64, rtabs),
                        L * (3 * rb_ * rn + 2 * tab_words),
                        scaled(L, dot_ops(rb_, 1, rn)),
                        f"(L={L}, B={rb_}, n={rn}) x2"),
        "polydot_rns": (lambda: K.polydot_rns_fused(dig32, kdot32, etabs),
                        lambda: P.polydot_rns_plain(dig, kdot, etabs),
                        ext_k * ((2 * dnum + 1) * KS_BATCH * KS_N + 4 * KS_N),
                        scaled(ext_k, dot_ops(KS_BATCH, dnum, KS_N)),
                        f"(K={ext_k}, B={KS_BATCH}, k={dnum}, n={KS_N}) x2"),
    })

    # the four-step kernels: K7a, K7b, K8 at n=2^16 (B=512), K9a, K9b at
    # n=2^21 (B=16), the flat layout's calls (K10a-c) at n=2^16 through
    # Ring(fourstep_kernel="flat"); bytes: each operand read once and
    # written once, and the twiddle, column and row tables once a call
    def fs_words(ft, operands: int, batch: int, tables: int = 1,
                 rows_: bool = True):
        tab = 2 * ft.n + 2 * ft.n1 + (2 * ft.n2 if rows_ else 0)
        return operands * batch * ft.n + tables * tab

    def fs_operands(i):
        ft = fs_rings[i].fourstep
        x_, a_, b_ = (tiled(v, ft) for v in fs_in[i])
        y_ = tiled(fs_out[i][0], ft)
        return ft, (x_, a_, b_, y_), tuple(v.to(torch.int64)
                                           for v in (x_, a_, b_, y_))

    f16, (x16, a16, b16, y16), (x16l, a16l, b16l, y16l) = fs_operands(0)
    f21, (x21, _, _, y21), (x21l, _, _, y21l) = fs_operands(3)
    b16n, b21n = x16.shape[0], x21.shape[0]
    s16 = f"(B={b16n}, {f16.n1}x{f16.n2})"
    s21 = f"(B={b21n}, {f21.n1}x{f21.n2})"
    flat_x = [v.view(b16n, f16.n) for v in (x16, a16, b16, y16)]
    timed.update({
        "fwd4": (lambda: K.fwd_ntt_fourstep(x16, f16),
                 lambda: P.fwd_ntt_fourstep_plain(x16l, f16),
                 fs_words(f16, 2, b16n), fwd4_ops(b16n, f16.n1, f16.n2), s16),
        "inv4": (lambda: K.inv_ntt_fourstep(y16, f16),
                 lambda: P.inv_ntt_fourstep_plain(y16l, f16),
                 fs_words(f16, 2, b16n), inv4_ops(b16n, f16.n1, f16.n2), s16),
        "polymul4": (lambda: K.polymul_fourstep_fused(a16, b16, f16),
                     lambda: P.polymul_fourstep_plain(a16l, b16l, f16),
                     fs_words(f16, 3, b16n, 2),
                     polymul4_ops(b16n, f16.n1, f16.n2), s16 + " x2"),
        "col_fwd": (lambda: K.fwd_col_fourstep(x21, f21),
                    lambda: P.fwd_col_fourstep_plain(x21l, f21),
                    fs_words(f21, 2, b21n, rows_=False),
                    fwd4_ops(b21n, f21.n1, f21.n2, rows=False), s21),
        "col_inv": (lambda: K.inv_col_fourstep(y21, f21),
                    lambda: P.inv_col_fourstep_plain(y21l, f21),
                    fs_words(f21, 2, b21n, rows_=False),
                    inv4_ops(b21n, f21.n1, f21.n2, rows=False), s21),
        "flat_fwd": (lambda: flat.ntt(flat_x[0]),
                     lambda: P.fwd_ntt_fourstep_plain(x16l, f16),
                     fs_words(f16, 2, b16n), fwd4_ops(b16n, f16.n1, f16.n2),
                     f"(B={b16n}, n={f16.n}) flat"),
        "flat_inv": (lambda: flat.intt(flat_x[3]),
                     lambda: P.inv_ntt_fourstep_plain(y16l, f16),
                     fs_words(f16, 2, b16n), inv4_ops(b16n, f16.n1, f16.n2),
                     f"(B={b16n}, n={f16.n}) flat"),
        "flat_polymul": (lambda: flat.polymul(flat_x[1], flat_x[2]),
                         lambda: P.polymul_fourstep_plain(a16l, b16l, f16),
                         fs_words(f16, 3, b16n, 2),
                         polymul4_ops(b16n, f16.n1, f16.n2),
                         f"(B={b16n}, n={f16.n}) x2 flat"),
    })
    # K12 at the main shape on Ring.ntt's words (any words below 2q), K11
    # on one shard of the sharded path
    dt4 = D._dit_tables(ring.params, dev)
    y64 = y.to(torch.int64)
    gen = torch.Generator(dev).manual_seed(90)
    xq = Ring(SHARD_N, device=dev).q
    xs_ = [rand(gen, 2 * xq, (XCHG_ROWS, XCHG_WIDTH)) for _ in range(2)]
    xw = rand(gen, xq, (XCHG_WIDTH,))
    xw_p = (xw << 32) // xq
    x32s = [t.to(torch.uint32) for t in xs_ + [xw, xw_p]]
    words_x = 3 * XCHG_ROWS * XCHG_WIDTH + 2 * XCHG_WIDTH
    xshape = f"(B={XCHG_ROWS}, S={XCHG_WIDTH})"
    timed.update({
        "dit_inv": (lambda: K.dit_inv_core(y, dt4),
                    lambda: P.dit_inv_core_plain(y64, dt4),
                    2 * bsz * n + 6 * n,
                    ops_sum((1, butterflies(bsz, n)), (bsz * n, OPS_SHOUP),
                            (bsz * n, OPS_SCALE_REDUCE)), f"(B={bsz}, n={n})"),
        "xchg_fwd": (lambda: K.xchg_step(*x32s, q=xq, fwd=True, is_u=True),
                     lambda: P.fwd_stage_step_plain(*xs_, True, xw, xw_p, xq),
                     words_x, scaled(XCHG_ROWS * XCHG_WIDTH, OPS_XCHG_FWD),
                     xshape + " u"),
        "xchg_inv": (lambda: K.xchg_step(*x32s, q=xq, fwd=False, is_u=False),
                     lambda: P.inv_stage_step_plain(*xs_, False, xw, xw_p, xq),
                     words_x, scaled(XCHG_ROWS * XCHG_WIDTH, OPS_XCHG_INV),
                     xshape + " v"),
    })
    # the wide kernels at the main shape on phase 3i's 62-bit ring: 8 bytes
    # a word each way (lo and hi) and the two u64 tables of a transform;
    # the pointwise kernel in the polymul's Montgomery mode
    _, wr62, wins, _ = wide_cases[0]
    wt, wn, wb = wr62.tables, MAIN_N, MAIN_BATCH
    wx64, wy64, wa64, wb64 = (i64(wins[v]) for v in ("x", "y", "a", "b"))
    wshape = f"(B={wb}, n={wn}) q62"
    timed.update({
        "wide_fwd": (lambda: WK.wide_fwd(wins["x"], wt),
                     lambda: WK.wide_fwd_plain(wx64, wt),
                     4 * wb * wn + 4 * wn, wide_fwd_ops(wb, wn), wshape),
        "wide_inv": (lambda: WK.wide_inv(wins["y"], wt, wr62.n_inv),
                     lambda: WK.wide_inv_plain(wy64, wt, wr62.n_inv),
                     4 * wb * wn + 4 * wn, wide_inv_ops(wb, wn), wshape),
        "wide_pointwise": (
            lambda: WK.wide_pointwise(wins["a"], wins["b"], wt, "mont"),
            lambda: WK.wide_pointwise_plain(wa64, wb64, wt, "mont"),
            6 * wb * wn, scaled(wb * wn, OPS_WIDE_MONT), wshape + " mont"),
    })
    # M1's column pass at the A/B's main shape (2^16, B=512); its bound
    # counts the tensor cores' int8 multiply-adds beside bytes and int32
    # operations
    r_m, x_m = mxu_main
    mt_m = MX.mxu_tables(r_m.plan, dev)
    xm3 = x_m.view(-1, mt_m.n1, mt_m.n2)
    xm3l = xm3.to(torch.int64)
    words_m, ops_m, macs_m = mxu_pass_cost(xm3.shape[0], mt_m.n1, mt_m.n2,
                                           row=False)
    timed["mxu"] = (lambda: MX.mxu_pass(xm3, mt_m, False),
                    lambda: MX.col_pass_plain(xm3l, mt_m), words_m,
                    ops_m + (macs_m,),
                    f"(B={xm3.shape[0]}, {mt_m.n1}x{mt_m.n2}) col pass")
    # a kernel's launches over every path of phase 3 (the flat path's are
    # the flat rows')
    paths = {"3a": launches, "3b": rns_launches, "3c": fs_launches,
             "3e": slice_launches, "3f": ckks_launches, "3g": int_launches,
             "3h": h_launches, "3i": wide_launches, "3k": k_launches,
             "3l": mxu_launches}
    for key in tuple(ONE_KERNELS) + MULTI + ("xchg_fwd", "xchg_inv"):
        log(f"{KERNELS[key][0]} launches by path: " + ", ".join(
            f"{p} {c[key]}" for p, c in paths.items()))
    log("cluster kernels (K7a, K7b: one matrix, K8: two) and K9a's and "
        "K9b's slab kernels by matrix, and ptxas:")
    for n_, _ in FS_ROUTE_SHAPES + ((1 << 21, 16),):
        ft = Ring(n_, device=dev).fourstep
        for key, (what, _) in CLUSTER_KERNELS.items():
            info = K.fourstep_launch_info(ft, key)
            where = f"  {what} n={n_} ({ft.n1}x{ft.n2}):"
            if not info["ctas"]:
                log(f"{where} the walking kernel")
            elif key in K.SLAB_KERNELS:
                log(f"{where} {info['ctas']} slabs of {info['width']} columns, "
                    f"one CTA each x {info['threads']} threads, "
                    f"{info['smem_bytes']} bytes of shared memory a CTA, "
                    f"{info['ctas_per_sm']} CTAs an SM")
            else:
                log(f"{where} cluster of {info['ctas']} CTAs x {info['threads']} "
                    f"threads, {info['smem_bytes']} bytes of shared memory a "
                    f"CTA, {info['ctas_per_sm']} CTAs an SM, at most "
                    f"{info['max_active_clusters']} clusters at once")
    for _, name in CLUSTER_KERNELS.values():
        log(f"  ptxas {name}: {'; '.join(ptxas.get(name, ['not found']))}")
    log("K5 and K6b (polydot_rns_cluster_kernel) by n, and ptxas:")
    for n_, k_ in ((RNS_N, 1), (8192, 2), (KS_N, KS_L), (32768, 2), (256, 2)):
        info = K.polydot_rns_launch_info(RNSRing(n_, 1, device=dev).tables, k_)
        log(f"  n={n_} k={k_}: {info['ctas']} CTAs a polynomial, "
            f"{info['polys']} polynomials a CTA, {info['threads']} threads, "
            f"{info['smem_bytes']} bytes of shared memory a CTA, "
            f"{info['ctas_per_sm']} CTAs an SM, at most "
            f"{info['max_active_clusters']} clusters at once")
    log(f"  ptxas {DOT_KERNEL}: {'; '.join(ptxas.get(DOT_KERNEL, ['not found']))}")
    log(f"K3 and K6a ({DOT_KERNEL} at one channel) by n:")
    for n_, k_, cyclic in ((MAIN_N, 1, False), (MAIN_N, MAIN_K, False),
                           (MAIN_N, 8, False), (32768, 1, False),
                           (16384, MAIN_K, False), (32, 1, False),
                           (2, 1, True)):
        r_ = (CyclicRing if cyclic else Ring)(n_, device=dev)
        info = K.polydot_launch_info(r_.tables, k_)
        log(f"  {'K3' if k_ == 1 else 'K6a'} n={n_} k={k_}"
            f"{' cyclic' if cyclic else ''}: {info['ctas']} CTAs a cluster, "
            f"{info['polys']} polynomials a CTA, {info['threads']} threads, "
            f"{info['smem_bytes']} bytes of shared memory a CTA, "
            f"{info['ctas_per_sm']} CTAs an SM, at most "
            f"{info['max_active_clusters']} clusters at once")
    # K4a and K4b at the main shape and at the key switch's: its digits'
    # forward transform (K, B dnum, n) and its sum's inverse (K, B, n)
    gen = torch.Generator(dev).manual_seed(91)
    ks_fx = channels(gen, ext_qs, 4, (KS_BATCH * dnum, KS_N)).to(torch.uint32)
    ks_ix = channels(gen, ext_qs, 2, (KS_BATCH, KS_N)).to(torch.uint32)
    rns_shapes = (("fwd_rns", rtabs, rx, RNS_BATCH, RNS_N),
                  ("inv_rns", rtabs, rc, RNS_BATCH, RNS_N),
                  ("fwd_rns", etabs, ks_fx, KS_BATCH * dnum, KS_N),
                  ("inv_rns", etabs, ks_ix, KS_BATCH, KS_N))
    log("K4a and K4b (fwd_rns_cluster_kernel, inv_rns_cluster_kernel) by "
        "shape, and ptxas:")
    for key, tabs_, _, b_, n_ in rns_shapes:
        info = K.rns_launch_info(tabs_, key, b_)
        log(f"  {RNS_KERNELS[key][0]} (L={tabs_.L}, B={b_}, n={n_}): "
            f"{info['ctas']} CTAs a polynomial, {info['polys']} polynomials "
            f"a CTA, {info['threads']} threads, {info['registers']} "
            f"registers, {info['smem_bytes']} bytes of shared memory a CTA, "
            f"{info['ctas_per_sm']} CTAs an SM, at most "
            f"{info['max_active_clusters']} clusters at once; "
            f"{info['clusters']} clusters a channel")
    for _, name in RNS_KERNELS.values():
        log(f"  ptxas {name}: {'; '.join(ptxas.get(name, ['not found']))}")
    log("K1 and K2 (the same kernels at one channel) by caller's shape:")
    f20 = fs_rings[2].fourstep
    for what, tabs_, b_ in (
            ("Ring", tabs, MAIN_BATCH),
            ("Ring(32768)", Ring(32768, device=dev).tables, 1024),
            ("CyclicRing(2)", CyclicRing(2, device=dev).tables, 1 << 21),
            ("row pass of 2^20", f20.row, 32 * f20.n1),
            ("row pass of 2^21", f21.row, 16 * f21.n1),
            (f"shard of Ring({SHARD_N}) over sp={SHARD_SP}",
             SS._shard_tables(sring.params, SHARD_SP, 0, dev),
             SHARD_BATCH // SHARD_DP)):
        for key, (k_name, _) in ONE_KERNELS.items():
            info = K.launch_info(tabs_, key, b_)
            log(f"  {k_name} {what} (B={b_}, n={tabs_.n}): {info['ctas']} CTAs "
                f"a polynomial, {info['polys']} polynomials a CTA, "
                f"{info['threads']} threads, {info['registers']} registers, "
                f"{info['smem_bytes']} bytes of shared memory a CTA, "
                f"{info['ctas_per_sm']} CTAs an SM, at most "
                f"{info['max_active_clusters']} clusters at once; "
                f"{info['clusters']} clusters")
    log(f"K12 ({DIT_KERNEL}, K1's launch) by shape, and ptxas:")
    for n_, b_ in DIT_CHECK_SHAPES:
        info = K.launch_info(Ring(n_, device=dev).tables, "dit_inv", b_)
        log(f"  K12 (B={b_}, n={n_}): {info['ctas']} CTAs a polynomial, "
            f"{info['polys']} polynomials a CTA, {info['threads']} threads, "
            f"{info['registers']} registers, {info['smem_bytes']} bytes of "
            f"shared memory a CTA, {info['ctas_per_sm']} CTAs an SM, at most "
            f"{info['max_active_clusters']} clusters at once; "
            f"{info['clusters']} clusters")
    for name in (DIT_KERNEL, "xchg_group_kernel"):
        log(f"  ptxas {name}: {'; '.join(ptxas.get(name, ['not found']))}")
    log("the wide kernels (ntt_wide.cuh) by shape: register-radix passes on "
        "4096 words a CTA, a cluster a block through n = 65536, passes in "
        "device memory above; ptxas:")
    for label, wr, ins, words in wide_cases:
        if words is not None:
            continue
        for which in ("wide_fwd", "wide_inv"):
            info = WK.wide_launch_info(wr.tables, which, ins["x"][0].shape[0])
            log(f"  {which} {label}: {info['passes']} passes in device memory,"
                f" blocks of {info['block']} words, {info['ctas']} CTAs a "
                f"block, {info['blocks']} blocks a CTA, {info['threads']} "
                f"threads, {info['registers']} registers, "
                f"{info['smem_bytes']} bytes of shared memory a CTA, "
                f"{info['ctas_per_sm']} CTAs an SM, at most "
                f"{info['max_active_clusters']} clusters at once; "
                f"{info['clusters']} clusters")
    for name in WIDE_KERNELS:
        log(f"  ptxas {name}: {'; '.join(ptxas.get(name, ['not found']))}")
    rows = []
    log(f"timing on {card} (CUDA events, median of 5 runs of 10 calls):")
    for key, (kern, plain, words, ops, shape) in timed.items():
        ms = cuda_time_ms(kern)
        plain_ms = cuda_time_ms(plain, warmup=1, reps=3, inner=2)
        bound_ms, bound_by = bound(words, ops[:3], *ops[3:])
        name, replaces = KERNELS[key]
        macs = f", {ops[3]} int8 multiply-adds" if len(ops) > 3 else ""
        log(f"  {name:30s} {shape:36s} {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}; {words * 4} bytes, int32 "
            f"{ops[0]} multiplies, {ops[1]} compares, {ops[2]} adds{macs}), "
            f"{bound_ms / ms:.1%} of bound")
        count = (flat_launches[FLAT[key]] if key in FLAT
                 else sum(c[key] for c in paths.values()))
        rows.append({
            "name": name, "route": "cuda",
            "source": BODY_SOURCE.get(key, KERNEL_SOURCE),
            "replaces": replaces, "launches": count,
            "max_abs_err": worst[key], "mismatches": mismatched[key],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "shape": shape,
        })
    log("library_ms: null for every kernel but M1 - no PyTorch call computes "
        "a negacyclic NTT mod q")
    lib_ms, why = MXP.library_ms(mt_m, xm3, False)
    mxu_row = rows[list(timed).index("mxu")]
    mxu_row["library_ms"] = lib_ms
    mxu_row["share_of_bound"] = mxu_row["bound_ms"] / mxu_row["ms"]
    mxu_row["launch"] = MX.mxu_launch_info(mt_m, False, xm3.shape[0])
    log(f"  M1's library_ms: its 16 digit products alone by torch._int_mm "
        f"at {timed['mxu'][4]}: "
        + (f"{lib_ms:.4f} ms" if lib_ms is not None else f"null ({why})"))
    log("M1 (mxu_col_kernel, mxu_row_kernel) launch shapes at the A/B's "
        "shapes, and ptxas:")
    for _, n_, b_ in MXU_PATH:
        mt_ = MX.mxu_tables(Ring(n_, device=dev).plan, dev)
        for row_ in (False, True):
            info = MX.mxu_launch_info(mt_, row_, b_)
            log(f"  {'row' if row_ else 'col'} pass n={n_} ({mt_.n1}x"
                f"{mt_.n2}) B={b_}: tile {info['tile_m']}x{info['tile_n']} "
                f"over k chunks of {info['tile_k']}, {info['threads']} "
                f"threads ({info['converter_threads']} converting, "
                f"{info['consumer_threads']} on wgmma), {info['stages']} "
                f"stages and {info['raw_stages']} raw stages in "
                f"{info['smem_bytes']} bytes of shared memory, "
                f"{info['registers']} registers as launched, "
                f"{info['local_bytes']} bytes of local memory a thread, "
                f"{info['ctas_per_sm']} CTAs an SM, {info['ctas']} "
                f"persistent CTAs over {info['tiles']} tiles")
    for name in MXU_KERNELS:
        log(f"  ptxas {name}: {'; '.join(ptxas.get(name, ['not found']))}")
    log(f"the matrix-product four-step A/B on {card} (utils/mxu_probe.py; "
        "CUDA events, median of 5 runs of 10 calls; the transform and "
        "Ring.ntt in turns):")
    MXP.measure(dev, emit=lambda row_: log("  mxu " + json.dumps(row_)),
                check=False)
    log(f"K3 and K6a beyond the main shapes on {card} (CUDA events, median "
        "of 5 runs of 10 calls):")
    gen = torch.Generator(dev).manual_seed(92)
    for n_, b_, k_ in FUSED_TIMED_SHAPES:
        r_ = Ring(n_, device=dev)
        shape = (b_, n_) if k_ == 1 else (b_, k_, n_)
        u, v = (rand(gen, r_.q, shape).to(torch.uint32) for _ in range(2))
        fused = K.polymul_fused if k_ == 1 else K.polydot_fused
        ms = cuda_time_ms(lambda: fused(u, v, r_.tables))
        bound_ms, bound_by = bound((2 * k_ + 1) * b_ * n_, dot_ops(b_, k_, n_))
        log(f"  {'K3' if k_ == 1 else 'K6a'} (B={b_}, k={k_}, n={n_}) "
            f"{one_dot_shape(r_.tables, k_)}: {ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound")
        del u, v
    log(f"K4a and K4b at the key switch's shapes on {card} (CUDA events, "
        "median of 5 runs of 10 calls):")
    for key, tabs_, v, b_, n_ in rns_shapes[2:]:
        call = ((lambda: K.fwd_ntt_rns(v, tabs_)) if key == "fwd_rns"
                else (lambda: K.inv_ntt_rns(v, tabs_)))
        ms = cuda_time_ms(call)
        ops = (fwd_ops if key == "fwd_rns" else inv_ops)(b_, n_)
        bound_ms, bound_by = bound(tabs_.L * (2 * b_ * n_ + 2 * n_),
                                   scaled(tabs_.L, ops))
        log(f"  {KERNELS[key][0]:30s} (L={tabs_.L}, B={b_}, n={n_}) "
            f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"{bound_ms / ms:.1%} of bound")
    del ks_fx, ks_ix
    del x16l, a16l, b16l, y16l, x21l, y21l
    torch.cuda.empty_cache()
    # the fused four-step kernels beside the routes the caps of
    # ops/fourstep.py choose between, at 128 MiB an operand: K7a against
    # the two-kernel forward (K9a + K1 rows), K7b against K2 rows + K9b,
    # K8 against the composed polymul (two forward transforms, the int64
    # Montgomery product, the scaled inverse; its transforms routed by
    # FULL_FUSE_BYTES as on the main path)
    log(f"  fused four-step kernels beside their routes on {card} (API: "
        f"Ring.ntt / Ring.intt through the caps):")
    wins = {"transform": [], "polymul": []}
    for n_, b_ in FS_ROUTE_SHAPES:
        r_ = Ring(n_, device=dev)
        ft = r_.fourstep
        gen = torch.Generator(dev).manual_seed(n_ + 7)
        shape = (b_, ft.n1, ft.n2)
        xi = rand(gen, 4 * r_.q, shape).to(torch.uint32)
        ai, bi = (rand(gen, r_.q, shape).to(torch.uint32) for _ in range(2))
        yi = K.fwd_ntt_fourstep(xi, ft)
        b_fwd = bound(fs_words(ft, 2, b_), fwd4_ops(b_, ft.n1, ft.n2))[0]
        b_inv = bound(fs_words(ft, 2, b_), inv4_ops(b_, ft.n1, ft.n2))[0]
        b_mul = bound(fs_words(ft, 3, b_, 2),
                      polymul4_ops(b_, ft.n1, ft.n2))[0]
        calls = (  # (name, call, bound_ms)
            ("K7a", lambda: K.fwd_ntt_fourstep(xi, ft), b_fwd),
            ("K9a + K1", lambda: K.fwd_ntt(
                K.fwd_col_fourstep(xi, ft).view(-1, ft.n2), ft.row), b_fwd),
            ("K7b", lambda: K.inv_ntt_fourstep(yi, ft), b_inv),
            ("K2 + K9b", lambda: K.inv_col_fourstep(
                K.inv_ntt(yi.view(-1, ft.n2), ft.row).view(shape), ft), b_inv),
            ("K8", lambda: K.polymul_fourstep_fused(ai, bi, ft), b_mul),
            ("composed", lambda: FS.polymul_fourstep_tiled(ai, bi, ft), b_mul),
        )
        saved = FS.POLYMUL_FUSE_BYTES
        FS.POLYMUL_FUSE_BYTES = 0  # the composed polymul
        t_ = {name: cuda_time_ms(call, warmup=2, reps=5, inner=4)
              for name, call, _ in calls}
        FS.POLYMUL_FUSE_BYTES = saved
        api = [cuda_time_ms(call, warmup=2, reps=5, inner=4) for call in (
            lambda: r_.ntt(xi.view(b_, n_)), lambda: r_.intt(yi.view(b_, n_)))]
        log(f"    n={n_} ({ft.n1}x{ft.n2}) B={b_}, K7a/K7b {body(ft, 1)}, "
            f"K8 {body(ft, 2)}, K9a {slabs(ft)}: " + "; ".join(
                f"{name} {t_[name]:.4f} ms ({bnd / t_[name]:.1%} of bound)"
                for name, _, bnd in calls)
            + f"; API ntt {api[0]:.4f} ms, intt {api[1]:.4f} ms")
        if t_["K7a"] + t_["K7b"] < t_["K9a + K1"] + t_["K2 + K9b"]:
            wins["transform"].append(4 * n_)
        if t_["K8"] < t_["composed"]:
            wins["polymul"].append(4 * n_)
        del xi, ai, bi, yi
        torch.cuda.empty_cache()
    log(f"  fused K7 (forward + inverse) faster than the two-kernel route at "
        f"matrices of {wins['transform']} bytes, K8 faster than the composed "
        f"polymul at {wins['polymul']} bytes; ops/fourstep.py caps: "
        f"FULL_FUSE_BYTES={FS.FULL_FUSE_BYTES}, "
        f"POLYMUL_FUSE_BYTES={FS.POLYMUL_FUSE_BYTES}")
    # the row pass alone (K1, K2 on the cyclic row tables), on Ring.ntt's
    # words of 2^20 and 2^21 (any words below 2q)
    for i in (2, 3):
        ft = fs_rings[i].fourstep
        rows_ = fs_out[i][0].view(-1, ft.n2)
        for name, call in (
                ("fwd_ntt row pass", lambda: K.fwd_ntt(rows_, ft.row)),
                ("inv_ntt row pass", lambda: K.inv_ntt(rows_, ft.row))):
            ms = cuda_time_ms(call)
            bound_ms, bound_by = bound(2 * rows_.numel() + 2 * ft.n2,
                                       (fwd_ops if "fwd" in name else inv_ops)(
                                           rows_.shape[0], ft.n2))
            log(f"  {name:20s} of n={ft.n} ({rows_.shape[0]}, {ft.n2}) "
                f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                f"{bound_ms / ms:.1%} of bound")
    # the DIT inverse beside K2 and its two bit-reversal forms
    log(f"  DIT inverse against K2 (B={bsz}, n={n}):")
    for what, call, words in (
        ("inv_ntt (K2)", lambda: K.inv_ntt(y, tabs), 2 * bsz * n + 4 * n),
        ("dit_inv_core (K12)", lambda: K.dit_inv_core(y, dt4),
         2 * bsz * n + 6 * n),
        ("bitrev_permute direct", lambda: D.bitrev_permute(y), 2 * bsz * n),
        ("bitrev_permute factored",
         lambda: D.bitrev_permute(y, factored=True), 2 * bsz * n),
        ("inv_ntt_dit direct", lambda: D.inv_ntt_dit(y, ring.params),
         2 * bsz * n + 6 * n),
        ("inv_ntt_dit factored",
         lambda: D.inv_ntt_dit(y, ring.params, factored=True),
         2 * bsz * n + 6 * n),
        ("Ring.intt", lambda: ring.intt(y), 2 * bsz * n + 4 * n),
    ):
        ms = cuda_time_ms(call)
        bound_ms = words * 4 / HBM_BYTES_PER_S * 1e3
        log(f"    {what:26s} {ms:.4f} ms, bytes bound {bound_ms:.4f} ms, "
            f"{bound_ms / ms:.1%} of it")
    # the sharded path on one card beside the unsharded calls
    log(f"  sharded path on one card (ShardedRing vs Ring, CUDA events, "
        f"median of 3 runs of 4 calls):")
    for what, sharded, plain_call, polys in (
        (f"ntt n={SHARD_N} B={SHARD_BATCH}", "ntt", lambda: sring.ntt(sx),
         SHARD_BATCH),
        (f"intt n={SHARD_N} B={SHARD_BATCH}", "intt", lambda: sring.intt(sx),
         SHARD_BATCH),
        (f"polymul n={SHARD_N} B={SHARD_BATCH}", "polymul",
         lambda: sring.polymul(sa, sb), SHARD_BATCH),
    ):
        base = cuda_time_ms(plain_call, warmup=2, reps=3, inner=4)
        line = f"    {what:28s} Ring {base:.4f} ms"
        for comm, sr in srs.items():
            fn = getattr(sr, sharded)
            args = (sa, sb) if sharded == "polymul" else (sx,)
            ms = cuda_time_ms(lambda: fn(*args), warmup=2, reps=3, inner=4)
            line += f", dp={SHARD_DP} x sp={SHARD_SP} {comm} {ms:.4f} ms"
        log(line + f" ({polys} polynomials)")
    for what, shard_call, plain_call in (
        (f"four-step ntt n={SHARD_FS_N} B={x_.shape[0]} sp={SHARD_SP}",
         lambda: fs_sr.ntt(x_), lambda: big.ntt(x_)),
        (f"four-step intt n={SHARD_FS_N} B={x_.shape[0]} sp={SHARD_SP}",
         lambda: fs_sr.intt(fs_out[0][0]), lambda: big.intt(fs_out[0][0])),
        (f"polydot n={MAIN_N} B={MAIN_DOT_BATCH} k={MAIN_K} dp={SHARD_DOT_DP}",
         lambda: dot_sr.polydot(da, db), lambda: ring.polydot(da, db)),
    ):
        base = cuda_time_ms(plain_call, warmup=2, reps=3, inner=4)
        ms = cuda_time_ms(shard_call, warmup=2, reps=3, inner=4)
        log(f"    {what:40s} Ring {base:.4f} ms, ShardedRing {ms:.4f} ms")
    # end to end through the public API, wrapper checks and allocation included
    for what, call, polys in (
        ("Ring.ntt", lambda: ring.ntt(x), bsz),
        ("Ring.intt", lambda: ring.intt(y), bsz),
        ("Ring.polymul", lambda: ring.polymul(a, b), bsz),
        ("Ring.polydot", lambda: ring.polydot(da, db), dbsz),
    ):
        ms = cuda_time_ms(call)
        log(f"  {what:14s} {ms:.4f} ms per call of {polys} polynomials: "
            f"{polys / ms / 1e3:.3f} M per second")
    for what, call, polys in (
        ("RNSRing.ntt", lambda: rns.ntt(rx), RNS_L * rb_),
        ("RNSRing.intt", lambda: rns.intt(ry), RNS_L * rb_),
        ("RNSRing.polymul", lambda: rns.polymul(ra, rb), RNS_L * rb_),
        ("RNSRing.polydot", lambda: rns.polydot(rda, rdb), RNS_L * rb_),
    ):
        ms = cuda_time_ms(call)
        log(f"  {what:16s} {ms:.4f} ms per call of {polys} channel "
            f"polynomials: {polys / ms / 1e3:.3f} M per second")
    log(f"wide transform kernels alone by shape on {card} (CUDA events, "
        "median of 5 runs of 10 calls; bound: utils/report.py, 8 bytes a word "
        "each way and the two u64 tables):")
    for label, wr, ins, words in wide_cases:
        if words is not None:
            continue
        bn, n_ = ins["x"][0].shape[0], wr.n
        for key, call, ops in (
            ("wide_fwd", lambda: WK.wide_fwd(ins["x"], wr.tables),
             wide_fwd_ops(bn, n_)),
            ("wide_inv", lambda: WK.wide_inv(ins["y"], wr.tables, wr.n_inv),
             wide_inv_ops(bn, n_)),
        ):
            ms = cuda_time_ms(call)
            bound_ms, bound_by = bound(4 * bn * n_ + 4 * n_, ops)
            log(f"  {key} {label:28s} {ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}), {bound_ms / ms:.1%} of bound")
    log(f"WideRing calls end to end on {card} (pair I/O, host work "
        "included; CUDA events, median of 3 runs of 2 calls; kernel launches "
        "a call):")
    for label, wr, ins, words in wide_cases:
        if words is not None:
            continue
        bn = ins["x"][0].shape[0]
        for op, call in wide_calls(wr, ins).items():
            ms = cuda_time_ms(call, warmup=1, reps=3, inner=2)
            torch.cuda.synchronize()
            for key in K.LAUNCHES:
                K.LAUNCHES[key] = 0
            call()
            torch.cuda.synchronize()
            log(f"  WideRing {label} {op:14s} {ms:.4f} ms per call of {bn} "
                f"polynomials: {bn / ms / 1e3:.3f} M per second; launches "
                f"{ {k: v for k, v in K.LAUNCHES.items() if v} }")
    for r, (x_, a_, b_), outs in zip(fs_rings, fs_in, fs_out):
        bn = x_.shape[0]
        for what, call in ((f"Ring({r.n}).ntt", lambda: r.ntt(x_)),
                           (f"Ring({r.n}).intt", lambda: r.intt(outs[0])),
                           (f"Ring({r.n}).polymul", lambda: r.polymul(a_, b_))):
            ms = cuda_time_ms(call, warmup=2, reps=3, inner=4)
            log(f"  {what:22s} {ms:.4f} ms per call of {bn} polynomials: "
                f"{bn / ms * 1e3:.1f} per second")
    for what, call, polys in (
        ("Ring(65536).polydot", lambda: big.polydot(fda, fdb), FS_DOT_BATCH),
        ("CyclicRing(65536).ntt", lambda: cyc.ntt(cx), FS_SMALL_BATCH),
        ("CyclicRing(65536).polymul", lambda: cyc.polymul(cx, cb),
         FS_SMALL_BATCH),
        ("RNSRing(65536, 3).ntt", lambda: frns.ntt(fr),
         FS_RNS_L * FS_SMALL_BATCH),
        ("RNSRing(65536, 3).polymul", lambda: frns.polymul(fr, fr2),
         FS_RNS_L * FS_SMALL_BATCH),
    ):
        ms = cuda_time_ms(call, warmup=2, reps=3, inner=4)
        log(f"  {what:26s} {ms:.4f} ms per call of {polys} (channel) "
            f"polynomials: {polys / ms * 1e3:.1f} per second")
    # the key switch end to end, host work (checks, table uploads) included
    log(f"key switch end to end on {card} (n={KS_N}, L={KS_L}, dnum={dnum}, "
        f"K={ext_k}, batch {KS_BATCH}; CUDA events, median of 3 runs of 2 "
        f"calls):")
    call_ms = {}
    for what, call, per in (
        ("keyswitch coeff keys",
         lambda: ks_ring.keyswitch(ks_x, ksk, ext_ring, dnum), KS_BATCH),
        ("keyswitch ntt keys",
         lambda: ks_ring.keyswitch(ks_x, ksk_ntt, ext_ring, dnum,
                                   ksk_domain="ntt"), KS_BATCH),
        (f"hoisted x{len(KS_STEPS)}",
         lambda: ks_ring.hoisted_keyswitch(ks_x, ksks_ntt, KS_STEPS, ext_ring,
                                           dnum, ksk_domain="ntt"),
         KS_BATCH * len(KS_STEPS)),
    ):
        ms = cuda_time_ms(call, warmup=1, reps=3, inner=2)
        call_ms[what] = ms
        log(f"  {what:22s} {ms:.4f} ms per call, {ms / per * 1e3:.3f} us per "
            f"ciphertext{' step' if 'hoisted' in what else ''}")
    # the CKKS ops end to end through the public calls, host work included
    log(f"CKKS ops end to end on {card} (n={KS_N}, L={KS_L}, batch "
        f"{CKKS_BATCH}; the matvec n={MV_N}, L={MV_L}; CUDA events, median of "
        f"3 calls; launches of the NTT kernels a call):")
    t_ck, ckks_ms = time.perf_counter(), {}
    for what, call in ck["calls"].items():
        ms = cuda_time_ms(call, warmup=1, reps=3, inner=1)
        torch.cuda.synchronize()
        for key in K.LAUNCHES:
            K.LAUNCHES[key] = 0
        call()
        torch.cuda.synchronize()
        ntt_launches = {k: v for k, v in K.LAUNCHES.items() if v}
        ckks_ms[what] = ms
        log(f"  {what:22s} {ms:.4f} ms per call, {ms / CKKS_BATCH * 1e3:.3f} us "
            f"per ciphertext, {sum(ntt_launches.values())} NTT-kernel "
            f"launches {ntt_launches}")
    log(f"  (timed in {time.perf_counter() - t_ck:.1f} s)")
    # the BGV and BFV ops alike; BFV's multiply also stage by stage
    log(f"BGV and BFV ops end to end on {card} (n={KS_N}, L={KS_L}, "
        f"t={INT_T}, batch {INT_BATCH}; the matvec n={MV_N}, L={MV_L}, "
        f"t={ik['mctx'].t}; CUDA events, median of 3 calls; launches of the "
        f"NTT kernels a call):")
    t_int, int_ms = time.perf_counter(), {}
    ik["calls"].update(bfv_stage_calls(ik))
    for what, call in ik["calls"].items():
        ms = cuda_time_ms(call, warmup=1, reps=3, inner=1)
        torch.cuda.synchronize()
        for key in K.LAUNCHES:
            K.LAUNCHES[key] = 0
        call()
        torch.cuda.synchronize()
        ntt_launches = {k: v for k, v in K.LAUNCHES.items() if v}
        int_ms[what] = ms
        log(f"  {what:30s} {ms:.4f} ms per call, {ms / INT_BATCH * 1e3:.3f} "
            f"us per ciphertext, {sum(ntt_launches.values())} NTT-kernel "
            f"launches {ntt_launches}")
    log(f"  (timed in {time.perf_counter() - t_int:.1f} s)")
    # phase 3h's calls beside the unsharded ones, each with its launches
    log(f"the sharded RNS ring and the schemes on a mesh of one card on {card} "
        f"(CUDA events, median of 3 calls; NTT-kernel launches a call):")

    def counted(call):
        torch.cuda.synchronize()
        for key in K.LAUNCHES:
            K.LAUNCHES[key] = 0
        call()
        torch.cuda.synchronize()
        return {k: v for k, v in K.LAUNCHES.items() if v}

    h_timed = [(f"{name} {op}", lambda sr=sr, op=op, vs=vs:
                getattr(sr, op.split()[0])(*vs),
                lambda r_=r_, op=op, vs=vs: getattr(r_, op.split()[0])(*vs))
               for name, r_, sr, ins, _ in h_layouts
               for op, vs in ins.items()]
    h_timed += [(f"n16384 key switch dp={SHARD_KS_DP} {name}",
                 lambda call=call: call(sks, sext),
                 lambda call=call: call(ks_ring, ext_ring))
                for name, call in ks_calls.items()]

    def unsharded(name):
        """The unsharded context's call of a scheme op of phase 3h."""
        scheme, op = name.split(" ", 1)
        if scheme != "CKKS":
            return ik["calls"][name]
        if op == "square":  # not one of phase 3f's calls
            return lambda: ck["ctx"].square(ck["outs"]["enc1"], ck["keys"])
        return ck["calls"][op]

    h_timed += [(f"{name} dp={SHARD_KS_DP}", call, unsharded(name))
                for name, (call, _, _, _) in sch.items()]
    t_h, mesh_ms = time.perf_counter(), {}
    for what, sharded, single in h_timed:
        base_ms = cuda_time_ms(single, warmup=1, reps=3, inner=1)
        ms = cuda_time_ms(sharded, warmup=1, reps=3, inner=1)
        mesh_ms[what] = ms
        log(f"  {what:44s} unsharded {base_ms:9.4f} ms "
            f"{counted(single)}, sharded {ms:9.4f} ms {counted(sharded)}")
    log(f"  (timed in {time.perf_counter() - t_h:.1f} s)")
    log("where the key switch's device time goes (torch.profiler, one call):")
    device_breakdown(lambda: ks_ring.keyswitch(ks_x, ksk, ext_ring, dnum),
                     "keyswitch coeff keys", call_ms["keyswitch coeff keys"])
    device_breakdown(lambda: ks_ring.keyswitch(
        ks_x, ksk_ntt, ext_ring, dnum, ksk_domain="ntt"), "keyswitch ntt keys",
        call_ms["keyswitch ntt keys"])
    # profiled after every timing, so that no profiler session precedes a
    # host-bound measurement
    log("the kernels K7a, K7b, K8, K9a and K9b launch at 2^16 and 2^18 "
        "(torch.profiler):")
    for n_ in FS_PROFILE_NS:
        i = [n for n, _ in FS_PATH].index(n_)
        ft, (xi, ai, bi, yi), _ = fs_operands(i)
        for key, call in (
                ("fwd4", lambda: K.fwd_ntt_fourstep(xi, ft)),
                ("inv4", lambda: K.inv_ntt_fourstep(yi, ft)),
                ("polymul4", lambda: K.polymul_fourstep_fused(ai, bi, ft)),
                ("col_fwd", lambda: K.fwd_col_fourstep(xi, ft)),
                ("col_inv", lambda: K.inv_col_fourstep(yi, ft))):
            what, name = CLUSTER_KERNELS[key]
            seen = kernels_seen(call)
            log(f"  n={n_} B={xi.shape[0]} {what}: " +
                ", ".join(f"{k} {c} x {ms:.4f} ms" for k, c, ms in seen))
            if seen and not any(name in k for k, _, _ in seen):
                raise AssertionError(f"{name} did not run at n={n_}")
    rows21 = fs_out[3][0].view(-1, f21.n2)
    for what, call, kernel in (
            (f"K1 (B={bsz}, n={n})", lambda: K.fwd_ntt(x, tabs),
             ONE_KERNELS["fwd"][1]),
            (f"K2 (B={bsz}, n={n})", lambda: K.inv_ntt(c, tabs),
             ONE_KERNELS["inv"][1]),
            (f"K1 row pass of n={f21.n} {tuple(rows21.shape)}",
             lambda: K.fwd_ntt(rows21, f21.row), ONE_KERNELS["fwd"][1]),
            (f"K2 row pass of n={f21.n} {tuple(rows21.shape)}",
             lambda: K.inv_ntt(rows21, f21.row), ONE_KERNELS["inv"][1]),
            (f"K3 (B={bsz}, n={n})", lambda: K.polymul_fused(a, b, tabs),
             DOT_KERNEL),
            (f"K6a (B={dbsz}, k={k}, n={n})",
             lambda: K.polydot_fused(da, db, tabs), DOT_KERNEL),
            (f"K6b (K={ext_k}, B={KS_BATCH}, k={dnum}, n={KS_N})",
             lambda: K.polydot_rns_fused(dig32, kdot32, etabs), DOT_KERNEL),
            (f"K5 (L={RNS_L}, B={RNS_BATCH}, n={RNS_N})",
             lambda: K.polymul_rns_fused(ra, rb, rtabs), DOT_KERNEL),
            (f"K4a (L={RNS_L}, B={RNS_BATCH}, n={RNS_N})",
             lambda: K.fwd_ntt_rns(rx, rtabs), RNS_KERNELS["fwd_rns"][1]),
            (f"K4b (L={RNS_L}, B={RNS_BATCH}, n={RNS_N})",
             lambda: K.inv_ntt_rns(rc, rtabs), RNS_KERNELS["inv_rns"][1]),
            (f"K12 (B={bsz}, n={n})", lambda: K.dit_inv_core(y, dt4),
             DIT_KERNEL),
            (f"K11 {xshape}", lambda: K.xchg_step(*x32s, q=xq, fwd=True,
                                                  is_u=True),
             "xchg_group_kernel")):
        seen = kernels_seen(call)
        log(f"  {what}: " + ", ".join(f"{k} {c} x {ms:.4f} ms"
                                      for k, c, ms in seen))
        if seen and not any(kernel in k for k, _, _ in seen):
            raise AssertionError(f"{kernel} did not run for {what}")
    # the scale's words are uploaded at its first use only: no later call
    # copies anything to the card (the profiler must first see the copy of
    # a host tensor)
    log("host-to-device copies in a call after the first (torch.profiler):")

    def copies_in(call):
        return [(k, c) for k, c, _ in kernels_seen(call) if "HtoD" in k]

    control = copies_in(lambda: torch.ones(4, dtype=torch.int32).to(dev))
    log(f"  control, a host tensor to the card: {control}")
    if not control:
        raise AssertionError("the profiler shows no host-to-device copy")
    odd = (3 * ring.polymul_scale + 1) % ring.q  # a scale no table holds
    big21 = fs_rings[3]
    for what, call in (
            (f"Ring({n}).intt(scale={odd})", lambda: ring.intt(y, scale=odd)),
            (f"Ring({n}).intt(scale=polymul_scale)",
             lambda: ring.intt(y, scale=ring.polymul_scale)),
            (f"Ring({big21.n}).ntt", lambda: big21.ntt(fs_in[3][0])),
            (f"Ring({big21.n}).intt", lambda: big21.intt(fs_out[3][0]))):
        copies = copies_in(call)
        log(f"  {what}: {copies if copies else 'none'}")
        if copies:
            raise AssertionError(f"{what} copies to the card on every call")
    # phase 3j's three timers, taken here: about a minute after a process's
    # first torch.profiler session its one-launch sessions recorded no
    # kernel (utils/profiler_probe.py), so phase 3j opens no session before
    # phase 4's checks above
    ring_ = Ring(MAIN_N, device=dev)
    x_ = rand(torch.Generator(dev).manual_seed(3), ring_.q,
              (MAIN_BATCH, MAIN_N)).to(torch.uint32)
    t_delta = device_time(ring_.ntt, x_) * 1e3
    t_prof = device_time_profiled(ring_.ntt, x_, iters=8)
    t_events = cuda_time_ms(lambda: ring_.ntt(x_))
    prof_note = ("the profiler recorded no device event"
                 if t_prof is None else f"{t_prof * 1e3:.4f} ms")
    log(f"Ring({MAIN_N}).ntt at B={MAIN_BATCH}, three timers: "
        f"device_time {t_delta:.4f} ms, device_time_profiled "
        f"{prof_note}, cuda_time_ms {t_events:.4f} ms")

    log("K11's share of a sharded transform's device time (torch.profiler):")
    for comm, sr in srs.items():
        kernel_share(lambda: sr.ntt(sx),
                     f"ShardedRing.ntt ({comm}, n={SHARD_N}, B={SHARD_BATCH})")
        kernel_share(lambda: sr.intt(sx),
                     f"ShardedRing.intt ({comm}, n={SHARD_N}, B={SHARD_BATCH})")
    # K11 by its device time: CUDA events around back-to-back calls of a
    # 15 us kernel time the wrapper's enqueue, not the kernel.  One shard's
    # half (the launch of a shard on its own card), and one cross stage of
    # one sp group of SHARD_SP shards on one card in one launch as each
    # comm takes it: `overlap` one entry a butterfly pair, which reads each
    # shard once; `ppermute` one entry a shard, from its partner's copy
    gen = torch.Generator(dev).manual_seed(93)
    grp, cps = ([rand(gen, 2 * xq, (XCHG_ROWS, XCHG_WIDTH)).to(torch.uint32)
                 for _ in range(SHARD_SP)] for _ in range(2))
    outs = [torch.empty_like(g) for g in grp]
    xrow = x32s[2:]
    cases = (
        (f"one shard's half {xshape}",
         [K.half_entry(*x32s[:2], *xrow, True, outs[0])]),
        (f"overlap stage of {SHARD_SP} shards",
         [(grp[d], grp[d ^ 1], *xrow, outs[d], outs[d ^ 1])
          for d in range(0, SHARD_SP, 2)]),
        (f"ppermute stage of {SHARD_SP} shards",
         [K.half_entry(grp[d], cps[d], *xrow, d % 2 == 0, outs[d])
          for d in range(SHARD_SP)]))
    log(f"K11 by device time on {card} (torch.profiler, 10 calls after a "
        f"warm-up):")
    xchg_ms = {}
    for key, fwd in (("xchg_fwd", True), ("xchg_inv", False)):
        for what, entries in cases:
            ms, per = profiled(torch, lambda: K.xchg_group(entries, q=xq,
                                                           fwd=fwd),
                               XCHG_KERNEL)
            # each input shard read once, each half written once
            halves = sum((e[4] is not None) + (e[5] is not None)
                         for e in entries)
            words = XCHG_ROWS * XCHG_WIDTH
            bnd, by = bound((2 * len(entries) + halves) * words
                            + 2 * len(entries) * XCHG_WIDTH,
                            scaled(halves * words,
                                   OPS_XCHG_FWD if fwd else OPS_XCHG_INV))
            if ms != ms:
                log(f"  {KERNELS[key][0]:16s} {what}: the profiler recorded "
                    f"no device time")
                continue
            log(f"  {KERNELS[key][0]:16s} {what:34s} {ms:.4f} ms device time "
                f"a call ({per:g} launches), bound {bnd:.4f} ms ({by}), "
                f"{bnd / ms:.1%} of bound")
            if what.startswith("one"):
                xchg_ms[key] = ms
    del grp, cps, outs
    # before the CKKS profiles, the matvecs' last: a matvec's profile holds
    # 76000-92000 kernel launches
    log("where the BGV and BFV ops' device time goes (torch.profiler, one "
        "call; kernel launches of every kind):")
    t_int, int_kernels = time.perf_counter(), set()
    for what, call in ik["calls"].items():
        if what != "BGV apply_matvec":
            int_kernels.update(device_breakdown(call, what,
                                                int_ms[what], top=3))
    log(f"  (profiled in {time.perf_counter() - t_int:.1f} s)")
    # K1 and K2 launch the kernels of K4a and K4b at one channel: the
    # profiler cannot tell them apart (the counters do, in phase 3g)
    want_kernels = (RNS_KERNELS["fwd_rns"][1], RNS_KERNELS["inv_rns"][1],
                    DOT_KERNEL)
    if int_kernels:
        seen = [name for name in want_kernels
                if any(name in k for k in int_kernels)]
        log(f"  the BGV and BFV calls run {seen} (torch.profiler)")
        if len(seen) != len(want_kernels):
            raise AssertionError("the profiler saw no "
                                 f"{set(want_kernels) - set(seen)} in the BGV "
                                 "and BFV calls")
    log("where the scheme multiplies' device time goes on the mesh of one "
        "card (torch.profiler, one call; kernel launches of every kind):")
    for name in ("CKKS multiply", "BGV multiply", "BFV multiply"):
        what = f"{name} dp={SHARD_KS_DP}"
        device_breakdown(sch[name][0], what, mesh_ms[what], top=3)
    log("where the CKKS ops' device time goes (torch.profiler, one call; "
        "kernel launches of every kind):")
    t_ck, ckks_kernels = time.perf_counter(), set()
    for what, call in ck["calls"].items():
        ckks_kernels.update(device_breakdown(call, what, ckks_ms[what],
                                             top=3))
    log(f"  (profiled in {time.perf_counter() - t_ck:.1f} s)")
    want_kernels = (RNS_KERNELS["fwd_rns"][1], RNS_KERNELS["inv_rns"][1],
                    DOT_KERNEL)
    if ckks_kernels:
        seen = [name for name in want_kernels
                if any(name in k for k in ckks_kernels)]
        log(f"  the CKKS calls run {seen} (torch.profiler)")
        if len(seen) != len(want_kernels):
            raise AssertionError(f"the profiler saw no {set(want_kernels) - set(seen)} "
                                 "in the CKKS calls")
    device_breakdown(ik["calls"]["BGV apply_matvec"], "BGV apply_matvec",
                     int_ms["BGV apply_matvec"], top=3)
    # the kernels line gives K11 its device time at the whole shard
    for row in rows:
        for key, ms in xchg_ms.items():
            if row["name"] == KERNELS[key][0]:
                log(f"  kernels line: {row['name']} ms {ms:.4f} (device time; "
                    f"CUDA events {row['ms']:.4f})")
                row["ms"] = ms
    torch.cuda.synchronize()

    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
