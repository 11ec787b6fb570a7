"""The port stands alone: importing every module of it and running its
command-line check, single- and multi-prime, the DIT inverse, the
matrix-product four-step transform and the sharded ring and the
multi-process setup (one process), loads neither
JAX nor the JAX package; and its CKKS, BGV and
BFV evaluators run a key generation, an encryption and a multiply, the
sharded RNS ring a channel x coefficient polymul, CKKS a multiply on a
mesh and the wide ring a polymul, an example its checks and the autotuner
a choice, in an interpreter where importing either raises."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = """
import sys
import agilex_ntt_tpu_torch
from agilex_ntt_tpu_torch import RNSRing, Ring
from agilex_ntt_tpu_torch.ops import (
    basechange, dit_inv, fourstep, gadget, mxu_ntt, ntt_kernel, plain_ntt,
    wide, wide_kernel,
)
from agilex_ntt_tpu_torch.parallel import (
    chsp, comm, fourstep_shard, mesh, multihost, overlap, shards, stage_shard,
)
from agilex_ntt_tpu_torch.utils import (
    autotune, crt, multihost_probe, mxu_probe, profiler_probe, profiling,
    report,
)
from agilex_ntt_tpu_torch import examples, native
from agilex_ntt_tpu_torch.models import presets
from agilex_ntt_tpu_torch.examples import _common
for name in examples.NAMES:
    __import__(f"agilex_ntt_tpu_torch.examples.{name}")
presets.preset_rns("n4096", device="cpu")
report.kernel_report(1024, 4, out_dir=sys.argv[1], device="cpu")
from agilex_ntt_tpu_torch import schemes
from agilex_ntt_tpu_torch.schemes import bfv, bgv, ckks
from agilex_ntt_tpu_torch.__main__ import main
main(["256", "4", "--device", "cpu"])
main(["256", "4", "--rns", "3", "--device", "cpu"])
import numpy as np
ring = RNSRing(256, 3, device="cpu")
ext = RNSRing(256, 4, device="cpu")
x = ring.to_rns(np.arange(2 * 256).reshape(2, 256))
ksk = np.ones((3, 4, 256), dtype=np.uint32)
ring.keyswitch(x, ring.ksk_to_ntt(ksk, ext), ext, 3, ksk_domain="ntt")
ring.hoisted_keyswitch(x, ksk[None], (3,), ext, 3)
ring.mod_down_bgv(ring.base_convert(x, ring.qs), 17)
r = Ring(1024, device="cpu")
dit_inv.inv_ntt_dit(r.ntt(np.ones((2, 1024), dtype=np.uint32)), r.params)
m = mesh.make_mesh(dp=2, sp=2, devices=["cpu"] * 4)
for comm in ("ppermute", "overlap"):
    mesh.ShardedRing(r, m, sp_axis="sp", sp_comm=comm).polymul(
        np.ones((3, 1024), dtype=np.uint32), np.ones((3, 1024), dtype=np.uint32))
mesh.ShardedRing(r, m, sp_axis="sp", sp_method="fourstep").ntt(
    np.ones((2, 1024), dtype=np.uint32))
pm = multihost.pod_mesh(dp=2, sp=2, local_devices=["cpu"] * 4)
mesh.ShardedRing(r, pm, sp_axis="sp").ntt(np.ones((2, 1024), dtype=np.uint32))
assert multihost.process_local_batch(8) == slice(0, 8)
import torch
r4 = Ring(4096, method="fourstep", device="cpu")
x4 = np.arange(2 * 4096, dtype=np.uint32).reshape(2, 4096) % np.uint32(r4.q)
print("MXU", torch.equal(mxu_ntt.fwd_ntt_fourstep_mxu(torch.from_numpy(x4),
                                                      r4.plan), r4.ntt(x4)))
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "agilex_ntt_tpu"))
print("LEAKED", leaked)
"""


def test_port_imports_neither_jax_nor_the_jax_package(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", PROBE, str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "all checks passed (n=256, q=" in proc.stdout
    assert "all checks passed (n=256, L=3 primes" in proc.stdout
    assert "MXU True" in proc.stdout, proc.stdout
    assert "LEAKED []" in proc.stdout, proc.stdout


BLOCKED = """
import importlib.abc
import sys


class Blocked(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "agilex_ntt_tpu"):
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, Blocked())
try:
    import jax
except ImportError as err:
    print("BLOCKED", err)
import numpy as np
from agilex_ntt_tpu_torch.schemes.ckks import CKKSContext
ctx = CKKSContext(64, 2, rng=np.random.default_rng(1), device="cpu")
keys = ctx.keygen()
z = np.full((2, 32), 0.5 + 0.25j)
ct = ctx.encrypt(ctx.encode(z), keys)
out = ctx.rescale(ctx.multiply(ct, ct, keys))
err = np.abs(ctx.decode(ctx.decrypt(out, keys)) - z * z).max()
print("CKKS", out.level, err < 1e-3)
from agilex_ntt_tpu_torch.schemes import BFVContext, BGVContext
for ctx in (BGVContext(64, 2, rng=np.random.default_rng(2), device="cpu"),
            BFVContext(64, 2, rng=np.random.default_rng(3), device="cpu")):
    keys = ctx.keygen()
    m = np.arange(64).reshape(2, 32) % ctx.t
    ct = ctx.encrypt(ctx.encode(m), keys)
    out = ctx.rescale(ctx.multiply(ct, ct, keys))
    print(type(ctx).__name__, out.level,
          (ctx.decode(ctx.decrypt(out, keys)) == m * m % ctx.t).all())
import torch
from agilex_ntt_tpu_torch import RNSRing
from agilex_ntt_tpu_torch.parallel import ShardedRNSRing, make_mesh
rns = RNSRing(16384, 2, method="fourstep", device="cpu")
srns = ShardedRNSRing(rns, make_mesh(ch=2, sp=2, devices=["cpu"] * 4),
                      dp_axis=None, sp_axis="sp", ch_axis="ch")
x = rns.to_rns(np.arange(2 * 16384).reshape(2, 16384) % 9973)
print("CHSP", torch.equal(srns.polymul(x, x), rns.polymul(x, x)))
one = CKKSContext(64, 2, rng=np.random.default_rng(5), device="cpu")
mctx = CKKSContext(64, 2, rng=np.random.default_rng(5), device="cpu",
                   mesh=make_mesh(dp=2, devices=["cpu"] * 2))
keys = one.keygen()
ct = one.encrypt(one.encode(z), keys)
want, got = one.multiply(ct, ct, keys), mctx.multiply(mctx.place(ct),
                                                     mctx.place(ct), keys)
print("MESH", torch.equal(want.c0, got.c0) and torch.equal(want.c1, got.c1))
from agilex_ntt_tpu_torch import WideRing, golden
wr = WideRing(64, device="cpu")
a = np.arange(1, 65, dtype=np.uint64) * np.uint64(72057594037927931)
b = a[::-1] % np.uint64(wr.q)
print("WIDE", [int(v) for v in wr.polymul(a, b)]
      == golden.negacyclic_convolution(a, b, wr.q))
from agilex_ntt_tpu_torch.examples import bgv_exact
bgv_exact.main(["--device", "cpu"])
from agilex_ntt_tpu_torch.utils import autotune
picked = autotune.tune(16384, 2, "polymul", timer=lambda fn, x, it: 1.0,
                       use_cache=False, device="cpu")
print("TUNED", picked["config"])
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "agilex_ntt_tpu"))
print("LEAKED", leaked)
"""


def test_ckks_runs_with_jax_and_the_jax_package_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "BLOCKED jax is blocked" in proc.stdout
    assert "CKKS 1 True" in proc.stdout, proc.stdout
    assert "BGVContext 1 True" in proc.stdout, proc.stdout
    assert "BFVContext 1 True" in proc.stdout, proc.stdout
    assert "CHSP True" in proc.stdout, proc.stdout
    assert "MESH True" in proc.stdout, proc.stdout
    assert "WIDE True" in proc.stdout, proc.stdout
    assert "bgv_exact: all checks passed with ==" in proc.stdout, proc.stdout
    assert "TUNED {'method': 'radix2'}" in proc.stdout, proc.stdout
    assert "LEAKED []" in proc.stdout, proc.stdout
