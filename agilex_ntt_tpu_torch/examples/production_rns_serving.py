"""Serving shape: RNS polynomial arithmetic over a device mesh.

Counterpart of ``examples/production_rns_serving.py``: L prime channels of
(batch, n) polynomials, the prime-channel axis sharded over one mesh axis
(channel parallelism: channels are independent) and the batch over another
(data parallelism, the reference's frame round-robin).

The mesh is ch=4 x dp=2 over the host's cards, or one card repeated (the
port's sharded rings take a device more than once); every result is held
word for word to an unsharded ``RNSRing`` of the plain CPU versions.

Run: python -m agilex_ntt_tpu_torch.examples.production_rns_serving
[--device cpu|cuda]
"""

import numpy as np

from agilex_ntt_tpu_torch import RNSRing
from agilex_ntt_tpu_torch.examples._common import (
    check, device_from, host, mesh_devices,
)
from agilex_ntt_tpu_torch.parallel import ShardedRNSRing, make_mesh


def main(argv=None):
    device = device_from(argv, __doc__)
    n, L, batch = 4096, 4, 64

    rns = RNSRing(n, num_primes=L, device=device)
    oracle = RNSRing(n, num_primes=L, device="cpu")

    devices = mesh_devices(device, 8)
    mesh = make_mesh(ch=4, dp=2, devices=devices)
    srns = ShardedRNSRing(rns, mesh, dp_axis="dp", ch_axis="ch")
    print(f"mesh: ch=4 x dp=2 over {len(set(devices))} distinct device(s)")

    rng = np.random.default_rng(0)
    a = np.stack(
        [rng.integers(0, r.q, size=(batch, n), dtype=np.uint32)
         for r in rns.rings]
    )
    b = np.stack(
        [rng.integers(0, r.q, size=(batch, n), dtype=np.uint32)
         for r in rns.rings]
    )

    # ciphertext-style multiply: one fused kernel per device shard
    c = host(srns.polymul(srns.shard(a), srns.shard(b)))
    want = host(oracle.polymul(a, b))
    check((c == want).all(), "sharded RNS polymul mismatch")
    print(f"sharded RNS polymul OK: L={L}, n={n}, batch={batch}, "
          "bit-exact vs the unsharded plain versions")

    # remainder-frame batch (the reference's miniBatchSize+1 capability)
    a_odd = a[:, : batch - 3]
    y = host(srns.ntt(a_odd))
    check((y == host(oracle.ntt(a_odd))).all(), "remainder batch mismatch")
    print(f"remainder batch OK: {batch - 3} frames over the dp axis")


if __name__ == "__main__":
    main()
