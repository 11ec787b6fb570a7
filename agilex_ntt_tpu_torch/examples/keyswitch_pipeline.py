"""Key-switch-shaped RNS pipeline: raise -> NTT -> polydot -> lower.

Counterpart of ``examples/keyswitch_pipeline.py``, the inner loop of FHE
serving end to end on the port's ``RNSRing``:

  1. RAISE    residues from the ciphertext basis Q (L primes) into the
              extended basis Q u P by fast base conversion
              (``RNSRing.base_convert``, the HPS float-corrected variant),
  2. DOT      a fused polynomial inner product against k key columns in
              the NTT domain on every extended-basis channel
              (``RNSRing.polydot``: transforms, Montgomery pointwise
              accumulation and the inverse in one kernel launch),
  3. LOWER    divide-and-round by the special prime back into Q
              (``RNSRing.rescale``).

The same pipeline runs on a dp=4 mesh (``make_mesh``: the host's cards, or
the one card repeated) and is held word for word to the one-device run;
the raise/lower arithmetic is held to the big-int oracle.

Run: python -m agilex_ntt_tpu_torch.examples.keyswitch_pipeline
[--device cpu|cuda]
"""

import numpy as np
import torch

from agilex_ntt_tpu_torch import RNSRing
from agilex_ntt_tpu_torch.examples._common import (
    check, device_from, host, mesh_devices,
)
from agilex_ntt_tpu_torch.params import find_primes
from agilex_ntt_tpu_torch.parallel import ShardedRNSRing, make_mesh


def main(argv=None):
    device = device_from(argv, __doc__)
    n, batch, k = 1024, 16, 3
    qs = find_primes(n, 4)           # ciphertext basis Q (3) + special p (1)
    q_basis, special = qs[:3], qs[3]
    rq = RNSRing(n, qs=q_basis, device=device)
    rqp = RNSRing(n, qs=q_basis + [special], device=device)

    rng = np.random.default_rng(0)
    ct = np.stack(
        [rng.integers(0, q, size=(batch, k, n), dtype=np.uint32)
         for q in q_basis], axis=0,
    )
    # key material lives in the EXTENDED basis (generated there, never
    # converted), shape (L+1, batch, k, n)
    keys = np.stack(
        [rng.integers(0, q, size=(batch, k, n), dtype=np.uint32)
         for q in rqp.qs], axis=0,
    )
    ct_t = rq._as_u32(ct)

    # -- one-device run --------------------------------------------------------
    # 1. raise: Q -> Q u P.  The Q channels pass through untouched; only the
    # special channel is new (and exact under correction='float').
    special_res = rq.base_convert(
        ct.reshape(rq.L, -1, n), [special], correction="float"
    ).reshape(1, batch, k, n)
    ext = torch.cat([ct_t, special_res], dim=0)
    dot = rqp.polydot(ext, keys)
    lowered = rqp.rescale(dot)
    print(f"one device: ct{ct.shape} -> ext{tuple(ext.shape)} -> "
          f"dot{tuple(dot.shape)} -> lowered{tuple(lowered.shape)}")

    # -- the same pipeline over a mesh -----------------------------------------
    mesh = make_mesh(dp=4, devices=mesh_devices(device, 4))
    srq = ShardedRNSRing(rq, mesh, dp_axis="dp")
    srqp = ShardedRNSRing(rqp, mesh, dp_axis="dp")
    m_special = srq.base_convert(
        ct.reshape(rq.L, -1, n), [special], correction="float",
    ).reshape(1, batch, k, n)
    m_ext = torch.cat([ct_t, m_special.to(device)], dim=0)
    m_dot = srqp.polydot(srqp.shard(m_ext), srqp.shard(keys))
    m_low = srqp.rescale(m_dot)
    check((host(m_low) == host(lowered)).all(),
          "mesh pipeline diverged from the one-device run")
    print("mesh (dp=4): bit-identical end to end")

    # -- hybrid variant: gadget digits feed polydot as the dot axis ------------
    # Hybrid key switching decomposes ct into dnum digits FIRST (noise
    # control), raises each digit into Q u P, and dots the digits against
    # per-digit key columns: digits become polydot's k axis directly.
    dnum = 3
    digits = rq.gadget_decompose(
        ct[:, :, 0, :], rqp, dnum, correction="float"
    )  # (dnum, L+1, batch, n)
    dig_k = digits.permute(1, 2, 0, 3)  # (L+1, B, dnum, n)
    ksk = np.stack(
        [rng.integers(0, q, size=(batch, dnum, n), dtype=np.uint32)
         for q in rqp.qs], axis=0,
    )
    ks_dot = rqp.polydot(dig_k, ksk)
    ks_out = rqp.rescale(ks_dot)
    print(f"hybrid (dnum={dnum}): digits{tuple(digits.shape)} "
          f"-> dot{tuple(ks_dot.shape)} -> lowered{tuple(ks_out.shape)}")

    # ...or as the one-call op (shared key material, (dnum, K, n)):
    ksk_shared = np.stack(
        [np.stack([rng.integers(0, q, size=n, dtype=np.uint32)
                   for q in rqp.qs]) for _ in range(dnum)]
    )
    one_call = rq.keyswitch(ct[:, :, 0, :], ksk_shared, rqp, dnum)
    print(f"RNSRing.keyswitch: {ct[:, :, 0, :].shape} -> "
          f"{tuple(one_call.shape)} (digits -> polydot -> mod_down)")

    # -- hoisted rotation batch (Halevi-Shoup) ---------------------------------
    # BSGS matrix-vector serving: ONE decomposition + ONE digit transform
    # shared by every Galois step; each step pays only an eval-domain slot
    # permutation + pointwise dot + inverse + ModDown.
    steps = (3, 5, 2 * n - 1)  # three rotation exponents
    ksks = np.stack([ksk_shared] * len(steps))  # per-step keys (same here)
    hoisted = rq.hoisted_keyswitch(ct[:, :, 0, :], ksks, steps, rqp, dnum)
    check(tuple(hoisted.shape) == (len(steps), rq.L, batch, n),
          f"hoisted_keyswitch returned {tuple(hoisted.shape)}")
    # step j must equal keyswitching the tau_j'd digits the slow way
    dig_ch = digits.movedim(0, 1)
    tau = rqp.automorphism(dig_ch, steps[0])
    tau_k = tau.movedim(1, -2)
    key_k = rqp._as_u32(ksk_shared).movedim(0, -2)[:, None].expand(
        tau_k.shape)
    slow = rqp.mod_down(rqp.polydot(tau_k, key_k), count=1)
    check((host(hoisted[0]) == host(slow)).all(),
          "hoisted step 0 disagreed with the per-step composition")
    print(f"hoisted_keyswitch: {len(steps)} rotations from one "
          f"decomposition -> {tuple(hoisted.shape)}, step 0 bit-exact "
          f"vs the per-step composition")

    # -- big-int oracle for the raise/lower arithmetic ------------------------
    # raise is exact (correction='float'): the special-channel residues must
    # equal the CRT-composed ciphertext mod p
    composed = rq.from_rns(ct.reshape(rq.L, -1, n))
    expect = (composed % special).astype(np.uint32)
    check((host(special_res).reshape(-1, n) == expect).all(),
          "raise disagreed with the big-int oracle")
    # lower: rescale(dot) == round(dot / p) in Q (centered subtraction)
    dot_big = rqp.from_rns(dot)
    s = dot_big % special
    s = np.where(s > special // 2, s - special, s)
    y = (dot_big - s) // special
    low = host(lowered)
    for l, q in enumerate(q_basis):
        check((low[l] == (y % q).astype(np.uint32)).all(),
              f"lower channel {l} disagreed with the big-int oracle")
    print("oracle: raise and lower both exact vs big-int CRT")


if __name__ == "__main__":
    main()
