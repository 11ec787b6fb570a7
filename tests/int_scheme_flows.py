"""The parity flows of the port's RNS-BGV and RNS-BFV against the JAX
package's, shared by ``test_torch_bgv.py`` and ``test_torch_bfv.py``.

One flow a scheme, from one seed, through the JAX package's context and
through the port's: keys in both domains, encodings, both encryptions,
decryption, add, sub, negate, ``add_plain`` and ``mul_plain``,
``multiply``, ``square``, ``rescale``, ``mod_down_to``, the row rotations
and the row swap, a linear transform and the full BSGS matvec, at the top
level and at a lower one; BGV's also ``poly_eval`` in both bases, BFV's
each stage of its HPS multiply (the lift, the tensor parts, the scale and
round, the Shenoy-Kumaresan return).  Both contexts draw every secret,
error and mask from ``np.random.default_rng(FLOW_SEED)`` with the same
calls in the same order, so they hold the same words.

The JAX flows run once a test session, both in one child process
(``test_torch_jaxref.py``), op by op (``jax.disable_jit()``): compiled,
the scheme graphs cost minutes of XLA CPU compile, and the float32 steps
(the HPS estimates of ``base_convert`` and ``scale_round``) would be
contracted into fused multiply-adds (ROADMAP Queue 3, Q3-1), which the
port, op by op on the CPU and on the card, does not do.
"""

import time

import numpy as np
import torch

from test_torch_jaxref import computed_once

FLOW_N, FLOW_L, FLOW_LOW, FLOW_SEED = 16, 4, 2, 2027
S = FLOW_N // 2
ROT_STEPS = (1, -1)
LIN_STEPS = (0, 1, -1)
# degree 4: the baby x^2 by a square, a full giant node; Chebyshev: T_3 by
# the odd recurrence, a constant quotient on T_4; degree 2 below
POWER = [3, 7, 1, 5, 2]
CHEB = [3, 1, 7, 2, 5]
# BSGS steps of the full n/2 matvec at FLOW_N (split 3 x 3) and the rows'
STEPS = (-1, 1, 2, 3, 6)
LEVEL_CTS = ("add", "sub", "negate", "add_plain", "mul_plain", "multiply",
             "square", "rescale", "conjugate", "apply_linear",
             "apply_matvec") + tuple(f"rotate{t}" for t in ROT_STEPS)
BGV_CTS = ("poly_power", "poly_cheb")
# BFV's multiply, stage by stage: the four lifted parts, the three tensor
# parts, each scaled and rounded into B + {m_sk}, each returned to Q
HPS = (tuple(f"lift.{p}" for p in ("a0", "a1", "b0", "b1"))
       + tuple(f"{stage}.d{i}" for stage in ("tensor", "scale_round", "sk")
               for i in range(3)))


def flow_names(scheme: str):
    elements = sorted({pow(5, t % S, 2 * FLOW_N) for t in STEPS}
                      | {1, 2 * FLOW_N - 1})
    names = ["sk", "sk_rns", "pk0", "pk1", "rlk_b", "rlk_a", "rlk_coeff_b",
             "rlk_coeff_a", "pt1", "pt2", "slot_pos", "level_scales"]
    for g in elements:
        names += [f"gk{g}_b", f"gk{g}_a", f"gk_coeff{g}_b", f"gk_coeff{g}_a"]
    cts = ["enc1", "enc2", "encsym"]
    for lvl in (FLOW_L, FLOW_LOW):
        names += [f"L{lvl}.decrypt", f"L{lvl}.linear.pts", f"L{lvl}.linear.kb",
                  f"L{lvl}.linear.ka", f"L{lvl}.matvec.pts",
                  f"L{lvl}.matvec.baby_ksks", f"L{lvl}.decoded"]
        cts += [f"L{lvl}.{op}" for op in LEVEL_CTS]
        if lvl != FLOW_L:
            cts.append(f"L{lvl}.mod_down_to")
        if scheme == "bgv":
            cts += [f"L{lvl}.{op}" for op in BGV_CTS]
        else:
            names += [f"L{lvl}.aux"] + [f"L{lvl}.{s}" for s in HPS]
    return names + [f"{c}.{part}" for c in cts for part in ("c0", "c1")]


def flow(ctx, arr, hps=None) -> dict:
    """Every op of the slice on ``ctx``, each output as numpy under a name
    of ``flow_names`` (``arr`` turns a JAX array or a tensor into numpy);
    ``hps(ctx, a, b, level)`` gives BFV's multiply stage by stage."""
    keys = ctx.keygen(galois_steps=STEPS)
    out = {"sk": np.asarray(keys.sk), "sk_rns": arr(keys.sk_rns),
           "pk0": arr(keys.pk[0]), "pk1": arr(keys.pk[1]),
           "slot_pos": np.asarray(ctx._slot_pos)}
    for name, pair in (("rlk", keys.rlk), ("rlk_coeff", keys.rlk_coeff)):
        out[name + "_b"], out[name + "_a"] = arr(pair[0]), arr(pair[1])
    for g in sorted(keys.gk):
        out[f"gk{g}_b"], out[f"gk{g}_a"] = (arr(k) for k in keys.gk[g])
        out[f"gk_coeff{g}_b"], out[f"gk_coeff{g}_a"] = (
            arr(k) for k in keys.gk_coeff[g])
    rng = np.random.default_rng(FLOW_SEED + 1)
    m1, m2 = (rng.integers(0, ctx.t, (2, 2, S)) for _ in range(2))
    ws = [rng.integers(0, ctx.t, (2, S)) for _ in LIN_STEPS]
    M = rng.integers(0, ctx.t, (S, S))
    encode_mul = getattr(ctx, "encode_mul", ctx.encode)
    pt1, pt2 = ctx.encode(m1), ctx.encode(m2)
    out["pt1"], out["pt2"] = arr(pt1.rns), arr(pt2.rns)
    scales = []

    def put(name, ct):
        out[name + ".c0"], out[name + ".c1"] = arr(ct.c0), arr(ct.c1)
        scales.append(str(ct.scale))

    c1, c2 = ctx.encrypt(pt1, keys), ctx.encrypt(pt2, keys)
    put("enc1", c1)
    put("enc2", c2)
    put("encsym", ctx.encrypt_symmetric(pt1, keys))
    for lvl in (FLOW_L, FLOW_LOW):
        tag = f"L{lvl}"
        a, b = ctx.mod_down_to(c1, lvl), ctx.mod_down_to(c2, lvl)
        if lvl != FLOW_L:
            put(f"{tag}.mod_down_to", a)
        out[f"{tag}.decrypt"] = arr(ctx.decrypt(a, keys).rns)
        put(f"{tag}.add", ctx.add(a, b))
        put(f"{tag}.sub", ctx.sub(a, b))
        put(f"{tag}.negate", ctx.negate(a))
        put(f"{tag}.add_plain", ctx.add_plain(a, ctx.encode(m2, level=lvl)))
        put(f"{tag}.mul_plain", ctx.mul_plain(a, encode_mul(m2, level=lvl)))
        prod = ctx.multiply(a, b, keys)
        put(f"{tag}.multiply", prod)
        put(f"{tag}.square", ctx.square(a, keys))
        resc = ctx.rescale(prod)
        put(f"{tag}.rescale", resc)
        out[f"{tag}.decoded"] = np.asarray(ctx.decode(ctx.decrypt(resc, keys)))
        for t in ROT_STEPS:
            put(f"{tag}.rotate{t}", ctx.rotate(a, t, keys))
        put(f"{tag}.conjugate", ctx.conjugate(a, keys))
        op = ctx.make_linear_op(list(zip(LIN_STEPS, ws)), keys, lvl)
        for name in ("pts", "kb", "ka"):
            out[f"{tag}.linear.{name}"] = arr(getattr(op, name))
        put(f"{tag}.apply_linear", ctx.apply_linear(a, op))
        mv = ctx.make_matvec(M, keys, lvl)
        out[f"{tag}.matvec.pts"] = arr(mv.pts)
        out[f"{tag}.matvec.baby_ksks"] = arr(mv.baby_ksks)
        put(f"{tag}.apply_matvec", ctx.apply_matvec(a, mv))
        if hps is None:
            top = lvl == FLOW_L
            put(f"{tag}.poly_power",
                ctx.poly_eval(a, POWER if top else POWER[:3], keys))
            put(f"{tag}.poly_cheb",
                ctx.poly_eval(a, CHEB if top else CHEB[:3], keys,
                              basis="chebyshev"))
        else:
            for name, v in hps(ctx, a, b, lvl).items():
                out[f"{tag}.{name}"] = arr(v) if name != "aux" else v
    out["level_scales"] = np.array(scales)
    return out


def jax_hps(ctx, a, b, level: int) -> dict:
    """The JAX package's ``_mul_fused`` stage by stage (its own calls)."""
    import jax.numpy as jnp

    from agilex_ntt_tpu.ops import basechange as jb

    aux, rbig = ctx._aux(level)
    qs = tuple(ctx.qs[:level])
    lifted = [jnp.concatenate(
        [c, jb.base_convert(c, qs, aux, correction="float")], axis=0)
        for c in (a.c0, a.c1, b.c0, b.c1)]
    parts = rbig.tensor(*lifted)
    ys = [jb.scale_round(d[:level], d[level:], qs, aux, ctx.t) for d in parts]
    back = [jb.base_convert_sk(y[:-1], y[-1], aux[:-1], aux[-1], qs)
            for y in ys]
    return _stages(aux, lifted, parts, ys, back)


def port_hps(ctx, a, b, level: int) -> dict:
    """The port's multiply stage by stage: ``_lift``, the union ring's
    ``tensor``, ``basechange.scale_round`` and ``_scale_down`` (the scale
    and round, then the Shenoy-Kumaresan return)."""
    from agilex_ntt_tpu_torch.ops import basechange as B

    aux, rbig = ctx._aux(level)
    qs = ctx.qs[:level]
    lifted = [ctx._lift(c, level) for c in (a.c0, a.c1, b.c0, b.c1)]
    parts = rbig.tensor(*lifted)
    ys = [B.scale_round(d[:level].to(torch.int64), d[level:].to(torch.int64),
                        qs, aux, ctx.t).to(torch.uint32) for d in parts]
    back = [ctx._scale_down(d, level) for d in parts]
    return _stages(aux, lifted, parts, ys, back)


def _stages(aux, lifted, parts, ys, back) -> dict:
    out = {"aux": np.array(aux, dtype=np.int64)}
    for p, v in zip(("a0", "a1", "b0", "b1"), lifted):
        out[f"lift.{p}"] = v
    for stage, vs in (("tensor", parts), ("scale_round", ys), ("sk", back)):
        for i, v in enumerate(vs):
            out[f"{stage}.d{i}"] = v
    return out


def _jax_flows() -> dict:
    """Both flows on the JAX package's contexts, op by op; "__seconds__" is
    their time in the child."""
    import jax

    from agilex_ntt_tpu.schemes.bfv import BFVContext
    from agilex_ntt_tpu.schemes.bgv import BGVContext

    t0 = time.perf_counter()
    with jax.disable_jit():
        out = {
            "bgv": flow(BGVContext(FLOW_N, FLOW_L,
                                   rng=np.random.default_rng(FLOW_SEED)),
                        np.asarray),
            "bfv": flow(BFVContext(FLOW_N, FLOW_L,
                                   rng=np.random.default_rng(FLOW_SEED)),
                        np.asarray, jax_hps),
        }
    out["__seconds__"] = time.perf_counter() - t0
    return out


_FLOWS = {}


def jax_flows(request, tmp_path_factory) -> dict:
    """The JAX flows, computed once for every xdist worker of the session
    (and once in a session without xdist)."""
    if "jax" not in _FLOWS:
        _FLOWS["jax"] = computed_once(request, tmp_path_factory,
                                      "int_jax_flows", _jax_flows)
    return _FLOWS["jax"]


def port_flow(scheme: str) -> dict:
    from agilex_ntt_tpu_torch.schemes import BFVContext, BGVContext

    ctx = (BGVContext if scheme == "bgv" else BFVContext)(
        FLOW_N, FLOW_L, rng=np.random.default_rng(FLOW_SEED), device="cpu")
    return flow(ctx, lambda t: t.numpy(), None if scheme == "bgv" else port_hps)


def mismatches(want: dict, got: dict, names) -> list:
    """The names whose outputs differ in dtype, shape or any word."""
    bad = []
    for name in names:
        w, g = np.asarray(want[name]), np.asarray(got[name])
        if w.dtype != g.dtype or w.shape != g.shape or not np.array_equal(w, g):
            bad.append(name)
    return bad
