"""RNS base conversion and rescaling, on int64 tensors.

Counterpart of ``agilex_ntt_tpu/ops/basechange.py`` (``base_convert``,
``rescale``, ``mod_down``, ``rescale_bgv``, ``mod_down_bgv``), with the
same host tables and the same word-for-word arithmetic.  There these are
elementwise and channel-mixing XLA code, not Pallas kernels; here they are
plain PyTorch, the same on the CPU and the card.  Values are int64 tensors
holding uint32 words (see ``modmul.py``); Shoup products go through
``shoup_mulmod_lazy``, whose 16-bit split keeps a * w' (up to 2**64) from
overflowing.

Fast base conversion (HPS/BEHZ): for x given by residues x_l mod q_l,

    y_l   = [x_l * (Q/q_l)^-1]_{q_l}                (one Shoup mulmod)
    S     = sum_l y_l * (Q/q_l)  =  x + e*Q,  e = floor(sum_l y_l / q_l) < L
    out_j = [S]_{p_j} = sum_l y_l * [(Q/q_l)]_{p_j}  - e * [Q]_{p_j}

``correction="float"`` (HPS) estimates e with a float32 sum of y_l / q_l,
each product and each sum rounded to float32 in channel order, as the JAX
package computes it; ``correction="none"`` (BEHZ) returns x + e*Q mod p_j.

Rescaling (drop the last prime, divide and round):

    t_l   = centered [x_L]_{q_L} reduced mod q_l
    out_l = [(x_l - t_l) * q_L^-1]_{q_l}            l < L-1
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from .modmul import cond_sub, mulhi_u32, shoup_mulmod_lazy, sub_mod


def _shoup_pair(w: int, q: int) -> Tuple[np.uint32, np.uint32]:
    return np.uint32(w), np.uint32((w << 32) // q)


@functools.lru_cache(maxsize=64)
def _convert_tables(qs_src: tuple, qs_dst: tuple):
    """Host tables for qs_src -> qs_dst conversion (all numpy)."""
    L, K = len(qs_src), len(qs_dst)
    Q = 1
    for q in qs_src:
        Q *= q
    qtilde = np.zeros((L, 2), dtype=np.uint32)   # (Q/q_l)^-1 mod q_l + precon
    for l, q in enumerate(qs_src):
        qhat = Q // q
        qtilde[l] = _shoup_pair(pow(qhat % q, q - 2, q), q)
    mat = np.zeros((K, L, 2), dtype=np.uint32)   # [Q/q_l]_{p_j} + precon
    qmodp = np.zeros((K, 2), dtype=np.uint32)    # [Q]_{p_j} + precon
    for j, p in enumerate(qs_dst):
        for l, q in enumerate(qs_src):
            mat[j, l] = _shoup_pair((Q // q) % p, p)
        qmodp[j] = _shoup_pair(Q % p, p)
    inv_q_f32 = np.array([1.0 / q for q in qs_src], dtype=np.float32)
    return qtilde, mat, qmodp, inv_q_f32


def _shoup(x: torch.Tensor, pair, q: int) -> torch.Tensor:
    """x * w mod q in [0, 2q) for a Shoup pair (w, w')."""
    return shoup_mulmod_lazy(x, int(pair[0]), int(pair[1]), q)


def base_convert(
    x: torch.Tensor,
    qs_src: Sequence[int],
    qs_dst: Sequence[int],
    *,
    correction: str = "none",
) -> torch.Tensor:
    """Residues (L, ..., n) mod qs_src -> (K, ..., n) mod qs_dst, int64.

    correction="none": classical BEHZ approximate conversion, x + e*Q mod
    p_j with 0 <= e < L.  correction="float": the HPS float32 estimate of e
    is subtracted.  Inputs in [0, q_l); outputs in [0, p_j).
    """
    if correction not in ("none", "float"):
        raise ValueError(f"correction must be none|float, got {correction!r}")
    qs_src, qs_dst = tuple(int(q) for q in qs_src), tuple(int(q) for q in qs_dst)
    qtilde, mat, qmodp, inv_q = _convert_tables(qs_src, qs_dst)

    ys = [cond_sub(_shoup(x[l], qtilde[l], q), q) for l, q in enumerate(qs_src)]

    if correction == "float":
        # float32 throughout, one rounding per product and per sum, in
        # channel order; inv_q[l] is the float32 nearest 1/q_l
        inv = torch.from_numpy(inv_q).to(x.device)
        v = ys[0].to(torch.float32) * inv[0]
        for l in range(1, len(qs_src)):
            v = v + ys[l].to(torch.float32) * inv[l]
        e = torch.floor(v).to(torch.int64)

    outs = []
    for j, p in enumerate(qs_dst):
        acc = None
        for l in range(len(qs_src)):
            t = _shoup(ys[l], mat[j, l], p)  # [0, 2p)
            acc = t if acc is None else cond_sub(acc + t, 2 * p)
        acc = cond_sub(cond_sub(acc, 2 * p), p)  # [0, p)
        if correction == "float":
            eq = _shoup(e, qmodp[j], p)
            acc = sub_mod(acc, cond_sub(eq, p), p)
        outs.append(acc)
    return torch.stack(outs)


def _barrett_small(u: torch.Tensor, mu: int, q: int) -> torch.Tensor:
    """u mod q for u < 2**30 with mu = floor(2**32 / q): one Barrett step
    lands in [0, 2q), two conditional subtractions finish it."""
    m = mulhi_u32(u, mu)
    return cond_sub(cond_sub(u - m * q, 2 * q), q)


@functools.lru_cache(maxsize=64)
def _rescale_tables(qs: tuple):
    """Host tables for dropping q_L: per surviving channel l, the Barrett mu
    for reducing values < q_L mod q_l, [q_L]_{q_l} and q_L^-1 mod q_l."""
    qL = qs[-1]
    out = []
    for q in qs[:-1]:
        mu = (1 << 32) // q
        out.append((
            np.uint32(mu),
            _shoup_pair(qL % q, q),
            _shoup_pair(pow(qL % q, q - 2, q), q),
        ))
    return out, qL


def rescale(x: torch.Tensor, qs: Sequence[int]) -> torch.Tensor:
    """Divide and round by the last prime: (L, ..., n) -> (L-1, ..., n).

    out_l = [(x_l - centered([x_{L-1}]_{q_L})) * q_L^-1]_{q_l}, the residues
    of round(x / q_L) in the basis qs[:-1].  Inputs and outputs in [0, q_l).
    """
    qs = tuple(int(q) for q in qs)
    if len(qs) < 2:
        raise ValueError("rescale needs at least 2 primes")
    tabs, qL = _rescale_tables(qs)
    xL = x[-1]
    big = xL > qL // 2  # centered lift: subtract qL when high
    outs = []
    for l, (mu, (rw, _), inv) in enumerate(tabs):
        q = qs[l]
        t = _barrett_small(xL, int(mu), q)
        # centered: x_L - qL  ==  t - [qL]_{q_l}  (mod q_l)
        t = torch.where(big, sub_mod(t, int(rw), q), t)
        diff = sub_mod(x[l], t, q)
        outs.append(cond_sub(_shoup(diff, inv, q), q))
    return torch.stack(outs)


def _check_count(qs: tuple, count: int) -> None:
    if not 1 <= count <= len(qs) - 1:
        raise ValueError(
            f"count must be in [1, L-1={len(qs) - 1}], got {count}"
        )


def mod_down(x: torch.Tensor, qs: Sequence[int], count: int = 1) -> torch.Tensor:
    """Iterated divide and round: drop the last ``count`` primes one at a
    time (the ModDown after a key switch in an extended basis).
    (L, ..., n) -> (L-count, ..., n)."""
    qs = tuple(int(q) for q in qs)
    _check_count(qs, count)
    for i in range(count):
        x = rescale(x, qs[: len(qs) - i])
    return x


@functools.lru_cache(maxsize=64)
def _rescale_bgv_tables(qs: tuple, t: int):
    """Host tables for the t-correcting drop of q_L: the Shoup pair of
    t^-1 mod q_L and, per surviving channel, the Barrett mu for u < q_L and
    the Shoup pairs of [t]_{q_l}, [t q_L]_{q_l} and q_L^-1 mod q_l."""
    qL = qs[-1]
    tinv = _shoup_pair(pow(t % qL, qL - 2, qL), qL)
    out = []
    for q in qs[:-1]:
        mu = (1 << 32) // q
        out.append((
            np.uint32(mu),
            _shoup_pair(t % q, q),
            _shoup_pair((t * qL) % q, q),
            _shoup_pair(pow(qL % q, q - 2, q), q),
        ))
    return tinv, out, qL


def rescale_bgv(x: torch.Tensor, qs: Sequence[int], t: int) -> torch.Tensor:
    """BGV modulus switch: drop q_L by the t-multiple correction.

    out = (x - delta) / q_L with delta = t * centered([x_L t^-1]_{q_L}), so
    delta ≡ x (mod q_L) and delta ≡ 0 (mod t): the division is exact and
    the phase mod t survives up to the q_L^-1 factor the scheme tracks.
    (L, ..., n) -> (L-1, ..., n); inputs and outputs in [0, q_l).
    """
    qs = tuple(int(q) for q in qs)
    t = int(t)
    if len(qs) < 2:
        raise ValueError("rescale_bgv needs at least 2 primes")
    tinv, tabs, qL = _rescale_bgv_tables(qs, t)
    u = cond_sub(_shoup(x[-1], tinv, qL), qL)  # [x_L t^-1]_{q_L}
    big = u > qL // 2  # centered lift of u
    outs = []
    for l, (mu, tw, tqw, inv) in enumerate(tabs):
        q = qs[l]
        ul = _barrett_small(u, int(mu), q)
        tu = cond_sub(_shoup(ul, tw, q), q)
        # centered: t (u - qL) == t u - [t qL]_{q_l}  (mod q_l)
        tu = torch.where(big, sub_mod(tu, int(tqw[0]), q), tu)
        diff = sub_mod(x[l], tu, q)
        outs.append(cond_sub(_shoup(diff, inv, q), q))
    return torch.stack(outs)


def mod_down_bgv(
    x: torch.Tensor, qs: Sequence[int], t: int, count: int = 1
) -> torch.Tensor:
    """Iterated t-correcting divide: the BGV ModDown after an extended-basis
    key switch.  (L, ..., n) -> (L-count, ..., n)."""
    qs = tuple(int(q) for q in qs)
    _check_count(qs, count)
    for i in range(count):
        x = rescale_bgv(x, qs[: len(qs) - i], t)
    return x
