"""RNS base conversion and rescaling, on int64 tensors.

Counterpart of ``agilex_ntt_tpu/ops/basechange.py`` (``base_convert``,
``scale_round``, ``base_convert_sk``, ``rescale``, ``mod_down``,
``rescale_bgv``, ``mod_down_bgv``), with the
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


def _shoup_sum(ys, pairs, p: int) -> torch.Tensor:
    """sum_l ys[l] w_l mod p in [0, p) for the Shoup pairs (w_l, w_l'):
    lazy products in [0, 2p), the running sum kept below 2p."""
    acc = None
    for y, pair in zip(ys, pairs):
        t = _shoup(y, pair, p)
        acc = t if acc is None else cond_sub(acc + t, 2 * p)
    return cond_sub(cond_sub(acc, 2 * p), p)


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
        acc = _shoup_sum(ys, mat[j], p)
        if correction == "float":
            eq = _shoup(e, qmodp[j], p)
            acc = sub_mod(acc, cond_sub(eq, p), p)
        outs.append(acc)
    return torch.stack(outs)


@functools.lru_cache(maxsize=64)
def _scale_round_tables(qs_src: tuple, qs_dst: tuple, t: int):
    """Host tables for round(t x / Q) into qs_dst (HPS scale and round):
    per source channel the Shoup pair of (Q/q_l)^-1 mod q_l and the float32
    constants t 2^15 / q_l and t / q_l (the hi/lo split fractional sum); per
    (dst j, src l) the Shoup pair of [t q_l^-1]_{p_j}; per dst j the Shoup
    pair of [t Q^-1]_{p_j} and the Barrett mu of p_j."""
    L, K = len(qs_src), len(qs_dst)
    Q = 1
    for q in qs_src:
        Q *= q
    qtilde = np.zeros((L, 2), dtype=np.uint32)
    th = np.zeros(L, dtype=np.float32)
    tl = np.zeros(L, dtype=np.float32)
    for l, q in enumerate(qs_src):
        qhat = Q // q
        qtilde[l] = _shoup_pair(pow(qhat % q, q - 2, q), q)
        th[l] = float(t) * float(1 << 15) / float(q)
        tl[l] = float(t) / float(q)
    tq = np.zeros((K, L, 2), dtype=np.uint32)
    tQ = np.zeros((K, 2), dtype=np.uint32)
    mu = np.zeros(K, dtype=np.uint32)
    for j, p in enumerate(qs_dst):
        for l, q in enumerate(qs_src):
            tq[j, l] = _shoup_pair((t * pow(q % p, p - 2, p)) % p, p)
        tQ[j] = _shoup_pair((t * pow(Q % p, p - 2, p)) % p, p)
        mu[j] = (1 << 32) // p
    return qtilde, th, tl, tq, tQ, mu


def scale_round(
    x_src: torch.Tensor,
    x_dst: torch.Tensor,
    qs_src: Sequence[int],
    qs_dst: Sequence[int],
    t: int,
) -> torch.Tensor:
    """round(t x / Q) mod each p_j, the BFV scale-invariant division, int64.

    ``x`` is one integer in [0, Q P') held in the union basis qs_src (+)
    qs_dst: ``x_src`` its residues (L, ..., n) mod the Q primes, ``x_dst``
    its residues (K, ..., n) mod the target primes, each coprime to Q.  HPS
    folding (the base-conversion overflow cancels):

        round(t x / Q) ≡ [t Q^-1]_p x_p - sum_l xt_l [t q_l^-1]_p + v  (mod p)
        v = round(sum_l xt_l t / q_l),   xt_l = [x_l (Q/q_l)^-1]_{q_l}

    v is the one float step: xt_l split into 15-bit halves, each half times
    its float32 constant, the two products added and the terms summed in
    channel order, each product and each sum rounded to float32 as the JAX
    package computes it, then rounded half to even.  The same v serves
    every target channel, so the outputs are residues of one integer.
    """
    qs_src = tuple(int(q) for q in qs_src)
    qs_dst = tuple(int(q) for q in qs_dst)
    qtilde, th, tl, tq, tQ, mu = _scale_round_tables(qs_src, qs_dst, int(t))
    th_t = torch.from_numpy(th).to(x_src.device)
    tl_t = torch.from_numpy(tl).to(x_src.device)

    xts, v = [], None
    for l, q in enumerate(qs_src):
        xt = cond_sub(_shoup(x_src[l], qtilde[l], q), q)
        xts.append(xt)
        hi = (xt >> 15).to(torch.float32)
        lo = (xt & 0x7FFF).to(torch.float32)
        term = hi * th_t[l] + lo * tl_t[l]
        v = term if v is None else v + term
    v = torch.round(v).to(torch.int64)  # < L t < 2^21

    outs = []
    for j, p in enumerate(qs_dst):
        a = cond_sub(_shoup(x_dst[j], tQ[j], p), p)
        y = sub_mod(a, _shoup_sum(xts, tq[j], p), p)
        outs.append(cond_sub(y + _barrett_small(v, int(mu[j]), p), p))
    return torch.stack(outs)


@functools.lru_cache(maxsize=64)
def _sk_tables(qs_src: tuple, m_sk: int, qs_dst: tuple):
    """Host tables for the Shenoy-Kumaresan exact conversion from qs_src
    (+) {m_sk} to qs_dst: per l the Shoup pair of (B/b_l)^-1 mod b_l and of
    [B/b_l]_{m_sk}, the pair of B^-1 mod m_sk, per (j, l) the pair of
    [B/b_l]_{q_j} and per j the pair of [B]_{q_j}."""
    L = len(qs_src)
    B = 1
    for b in qs_src:
        B *= b
    btilde = np.zeros((L, 2), dtype=np.uint32)
    for l, b in enumerate(qs_src):
        bhat = B // b
        btilde[l] = _shoup_pair(pow(bhat % b, b - 2, b), b)
    sk_mat = np.zeros((L, 2), dtype=np.uint32)
    for l, b in enumerate(qs_src):
        sk_mat[l] = _shoup_pair((B // b) % m_sk, m_sk)
    binv_sk = _shoup_pair(pow(B % m_sk, m_sk - 2, m_sk), m_sk)
    K = len(qs_dst)
    mat = np.zeros((K, L, 2), dtype=np.uint32)
    bmod = np.zeros((K, 2), dtype=np.uint32)
    for j, p in enumerate(qs_dst):
        for l, b in enumerate(qs_src):
            mat[j, l] = _shoup_pair((B // b) % p, p)
        bmod[j] = _shoup_pair(B % p, p)
    return btilde, sk_mat, binv_sk, mat, bmod


def base_convert_sk(
    x: torch.Tensor,
    x_sk: torch.Tensor,
    qs_src: Sequence[int],
    m_sk: int,
    qs_dst: Sequence[int],
) -> torch.Tensor:
    """Exact base conversion through the Shenoy-Kumaresan redundant modulus,
    int64.

    ``x`` (L, ..., n) are the residues mod qs_src of an integer y with
    0 <= y < B = prod(qs_src), ``x_sk`` (..., n) the same integer's residue
    mod m_sk.  The approximate conversion gives y + e B with 0 <= e < L;
    the m_sk channel pins e = [(approx_sk - x_sk) B^-1]_{m_sk} exactly, so
    the output is y mod q_j with no float step.
    """
    qs_src = tuple(int(q) for q in qs_src)
    qs_dst = tuple(int(q) for q in qs_dst)
    m_sk = int(m_sk)
    btilde, sk_mat, binv_sk, mat, bmod = _sk_tables(qs_src, m_sk, qs_dst)

    yts = [cond_sub(_shoup(x[l], btilde[l], b), b)
           for l, b in enumerate(qs_src)]
    diff = sub_mod(_shoup_sum(yts, sk_mat, m_sk), x_sk, m_sk)
    e = cond_sub(_shoup(diff, binv_sk, m_sk), m_sk)  # the exact e in [0, L)
    return torch.stack([
        sub_mod(_shoup_sum(yts, mat[j], p), cond_sub(_shoup(e, bmod[j], p), p),
                p)
        for j, p in enumerate(qs_dst)
    ])


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
