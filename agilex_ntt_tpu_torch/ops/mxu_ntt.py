"""The four-step forward NTT with both passes as matrix products on the
tensor cores.

Counterpart of ``agilex_ntt_tpu/ops/mxu_ntt.py``.  With n = n1 n2 and the
coefficients viewed as (B, n1, n2), the two passes of the four-step
transform are products with constant matrices:

    column:  G[b, k, c] = sum_r D[k, r] X[b, r, c],  D[k, r] = psi1^((2 bitrev(k) + 1) r)
    row:     H[b, r, p] = sum_c G'[b, r, c] R[p, c],  R[p, c] = omega2^(bitrev(p) c)

(D[k, r] = omega1^(bitrev(k) r) for a cyclic plan), with G' the twiddled G.
No unit of either machine multiplies mod q, so each product is built from
int8 digits: both operands split into four balanced signed base-256
digits, the 16 digit products summed into the seven partials
P_s = sum_{i + j = s} A_i B_j, and sum_s P_s 256^s reduced mod q.  The
output is bit-identical to ``Ring.ntt``'s four-step transform (both are
the exact transform, reduced to [0, q)).

On the card each pass is one launch of kernel M1 (``csrc/ntt_mxu.cuh``:
``wgmma`` on s8 digits from shared memory, fed by bulk copies through
mbarrier-guarded stages; a converting warpgroup splits the data, two
consumer warpgroups multiply into five partials and reconstruct them);
``mxu_pass`` is its wrapper and adds one to ``ntt_kernel.LAUNCHES["mxu"]``
a launch.  On a CPU tensor the wrapper
runs the plain version below, the JAX module's functions under its names:
the same digit split, the 16 products (as float64 products, which are
exact here: every sum is an integer below 2^53; PyTorch has no integer
matrix product on the card), and the JAX package's Horner reconstruction
step by step.  There is no fallback: a CUDA tensor is never handed to the
plain version.

Nothing dispatches to these functions, as nothing does in the JAX package
(there the matrix form lost to the vector path on the TPU, BASELINE.md
"MXU four-step formulation"); ``chip_smoke.py`` and ``utils/mxu_probe.py``
time them beside ``Ring.ntt`` on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..params import CyclicParams, bit_reverse_array
from . import _build
from . import modmul as mm
from .fourstep import FourStepPlan
from .ntt_kernel import LAUNCHES, _stream
from .plain_ntt import _u32_tensor

DIGITS = 4
# The pass sizes n1 and n2 the functions take: the JAX reconstruction's
# offset (2^27) bounds the partials, |P_s| <= 4 K 2^14, so K <= 2048; the
# kernel's blocks are 64 rows x 32 k, so K >= 64 on the card.
MAX_SIDE = 1 << 11
MIN_KERNEL_SIDE = 1 << 6


def _balanced_digits_np(m: np.ndarray) -> np.ndarray:
    """(DIGITS, *m.shape) int8 balanced-signed base-256 digits of uint32/64
    values < 2**30 (host side, for the constant DFT matrices)."""
    v = m.astype(np.int64)
    out = np.zeros((DIGITS,) + m.shape, dtype=np.int8)
    for k in range(DIGITS):
        d = v & 0xFF
        adj = d >= 128
        d = d - 256 * adj
        v = (v >> 8) + adj
        out[k] = d.astype(np.int8)
    if not (v == 0).all():
        raise ValueError("values exceed the digit range")
    return out


def _balanced_digits(x: torch.Tensor) -> list:
    """The balanced digits of values < 2**30 (any integer tensor) as a list
    of DIGITS int8 tensors.

    The bound matters: at values just below 2**31 the carry chain pushes a
    fifth digit out of the top (silent truncation), so callers reduce to
    [0, q) (q < 2**30) first; the top digit then stays <= 64.
    """
    v = x.to(torch.int64)
    out = []
    for _ in range(DIGITS):
        d = v & 255
        adj = (d >= 128).to(torch.int64)
        d = d - 256 * adj
        v = (v >> 8) + adj
        out.append(d.to(torch.int8))
    return out


def _vandermonde(bases: np.ndarray, width: int, q: int) -> np.ndarray:
    """M[k, r] = bases[k]^r mod q, built with `width` vectorized uint64
    column multiplies (bases, M < 2**30 so the products stay < 2**60)."""
    m = np.ones((len(bases), width), dtype=np.uint64)
    for r in range(1, width):
        m[:, r] = m[:, r - 1] * bases % np.uint64(q)
    return m


def _bases(root: int, size: int, q: int, odd: bool) -> np.ndarray:
    """root^(2 bitrev(k) + 1) (``odd``) or root^bitrev(k) mod q, k < size."""
    br = bit_reverse_array(size)
    exps = 2 * br + 1 if odd else br
    return np.array([pow(root, int(e), q) for e in exps], dtype=np.uint64)


@functools.lru_cache(maxsize=32)
def _col_matrix_digits(plan: FourStepPlan) -> np.ndarray:
    """D[k, r] = psi1^((2*bitrev(k)+1) r): the negacyclic column DFT
    (omega1^(bitrev(k) r) for cyclic plans), as (DIGITS, n1, n1) int8."""
    n1, q = plan.n1, plan.q
    if isinstance(plan.col, CyclicParams):
        bases = _bases(plan.col.omega, n1, q, odd=False)
    else:
        bases = _bases(plan.col.psi, n1, q, odd=True)
    return _balanced_digits_np(_vandermonde(bases, n1, q))


@functools.lru_cache(maxsize=32)
def _row_matrix_digits(plan: FourStepPlan) -> np.ndarray:
    """R[p, c] = omega2^(bitrev(p) c): the cyclic row DFT, as
    (DIGITS, n2, n2) int8."""
    n2, q = plan.n2, plan.q
    return _balanced_digits_np(
        _vandermonde(_bases(plan.row.omega, n2, q, odd=False), n2, q)
    )


def _reconstruct_mod(partials, q: int) -> torch.Tensor:
    """Horner-reassemble sum_s P_s * 256^s mod q from the 2*DIGITS-1 signed
    partials (int64 tensors of int32 values), output in [0, q) as int64.

    The JAX package's words step by step: u <- (256 u mod q, Shoup lazy) +
    (P_s + OFF) as a 32-bit word, then a Barrett reduction (mu =
    floor(2**32 / q), residue in [0, 3q)).  OFF is a fixed multiple of q
    above max |P_s| that makes the signed partial non-negative without
    changing it mod q.
    """
    off = ((1 << 27) // q + 1) * q  # > 4 * n1_max * 2^14 = 2^27
    mu = (1 << 32) // q
    pre256 = (256 << 32) // q

    def barrett(v):
        m = mm.mulhi_u32(v, mu)
        r = (v - m * q) & mm.MASK32
        return mm.cond_sub(mm.cond_sub(r, 2 * q), q)

    u = barrett((partials[-1] + off) & mm.MASK32)
    for s in range(len(partials) - 2, -1, -1):
        t = mm.shoup_mulmod_lazy(u, 256, pre256, q)  # [0, 2q)
        u = barrett((t + ((partials[s] + off) & mm.MASK32)) & mm.MASK32)
    return u


def _digit_matmul(mat_digits: torch.Tensor, x_digits: list, pattern: str,
                  q: int) -> torch.Tensor:
    """Exact mod-q product of a constant digit-split matrix with digit-split
    data: 16 digit products into the seven partials, then the Horner
    reconstruction.  The products run in float64, exact: a digit product is
    at most 2^14 in size and a partial at most 4 K 2^14 <= 2^27."""
    nparts = 2 * DIGITS - 1
    partials = [None] * nparts
    xs = [d.to(torch.float64) for d in x_digits]
    for i in range(DIGITS):
        di = mat_digits[i].to(torch.float64)
        for j in range(DIGITS):
            p = torch.einsum(pattern, di, xs[j])
            s = i + j
            partials[s] = p if partials[s] is None else partials[s] + p
    return _reconstruct_mod([p.to(torch.int64) for p in partials], q)


# -- the tables on a device, the kernel's wrapper --------------------------------


# the kernel's blocks of A: 64 rows x 32 k, core matrices of 8 rows x 16
# bytes (csrc/ntt_mxu.cuh mxu_core_offset)
BLOCK_ROWS, BLOCK_K = 64, 32


def _kernel_tiles(digits: torch.Tensor):
    """A (DIGITS, M, K) int8 digit matrix in the order the kernel copies it:
    for each 64-row block and 32-column block, the four digits' 64 x 32
    blocks, each as wgmma reads it without swizzle (row groups of 8 at 256
    bytes, a group's two 16-byte k halves at 128, 16 bytes a row); None
    where M or K is below a block."""
    d, m, k = digits.shape
    if m < BLOCK_ROWS or k < BLOCK_K:
        return None
    t = digits.reshape(d, m // BLOCK_ROWS, BLOCK_ROWS // 8, 8, k // BLOCK_K,
                       BLOCK_K // 16, 16)
    # (digit, m block, row group, row, k block, k half, byte) ->
    # (m block, k block, digit, row group, k half, row, byte)
    return t.permute(1, 4, 0, 2, 5, 3, 6).contiguous()


@dataclasses.dataclass(frozen=True, eq=False)
class MxuTables:
    """One plan's constants on one device: ``col`` and ``row`` the (DIGITS,
    n1, n1) and (DIGITS, n2, n2) int8 digit planes of D and R, ``tw`` and
    ``tw_precon`` the (n1, n2) twiddles and their Shoup words, uint32;
    ``col_tiles`` and ``row_tiles`` the planes in the kernel's order
    (``_kernel_tiles``, None below 64)."""

    n1: int
    n2: int
    q: int
    col: torch.Tensor
    row: torch.Tensor
    tw: torch.Tensor
    tw_precon: torch.Tensor
    col_tiles: torch.Tensor | None
    row_tiles: torch.Tensor | None

    @property
    def device(self) -> torch.device:
        return self.tw.device


@functools.lru_cache(maxsize=32)
def mxu_tables(plan: FourStepPlan, device: torch.device) -> MxuTables:
    """The plan's matrix digits and twiddles on ``device``, built once per
    plan and device (D's digits take 16 MiB at n1 = 2048, twice with the
    kernel's copy)."""
    for side in (plan.n1, plan.n2):
        if side > MAX_SIDE:
            raise ValueError(
                f"the matrix-product passes take n1, n2 <= {MAX_SIDE} (the "
                f"partials' bound); this plan is {plan.n1} x {plan.n2}")

    def digits(a):
        return torch.from_numpy(a).to(device)

    col = digits(_col_matrix_digits(plan))
    row = digits(_row_matrix_digits(plan))
    return MxuTables(
        n1=plan.n1, n2=plan.n2, q=plan.q, col=col, row=row,
        tw=_u32_tensor(plan.tw, device),
        tw_precon=_u32_tensor(plan.tw_precon, device),
        col_tiles=_kernel_tiles(col), row_tiles=_kernel_tiles(row),
    )


def col_pass_plain(x3: torch.Tensor, mt: MxuTables) -> torch.Tensor:
    """G = D X mod q of int64 (B, n1, n2) words in [0, 4q) (reduced to
    [0, q) first, for the digit bound), in [0, q)."""
    q = mt.q
    xt = mm.cond_sub(mm.cond_sub(x3, 2 * q), q)
    return _digit_matmul(mt.col, _balanced_digits(xt), "kr,brc->bkc", q)


def row_pass_plain(g: torch.Tensor, mt: MxuTables) -> torch.Tensor:
    """H = (T G) R^T mod q of int64 (B, n1, n2) words in [0, q): the
    inter-pass twiddle (positional Shoup, lazy [0, 2q) -> [0, q)), then the
    row product; in [0, q)."""
    q = mt.q
    tw, twp = mt.tw.to(torch.int64), mt.tw_precon.to(torch.int64)
    m2 = mm.cond_sub(mm.shoup_mulmod_lazy(g, tw, twp, q), q)
    return _digit_matmul(mt.row, _balanced_digits(m2), "pc,brc->brp", q)


def mxu_pass(x3: torch.Tensor, mt: MxuTables, row: bool) -> torch.Tensor:
    """One pass of the matrix-product transform on (B, n1, n2) uint32 words:
    the column pass (``row=False``, words in [0, 4q)) or the row pass with
    the inter-pass twiddle first (``row=True``, words in [0, q)); out a new
    (B, n1, n2) uint32 tensor in [0, q).

    On a CUDA tensor one launch of M1 (``mxu_col_kernel`` or
    ``mxu_row_kernel``: persistent CTAs of 384 threads over 128 x 64
    tiles, ``mxu_launch_info``) on the current stream; on a CPU tensor the
    plain version."""
    if not isinstance(x3, torch.Tensor):
        raise TypeError(f"mxu_pass: expected a torch.Tensor, got "
                        f"{type(x3).__name__}")
    if x3.dtype != torch.uint32:
        raise TypeError(f"mxu_pass: expected torch.uint32, got {x3.dtype}")
    if x3.device != mt.device:
        raise ValueError(f"mxu_pass: tensor on {x3.device}, tables on "
                         f"{mt.device}")
    if x3.dim() != 3 or tuple(x3.shape[1:]) != (mt.n1, mt.n2) or not x3.shape[0]:
        raise ValueError(f"mxu_pass: expected (B >= 1, n1={mt.n1}, "
                         f"n2={mt.n2}), got {tuple(x3.shape)}")
    if not x3.is_contiguous():
        raise ValueError("mxu_pass: tensor must be contiguous")
    if x3.device.type == "cpu":
        plain = row_pass_plain if row else col_pass_plain
        return plain(x3.to(torch.int64), mt).to(torch.uint32).contiguous()
    if min(mt.n1, mt.n2) < MIN_KERNEL_SIDE:
        raise ValueError(f"mxu_pass: the kernel takes n1, n2 >= "
                         f"{MIN_KERNEL_SIDE}; this plan is {mt.n1} x {mt.n2}")
    if x3.data_ptr() % 16:
        raise ValueError("mxu_pass: the kernel copies 16-byte pieces; the "
                         "tensor's data must start on a 16-byte boundary")
    tiles = mt.row_tiles if row else mt.col_tiles
    y = torch.empty_like(x3)
    lib = _build.load()
    with torch.cuda.device(x3.device):
        rc = lib.ntt_mxu_pass(
            x3.data_ptr(), y.data_ptr(),
            tiles.data_ptr(),
            mt.tw.data_ptr(), mt.tw_precon.data_ptr(), x3.shape[0],
            mt.n1.bit_length() - 1, mt.n2.bit_length() - 1, int(row), mt.q,
            _stream(x3),
        )
    _build.check(lib, rc, "mxu_pass")
    LAUNCHES["mxu"] += 1
    return y


def mxu_launch_info(mt: MxuTables, row: bool, batch: int) -> dict:
    """The launch of one M1 pass at (batch, n1, n2): its tile (M x N, k a
    stage), threads a CTA and by role (the converting warpgroup, the
    consumers on wgmma), the stages of the operand ring and of the raw
    ring, shared memory a CTA, registers a thread as launched (before
    setmaxnreg) and local memory (spills), CTAs an SM, the persistent CTAs
    launched and the tiles they walk."""
    lib = _build.load()
    info = (ctypes.c_int * 14)()
    _build.check(lib, lib.ntt_mxu_launch_info(
        int(row), mt.n1.bit_length() - 1, mt.n2.bit_length() - 1, batch,
        info), "mxu_launch_info")
    keys = ("tile_m", "tile_n", "tile_k", "threads", "smem_bytes",
            "registers", "local_bytes", "ctas_per_sm", "ctas",
            "converter_threads", "consumer_threads", "stages", "raw_stages",
            "tiles")
    return dict(zip(keys, info))


# -- the JAX module's public functions -----------------------------------------


def fwd_ntt_fourstep_mxu(x: torch.Tensor, plan: FourStepPlan) -> torch.Tensor:
    """Forward four-step NTT of (batch, n) uint32 with both passes as matrix
    products.  Input in [0, 4q); output [0, q), bit-identical to the
    four-step ``Ring.ntt`` (the same exact transform, the same final range).
    Two ``mxu_pass`` launches on the card, the plain version on the CPU."""
    if x.dim() != 2 or x.shape[-1] != plan.n:
        raise ValueError(f"fwd_ntt_fourstep_mxu: expected (batch, n={plan.n}), "
                         f"got {tuple(x.shape)}")
    b = x.shape[0]
    mt = mxu_tables(plan, x.device)
    g = mxu_pass(x.reshape(b, plan.n1, plan.n2), mt, row=False)
    return mxu_pass(g, mt, row=True).view(b, plan.n)


def fwd_col_pass_mxu(xt: torch.Tensor, plan: FourStepPlan) -> torch.Tensor:
    """The column pass alone (G = D X mod q on (B, n1, n2) uint32 in
    [0, 4q), out [0, q)), for the pass-level A/B against the four-step
    column kernel.  On words below 2**30 it equals the JAX function's."""
    return mxu_pass(xt, mxu_tables(plan, xt.device), row=False)
