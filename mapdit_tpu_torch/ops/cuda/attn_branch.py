"""Attention half-block on Hopper: forward, residual forward, fused backward.

Port of the attention half of ``mapdit_tpu/ops/pallas/dit_block.py``:
``fused_attn_branch`` and its three Pallas kernels,

  row 3  ``_attn_fwd_impl`` (forward)            -> :func:`attn_fwd`
  row 5  ``_attn_res_fwd_impl`` (+ p, attn)      -> :func:`attn_res_fwd`
  row 4  ``_attn_bwd_impl`` / ``_attn_bwd_math`` -> :func:`attn_bwd`
  row 4' ``_attn_bwd_dw_kernel`` (dW in the kernel) -> :func:`attn_bwd` with
         :func:`dw_gemm`, taken when ``16*D*D <= DW_IN_KERNEL_BUDGET``

with the plain-op backward over the residuals (``_attn_bwd_from_res``) and
the reference VJP. The half-block is

  y = mp_sum(x, gate * out_proj(cosine_attention(qkv(modulate(x)))), 0.3)

On the card rows 3, 4 and 5 are one launch each of ``csrc/attn_branch.cu``
(:func:`attn_branch_fwd`, :func:`attn_branch_bwd`, :func:`attn_branch_res_fwd`:
a persistent work list laid out by :func:`branch_plan`, shift, scale and gate
read in place) where :func:`branch_route` takes the shape: bf16, head widths
64 and 72, an even T <= 64 dividing 128, D a multiple of 8, 16-byte aligned
operands. Elsewhere (T = 256 at 32 x 32 latents among them) the half-block
runs as a launch sequence of other rows' kernels (:func:`fwd_launch_sequence`, :func:`bwd_launch_sequence`,
:func:`res_fwd_launch_sequence`, counted as ``attn_branch/<row>/sequence``),
with shift, scale and gate packed once into one (N, 3D) f32 row buffer (the model hands
them in as bf16, so the upcast is exact) and the gain read from device
memory: ``mp_gemm`` with the modulate prologue, ``cosine_attention`` (the
residual mode for row 5), and ``mp_gemm`` with the gated-residual epilogue.
The fused backward recomputes the forward and runs the hand VJP in this
order, the one-launch kernel's stages too (``csrc/attn_branch_bwd.cu`` for
the sequence's stages between the products):

  h = modulate_fwd(x)                      bf16, also the dW_qkv operand
  qkv = h . Wqkv^T / sqrt(D)               mp_gemm
  attn = cosine_attention(qkv), residual   bf16, also the dW_out operand
  dout, dgate = out_gate_residual_bwd(attn, dy)          (a) mp_gemm with the
                                           residual backward as its epilogue:
                                           out = attn . Wout^T / sqrt(D) is
                                           never stored
  dattn = dout . Wout / sqrt(D)            mp_gemm reading W as (K, N)
  dqkv = attention_bwd(qkv, dattn)                       (b)
  dh = dqkv . Wqkv / sqrt(D)               mp_gemm reading W as (K, N)
  dx, dshift, dscale, dgain = modulate_bwd(dh, x, dy)    (c), one launch;
                                           dx = dy*0.7/rd + du*scale: the
                                           residual's direct path is formed
                                           here, no f32 dx0 array
  dWqkv = dqkv^T h / sqrt(D), dWout = dout^T attn / sqrt(D)   one bf16 product
                                           each with f32 sums and output, or
                                           dw_gemm (csrc/dw_gemm.cu)

The two dW products are library products, as the Pallas package leaves them
to XLA outside its streaming kernel (``dot_general`` of the bf16 operands
with ``preferred_element_type=f32``: every product of two bf16 values is
exact in f32, so only the order of the sums differs); where
``16*D*D <= DW_IN_KERNEL_BUDGET``
(the Pallas package's predicate for its in-kernel-dW variant, off by default
there and here: the train CLI on the card, bound by the host, ran no faster
with it, PERF.md) they go through :func:`dw_gemm`, which contracts the bf16
operands over the N*T rows with f32 sums, split across blocks and reduced in
a fixed order, and applies 1/sqrt(D) once at the end. Gradient semantics are
the reference's: the modulate denominator is constant in the gain,
``normalize`` gets the full quotient VJP. Three roundings are kept apart, as in the Pallas kernels: row 3 divides
after P.V on the unnormalised exponentials; row 5 and the backward's
attention normalise p first and round it to bf16; (b) recomputes the exact
softmax of the pre-normalised bf16 q/k; h, dqkv, attn and dout leave as bf16.

Every wrapper takes its kernel for a CUDA tensor (raising on what it does not
take) and its plain PyTorch version for a CPU tensor. ``LAUNCHES`` counts
launches (``attn_branch/fwd``, ``attn_branch/bwd`` and ``attn_branch/res_fwd``:
of the one-launch kernels; ``attn_branch/<row>/sequence``: calls of a launch
sequence); :func:`reset_launch_counts` zeroes them.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from mapdit_tpu_torch.ops.cuda.dit_block import (
    H100_SMS,
    RES_DENOM,
    RES_T,
    NORM_EPS,
    ATTENTION_HEAD_WIDTHS,
    STACK_TILE,
    STACK_K,
    StackProduct,
    _DTYPE_CODE,
    _cdiv,
    _mp_gemm_splits,
    _raise_on,
    _require_cuda,
    _rows,
    attention_reference,
    cosine_attention,
    cosine_attention_plain,
    modulate_reference,
    mp_gemm,
    mp_gemm_plain,
    needs_grad,
    vjp_through,
)
from mapdit_tpu_torch.ops.cuda.dit_block_tp import (
    TP_PLAN_HEADER,
    TP_PLAN_STAGE_WORDS,
    TP_SYNC_DONE,
    TpPlan,
    TpStage,
    _row_operands,
)
from mapdit_tpu_torch.ops.mp import mp_sum

LAUNCHES = {
    "attn_bwd/out_gate_residual": 0,
    "attn_bwd/attention": 0,
    "attn_bwd/modulate_fwd": 0,
    "attn_bwd/modulate_bwd": 0,
    "attn_bwd/dw": 0,
    "attn_branch/fwd": 0,
    "attn_branch/res_fwd": 0,
    "attn_branch/bwd": 0,
    "attn_branch/fwd/sequence": 0,
    "attn_branch/bwd/sequence": 0,
    "attn_branch/res_fwd/sequence": 0,
}
BWD_IMPLS = ("pallas", "residual", "reference")
DX_FAC = (1.0 - RES_T) / RES_DENOM
DB_FAC = RES_T / RES_DENOM
_LIB = "attn_branch_bwd"
# The f32 dW accumulators of the in-kernel-dW backward take 16*D*D bytes; the
# variant is taken when they fit this budget (the Pallas package's predicate
# and its default: off). Raise it to run the dW products through dw_gemm.
DW_IN_KERNEL_BUDGET = 0
# the longest sequence the CUDA attention backward takes: up to 64 one form
# (four warps of 16 query rows, one key tile, p and dlog in shared memory),
# past it a second that keeps the head's T rows of q, k, v and do in shared
# memory and no T x T array (180 KB at T = 256 and hd 72)
ATTENTION_BWD_MAX_T = 256
# columns a thread of the CUDA modulate passes takes, with 16-byte accesses
MODULATE_COLUMNS = 8
# rows of one mp_gemm tile: where T divides it the CUDA out_gate_residual_bwd
# sums each sample inside a tile; elsewhere a sample's tile sums are added in
# tile order, which takes T > GATE_GROUP_ROWS (a thread's 8 rows meet at most
# two samples)
GEMM_TILE_ROWS = 128
GATE_GROUP_ROWS = 8
# the one-launch kernels of rows 3, 4 and 5 (csrc/attn_branch.cu): their lists
# (stage kinds: dit_block_tp.TP_STAGE_KINDS), the plan's words (the TP plans'
# header, one group a stage), the longest sequence (one tile of 64 queries
# and keys), the trace's words a CTA.
# BRANCH_KERNELS False runs the launch sequences in their place (the
# yardstick: chip_smoke.py trains on both)
BRANCH_STAGES = {
    "fwd": ("pre", "qkv", "attention", "out"),
    "res_fwd": ("pre", "qkv", "attention", "out"),
    "bwd": ("pre", "qkv", "attention", "out", "dattn", "attention_bwd", "dh"),
}
BRANCH_PLAN_WORDS = TP_PLAN_HEADER + 7 * TP_PLAN_STAGE_WORDS
BRANCH_MAX_T = 64
# token rows of a pre item: the most of these whose rows of x (ceil(D / 64)
# boxes of 64 columns, bf16) fill one 32 KB ring stage
BRANCH_PRE_ROWS = (32, 16, 8)
BRANCH_STAGE_BYTES = 2 * STACK_TILE * STACK_K * 2
BRANCH_MAX_D = BRANCH_STAGE_BYTES // (BRANCH_PRE_ROWS[-1] * 2)  # the widest D whose 8 rows fill a stage
BRANCH_TRACE_WORDS = 24
BRANCH_KERNELS = True
# row splits of a dW product on the card, each one bf16 product with f32
# output, the splits' sums added in order: one product over the N*T rows of
# DiT-XL/2 at 256 lands 1.7-1.9e-5 (relative L2) off the f32 pair, four hold
# it to 4-5e-6 (mapdit_tpu_torch/tools/bench_attn_branch.py)
DW_SPLITS = (4, 2, 1)


def dw_in_kernel(d: int) -> bool:
    return 16 * d * d <= DW_IN_KERNEL_BUDGET


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _lib():
    from mapdit_tpu_torch.ops.cuda import build

    return build.library(_LIB)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_rows(rows, n):
    if rows.dtype != torch.float32 or rows.ndim != 2 or rows.shape[0] != n:
        raise ValueError(f"rows must be f32 with {n} rows, got {rows.dtype} {tuple(rows.shape)}")


def _gain_value(gain: torch.Tensor) -> torch.Tensor:
    if gain.dtype != torch.float32 or gain.numel() != 1:
        raise ValueError("the gain must be one f32 value")
    return gain


# ---------------------------------------------------------------------------
# (a) the out product with the gated MP residual backward as its epilogue


def gate_residual_bwd_plain(dy, out, rows, gate_off, tokens, out_dtype):
    """Backward of y = (x + (gate*out - x)*0.3)/sqrt(0.58) through its
    branch, over flat (N*T, D) rows: dy (x's type), out f32, rows (N, *) f32
    holding gate at ``gate_off``. Returns dout = dy*0.3/rd*gate
    (``out_dtype``) and the per-sample dgate rows (N, D) f32; the direct
    path dy*0.7/rd is :func:`modulate_bwd`'s."""
    m, d = out.shape
    db = dy.reshape(m, d).float() * DB_FAC
    dgate = (db * out).reshape(m // tokens, tokens, d).sum(dim=1)
    dout = (db * _rows(rows[:, gate_off : gate_off + d], tokens)).to(out_dtype)
    return dout, dgate


def out_gate_residual_bwd_plain(attn, w_out, dy, rows, gate_off, tokens):
    """Plain version of :func:`out_gate_residual_bwd`: the f32 product of
    :func:`mp_gemm_plain`, then :func:`gate_residual_bwd_plain`."""
    out = mp_gemm_plain(attn, w_out, alpha=1.0 / math.sqrt(w_out.shape[1]), out_dtype=torch.float32)
    return gate_residual_bwd_plain(dy, out, rows, gate_off, tokens, w_out.dtype)


def check_out_gate_residual_shape(tokens: int) -> None:
    """Raise unless the CUDA :func:`out_gate_residual_bwd` takes T =
    ``tokens``: T dividing GEMM_TILE_ROWS (a tile of the product holds whole
    samples: T = 64, 16, 4 at 16 x 16 latents) or T > GATE_GROUP_ROWS (a
    sample's sums cross tiles and are added in tile order: T = 256 at 32 x
    32). T = 3, 5, 6 and 7 are refused."""
    if tokens < 1 or (GEMM_TILE_ROWS % tokens and tokens <= GATE_GROUP_ROWS):
        raise ValueError(f"out_gate_residual_bwd on CUDA takes T dividing {GEMM_TILE_ROWS} or above "
                         f"{GATE_GROUP_ROWS}, got T={tokens}")


def out_gate_residual_bwd(attn, w_out, dy, rows, gate_off, tokens):
    """The attention backward's out product with the residual backward of
    y = (x + (gate*out - x)*0.3)/sqrt(0.58) as its epilogue: out = attn .
    w_out^T / sqrt(D) (attn (N*T, D), w_out (D, D) in the weights' type) is
    formed and used, never stored; dy (N*T*D elements, f32 or bf16) and the
    f32 rows (N, *) holding gate at ``gate_off``. Returns dout =
    dy*0.3/rd*gate in the weights' type and dgate = sum_t dy*0.3/rd*out
    (N, D) f32. One launch of ``csrc/mp_gemm.cu`` (one more under split-K,
    and one more where T does not divide 128: the tiles' sums of a sample
    added in tile order). On the card: bf16 operands,
    :func:`check_out_gate_residual_shape`, D a multiple of 8 and 16-byte
    aligned tensors; it raises otherwise, naming CUDA."""
    if attn.device.type == "cpu":
        return out_gate_residual_bwd_plain(attn, w_out, dy, rows, gate_off, tokens)
    from mapdit_tpu_torch.ops.cuda import build

    m, k = attn.shape
    n = w_out.shape[0]
    if attn.dtype != torch.bfloat16 or w_out.dtype != torch.bfloat16 or w_out.shape != (n, k):
        raise ValueError(f"out_gate_residual_bwd on CUDA takes bf16 attn (M, K) and a bf16 (N, K) weight (its float32 "
                         f"form comes with row 4's float32 slice), got "
                         f"{attn.dtype} {tuple(attn.shape)} and {w_out.dtype} {tuple(w_out.shape)}")
    if dy.dtype not in _DTYPE_CODE or dy.numel() != m * n:
        raise ValueError(f"out_gate_residual_bwd on CUDA takes f32/bf16 dy of {m}x{n} elements, got {dy.dtype} "
                         f"{tuple(dy.shape)}")
    check_out_gate_residual_shape(tokens)
    if m % tokens or k % 8 or n % 8:
        raise ValueError(f"out_gate_residual_bwd on CUDA takes M a multiple of T and K, N multiples of 8, got "
                         f"M={m}, K={k}, N={n}, T={tokens}")
    _check_rows(rows, m // tokens)
    if gate_off + n > rows.shape[1] or gate_off % 4 or rows.shape[1] % 4:
        raise ValueError("out_gate_residual_bwd on CUDA reads the gate as float4: offset and row length must be "
                         "multiples of 4, the gate inside the rows")
    dout = torch.empty(m, n, dtype=torch.bfloat16, device=attn.device)
    dgate = torch.empty(m // tokens, n, dtype=torch.float32, device=attn.device)
    _require_cuda(attn, w_out, dy, rows, dout, dgate)
    _check_aligned("out_gate_residual_bwd", attn, w_out, dy, rows)
    splits = _mp_gemm_splits(m, n, k)
    partial = torch.empty(splits, m, n, dtype=torch.float32, device=attn.device) if splits > 1 else None
    lib = build.library("mp_gemm")
    tile_floats = lib.mp_gemm_gate_partial_floats(m, n, tokens)
    tile_partial = torch.empty(tile_floats, dtype=torch.float32, device=attn.device) if tile_floats else None
    code = lib.mp_gemm_gate_residual_bwd(
        attn.data_ptr(), w_out.data_ptr(), dout.data_ptr(), dgate.data_ptr(), m, n, k, 1.0 / math.sqrt(k),
        rows.data_ptr(), rows.shape[1], gate_off, dy.data_ptr(), _DTYPE_CODE[dy.dtype], tokens,
        None if partial is None else partial.data_ptr(), None if tile_partial is None else tile_partial.data_ptr(),
        _stream(attn),
    )
    _raise_on(code, lib, "out_gate_residual_bwd", "mp_gemm")
    LAUNCHES["attn_bwd/out_gate_residual"] += 1
    return dout, dgate


# ---------------------------------------------------------------------------
# (b) attention backward


def _dnorm(z, r, dzn, sqrt_hd):
    """Full quotient VJP of zn = z*sqrt(hd)/(r + eps), r = ||z||."""
    c = sqrt_hd / (r + NORM_EPS)
    zdot = (z * dzn).sum(dim=-1, keepdim=True)
    return c * dzn - z * (zdot * sqrt_hd / (r * (r + NORM_EPS) ** 2))


def _attention_vjp(qkv, dattn, tokens, heads, dt, p=None):
    """The per-head math of ``_attn_bwd_math`` batched over (N, heads),
    products on ``dt``-rounded operands with f32 sums. ``p`` is the saved
    softmax (N, heads, T, T); without it the exact softmax of the rounded
    normalised q/k is recomputed. Returns dqkv (N*T, 3D) f32, unrounded."""
    nt, d3 = qkv.shape
    d = d3 // 3
    n, hd = nt // tokens, d // heads
    sqrt_hd = math.sqrt(hd)

    def rd(z):
        return z.to(dt).float()

    q, k, v = qkv.float().reshape(n, tokens, 3, heads, hd).permute(2, 0, 3, 1, 4)
    do = dattn.float().reshape(n, tokens, heads, hd).transpose(1, 2)
    rq = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    rk = torch.linalg.vector_norm(k, dim=-1, keepdim=True)
    qn = q * sqrt_hd / (rq + NORM_EPS)
    kn = k * sqrt_hd / (rk + NORM_EPS)
    if p is None:
        p = torch.softmax((rd(qn) @ rd(kn).transpose(-1, -2)) * (1.0 / sqrt_hd), dim=-1)
    p = p.float()
    dp = rd(do) @ rd(v).transpose(-1, -2)
    dv = rd(p).transpose(-1, -2) @ rd(do)
    dlog = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dlog = dlog * (1.0 / sqrt_hd)
    dqn = rd(dlog) @ rd(kn)
    dkn = rd(dlog).transpose(-1, -2) @ rd(qn)
    cols = [_dnorm(q, rq, dqn, sqrt_hd), _dnorm(k, rk, dkn, sqrt_hd), dv]
    return torch.cat([z.transpose(1, 2).reshape(nt, d) for z in cols], dim=-1)


def attention_bwd_plain(qkv, dattn, tokens, heads, out_dtype):
    """Plain version of :func:`attention_bwd`."""
    return _attention_vjp(qkv, dattn, tokens, heads, out_dtype).to(out_dtype)


def check_attention_bwd_shape(tokens: int, hd: int) -> None:
    """Raise unless the CUDA ``attention_bwd`` takes T = ``tokens`` at head
    width ``hd``: the head widths of every registry model (each a template
    instance) and 1 <= T <= ATTENTION_BWD_MAX_T (T = 256 at 32 x 32 latents;
    past 64 the form that holds the head's rows, not p, in shared
    memory)."""
    if hd not in ATTENTION_HEAD_WIDTHS:
        raise ValueError(f"attention_bwd on CUDA takes head widths {ATTENTION_HEAD_WIDTHS}, got {hd}")
    if not 1 <= tokens <= ATTENTION_BWD_MAX_T:
        raise ValueError(f"attention_bwd on CUDA takes 1 <= T <= {ATTENTION_BWD_MAX_T}, got T={tokens}")


def attention_bwd(qkv, dattn, tokens, heads, out_dtype):
    """Attention backward over the flat f32 qkv product (N*T, 3D) and the
    f32 cotangent of the pre-projection attention (N*T, D); returns dqkv
    (N*T, 3D) in ``out_dtype`` (bf16 on the card), heads as column slices.
    On the card: :func:`check_attention_bwd_shape`."""
    if qkv.device.type == "cpu":
        return attention_bwd_plain(qkv, dattn, tokens, heads, out_dtype)
    nt, d3 = qkv.shape
    d = d3 // 3
    if qkv.dtype != torch.float32 or d3 != 3 * d or d % heads or nt % tokens:
        raise ValueError(f"attention_bwd takes f32 (N*T, 3D) qkv, got {qkv.dtype} {tuple(qkv.shape)}")
    if dattn.dtype != torch.float32 or dattn.shape != (nt, d) or out_dtype != torch.bfloat16:
        raise ValueError("attention_bwd takes f32 (N*T, D) dattn and writes bf16 dqkv")
    hd = d // heads
    check_attention_bwd_shape(tokens, hd)
    dqkv = torch.empty(nt, d3, dtype=torch.bfloat16, device=qkv.device)
    _require_cuda(qkv, dattn, dqkv)
    if qkv.data_ptr() % 16 or dattn.data_ptr() % 16:
        raise ValueError("attention_bwd reads 16 bytes a lane: qkv and dattn must start at a multiple of 16 bytes")
    lib = _lib()
    code = lib.attention_bwd(qkv.data_ptr(), dattn.data_ptr(), dqkv.data_ptr(), nt // tokens, tokens, heads, hd,
                             _stream(qkv))
    _raise_on(code, lib, "attention_bwd", _LIB)
    LAUNCHES["attn_bwd/attention"] += 1
    return dqkv


# ---------------------------------------------------------------------------
# (c) modulate forward and backward


def _modulate_rows(rows, d, tokens):
    return _rows(rows[:, :d], tokens), _rows(rows[:, d : 2 * d], tokens)


def check_modulate_shape(d: int) -> None:
    """Raise unless the CUDA modulate passes take width ``d``: a multiple of
    MODULATE_COLUMNS (eight columns a thread, 16-byte accesses). Every
    registry width (256, 384, 768, 1024, 1152) is one."""
    if d < MODULATE_COLUMNS or d % MODULATE_COLUMNS:
        raise ValueError(f"the CUDA modulate passes take D a multiple of {MODULATE_COLUMNS}, got D={d}")


def _check_modulate_rows(rows, n, d):
    _check_rows(rows, n)
    check_modulate_shape(d)
    if rows.shape[1] < 2 * d or rows.shape[1] % 4:
        raise ValueError(f"rows must hold shift and scale and be a multiple of 4 floats wide, got {rows.shape[1]}")


def _check_aligned(what, *tensors):
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what} reads and writes 16 bytes a thread: its tensors must start at a multiple of 16 "
                         "bytes")


def modulate_fwd_plain(x, rows, gain, tokens, out_dtype):
    """Plain version of :func:`modulate_fwd`."""
    d = x.shape[1]
    shift, scale = _modulate_rows(rows, d, tokens)
    g = gain.reshape(()).float()
    u = x.float() * scale
    return ((u + (shift - u) * g) / torch.sqrt((1.0 - g) ** 2 + g**2)).to(out_dtype)


def modulate_fwd(x, rows, gain, tokens, out_dtype):
    """h = (u + (shift - u)*g) / sqrt((1-g)^2 + g^2), u = x*scale, over flat
    (N*T, D) x with shift at column 0 and scale at column D of the f32 rows;
    returns h in ``out_dtype`` (bf16 on the card). On the card:
    :func:`check_modulate_shape` and 16-byte aligned x and rows."""
    if x.device.type == "cpu":
        return modulate_fwd_plain(x, rows, gain, tokens, out_dtype)
    m, d = x.shape
    if x.dtype not in _DTYPE_CODE or out_dtype != torch.bfloat16:
        raise ValueError("modulate_fwd takes f32/bf16 x and writes bf16 h")
    _check_modulate_rows(rows, m // tokens, d)
    gain = _gain_value(gain)
    h = torch.empty(m, d, dtype=torch.bfloat16, device=x.device)
    _require_cuda(x, rows, gain, h)
    _check_aligned("modulate_fwd", x, rows)
    lib = _lib()
    code = lib.modulate_fwd(x.data_ptr(), _DTYPE_CODE[x.dtype], rows.data_ptr(), rows.shape[1], 0, d,
                            gain.data_ptr(), h.data_ptr(), m // tokens, tokens, d, _stream(x))
    _raise_on(code, lib, "modulate_fwd", _LIB)
    LAUNCHES["attn_bwd/modulate_fwd"] += 1
    return h


def modulate_bwd_plain(dh, x, rows, gain, dy, tokens):
    """Plain version of :func:`modulate_bwd`."""
    m, d = x.shape
    n = m // tokens
    shift, scale = _modulate_rows(rows, d, tokens)
    g = gain.reshape(()).float()
    den = torch.sqrt((1.0 - g) ** 2 + g**2)
    xf = x.float()
    u = xf * scale
    du = dh * ((1.0 - g) / den)
    dshift = dh.reshape(n, tokens, d).sum(dim=1) * (g / den)
    dgain = (dh * (shift - u)).sum().reshape(1) / den
    dx = (dy.reshape(m, d).float() * DX_FAC + du * scale).to(x.dtype)
    dscale = (du * xf).reshape(n, tokens, d).sum(dim=1)
    return dx, dshift, dscale, dgain


def modulate_bwd(dh, x, rows, gain, dy, tokens):
    """Backward of :func:`modulate_fwd` with the denominator constant in the
    gain, plus the gated residual's direct path: dh f32 (N*T, D), x as given
    to the forward, dy the residual's cotangent (f32 or bf16, N*T*D
    elements). Returns dx = dy*0.7/rd + du*scale (x's type), the dshift and
    dscale rows (N, D) f32 and dgain (1,) f32, summed over the batch in a
    fixed order. One launch. On the card: :func:`check_modulate_shape` and
    16-byte aligned tensors."""
    if x.device.type == "cpu":
        return modulate_bwd_plain(dh, x, rows, gain, dy, tokens)
    m, d = x.shape
    n = m // tokens
    if dh.dtype != torch.float32 or dh.shape != (m, d):
        raise ValueError("modulate_bwd takes f32 (N*T, D) dh")
    if x.dtype not in _DTYPE_CODE or dy.dtype not in _DTYPE_CODE or dy.numel() != m * d:
        raise ValueError("modulate_bwd takes f32/bf16 x and dy of the same size")
    _check_modulate_rows(rows, n, d)
    gain = _gain_value(gain)
    _require_cuda(dh, x, dy, rows, gain)
    _check_aligned("modulate_bwd", dh, x, dy, rows)
    lib = _lib()
    dev = x.device
    dx = torch.empty_like(x)
    dshift = torch.empty(n, d, dtype=torch.float32, device=dev)
    dscale = torch.empty(n, d, dtype=torch.float32, device=dev)
    partial = torch.empty(lib.modulate_bwd_partials(n, d), dtype=torch.float32, device=dev)
    dgain = torch.empty(1, dtype=torch.float32, device=dev)
    code = lib.modulate_bwd(
        dh.data_ptr(), x.data_ptr(), _DTYPE_CODE[x.dtype], dy.data_ptr(), _DTYPE_CODE[dy.dtype], rows.data_ptr(),
        rows.shape[1], 0, d, gain.data_ptr(), dx.data_ptr(), dshift.data_ptr(), dscale.data_ptr(), partial.data_ptr(),
        dgain.data_ptr(), n, tokens, d, _stream(x),
    )
    _raise_on(code, lib, "modulate_bwd", _LIB)
    LAUNCHES["attn_bwd/modulate_bwd"] += 1
    return dx, dshift, dscale, dgain


# ---------------------------------------------------------------------------
# (d) the weight-gradient products of the in-kernel-dW variant


def dw_gemm_plain(a, b, alpha):
    """Plain version of :func:`dw_gemm`: the operands as they are (already
    in the weights' type), multiplied in f32."""
    return (a.t().float() @ b.float()) * alpha


def dw_gemm(a, b, alpha):
    """C (P, Q) f32 = alpha * a^T . b for bf16 a (M, P) and b (M, Q), summed
    in f32 over the M rows in a fixed order (the same bits on every run).
    One count of ``attn_bwd/dw`` is one product (the TMA + wgmma kernel over
    the splits of M, then, with more than one split, their sum in split
    order)."""
    if a.device.type == "cpu":
        return dw_gemm_plain(a, b, alpha)
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"dw_gemm takes bf16 (M, P) and (M, Q) operands, got {a.dtype} {tuple(a.shape)}, "
                         f"{b.dtype} {tuple(b.shape)}")
    m, p = a.shape
    q = b.shape[1]
    if b.shape[0] != m or m < 1 or p % 8 or q % 8:
        raise ValueError(f"dw_gemm takes operands with the same M >= 1 rows and widths that are multiples of 8, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    _require_cuda(a, b)
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("dw_gemm reads its operands with TMA: they must start at a multiple of 16 bytes")
    from mapdit_tpu_torch.ops.cuda import build

    lib = build.library("dw_gemm")
    splits = lib.dw_gemm_splits(m, p, q)
    partial = torch.empty(splits, p, q, dtype=torch.float32, device=a.device) if splits > 1 else None
    c = torch.empty(p, q, dtype=torch.float32, device=a.device)
    code = lib.dw_gemm(a.data_ptr(), b.data_ptr(), None if partial is None else partial.data_ptr(), c.data_ptr(),
                       m, p, q, float(alpha), _stream(a))
    _raise_on(code, lib, "dw_gemm")
    LAUNCHES["attn_bwd/dw"] += 1
    return c


# ---------------------------------------------------------------------------
# the half-block: forwards and backwards


def _pack(shift, scale, gate, gain):
    """One (N, 3D) f32 row buffer [shift | scale | gate] and the gain as a
    (1,) f32 device value."""
    rows = torch.cat([shift, scale, gate], dim=1).float().contiguous()
    return rows, gain.detach().reshape(1).float().contiguous()


def _check(x, shift, scale, gate, gain, w_qkv, w_out, heads):
    n, t, d = x.shape
    if d % heads:
        raise ValueError(f"D={d} does not split into {heads} heads")
    if w_qkv.shape != (3 * d, d) or w_out.shape != (d, d):
        raise ValueError(f"w_qkv must be (3D, D) and w_out (D, D), got {tuple(w_qkv.shape)}, {tuple(w_out.shape)}")
    if any(r.shape != (n, d) for r in (shift, scale, gate)) or gain.numel() != 1:
        raise ValueError("shift, scale and gate must be (N, D) and the gain one value")
    if x.device.type != "cpu" and (
        x.dtype != torch.bfloat16 or w_qkv.dtype != torch.bfloat16 or w_out.dtype != torch.bfloat16
    ):
        raise ValueError(
            "the CUDA attention half-block kernels (rows 3-5 and their launch sequences) run bf16 only: x and the "
            "weights must be bf16; their float32 forms come in a later slice of the port (a float32 model runs "
            "block_kernel='mega' or 'mega_stack' on the whole-block kernel's f32 instances, or 'off')"
        )


def _fwd_sequence(x, rows, gain, w_qkv, w_out, heads, gemm, attention, probs=None, normalize_first=False):
    n, t, d = x.shape
    inv_d = 1.0 / math.sqrt(d)
    xf = x.reshape(n * t, d)
    qkv = gemm(xf, w_qkv, alpha=inv_d, out_dtype=torch.float32, modulate=(rows, 0, d, gain), tokens=t, site="qkv")
    attn = attention(qkv, t, heads, w_qkv.dtype, normalize_first=normalize_first, probs=probs)
    y = gemm(attn, w_out, alpha=inv_d, out_dtype=x.dtype, residual=(xf, rows, 2 * d), tokens=t, site="out")
    return y.reshape(n, t, d), attn


def _fwd(x, shift, scale, gate, gain, w_qkv, w_out, heads, residual, gemm, attention):
    _check(x, shift, scale, gate, gain, w_qkv, w_out, heads)
    rows, g = _pack(shift, scale, gate, gain)
    n, t, _ = x.shape
    probs = torch.empty(n, heads, t, t, dtype=torch.float32, device=x.device) if residual else None
    y, attn = _fwd_sequence(
        x.contiguous(), rows, g, w_qkv.contiguous(), w_out.contiguous(), heads, gemm, attention,
        probs=probs, normalize_first=residual,
    )
    return (y, probs, attn.reshape(x.shape)) if residual else y


def fwd_launch_sequence(x, shift, scale, gate, gain, w_qkv, w_out, heads: int):
    """Row 3 as three launches of other rows' kernels (``mp_gemm`` with the
    modulate prologue, ``cosine_attention``, ``mp_gemm`` with the gated
    residual epilogue): the route outside :func:`attn_branch_fwd`'s domain,
    and its yardstick."""
    return _fwd(x, shift, scale, gate, gain, w_qkv, w_out, heads, False, mp_gemm, cosine_attention)


def attn_fwd(x, shift, scale, gate, gain, w_qkv, w_out, heads: int):
    """Row 3: the attention half-block forward. x (N,T,D); shift, scale,
    gate (N,D); gain one f32 value; w_qkv (3D,D), w_out (D,D) folded.
    Returns the new stream in x's type. On the card: one launch of
    :func:`attn_branch_fwd` where :func:`branch_route` takes the call, else
    :func:`fwd_launch_sequence` (counted as ``attn_branch/fwd/sequence``)."""
    _check(x, shift, scale, gate, gain, w_qkv, w_out, heads)
    if x.device.type == "cpu":
        return attn_fwd_plain(x, shift, scale, gate, gain, w_qkv, w_out, heads)
    if branch_route(x, w_qkv, w_out, heads) == "kernel":
        return attn_branch_fwd(x, shift, scale, gate, gain, w_qkv, w_out, heads)
    LAUNCHES["attn_branch/fwd/sequence"] += 1
    return fwd_launch_sequence(x, shift, scale, gate, gain, w_qkv, w_out, heads)


def attn_fwd_plain(x, shift, scale, gate, gain, w_qkv, w_out, heads: int):
    """Plain version of :func:`attn_fwd`."""
    return _fwd(x, shift, scale, gate, gain, w_qkv, w_out, heads, False, mp_gemm_plain, cosine_attention_plain)


def res_fwd_launch_sequence(x, shift, scale, gate, gain, w_qkv, w_out, heads: int):
    """Row 5 as three launches of other rows' kernels (row 3's sequence with
    ``cosine_attention`` in its residual mode): the route outside
    :func:`attn_branch_res_fwd`'s domain, and its yardstick."""
    return _fwd(x, shift, scale, gate, gain, w_qkv, w_out, heads, True, mp_gemm, cosine_attention)


def attn_res_fwd(x, shift, scale, gate, gain, w_qkv, w_out, heads: int):
    """Row 5: :func:`attn_fwd` that also returns the residuals of the plain
    backward, the probabilities p (N, heads, T, T) f32 (normalised before
    P.V) and the pre-projection attention (N, T, D) in the weights' type.
    On the card: one launch of :func:`attn_branch_res_fwd` where
    :func:`branch_route` takes the call, else :func:`res_fwd_launch_sequence`
    (counted as ``attn_branch/res_fwd/sequence``)."""
    _check(x, shift, scale, gate, gain, w_qkv, w_out, heads)
    if x.device.type == "cpu":
        return attn_res_fwd_plain(x, shift, scale, gate, gain, w_qkv, w_out, heads)
    if branch_route(x, w_qkv, w_out, heads) == "kernel":
        return attn_branch_res_fwd(x, shift, scale, gate, gain, w_qkv, w_out, heads)
    LAUNCHES["attn_branch/res_fwd/sequence"] += 1
    return res_fwd_launch_sequence(x, shift, scale, gate, gain, w_qkv, w_out, heads)


def attn_res_fwd_plain(x, shift, scale, gate, gain, w_qkv, w_out, heads: int):
    """Plain version of :func:`attn_res_fwd`."""
    return _fwd(x, shift, scale, gate, gain, w_qkv, w_out, heads, True, mp_gemm_plain, cosine_attention_plain)


def dgain_terms(dh, x, rows, gain, tokens):
    """The terms of dgain's sum, dh * (shift - x*scale), f32, as
    :func:`modulate_bwd_plain` forms them (shift at column 0 and scale at
    column D of the rows)."""
    shift, scale = _modulate_rows(rows, x.shape[1], tokens)
    return dh * (shift - x.float() * scale)


def dgain_in_tile_order(terms, gain):
    """dgain as :func:`attn_branch_bwd` orders its sums: each 128 x 128
    tile's terms summed, the tiles' sums added in tile order (row tile
    major), the total divided by sqrt((1-g)^2 + g^2). Returns (1,) f32."""
    m, d = terms.shape
    total = None
    for r0 in range(0, m, STACK_TILE):
        for c0 in range(0, d, STACK_TILE):
            part = terms[r0 : r0 + STACK_TILE, c0 : c0 + STACK_TILE].contiguous().sum()
            total = part if total is None else total + part
    g = gain.reshape(()).float()
    return (total / torch.sqrt((1.0 - g) ** 2 + g**2)).reshape(1)


def _dw_product(a, b, alpha):
    """alpha * a^T . b (C (P, Q) f32) for a (M, P), b (M, Q) in the weights'
    type, as the Pallas package's ``dot_general`` writes it: bf16 operands
    with f32 sums and an f32 result (products of bf16 values are exact in
    f32). On the card the rows split into the first of DW_SPLITS that
    divides M, one batched bf16 product with f32 output, the splits' sums
    added in order; on the CPU the product of the f32 upcasts."""
    if a.device.type == "cpu":
        return (a.t().float() @ b.float()) * alpha
    m = a.shape[0]
    splits = next(s for s in DW_SPLITS if m % s == 0)
    if splits == 1:
        return torch.mm(a.t(), b, out_dtype=torch.float32) * alpha
    a3, b3 = a.reshape(splits, m // splits, a.shape[1]), b.reshape(splits, m // splits, b.shape[1])
    return torch.bmm(a3.transpose(1, 2), b3, out_dtype=torch.float32).sum(0) * alpha


def _dw_pair(dqkv, h, dout, attn, inv_d, dw):
    """The two weight-gradient products: through ``dw`` (dw_gemm, the
    in-kernel-dW variant) where :func:`dw_in_kernel` holds, else
    :func:`_dw_product`. h, dqkv, attn and dout are in the weights' type, as
    the Pallas kernel rounds them before its products."""
    if dw_in_kernel(h.shape[1]):
        return dw(dqkv, h, inv_d), dw(dout, attn, inv_d)
    return _dw_product(dqkv, h, inv_d), _dw_product(dout, attn, inv_d)


def _bwd_stages(dy, x, rows, gain, w_qkv, w_out, heads, gemm, attention, out_gate_bwd, attn_bwd_k, mod_fwd,
                mod_bwd, dgain_tiles):
    """The backward's stages through the given kernels: ((dx, dshift,
    dscale, dgate, dgain), (h, attn, dout, dqkv)), the second the dW
    products' operands; dgain_tiles sums dgain in the one-launch kernel's
    order."""
    n, t, d = x.shape
    inv_d = 1.0 / math.sqrt(d)
    dt = w_qkv.dtype
    f32 = torch.float32
    xf = x.reshape(n * t, d)
    h = mod_fwd(xf, rows, gain, t, dt)
    qkv = gemm(h, w_qkv, alpha=inv_d, out_dtype=f32, site="qkv")
    attn = attention(qkv, t, heads, dt, normalize_first=True)
    dyf = dy.reshape(n * t, d)
    dout, dgate = out_gate_bwd(attn, w_out, dyf, rows, 2 * d, t)
    dattn = gemm(dout, w_out, alpha=inv_d, out_dtype=f32, w_kn=True, site="dattn")
    dqkv = attn_bwd_k(qkv, dattn, t, heads, dt)
    dh = gemm(dqkv, w_qkv, alpha=inv_d, out_dtype=f32, w_kn=True, site="dh")
    dx, dshift, dscale, dgain = mod_bwd(dh, xf, rows, gain, dyf, t)
    if dgain_tiles:
        dgain = dgain_in_tile_order(dgain_terms(dh, xf, rows, gain, t), gain)
    return (dx.reshape(n, t, d), dshift, dscale, dgate, dgain), (h, attn, dout, dqkv)


def _bwd(dy, x, shift, scale, gate, gain, w_qkv, w_out, heads, kernels, dgain_tiles=False, operands=False):
    """The seven cotangents through ``kernels`` (the last of them the dW
    product of the in-kernel-dW variant), or with ``operands`` the five
    before the dW pair and its operands (h, attn, dout, dqkv)."""
    _check(x, shift, scale, gate, gain, w_qkv, w_out, heads)
    rows, g = _pack(shift, scale, gate, gain)
    grads, ops = _bwd_stages(dy.contiguous(), x.contiguous(), rows, g, w_qkv.contiguous(), w_out.contiguous(), heads,
                             *kernels[:-1], dgain_tiles)
    if operands:
        return (*grads, ops)
    h, attn, dout, dqkv = ops
    return (*grads, *_dw_pair(dqkv, h, dout, attn, 1.0 / math.sqrt(x.shape[-1]), kernels[-1]))


_KERNELS = (mp_gemm, cosine_attention, out_gate_residual_bwd, attention_bwd, modulate_fwd, modulate_bwd, dw_gemm)
_PLAIN = (mp_gemm_plain, cosine_attention_plain, out_gate_residual_bwd_plain, attention_bwd_plain, modulate_fwd_plain,
          modulate_bwd_plain, dw_gemm_plain)


def bwd_launch_sequence(dy, x, shift, scale, gate, gain, w_qkv, w_out, heads: int):
    """Row 4 as eight launches of other rows' kernels (modulate_fwd, qkv,
    attention, out with the residual backward, dattn, attention_bwd, dh,
    modulate_bwd) and the dW pair: the route outside
    :func:`attn_branch_bwd`'s domain, and its yardstick."""
    return _bwd(dy, x, shift, scale, gate, gain, w_qkv, w_out, heads, _KERNELS)


def attn_bwd(dy, x, shift, scale, gate, gain, w_qkv, w_out, heads: int):
    """Row 4: the fused backward. Returns the f32 cotangents (dx in x's
    type) of x, shift, scale, gate, gain (shape (1,)), w_qkv and w_out. On
    the card: one launch of :func:`attn_branch_bwd` and the dW pair where
    :func:`branch_route` takes the call, else :func:`bwd_launch_sequence`
    (counted as ``attn_branch/bwd/sequence``). Where :func:`dw_in_kernel`
    holds it is row 4': the two weight-gradient products run through
    :func:`dw_gemm`. On the CPU: :func:`attn_bwd_plain`'s math, through the
    wrappers."""
    if x.device.type == "cpu":
        return _bwd(dy, x, shift, scale, gate, gain, w_qkv, w_out, heads, _KERNELS, dgain_tiles=True)
    _check(x, shift, scale, gate, gain, w_qkv, w_out, heads)
    if branch_route(x, w_qkv, w_out, heads, dy) == "kernel":
        n, t, d = x.shape
        dx, dshift, dscale, dgate, dgain, (h, attn, dout, dqkv) = attn_branch_bwd(
            dy, x, shift, scale, gate, gain, w_qkv, w_out, heads)
        dw_qkv, dw_out = _dw_pair(dqkv, h, dout, attn, 1.0 / math.sqrt(d), _KERNELS[-1])
        return dx, dshift, dscale, dgate, dgain, dw_qkv, dw_out
    LAUNCHES["attn_branch/bwd/sequence"] += 1
    return bwd_launch_sequence(dy, x, shift, scale, gate, gain, w_qkv, w_out, heads)


def attn_bwd_plain(dy, x, shift, scale, gate, gain, w_qkv, w_out, heads: int):
    """Plain version of :func:`attn_bwd`: the sequence's plain versions,
    with dgain summed in :func:`attn_branch_bwd`'s order
    (:func:`dgain_in_tile_order`)."""
    return _bwd(dy, x, shift, scale, gate, gain, w_qkv, w_out, heads, _PLAIN, dgain_tiles=True)


def attn_branch_bwd_plain(dy, x, shift, scale, gate, gain, w_qkv, w_out, heads: int):
    """Plain version of :func:`attn_branch_bwd`: :func:`attn_bwd_plain`
    before its dW pair, with the pair's operands."""
    return _bwd(dy, x, shift, scale, gate, gain, w_qkv, w_out, heads, _PLAIN, dgain_tiles=True, operands=True)


# ---------------------------------------------------------------------------
# rows 3, 4 and 5 as one launch each (csrc/attn_branch.cu)


def check_branch_shape(tokens: int, d: int, heads: int) -> None:
    """Raise unless ``csrc/attn_branch.cu`` takes T = ``tokens`` at width D
    in ``heads`` heads: head widths 64 and 72 (the attention tiles' template
    instances, every registry model's), D a multiple of 8 (TMA rows, 16-byte
    accesses) up to BRANCH_MAX_D (a pre item's rows of x in one ring stage),
    and an even T <= BRANCH_MAX_T that divides 128 (one tile of queries and
    keys; a sample inside one row tile, so its sums are the tile's)."""
    hd = d // heads if heads > 0 and d % heads == 0 else 0
    if hd not in ATTENTION_HEAD_WIDTHS:
        raise ValueError(f"attn_branch on CUDA takes head widths {ATTENTION_HEAD_WIDTHS}, got D={d} in {heads} heads")
    if d % 8 or d > BRANCH_MAX_D:
        raise ValueError(f"attn_branch on CUDA takes D a multiple of 8 up to {BRANCH_MAX_D}, got {d}")
    if not 2 <= tokens <= BRANCH_MAX_T or tokens % 2 or STACK_TILE % tokens:
        raise ValueError(f"attn_branch on CUDA takes an even T <= {BRANCH_MAX_T} dividing {STACK_TILE}, got T={tokens}")


def branch_route(x, w_qkv, w_out, heads: int, dy=None) -> str:
    """``"kernel"`` (one launch of ``csrc/attn_branch.cu``) where the call
    lies in its domain: bf16 x and weights, :func:`check_branch_shape`,
    16-byte aligned x, weights (and dy); else ``"sequence"`` (the launch
    sequence, which raises where it raises). BRANCH_KERNELS False: always
    ``"sequence"``."""
    _, t, d = x.shape
    try:
        check_branch_shape(t, d, heads)
    except ValueError:
        return "sequence"
    tensors = (x, w_qkv, w_out) + (() if dy is None else (dy,))
    ok = (BRANCH_KERNELS and x.dtype == w_qkv.dtype == w_out.dtype == torch.bfloat16
          and all(z.data_ptr() % 16 == 0 for z in tensors))
    return "kernel" if ok else "sequence"


@functools.lru_cache(maxsize=None)
def branch_plan(kind: str, n: int, t: int, d: int, heads: int, ctas: int = H100_SMS) -> TpPlan:
    """The plan of one launch of ``csrc/attn_branch.cu`` for N samples of T
    tokens at width D in ``heads`` heads: ``kind`` "fwd" (row 3: pre, qkv,
    attention, out), "res_fwd" (row 5: row 3's list) or "bwd" (row 4: then
    dattn, attention_bwd, dh), on ``ctas`` resident CTAs, pre items of the
    most of BRANCH_PRE_ROWS token rows whose rows of x fill one ring stage.
    A ``dit_block_tp.TpPlan`` (the TP kernels' list
    machinery: stages, waits, counter targets, words, scratch layout), its
    products unsplit; the backward's dgain ticket is the sync word after
    the counters. Scratch: h, qkv and attn (and for row 4 dout, dattn, dqkv,
    one dgain partial a dh tile); row 5's is qkv alone: its attn is an output
    of the call, kept by the caller as the backward's residual, and h lies
    in attn's memory (a row tile's attention units wait for every qkv item
    of the tile, the only readers of its h rows, so they overwrite h only
    once it is read)."""
    if kind not in BRANCH_STAGES:
        raise ValueError(f"kind must be one of {tuple(BRANCH_STAGES)}, got {kind!r}")
    check_branch_shape(t, d, heads)
    pre_rows = next(r for r in BRANCH_PRE_ROWS if _cdiv(d, 64) * r * 128 <= BRANCH_STAGE_BYTES)
    m = n * t
    prods = {"qkv": StackProduct("qkv", m, 3 * d, d, 1), "out": StackProduct("out", m, d, d, 1),
             "dattn": StackProduct("dattn", m, d, d, 1), "dh": StackProduct("dh", m, d, 3 * d, 1)}
    stages = []
    for name in BRANCH_STAGES[kind]:
        if name == "pre":
            stages.append(TpStage(name, _cdiv(m, pre_rows)))
        elif name in prods:
            stages.append(TpStage(name, prods[name].items, prods[name]))
        else:
            stages.append(TpStage(name, _cdiv(n * heads, 2)))
    words = TP_SYNC_DONE + 8 * len(stages) * _cdiv(m, STACK_TILE)
    tickets = {}
    if kind == "bwd":
        tickets["dgain"] = words
        words += 1
    sizes = {"qkv": m * 3 * d * 4} if kind == "res_fwd" else {"h": m * d * 2, "qkv": m * 3 * d * 4, "attn": m * d * 2}
    if kind == "bwd":
        sizes.update(dout=m * d * 2, dattn=m * d * 4, dqkv=m * 3 * d * 2, dgain_partial=prods["dh"].tiles * 4)
    layout, offset = {}, 0
    for name, size in sizes.items():
        layout[name] = offset
        offset += _cdiv(size, 256) * 256
    return TpPlan(
        kernel=f"branch_{kind}", ctas=ctas, samples=n, tokens=t, heads=heads, pre_rows=pre_rows, modulation=None,
        stages=tuple(stages), tickets=tickets, sync_words=words, layout=layout, workspace_bytes=offset,
    )


@functools.lru_cache(maxsize=None)
def _branch_ctas(device_index: int, hd: int) -> int:
    from mapdit_tpu_torch.ops.cuda import build

    lib = build.library("attn_branch")
    with torch.cuda.device(device_index):
        ctas = lib.attn_branch_resident_ctas(hd)
    if ctas < 1:
        _raise_on(-ctas, lib, "attn_branch")
    return ctas


@functools.lru_cache(maxsize=None)
def _branch_state(plan: TpPlan, device_index: int) -> tuple:
    """The plan's words for the launch (host) and its buffer on the card:
    made once a plan and device (a copy to the card, so not while a CUDA
    graph is being captured); the kernel leaves the buffer's sync words
    zeroed after every launch."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("attn_branch: call the kernel once at this shape before capturing a CUDA graph (its "
                           "plan's buffer is copied to the card at the first call)")
    words = plan.words()
    words = words + (0,) * (BRANCH_PLAN_WORDS - len(words))
    buffer = torch.tensor(plan.table(), dtype=torch.int32, device=torch.device("cuda", device_index))
    return (ctypes.c_int * len(words))(*words), buffer


def _branch_call(kind, x, shift, scale, gate, gain, w_qkv, w_out, heads, trace):
    """What both launches share: the checks, the plan, its state, the
    workspace and the operands' pointers."""
    n, t, d = x.shape
    _require_cuda(x, gain, w_qkv, w_out)
    check_branch_shape(t, d, heads)
    if x.dtype != torch.bfloat16 or w_qkv.dtype != torch.bfloat16 or w_out.dtype != torch.bfloat16:
        raise ValueError("attn_branch on CUDA takes bf16 x and weights")
    x, w_qkv, w_out = x.contiguous(), w_qkv.contiguous(), w_out.contiguous()
    if any(z.data_ptr() % 16 for z in (x, w_qkv, w_out)):
        raise ValueError("attn_branch reads its operands with TMA and 16-byte loads: they must be 16-byte aligned")
    g = gain.detach().reshape(1)
    if g.dtype != torch.float32:
        g = g.float()
    shift, scale, gate, rows_bf16 = _row_operands(x, shift, scale, gate)
    dev = x.get_device()
    plan = branch_plan(kind, n, t, d, heads, _branch_ctas(dev, d // heads))
    words, buffer = _branch_state(plan, dev)
    work = torch.empty(plan.workspace_bytes, dtype=torch.uint8, device=x.device)
    if trace is not None and (trace.dtype != torch.int64 or trace.numel() < plan.ctas * BRANCH_TRACE_WORDS
                              or trace.device != x.device):
        raise ValueError(f"trace must be int64 with {plan.ctas * BRANCH_TRACE_WORDS} words on {x.device}")
    rows = (shift.data_ptr(), shift.stride(0), scale.data_ptr(), scale.stride(0), gate.data_ptr(), gate.stride(0),
            int(rows_bf16), g.data_ptr())
    return plan, words, buffer, work, (x, w_qkv, w_out), rows, None if trace is None else trace.data_ptr()


def _view(work, plan, name, shape, dtype):
    size = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    off = plan.layout[name]
    return work[off : off + size].view(dtype).view(*shape)


def attn_branch_fwd(x, shift, scale, gate, gain, w_qkv, w_out, heads: int, *, trace: Optional[torch.Tensor] = None):
    """Row 3 as one launch of ``attn_branch_fwd`` (``csrc/attn_branch.cu``)
    on CUDA tensors in its domain (:func:`check_branch_shape`, bf16 x and
    weights, 16-byte aligned): y (N, T, D) bf16. shift, scale and gate (N,
    D), f32 or bf16 of one type, are read in place; the gain is one f32
    value. On CPU tensors: :func:`attn_fwd_plain`. ``trace``: int64 of BRANCH_TRACE_WORDS a CTA (each CTA's ns by
    stage). Calls of one plan run on one stream, and the first call at a
    shape comes before any CUDA graph capture of it (its plan's buffer is
    copied to the card then); a build or launch failure raises."""
    if x.device.type == "cpu":
        return attn_fwd_plain(x, shift, scale, gate, gain, w_qkv, w_out, heads)
    from mapdit_tpu_torch.ops.cuda import build

    n, t, d = x.shape
    plan, words, buffer, work, (x, w_qkv, w_out), rows, trace_ptr = _branch_call(
        "fwd", x, shift, scale, gate, gain, w_qkv, w_out, heads, trace)
    lib = build.library("attn_branch")
    y = torch.empty_like(x)
    code = lib.attn_branch_fwd(
        x.data_ptr(), w_qkv.data_ptr(), w_out.data_ptr(), *rows, y.data_ptr(),
        *(work.data_ptr() + plan.layout[name] for name in ("h", "qkv", "attn")),
        buffer.data_ptr(), words, n, t, d, heads, plan.ctas, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(x.device).cuda_stream, trace_ptr,
    )
    _raise_on(code, lib, "attn_branch_fwd", "attn_branch")
    LAUNCHES["attn_branch/fwd"] += 1
    return y


def attn_branch_res_fwd(x, shift, scale, gate, gain, w_qkv, w_out, heads: int, *,
                        trace: Optional[torch.Tensor] = None):
    """Row 5 as one launch of ``attn_branch_res_fwd`` (``csrc/attn_branch.cu``):
    row 3's list with its attention normalising p first and storing it in
    f32. Inputs as for :func:`attn_branch_fwd`. Returns y (N, T, D) bf16, p
    (N, heads, T, T) f32 and attn (N, T, D) bf16, each a tensor of its own
    (p and attn are the backward's residuals: no view of the launch's
    scratch, which is freed when the call returns; h, the modulated x, lives
    in attn's memory until the attention overwrites it). On CPU tensors:
    :func:`attn_res_fwd_plain`. The same rules as :func:`attn_branch_fwd`'s."""
    if x.device.type == "cpu":
        return attn_res_fwd_plain(x, shift, scale, gate, gain, w_qkv, w_out, heads)
    from mapdit_tpu_torch.ops.cuda import build

    n, t, d = x.shape
    plan, words, buffer, work, (x, w_qkv, w_out), rows, trace_ptr = _branch_call(
        "res_fwd", x, shift, scale, gate, gain, w_qkv, w_out, heads, trace)
    lib = build.library("attn_branch")
    y = torch.empty_like(x)
    attn = torch.empty_like(x)
    p = torch.empty(n, heads, t, t, dtype=torch.float32, device=x.device)
    code = lib.attn_branch_res_fwd(
        x.data_ptr(), w_qkv.data_ptr(), w_out.data_ptr(), *rows, y.data_ptr(), attn.data_ptr(),
        work.data_ptr() + plan.layout["qkv"], attn.data_ptr(), p.data_ptr(),
        buffer.data_ptr(), words, n, t, d, heads, plan.ctas, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(x.device).cuda_stream, trace_ptr,
    )
    _raise_on(code, lib, "attn_branch_res_fwd", "attn_branch")
    LAUNCHES["attn_branch/res_fwd"] += 1
    return y, p, attn


def attn_branch_bwd(dy, x, shift, scale, gate, gain, w_qkv, w_out, heads: int, *,
                    trace: Optional[torch.Tensor] = None):
    """Row 4 without its dW products as one launch of ``attn_branch_bwd``
    (``csrc/attn_branch.cu``), inputs as for :func:`attn_branch_fwd` and dy
    (N, T, D) bf16 or f32. Returns dx (N, T, D, x's type), dshift, dscale,
    dgate (N, D) f32, dgain (1,) f32 and the dW products' operands (h, attn,
    dout, dqkv: (N*T, D) or (N*T, 3D) bf16 views of the call's workspace).
    On CPU tensors: :func:`attn_branch_bwd_plain`. The same rules as :func:`attn_branch_fwd`'s."""
    if x.device.type == "cpu":
        return attn_branch_bwd_plain(dy, x, shift, scale, gate, gain, w_qkv, w_out, heads)
    from mapdit_tpu_torch.ops.cuda import build

    n, t, d = x.shape
    m, bf, f32 = n * t, torch.bfloat16, torch.float32
    plan, words, buffer, work, (x, w_qkv, w_out), rows, trace_ptr = _branch_call(
        "bwd", x, shift, scale, gate, gain, w_qkv, w_out, heads, trace)
    if dy.numel() != m * d or dy.dtype not in (bf, f32) or dy.device != x.device:
        raise ValueError(f"attn_branch_bwd takes dy of {m}x{d} bf16 or f32 elements on {x.device}, got {dy.dtype} "
                         f"{tuple(dy.shape)}")
    dy = dy.contiguous()
    if dy.data_ptr() % 16:
        raise ValueError("attn_branch_bwd reads dy 16 bytes a thread: it must be 16-byte aligned")
    lib = build.library("attn_branch")
    dx = torch.empty_like(x)
    dshift, dscale, dgate = (torch.empty(n, d, dtype=f32, device=x.device) for _ in range(3))
    dgain = torch.empty(1, dtype=f32, device=x.device)
    code = lib.attn_branch_bwd(
        dy.data_ptr(), int(dy.dtype == bf), x.data_ptr(), w_qkv.data_ptr(), w_out.data_ptr(), *rows,
        dx.data_ptr(), dshift.data_ptr(), dscale.data_ptr(), dgate.data_ptr(), dgain.data_ptr(),
        *(work.data_ptr() + plan.layout[name] for name in ("h", "qkv", "attn", "dout", "dattn", "dqkv",
                                                           "dgain_partial")),
        buffer.data_ptr(), words, n, t, d, heads, plan.ctas, 1.0 / math.sqrt(d), DB_FAC, DX_FAC,
        torch.cuda.current_stream(x.device).cuda_stream, trace_ptr,
    )
    _raise_on(code, lib, "attn_branch_bwd", "attn_branch")
    LAUNCHES["attn_branch/bwd"] += 1
    operands = tuple(_view(work, plan, name, (m, w), bf) for name, w in (("h", d), ("attn", d), ("dout", d),
                                                                         ("dqkv", 3 * d)))
    return dx, dshift, dscale, dgate, dgain, operands


def attn_bwd_from_res(dy, x, shift, scale, gate, gain, w_qkv, w_out, p, attn, heads: int):
    """Backward for ``bwd="residual"``: plain ops over the saved
    probabilities and pre-projection attention (``_attn_bwd_from_res``; it
    is plain XLA in the Pallas package, so it is plain PyTorch here). Only
    the modulate, the qkv product, the q/k norms and the out-projection are
    recomputed. It runs the plain versions of the fused backward's stages
    in the same order and differs in its roundings only: h, dout and dqkv
    stay f32 (each product rounds its own operand; the dW products take
    them unrounded), and p is the saved one."""
    n, t, d = x.shape
    inv_d = 1.0 / math.sqrt(d)
    f32 = torch.float32
    rows, g = _pack(shift, scale, gate, gain)
    xf = x.reshape(n * t, d)
    attn2 = attn.reshape(n * t, d)
    h = modulate_fwd_plain(xf, rows, g, t, f32)
    qkv = mp_gemm_plain(h, w_qkv, alpha=inv_d, out_dtype=f32)
    out = mp_gemm_plain(attn2, w_out, alpha=inv_d, out_dtype=f32)
    dout, dgate = gate_residual_bwd_plain(dy, out, rows, 2 * d, t, f32)
    dattn = mp_gemm_plain(dout, w_out, alpha=inv_d, out_dtype=f32, w_kn=True)
    dqkv = _attention_vjp(qkv, dattn, t, heads, w_qkv.dtype, p=p)
    dh = mp_gemm_plain(dqkv, w_qkv, alpha=inv_d, out_dtype=f32, w_kn=True)
    dx, dshift, dscale, dgain = modulate_bwd_plain(dh, xf, rows, g, dy, t)
    dw_qkv = (dqkv.t() @ h) * inv_d
    dw_out = (dout.t() @ attn2.float()) * inv_d
    return dx.reshape(n, t, d), dshift, dscale, dgate, dgain, dw_qkv, dw_out


def attn_reference(x, shift, scale, gate, gain, w_qkv, w_out, heads: int):
    """Plain reference math of the half-block (``_attn_reference``),
    differentiable; the ``bwd="reference"`` VJP recomputes through it."""
    h = modulate_reference(x, shift, scale, gain.reshape(()))
    return mp_sum(x, gate[:, None, :] * attention_reference(h, w_qkv, w_out, heads), t=RES_T)


class _AttnBranch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, scale, gate, gain, w_qkv, w_out, heads, bwd):
        ctx.heads, ctx.bwd = heads, bwd
        inputs = (x, shift, scale, gate, gain, w_qkv, w_out)
        if bwd == "residual":
            y, p, attn = attn_res_fwd(*inputs, heads)
            ctx.save_for_backward(*inputs, p, attn)
        else:
            y = attn_fwd(*inputs, heads)
            ctx.save_for_backward(*inputs)
        return y

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        inputs, heads = saved[:7], ctx.heads
        if ctx.bwd == "reference":
            grads = vjp_through(attn_reference, inputs, ctx.needs_input_grad[:7], dy, heads)
            return (*grads, None, None)
        if ctx.bwd == "residual":
            grads = attn_bwd_from_res(dy, *inputs, *saved[7:], heads)
        else:
            grads = attn_bwd(dy, *inputs, heads)
        gain = inputs[4]
        out = [g.to(t.dtype) for g, t in zip(grads, inputs)]
        out[4] = grads[4].reshape(gain.shape).to(gain.dtype)
        return (*out, None, None)


def fused_attn_branch(x, shift, scale, gate, gain, w_qkv, w_out, heads: int, bwd: str = "pallas"):
    """The attention half-block with the VJP ``bwd`` picks: "pallas" (the
    fused backward kernels, recomputing the forward), "residual" (the
    residual-emitting forward and the plain backward over its residuals),
    "reference" (autograd through :func:`attn_reference`). Without a
    gradient to take it runs the residual-free forward, whatever ``bwd``."""
    if bwd not in BWD_IMPLS:
        raise ValueError(f"bwd must be one of {BWD_IMPLS}, got {bwd!r}")
    tensors = (x, shift, scale, gate, gain, w_qkv, w_out)
    if not needs_grad(*tensors):
        return attn_fwd(*tensors, heads)
    return _AttnBranch.apply(*tensors, heads, bwd)
