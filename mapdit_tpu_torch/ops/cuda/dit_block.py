"""Whole-DiT-block forward on Hopper: kernel wrappers, plain versions, counts.

Port of the Pallas whole-block and whole-stack megakernels
(``mapdit_tpu/ops/pallas/dit_block.py``: ``fused_dit_block`` over
``_fwd_impl``/``_kernel``, ``fused_dit_stack`` over
``_stack_fwd_impl``/``_stack_kernel``, both running ``_block_body`` with the
attention core ``_attention_core``). The port carries the math, not the TPU
tiling: a block is a sequence of two hand-written CUDA kernels,

  1. mods (N, 6D) f32   = mp_gemm(a, w_mod) / sqrt(D)
  2. qkv (N*T, 3D) f32  = mp_gemm(modulate(x; shift_msa, scale_msa, gain_msa), w_qkv) / sqrt(D)
  3. attn (N*T, D) bf16 = cosine_attention(qkv)
  4. x1 (N*T, D) f32    = mp_sum(x, gate_msa * mp_gemm(attn, w_out) / sqrt(D), 0.3)
  5. h (N*T, H) bf16    = mp_silu(mp_gemm(modulate(x1; shift_mlp, scale_mlp, gain_mlp), w1) / sqrt(D))
  6. x2 (N*T, D)        = mp_sum(x1, gate_mlp * mp_gemm(h, w2) / sqrt(H), 0.3)

with the Pallas body's types: the stream is f32 inside a block and x's type
between blocks; every product takes operands of the weights' type and sums
in f32. ``csrc/mp_gemm.cu`` and ``csrc/cosine_attention.cu`` hold the
kernels and their notes on bounds and design.

Each wrapper takes its kernel for a CUDA tensor (and raises on what the
kernel does not take) and its plain PyTorch version for a CPU tensor; there
is no other fallback. ``LAUNCHES`` counts kernel launches by call site.

Gradients: ``fused_dit_block`` and ``fused_dit_stack`` are autograd
functions whose backward recomputes through :func:`block_reference`, the
plain reference math (the Pallas package's ``_make`` / ``_make_stack`` VJPs
over ``_reference`` / ``_stack_reference``), so training through
``block_kernel="mega"`` keeps its graph.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from mapdit_tpu_torch.ops.mp import mp_silu, mp_sum, normalize

RES_T = 0.3
RES_DENOM = math.sqrt((1 - RES_T) ** 2 + RES_T**2)
SILU_DIV = 0.596
NORM_EPS = 1e-4
# largest dynamic shared memory a block may take on the H100 (232,448 bytes)
MAX_SMEM_BYTES = 227 * 1024

# forward sites of the block and the attention half-block, then the two
# products of the attention half-block's backward that read W as (K, N)
GEMM_SITES = ("modulation", "qkv", "out", "fc1", "fc2", "dattn", "dh")
LAUNCHES = {
    **{f"mp_gemm/{s}": 0 for s in GEMM_SITES},
    "cosine_attention": 0,
    "cosine_attention/residual": 0,
    "fused_dit_block": 0,
    "fused_dit_stack": 0,
}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _rows(v: torch.Tensor, tokens: int) -> torch.Tensor:
    """Per-sample (N, K) rows repeated over their ``tokens`` token rows."""
    return v.repeat_interleave(tokens, dim=0)


def _require_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"kernel inputs must share one CUDA device, got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def _raise_on(code: int, lib, fn: str, source: Optional[str] = None) -> None:
    """Raise if a launch returned a CUDA error; ``source`` names the library
    whose ``<source>_error_string`` decodes it (default ``fn``)."""
    if code != 0:
        msg = getattr(lib, f"{source or fn}_error_string")(code).decode()
        raise RuntimeError(f"{fn} launch failed: CUDA error {code} ({msg})")


# ---------------------------------------------------------------------------
# mp_gemm


def mp_gemm_plain(
    a, w, *, alpha, out_dtype, modulate=None, silu=False, residual=None, tokens=1, out=None, w_kn=False,
    site=None,
):
    """Plain version of :func:`mp_gemm` (``site`` only names a launch count).

    ``modulate=(mods, shift_off, scale_off, gain)`` and
    ``residual=(x, mods, gate_off)`` give the prologue and the gated MP
    residual epilogue; ``mods`` is (N, *) f32, column offsets index it, and
    row r of ``a`` belongs to sample r // tokens. ``w_kn`` reads ``w`` as
    (K, N) and takes ``a @ w`` instead of ``a @ w.T``."""
    af = a.float()
    if modulate is not None:
        mods, shift_off, scale_off, gain = modulate
        k = a.shape[1]
        shift = _rows(mods[:, shift_off : shift_off + k], tokens)
        scale = _rows(mods[:, scale_off : scale_off + k], tokens)
        xs = af * scale
        af = (xs + (shift - xs) * gain) / torch.sqrt((1.0 - gain) ** 2 + gain**2)
    n_out = w.shape[1] if w_kn else w.shape[0]
    c = (af.to(w.dtype).float() @ (w.float() if w_kn else w.float().t())) * alpha
    if silu:
        c = F.silu(c) / SILU_DIV
    if residual is not None:
        x, mods, gate_off = residual
        gate = _rows(mods[:, gate_off : gate_off + n_out], tokens)
        xf = x.float()
        c = (xf + (gate * c - xf) * RES_T) / RES_DENOM
    c = c.to(out_dtype)
    if out is None:
        return c
    return out.copy_(c)


def mp_gemm(
    a, w, *, alpha, out_dtype, modulate=None, silu=False, residual=None, tokens=1, out=None, w_kn=False,
    site="modulation",
):
    """``C = epilogue(prologue(a) @ w.T * alpha)``: a (M, K) f32 or bf16,
    w (N, K) bf16, C (M, N) ``out_dtype``; with ``w_kn`` w is read as (K, N)
    and C = epilogue(prologue(a) @ w * alpha). See :func:`mp_gemm_plain`
    for the optional prologue/epilogue. ``site`` keys the launch count."""
    if a.device.type == "cpu":
        return mp_gemm_plain(
            a, w, alpha=alpha, out_dtype=out_dtype, modulate=modulate, silu=silu,
            residual=residual, tokens=tokens, out=out, w_kn=w_kn,
        )
    from mapdit_tpu_torch.ops.cuda import build

    m, k = a.shape
    n = w.shape[1] if w_kn else w.shape[0]
    if w.dtype != torch.bfloat16 or w.shape != ((k, n) if w_kn else (n, k)):
        layout = f"({k}, N)" if w_kn else f"(N, {k})"
        raise ValueError(f"mp_gemm takes a bf16 {layout} weight, got {w.dtype} {tuple(w.shape)}")
    if a.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"mp_gemm takes f32 or bf16 activations, got {a.dtype} -> {out_dtype}")
    if silu and residual is not None:
        raise ValueError("mp_gemm takes one epilogue")
    if m % tokens:
        raise ValueError(f"{m} rows do not split into samples of {tokens} tokens")
    tensors = [a, w]
    mods = gain = x = None
    mods_ld = shift_off = scale_off = gate_off = 0
    if modulate is not None:
        mods, shift_off, scale_off, gain = modulate
        if gain.dtype != torch.float32 or gain.numel() != 1:
            raise ValueError("the modulate gain must be one f32 value")
        tensors += [gain]
        if max(shift_off, scale_off) + k > mods.shape[1]:
            raise ValueError("modulate offsets run past the modulation rows")
    if residual is not None:
        x, mods_r, gate_off = residual
        if mods is not None and mods_r is not mods:
            raise ValueError("prologue and epilogue must read one modulation buffer")
        mods = mods_r
        if x.shape != (m, n) or x.dtype not in _DTYPE_CODE:
            raise ValueError(f"residual stream must be f32/bf16 ({m}, {n}), got {x.dtype} {tuple(x.shape)}")
        tensors += [x]
        if gate_off + n > mods.shape[1]:
            raise ValueError("gate offset runs past the modulation rows")
    if mods is not None:
        if mods.dtype != torch.float32 or mods.shape[0] != m // tokens:
            raise ValueError("modulation rows must be f32, one row per sample")
        tensors += [mods]
        mods_ld = mods.shape[1]
    if out is None:
        out = torch.empty(m, n, dtype=out_dtype, device=a.device)
    elif out.shape != (m, n) or out.dtype != out_dtype:
        raise ValueError("out has the wrong shape or type")
    _require_cuda(*tensors, out)

    lib = build.library("mp_gemm")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = lib.mp_gemm(
        a.data_ptr(), _DTYPE_CODE[a.dtype], w.data_ptr(), out.data_ptr(), _DTYPE_CODE[out_dtype],
        m, n, k, float(alpha),
        1 if modulate is not None else 0,
        mods.data_ptr() if mods is not None else None, mods_ld, shift_off, scale_off, gate_off,
        gain.data_ptr() if gain is not None else None, tokens,
        1 if silu else (2 if residual is not None else 0),
        x.data_ptr() if x is not None else None, _DTYPE_CODE[x.dtype] if x is not None else 0,
        1 if w_kn else 0, stream,
    )
    _raise_on(code, lib, "mp_gemm")
    LAUNCHES[f"mp_gemm/{site}"] += 1
    return out


# ---------------------------------------------------------------------------
# cosine attention core


def cosine_attention_plain(qkv, tokens, heads, out_dtype, out=None, normalize_first=False, probs=None):
    """Plain version of :func:`cosine_attention`: the math of the Pallas
    ``_attention_core`` (or, with ``normalize_first``, of the attention in
    ``_attn_res_kernel``), products on ``out_dtype``-rounded operands with
    f32 sums."""
    nt, d3 = qkv.shape
    d = d3 // 3
    n, hd = nt // tokens, d // heads
    q, k, v = qkv.float().reshape(n, tokens, 3, heads, hd).permute(2, 0, 3, 1, 4)
    qs = math.sqrt(hd) / (torch.linalg.vector_norm(q, dim=-1) + NORM_EPS)
    ks = math.sqrt(hd) / (torch.linalg.vector_norm(k, dim=-1) + NORM_EPS)
    dt = out_dtype
    logits = (q.to(dt).float() @ k.to(dt).float().transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    logits = logits * qs[..., :, None] * ks[..., None, :]
    ex = torch.exp(logits - math.sqrt(hd))
    denom = ex.sum(dim=-1, keepdim=True)
    if normalize_first:
        p = ex * (1.0 / denom)
        if probs is not None:
            probs.copy_(p)
        o = p.to(dt).float() @ v.to(dt).float()
    else:
        o = (ex.to(dt).float() @ v.to(dt).float()) * (1.0 / denom)
    o = o.permute(0, 2, 1, 3).reshape(nt, d).to(out_dtype)
    if out is None:
        return o
    return out.copy_(o)


def cosine_attention(qkv, tokens, heads, out_dtype, out=None, normalize_first=False, probs=None):
    """Cosine attention over the flat f32 qkv product (N*T, 3D), heads as
    contiguous column slices; returns (N*T, D) in ``out_dtype``.

    ``normalize_first`` is the residual mode: the probabilities are
    normalised before P.V (rounded to bf16 for it) and, when ``probs`` is
    an (N, heads, T, T) f32 tensor, written there."""
    if qkv.device.type == "cpu":
        return cosine_attention_plain(
            qkv, tokens, heads, out_dtype, out=out, normalize_first=normalize_first, probs=probs
        )
    from mapdit_tpu_torch.ops.cuda import build

    nt, d3 = qkv.shape
    d = d3 // 3
    if qkv.dtype != torch.float32 or d3 != 3 * d or d % heads or nt % tokens:
        raise ValueError(f"cosine_attention takes f32 (N*T, 3D) qkv, got {qkv.dtype} {tuple(qkv.shape)}")
    hd = d // heads
    if hd % 2 or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"cosine_attention needs an even head width and f32/bf16 output (hd={hd})")
    _require_cuda(qkv)
    lib = build.library("cosine_attention")
    smem = lib.cosine_attention_smem_bytes(tokens, hd)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"T={tokens}, hd={hd} needs {smem} bytes of shared memory; the kernel holds at most {MAX_SMEM_BYTES}"
        )
    if out is None:
        out = torch.empty(nt, d, dtype=out_dtype, device=qkv.device)
    elif out.shape != (nt, d) or out.dtype != out_dtype:
        raise ValueError("out has the wrong shape or type")
    tensors = [qkv, out]
    if probs is not None:
        if not normalize_first:
            raise ValueError("probs are written in the residual mode (normalize_first=True) only")
        if probs.dtype != torch.float32 or probs.shape != (nt // tokens, heads, tokens, tokens):
            raise ValueError(f"probs must be f32 (N, heads, T, T), got {probs.dtype} {tuple(probs.shape)}")
        tensors.append(probs)
    _require_cuda(*tensors)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    code = lib.cosine_attention(
        qkv.data_ptr(), out.data_ptr(), 1 if out_dtype == torch.bfloat16 else 0,
        probs.data_ptr() if probs is not None else None, 1 if normalize_first else 0,
        nt // tokens, tokens, heads, hd, stream,
    )
    _raise_on(code, lib, "cosine_attention")
    LAUNCHES["cosine_attention/residual" if normalize_first else "cosine_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# whole block and whole stack


@dataclasses.dataclass
class BlockScratch:
    """The intermediates of one block, allocated once per stack."""

    mods: torch.Tensor
    qkv: torch.Tensor
    attn: torch.Tensor
    x1: torch.Tensor
    h: torch.Tensor

    @classmethod
    def allocate(cls, n, t, d, hidden, dtype, device):
        f32 = torch.float32
        return cls(
            mods=torch.empty(n, 6 * d, dtype=f32, device=device),
            qkv=torch.empty(n * t, 3 * d, dtype=f32, device=device),
            attn=torch.empty(n * t, d, dtype=dtype, device=device),
            x1=torch.empty(n * t, d, dtype=f32, device=device),
            h=torch.empty(n * t, hidden, dtype=dtype, device=device),
        )


def _block_sequence(
    x, a, gains, w_mod, w_qkv, w_out, w1, w2, heads, scratch, out,
    gemm: Callable, attention: Callable,
):
    """The six-launch block forward (module docstring), writing ``out``."""
    n, t, d = x.shape
    hidden = w1.shape[0]
    dt = w_qkv.dtype
    inv_d = 1.0 / math.sqrt(d)
    xf = x.reshape(n * t, d)
    s = scratch
    mods = gemm(a, w_mod, alpha=inv_d, out_dtype=torch.float32, out=s.mods, site="modulation")
    qkv = gemm(
        xf, w_qkv, alpha=inv_d, out_dtype=torch.float32, modulate=(mods, 0, d, gains[0:1]),
        tokens=t, out=s.qkv, site="qkv",
    )
    attn = attention(qkv, t, heads, dt, out=s.attn)
    x1 = gemm(
        attn, w_out, alpha=inv_d, out_dtype=torch.float32, residual=(xf, mods, 2 * d),
        tokens=t, out=s.x1, site="out",
    )
    h = gemm(
        x1, w1, alpha=inv_d, out_dtype=dt, modulate=(mods, 3 * d, 4 * d, gains[1:2]), silu=True,
        tokens=t, out=s.h, site="fc1",
    )
    gemm(
        h, w2, alpha=1.0 / math.sqrt(hidden), out_dtype=x.dtype, residual=(x1, mods, 5 * d),
        tokens=t, out=out.reshape(n * t, d), site="fc2",
    )
    return out


def _check_block_args(x, a, gains, weights, depth: Optional[int]):
    n, t, d = x.shape
    lead = () if depth is None else (depth,)
    hidden = weights[3].shape[-2]
    want = [(6 * d, d), (3 * d, d), (d, d), (hidden, d), (d, hidden)]
    for w, shape in zip(weights, want):
        if tuple(w.shape) != lead + shape:
            raise ValueError(f"weight shape {tuple(w.shape)}, expected {lead + shape}")
    if tuple(a.shape) != (n, d) or tuple(gains.shape) != lead + (2,):
        raise ValueError(f"a must be (N, D) and gains {lead + (2,)}")
    if x.device.type == "cuda":
        if any(w.dtype != torch.bfloat16 for w in weights) or x.dtype != torch.bfloat16 or a.dtype != torch.bfloat16:
            raise ValueError(
                "the CUDA block kernels run bf16 only: x, a and the weights must be bf16 "
                "(a float32 model runs block_kernel='off')"
            )
        if gains.dtype != torch.float32:
            raise ValueError("gains must be f32")


def _fused_dit_block_fwd(x, a, gains, w_mod, w_qkv, w_out, w1, w2, heads: int):
    weights = (w_mod, w_qkv, w_out, w1, w2)
    _check_block_args(x, a, gains, weights, None)
    n, t, d = x.shape
    scratch = BlockScratch.allocate(n, t, d, w1.shape[0], w_qkv.dtype, x.device)
    out = _block_sequence(x, a, gains, *weights, heads, scratch, torch.empty_like(x), mp_gemm, cosine_attention)
    if x.device.type == "cuda":
        LAUNCHES["fused_dit_block"] += 1
    return out


def fused_dit_block_plain(x, a, gains, w_mod, w_qkv, w_out, w1, w2, heads: int):
    """Plain version of :func:`fused_dit_block`'s forward on any device."""
    n, t, d = x.shape
    scratch = BlockScratch.allocate(n, t, d, w1.shape[0], w_qkv.dtype, x.device)
    return _block_sequence(
        x, a, gains, w_mod, w_qkv, w_out, w1, w2, heads, scratch, torch.empty_like(x),
        mp_gemm_plain, cosine_attention_plain,
    )


def _stack(x, a, gains, weights, heads, gemm, attention):
    depth = weights[0].shape[0]
    n, t, d = x.shape
    scratch = BlockScratch.allocate(n, t, d, weights[3].shape[1], weights[1].dtype, x.device)
    streams = (torch.empty_like(x), torch.empty_like(x))
    for b in range(depth):
        x = _block_sequence(
            x, a, gains[b], *(w[b] for w in weights), heads, scratch, streams[b % 2],
            gemm, attention,
        )
    return x


def _fused_dit_stack_fwd(x, a, gains, w_mod, w_qkv, w_out, w1, w2, heads: int):
    weights = (w_mod, w_qkv, w_out, w1, w2)
    _check_block_args(x, a, gains, weights, w_mod.shape[0])
    out = _stack(x, a, gains, weights, heads, mp_gemm, cosine_attention)
    if x.device.type == "cuda":
        LAUNCHES["fused_dit_stack"] += 1
    return out


def fused_dit_stack_plain(x, a, gains, w_mod, w_qkv, w_out, w1, w2, heads: int):
    """Plain version of :func:`fused_dit_stack`'s forward on any device."""
    return _stack(
        x, a, gains, (w_mod, w_qkv, w_out, w1, w2), heads, mp_gemm_plain, cosine_attention_plain
    )


# ---------------------------------------------------------------------------
# reference math and the VJPs that recompute through it


def modulate_reference(z, shift, scale, gain):
    """``mp_sum(z * scale, shift, gain)`` over (N, T, D) z and (N, D) rows,
    the denominator constant in ``gain`` (the reference coerces the gain to a
    float there)."""
    zs = z * scale[:, None, :]
    denom = torch.sqrt((1.0 - gain) ** 2 + gain**2).detach()
    return (zs + (shift[:, None, :] - zs) * gain) / denom


def attention_reference(h, w_qkv, w_out, heads: int):
    """Cosine multi-head attention with its projections, plain ops:
    ``normalize`` on q and k (full autograd through its denominator),
    softmax(q k^T / sqrt(hd)) v, then the out-projection / sqrt(D)."""
    n, t, d = h.shape
    hd = d // heads
    q, k, v = (h @ w_qkv.t() / math.sqrt(d)).split(d, dim=-1)

    def to_heads(z):
        return z.reshape(n, t, heads, hd).transpose(1, 2)

    q, k, v = normalize(to_heads(q)), normalize(to_heads(k)), to_heads(v)
    attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1) @ v
    return attn.transpose(1, 2).reshape(n, t, d) @ w_out.t() / math.sqrt(d)


def block_reference(x, a, gains, w_mod, w_qkv, w_out, w1, w2, heads: int):
    """Plain implementation of one block's math, the twin of the Pallas
    package's ``_reference``; differentiable, the oracle of the VJPs."""
    d = x.shape[-1]
    sm, scm, gm, sl, scl, gl = (a @ w_mod.t() / math.sqrt(d)).split(d, dim=-1)
    h = modulate_reference(x, sm, scm, gains[0])
    x = mp_sum(x, gm[:, None, :] * attention_reference(h, w_qkv, w_out, heads), t=RES_T)
    h = modulate_reference(x, sl, scl, gains[1])
    y = mp_silu(h @ w1.t() / math.sqrt(d)) @ w2.t() / math.sqrt(w1.shape[0])
    return mp_sum(x, gl[:, None, :] * y, t=RES_T)


def stack_reference(x, a, gains, w_mod, w_qkv, w_out, w1, w2, heads: int):
    """:func:`block_reference` over depth-stacked weights."""
    for b in range(w_mod.shape[0]):
        x = block_reference(x, a, gains[b], w_mod[b], w_qkv[b], w_out[b], w1[b], w2[b], heads)
    return x


def vjp_through(fn, inputs, needs, cotangent, *args):
    """Cotangents of ``fn(*inputs, *args)`` for the inputs flagged in
    ``needs``, recomputed in float32 from the saved inputs and cast back to
    each input's type (None where no gradient is asked for)."""
    with torch.enable_grad():
        xs = [t.detach().float().requires_grad_(need) for t, need in zip(inputs, needs)]
        out = fn(*xs, *args)
        wanted = [x for x in xs if x.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, cotangent.float()) if wanted else ())
    return [next(grads).to(t.dtype) if need else None for t, need in zip(inputs, needs)]


def needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _RecomputedVJP(torch.autograd.Function):
    """Kernel forward, backward through the reference math (``_make`` /
    ``_make_stack`` of the Pallas package)."""

    @staticmethod
    def forward(ctx, forward, reference, heads, *inputs):
        ctx.reference, ctx.heads = reference, heads
        ctx.save_for_backward(*inputs)
        return forward(*inputs, heads)

    @staticmethod
    def backward(ctx, g):
        grads = vjp_through(ctx.reference, ctx.saved_tensors, ctx.needs_input_grad[3:], g, ctx.heads)
        return (None, None, None, *grads)


def fused_dit_block(x, a, gains, w_mod, w_qkv, w_out, w1, w2, heads: int):
    """One whole DiT block. x (N,T,D) residual stream; a (N,D) = mp_silu(c);
    gains (2,) f32 = [gain_msa, gain_mlp]; folded weights w_mod (6D,D),
    w_qkv (3D,D), w_out (D,D), w1 (H,D), w2 (D,H). Returns the new stream;
    its gradient recomputes through :func:`block_reference`."""
    inputs = (x, a, gains, w_mod, w_qkv, w_out, w1, w2)
    if not needs_grad(*inputs):
        return _fused_dit_block_fwd(*inputs, heads)
    return _RecomputedVJP.apply(_fused_dit_block_fwd, block_reference, heads, *inputs)


def fused_dit_stack(x, a, gains, w_mod, w_qkv, w_out, w1, w2, heads: int):
    """All ``depth`` blocks over depth-stacked folded weights (leading depth
    axis on every weight; gains (depth, 2) f32). One scratch set serves every
    block and the stream ping-pongs between two buffers in x's type. The
    gradient recomputes through :func:`stack_reference`."""
    inputs = (x, a, gains, w_mod, w_qkv, w_out, w1, w2)
    if not needs_grad(*inputs):
        return _fused_dit_stack_fwd(*inputs, heads)
    return _RecomputedVJP.apply(_fused_dit_stack_fwd, stack_reference, heads, *inputs)
