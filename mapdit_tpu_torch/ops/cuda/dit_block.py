"""Whole-DiT-block forward on Hopper: kernel wrappers, plain versions, counts.

Port of the Pallas whole-block and whole-stack megakernels
(``mapdit_tpu/ops/pallas/dit_block.py``: ``fused_dit_block`` over
``_fwd_impl``/``_kernel``, ``fused_dit_stack`` over
``_stack_fwd_impl``/``_stack_kernel``, both running ``_block_body`` with the
attention core ``_attention_core``). The port carries the math, not the TPU
tiling. A block is

  1. mods (N, 6D) f32   = mp_gemm(a, w_mod) / sqrt(D)
  2. qkv (N*T, 3D) f32  = mp_gemm(modulate(x; shift_msa, scale_msa, gain_msa), w_qkv) / sqrt(D)
  3. attn (N*T, D) bf16 = cosine_attention(qkv)
  4. x1 (N*T, D) f32    = mp_sum(x, gate_msa * mp_gemm(attn, w_out) / sqrt(D), 0.3)
  5. h (N*T, H) bf16    = mp_silu(mp_gemm(modulate(x1; shift_mlp, scale_mlp, gain_mlp), w1) / sqrt(D))
  6. x2 (N*T, D)        = mp_sum(x1, gate_mlp * mp_gemm(h, w2) / sqrt(H), 0.3)

with the Pallas body's types: the stream is f32 inside a block and x's type
between blocks; every product takes operands of the weights' type and sums
in f32. A float32 model (x, a and the weights f32) rounds nothing, as the
Pallas body at ``dtype = float32``; its kernels are the f32 forms of the
same sources (the products and the attention on the f32 pipes). On the
card ``fused_dit_stack`` and ``fused_dit_block`` (the same at depth 1) run
all of it as one persistent kernel, :func:`dit_stack`
(``csrc/dit_stack.cu``: the modulation rows of every block first, then the
blocks' tiles as one work list whose items wait only on their own row
tile's earlier stage, on the tile pipeline of ``csrc/mp_gemm.cu`` and the
attention tiles of ``csrc/cosine_attention.cu``); :func:`stack_plan` lays
out its work. The
sequence of separate launches above (:func:`stack_launch_sequence`, the
route before it) stays as the yardstick, and the TP islands and the
attention half-block launch ``mp_gemm`` and ``cosine_attention`` on their
own. The sources hold the notes on bounds and design.

Each wrapper takes its kernel for a CUDA tensor (and raises on what the
kernel does not take) and its plain PyTorch version for a CPU tensor; there
is no other fallback. ``LAUNCHES`` counts kernel launches by call site.
``STACK_KERNEL = False`` routes ``fused_dit_stack`` and ``fused_dit_block``
on the card through :func:`stack_launch_sequence` instead of :func:`dit_stack`
(the yardstick route, which launches ``mp_gemm`` and ``cosine_attention``).

Gradients: ``fused_dit_block`` and ``fused_dit_stack`` are autograd
functions whose backward recomputes through :func:`block_reference`, the
plain reference math (the Pallas package's ``_make`` / ``_make_stack`` VJPs
over ``_reference`` / ``_stack_reference``), so training through
``block_kernel="mega"`` keeps its graph.
"""

from __future__ import annotations

import dataclasses
import functools
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
# head widths the tensor-core attention kernels are built for: every
# registry model's (64 for XS to L, 72 for XL)
ATTENTION_HEAD_WIDTHS = (64, 72)

# forward sites of the block and the attention half-block, then the two
# products of the attention half-block's backward that read W as (K, N)
GEMM_SITES = ("modulation", "qkv", "out", "fc1", "fc2", "dattn", "dh")
LAUNCHES = {
    **{f"mp_gemm/{s}": 0 for s in GEMM_SITES},
    "cosine_attention": 0,
    "cosine_attention/residual": 0,
    "fused_dit_block": 0,
    "fused_dit_stack": 0,
    "dit_stack": 0,
}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# fused_dit_stack / fused_dit_block on the card: dit_stack (True), or the
# launch sequence it replaced (False; chip_smoke.py counts the sequence
# kernels' launches on that route)
STACK_KERNEL = True


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _rows(v: torch.Tensor, tokens: int) -> torch.Tensor:
    """Per-sample (N, K) rows repeated over their ``tokens`` token rows."""
    return v.repeat_interleave(tokens, dim=0)


def _require_cuda(*tensors: torch.Tensor) -> None:
    index = tensors[0].get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(f"kernel inputs must share one CUDA device, got {t.device} and {tensors[0].device}")
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
    site=None, sum_dtype=torch.float32,
):
    """Plain version of :func:`mp_gemm` (``site`` only names a launch count).

    ``modulate=(mods, shift_off, scale_off, gain)`` and
    ``residual=(x, mods, gate_off)`` give the prologue and the gated MP
    residual epilogue; ``mods`` is (N, *) f32, column offsets index it, and
    row r of ``a`` belongs to sample r // tokens. ``w_kn`` reads ``w`` as
    (K, N) and takes ``a @ w`` instead of ``a @ w.T``. The arithmetic runs
    in ``sum_dtype`` (float64 for a witness of the f32 sums), with the
    operands of the product rounded to the weights' type as in f32."""
    af = a.to(sum_dtype)
    if modulate is not None:
        mods, shift_off, scale_off, gain = modulate
        k = a.shape[1]
        shift = _rows(mods[:, shift_off : shift_off + k], tokens)
        scale = _rows(mods[:, scale_off : scale_off + k], tokens)
        g = gain.to(sum_dtype)
        xs = af * scale
        af = (xs + (shift - xs) * g) / torch.sqrt((1.0 - g) ** 2 + g**2)
    n_out = w.shape[1] if w_kn else w.shape[0]
    wf = w.to(sum_dtype)
    c = (af.to(w.dtype).to(sum_dtype) @ (wf if w_kn else wf.t())) * alpha
    if silu:
        c = F.silu(c) / SILU_DIV
    if residual is not None:
        x, mods, gate_off = residual
        gate = _rows(mods[:, gate_off : gate_off + n_out], tokens)
        xf = x.to(sum_dtype)
        c = (xf + (gate * c - xf) * RES_T) / RES_DENOM
    c = c.to(out_dtype)
    if out is None:
        return c
    return out.copy_(c)


@functools.lru_cache(maxsize=None)
def _mp_gemm_splits(m: int, n: int, k: int, f32: bool = False) -> int:
    """mp_gemm's split-K count for an (M, N, K) product, bf16 or (``f32``)
    its f32 form's (the wrapper allocates the partials)."""
    from mapdit_tpu_torch.ops.cuda import build

    lib = build.library("mp_gemm")
    return (lib.mp_gemm_f32_splits if f32 else lib.mp_gemm_splits)(m, n, k)


def _check_tma(a, w, out, x, mods, k, n, shift_off, scale_off, gate_off):
    """What the TMA loads and 16-byte accesses of ``csrc/mp_gemm.cu`` need:
    K and N multiples of 8, 16-byte aligned operands, modulation rows read
    as float4."""
    if k % 8 or n % 8:
        raise ValueError(f"mp_gemm needs K and N multiples of 8 (TMA rows of 16 bytes), got K={k}, N={n}")
    if any(t is not None and t.data_ptr() % 16 for t in (a, w, out, x, mods)):
        raise ValueError("mp_gemm needs 16-byte aligned operands")
    if mods is not None and any(v % 4 for v in (mods.shape[1], shift_off, scale_off, gate_off)):
        raise ValueError("mp_gemm reads modulation rows as float4: row length and offsets must be multiples of 4")


def mp_gemm(
    a, w, *, alpha, out_dtype, modulate=None, silu=False, residual=None, tokens=1, out=None, w_kn=False,
    site="modulation",
):
    """``C = epilogue(prologue(a) @ w.T * alpha)``: a (M, K) f32 or bf16,
    w (N, K) bf16, C (M, N) ``out_dtype``; with ``w_kn`` w is read as (K, N)
    and C = epilogue(prologue(a) @ w * alpha). An f32 w (the f32 form: a
    f32 too) rounds nothing. See :func:`mp_gemm_plain` for the optional
    prologue/epilogue. ``site`` keys the launch count."""
    if a.device.type == "cpu":
        return mp_gemm_plain(
            a, w, alpha=alpha, out_dtype=out_dtype, modulate=modulate, silu=silu,
            residual=residual, tokens=tokens, out=out, w_kn=w_kn,
        )
    from mapdit_tpu_torch.ops.cuda import build

    m, k = a.shape
    n = w.shape[1] if w_kn else w.shape[0]
    f32 = w.dtype == torch.float32
    if f32 and a.dtype != torch.float32:
        raise ValueError(f"mp_gemm's f32 form takes an f32 a and an f32 weight, got a {a.dtype}")
    if w.dtype not in _DTYPE_CODE or w.shape != ((k, n) if w_kn else (n, k)):
        layout = f"({k}, N)" if w_kn else f"(N, {k})"
        raise ValueError(f"mp_gemm takes a bf16 or f32 {layout} weight, got {w.dtype} {tuple(w.shape)}")
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
    _check_tma(a, w, out, x, mods, k, n, shift_off, scale_off, gate_off)

    lib = build.library("mp_gemm")
    splits = _mp_gemm_splits(m, n, k, f32)
    partial = torch.empty(splits, m, n, dtype=torch.float32, device=a.device) if splits > 1 else None
    # the prologue pass writes the modulated (or f32) A as bf16 here; in the
    # f32 form the modulated A in f32
    converted = modulate is not None or (a.dtype != torch.bfloat16 and not f32)
    a_work = torch.empty(m, k, dtype=w.dtype, device=a.device) if converted else None
    stream = torch.cuda.current_stream(a.device).cuda_stream
    epilogue_args = (
        1 if modulate is not None else 0,
        mods.data_ptr() if mods is not None else None, mods_ld, shift_off, scale_off, gate_off,
        gain.data_ptr() if gain is not None else None, tokens,
        1 if silu else (2 if residual is not None else 0),
        x.data_ptr() if x is not None else None, _DTYPE_CODE[x.dtype] if x is not None else 0,
    )
    work_args = (a_work.data_ptr() if a_work is not None else None,
                 partial.data_ptr() if partial is not None else None, stream)
    if f32:
        code = lib.mp_gemm_f32(a.data_ptr(), w.data_ptr(), out.data_ptr(), _DTYPE_CODE[out_dtype], m, n, k,
                               float(alpha), *epilogue_args, 1 if w_kn else 0, *work_args)
    else:
        code = lib.mp_gemm(
            a.data_ptr(), _DTYPE_CODE[a.dtype], w.data_ptr(), out.data_ptr(), _DTYPE_CODE[out_dtype],
            m, n, k, float(alpha), *epilogue_args, 1 if w_kn else 0, *work_args,
        )
    _raise_on(code, lib, "mp_gemm")
    LAUNCHES[f"mp_gemm/{site}"] += 1
    return out


# ---------------------------------------------------------------------------
# cosine attention core


def cosine_attention_plain(qkv, tokens, heads, out_dtype, out=None, normalize_first=False, probs=None,
                           sum_dtype=torch.float32):
    """Plain version of :func:`cosine_attention`: the math of the Pallas
    ``_attention_core`` (or, with ``normalize_first``, of the attention in
    ``_attn_res_kernel``), products on ``out_dtype``-rounded operands with
    sums, norms and softmax in ``sum_dtype`` (f32; float64 for a witness)."""
    nt, d3 = qkv.shape
    d = d3 // 3
    n, hd = nt // tokens, d // heads
    q, k, v = qkv.to(sum_dtype).reshape(n, tokens, 3, heads, hd).permute(2, 0, 3, 1, 4)
    qs = math.sqrt(hd) / (torch.linalg.vector_norm(q, dim=-1) + NORM_EPS)
    ks = math.sqrt(hd) / (torch.linalg.vector_norm(k, dim=-1) + NORM_EPS)
    dt = out_dtype

    def rd(z):
        return z.to(dt).to(sum_dtype)

    logits = (rd(q) @ rd(k).transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    logits = logits * qs[..., :, None] * ks[..., None, :]
    ex = torch.exp(logits - math.sqrt(hd))
    denom = ex.sum(dim=-1, keepdim=True)
    if normalize_first:
        p = ex * (1.0 / denom)
        if probs is not None:
            probs.copy_(p)
        o = rd(p) @ rd(v)
    else:
        o = (rd(ex) @ rd(v)) * (1.0 / denom)
    o = o.permute(0, 2, 1, 3).reshape(nt, d).to(out_dtype)
    if out is None:
        return o
    return out.copy_(o)


def check_attention_shape(tokens: int, hd: int) -> None:
    """Raise unless :func:`cosine_attention`'s kernel takes ``tokens`` tokens
    of head width ``hd``: the head widths of every registry model (each a
    template instance) at any even T (keys run in tiles of 64; p is written
    in 8-byte pairs)."""
    if hd not in ATTENTION_HEAD_WIDTHS:
        raise ValueError(f"cosine_attention on the card takes head widths {ATTENTION_HEAD_WIDTHS}, got {hd}")
    if tokens % 2:
        raise ValueError(f"cosine_attention on the card takes an even T, got {tokens}")


def cosine_attention(qkv, tokens, heads, out_dtype, out=None, normalize_first=False, probs=None):
    """Cosine attention over the flat f32 qkv product (N*T, 3D), heads as
    contiguous column slices; returns (N*T, D) in ``out_dtype``.

    ``normalize_first`` is the residual mode: the probabilities are
    normalised before P.V (rounded to ``out_dtype`` for it) and, when
    ``probs`` is an (N, heads, T, T) f32 tensor, written there.

    ``out_dtype=torch.bfloat16`` runs the kernel's bf16 tensor-core form;
    ``torch.float32`` its f32 form (``cosine_attention_f32``: both products
    on the f32 pipes, nothing rounded)."""
    if qkv.device.type == "cpu":
        return cosine_attention_plain(
            qkv, tokens, heads, out_dtype, out=out, normalize_first=normalize_first, probs=probs
        )
    from mapdit_tpu_torch.ops.cuda import build

    nt, d3 = qkv.shape
    d = d3 // 3
    if qkv.dtype != torch.float32 or d3 != 3 * d or d % heads or nt % tokens:
        raise ValueError(f"cosine_attention takes f32 (N*T, 3D) qkv, got {qkv.dtype} {tuple(qkv.shape)}")
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"cosine_attention writes bf16 or f32, got out_dtype={out_dtype}")
    hd = d // heads
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
    check_attention_shape(tokens, hd)
    if any(z.data_ptr() % 16 for z in tensors):
        raise ValueError("cosine_attention reads and writes with 16-byte accesses: its tensors must be 16-byte aligned")
    lib = build.library("cosine_attention")
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    launch = lib.cosine_attention_f32 if out_dtype == torch.float32 else lib.cosine_attention
    code = launch(
        qkv.data_ptr(), out.data_ptr(), probs.data_ptr() if probs is not None else None,
        1 if normalize_first else 0, nt // tokens, tokens, heads, hd, stream,
    )
    _raise_on(code, lib, "cosine_attention")
    LAUNCHES["cosine_attention/residual" if normalize_first else "cosine_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# whole block and whole stack


@dataclasses.dataclass
class BlockScratch:
    """The intermediates of one block, allocated once per stack: mods, qkv
    and x1 in ``wide`` (f32; float64 for a witness of the f32 sums), attn
    and h in the weights' type."""

    mods: torch.Tensor
    qkv: torch.Tensor
    attn: torch.Tensor
    x1: torch.Tensor
    h: torch.Tensor

    @classmethod
    def allocate(cls, n, t, d, hidden, dtype, device, wide=torch.float32):
        return cls(
            mods=torch.empty(n, 6 * d, dtype=wide, device=device),
            qkv=torch.empty(n * t, 3 * d, dtype=wide, device=device),
            attn=torch.empty(n * t, d, dtype=dtype, device=device),
            x1=torch.empty(n * t, d, dtype=wide, device=device),
            h=torch.empty(n * t, hidden, dtype=dtype, device=device),
        )


def _block_sequence(
    x, a, gains, w_mod, w_qkv, w_out, w1, w2, heads, scratch, out,
    gemm: Callable, attention: Callable,
):
    """The six-launch block forward (module docstring), writing ``out``."""
    mods = gemm(a, w_mod, alpha=1.0 / math.sqrt(x.shape[-1]), out_dtype=scratch.mods.dtype, out=scratch.mods,
                site="modulation")
    return _block_stages(x, mods, 0, gains, w_qkv, w_out, w1, w2, heads, scratch, out, gemm, attention)


def _block_stages(x, mods, base, gains, w_qkv, w_out, w1, w2, heads, scratch, out, gemm, attention):
    """Steps 2-6 of a block over its modulation rows, columns ``base`` ..
    ``base + 6D`` of ``mods``, writing ``out``."""
    n, t, d = x.shape
    hidden = w1.shape[0]
    dt = w_qkv.dtype
    inv_d = 1.0 / math.sqrt(d)
    xf = x.reshape(n * t, d)
    s = scratch
    qkv = gemm(
        xf, w_qkv, alpha=inv_d, out_dtype=s.qkv.dtype, modulate=(mods, base, base + d, gains[0:1]),
        tokens=t, out=s.qkv, site="qkv",
    )
    attn = attention(qkv, t, heads, dt, out=s.attn)
    x1 = gemm(
        attn, w_out, alpha=inv_d, out_dtype=s.x1.dtype, residual=(xf, mods, base + 2 * d),
        tokens=t, out=s.x1, site="out",
    )
    h = gemm(
        x1, w1, alpha=inv_d, out_dtype=dt, modulate=(mods, base + 3 * d, base + 4 * d, gains[1:2]), silu=True,
        tokens=t, out=s.h, site="fc1",
    )
    gemm(
        h, w2, alpha=1.0 / math.sqrt(hidden), out_dtype=x.dtype, residual=(x1, mods, base + 5 * d),
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
    if x.device.type != "cpu":
        types = {x.dtype, a.dtype, *(w.dtype for w in weights)}
        if types not in ({torch.bfloat16}, {torch.float32}):
            raise ValueError(
                "the CUDA block kernels take x, a and the weights all bf16 (the bf16 instances) or all f32 "
                f"(the f32 instances), got {sorted(str(t) for t in types)}"
            )
        if gains.dtype != torch.float32:
            raise ValueError("gains must be f32")


def _stack(x, a, gains, weights, heads, gemm, attention, wide=torch.float32):
    depth = weights[0].shape[0]
    n, t, d = x.shape
    scratch = BlockScratch.allocate(n, t, d, weights[3].shape[1], weights[1].dtype, x.device, wide)
    streams = (torch.empty_like(x), torch.empty_like(x))
    for b in range(depth):
        x = _block_sequence(
            x, a, gains[b], *(w[b] for w in weights), heads, scratch, streams[b % 2],
            gemm, attention,
        )
    return x


def fused_dit_block_plain(x, a, gains, w_mod, w_qkv, w_out, w1, w2, heads: int):
    """Plain version of :func:`fused_dit_block`'s forward on any device."""
    n, t, d = x.shape
    scratch = BlockScratch.allocate(n, t, d, w1.shape[0], w_qkv.dtype, x.device)
    return _block_sequence(
        x, a, gains, w_mod, w_qkv, w_out, w1, w2, heads, scratch, torch.empty_like(x),
        mp_gemm_plain, cosine_attention_plain,
    )


SUM_DTYPES = (torch.float32, torch.float64)


def fused_dit_stack_plain(x, a, gains, w_mod, w_qkv, w_out, w1, w2, heads: int, sum_dtype=torch.float32):
    """Plain version of :func:`fused_dit_stack`'s forward on any device.

    ``sum_dtype=torch.float64`` is its float64 witness: the same roundings
    to the weights' type (the products' operands, attn, the MLP hidden, the
    stream between blocks) with every product, softmax, norm and the f32
    intermediates (modulation rows, qkv, x1) in float64. At the default it
    is the f32 plain version, bit for bit."""
    if sum_dtype not in SUM_DTYPES:
        raise ValueError(f"sum_dtype must be one of {SUM_DTYPES}, got {sum_dtype}")
    return _stack(
        x, a, gains, (w_mod, w_qkv, w_out, w1, w2), heads,
        functools.partial(mp_gemm_plain, sum_dtype=sum_dtype),
        functools.partial(cosine_attention_plain, sum_dtype=sum_dtype), wide=sum_dtype,
    )


def stack_launch_sequence(x, a, gains, w_mod, w_qkv, w_out, w1, w2, heads: int):
    """The stack as separate launches of ``mp_gemm`` and
    ``cosine_attention``, nine a block (the route of ``fused_dit_stack``
    before :func:`dit_stack`): the yardstick ``chip_smoke.py`` and
    ``tools/bench_dit_stack.py`` time the kernel against."""
    return _stack(x, a, gains, (w_mod, w_qkv, w_out, w1, w2), heads, mp_gemm, cosine_attention)


# ---------------------------------------------------------------------------
# the persistent whole-stack kernel

H100_SMS = 132
# csrc/dit_stack.cu's layout: 128 x 128 product tiles of k depth 64 (32 in
# the f32 instances: 128-byte rows either way), a ring of four 32 KB stages
# with its mbarriers (two groups' attention buffers lie in it), the
# hand-off mbarriers and a count, the f32 epilogue tile (128 rows padded by 4
# floats), 1 KB of alignment slack; one CTA an SM
STACK_TILE, STACK_K = 128, 64
STACK_RING_BYTES = 4 * 2 * STACK_TILE * STACK_K * 2
STACK_SMEM_BYTES = 1024 + STACK_RING_BYTES + 2 * 4 * 8 + 32 + STACK_TILE * (STACK_TILE + 4) * 4
# shared memory of an SM (233,472 bytes), 1 KB of it reserved for each block
SM_SMEM_BYTES = 228 * 1024
# the attention stage streams its keys in tiles of 64 (a unit is one tile of
# 64 queries), so shared memory does not bound T; the limit is the largest
# registry T (32 x 32 latents at patch 2), the T chip_smoke.py holds the
# kernel to its plain version at
STACK_MAX_T = 256
STACK_QUERY_TILE = 64  # query rows of an attention unit, keys of a tile
# the sync words: the grid barrier's counter, then from word STACK_SYNC_DONE
# one counter a row tile for each of a block's five stages (8 words apart),
# then the tile tickets of every split product of every block
STACK_SYNC_DONE = 32
STACK_TRACE_WORDS = 8  # a CTA's ns by kind of work (6), its start and end


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def stack_attention_smem(hd: int, elem_bytes: int = 2) -> int:
    """Shared memory of one group of four warps' attention buffers (Q, K, V
    rows of 64 tokens padded as attention_tiles.cuh pads them, two scale
    vectors; with ``elem_bytes=4`` the f32 rows of cosine_tiles.cuh's
    DimsF32, hd + 4 floats a row); the kernel keeps two groups in the
    ring."""
    ld = hd + 4 if elem_bytes == 4 else _cdiv(hd, 16) * 16 + 8
    return 3 * 64 * ld * elem_bytes + 2 * 64 * 4


@dataclasses.dataclass(frozen=True)
class StackProduct:
    """One product stage of :func:`dit_stack` (and of the work lists of
    ``dit_block_tp``): C (m, n) = A (m, k) . W^T in tiles of 128 rows by
    ``width`` columns (128, or 256 for row 9's kernel), K split ``splits``
    ways."""

    name: str
    m: int
    n: int
    k: int
    splits: int
    width: int = STACK_TILE
    k_step: int = STACK_K  # elements a k step (32 for f32 operands)

    @property
    def row_tiles(self) -> int:
        return _cdiv(self.m, STACK_TILE)

    @property
    def col_tiles(self) -> int:
        return _cdiv(self.n, self.width)

    @property
    def kt(self) -> int:
        return _cdiv(self.k, self.k_step)

    @property
    def tiles(self) -> int:
        return self.row_tiles * self.col_tiles

    @property
    def items(self) -> int:
        return self.tiles * self.splits

    def item(self, j: int) -> tuple:
        """Item j: (row tile, column tile, split, k steps [kb, ke)); split
        major, then row tile, then column tile (the splits of a tile lie
        ``tiles`` items apart)."""
        nt, kt = self.col_tiles, self.kt
        tile, z = j % self.tiles, j // self.tiles
        return tile // nt, tile % nt, z, z * kt // self.splits, (z + 1) * kt // self.splits


@dataclasses.dataclass(frozen=True)
class StackPlan:
    """The work of one :func:`dit_stack` launch: the grid, the product
    stages (the modulation rows of every block, then qkv, out, fc1, fc2 of
    each block), the attention's (sample, head, query tile) units a block
    (unit ``u`` is query tile ``u % query_tiles`` of head ``u //
    query_tiles % heads`` of sample ``u // query_tiles // heads``), the
    shared memory a CTA takes, the tile tickets, and the layout of the one
    scratch buffer (byte offsets of its parts; ``sync`` is zeroed at every
    launch; each split product has partials of its own)."""

    ctas: int
    depth: int
    products: tuple
    attention_items: int
    smem_bytes: int
    attention_smem_bytes: int
    tickets: int
    layout: dict
    workspace_bytes: int
    tokens: int
    heads: int

    @property
    def query_tiles(self) -> int:
        return _cdiv(self.tokens, STACK_QUERY_TILE)

    def unit(self, u: int) -> tuple:
        """Attention unit ``u``: (sample, head, first query row, query rows)."""
        q0 = u % self.query_tiles * STACK_QUERY_TILE
        return u // self.query_tiles // self.heads, u // self.query_tiles % self.heads, q0, min(
            STACK_QUERY_TILE, self.tokens - q0)

    def units_of(self, r: int) -> int:
        """The attention units that read row tile ``r``: every unit of every
        sample with a row in it (a unit reads its whole sample's keys). The
        count a block's out product of that row tile waits for (the
        kernel's Work::units_of)."""
        t, m = self.tokens, self.products[1].m
        first, last = r * STACK_TILE // t, min(m // t, _cdiv(r * STACK_TILE + STACK_TILE, t)) - 1
        return (last - first + 1) * self.heads * self.query_tiles

    @property
    def items_per_block(self) -> int:
        """The work list's items of one block: the four products' tiles and
        K splits and the attention's pairs of units."""
        return sum(p.items for p in self.products[1:]) + _cdiv(self.attention_items, 2)

    def walk(self):
        """What each CTA computes, in the kernel's order: the modulation
        rows' tiles (``block`` -1), then the blocks' work list, CTA c taking
        items c, c + ctas, ... Per CTA a list of (block, stage, index in the
        stage, the product item as :meth:`StackProduct.item` gives it, or
        the attention's two units, as :meth:`unit` reads them)."""
        out = [[] for _ in range(self.ctas)]
        mods = self.products[0]
        for j in range(mods.items):
            out[j % self.ctas].append((-1, "modulation", j, mods.item(j)))
        stages = [("qkv", self.products[1]), ("attention", None), ("out", self.products[2]),
                  ("fc1", self.products[3]), ("fc2", self.products[4])]
        counts = [p.items if p is not None else _cdiv(self.attention_items, 2) for _, p in stages]
        for g in range(self.depth * self.items_per_block):
            b, j = divmod(g, self.items_per_block)
            for (name, prod), count in zip(stages, counts):
                if j < count:
                    break
                j -= count
            units = tuple(u for u in (2 * j, 2 * j + 1) if u < self.attention_items)
            what = prod.item(j) if prod is not None else units
            out[g % self.ctas].append((b, name, j, what))
        return out

    @property
    def trace_words(self) -> int:
        """int64 words of a trace: for each CTA the ns it spent on the
        modulation rows and the pre stage, on qkv, attention, out, fc1 and
        fc2 items, then its start and end clock."""
        return STACK_TRACE_WORDS * self.ctas

    def product(self, name: str) -> StackProduct:
        return next(p for p in self.products if p.name == name)


def _split(tiles: int, kt: int, ctas: int) -> int:
    """K splits of a product with ``tiles`` output tiles of ``kt`` k steps:
    none when the tiles fill the grid, else as many as the grid takes at
    once (the splits of a tile wait on each other), at least three k steps
    each, at most 8."""
    if tiles >= ctas:
        return 1
    return max(1, min(ctas // tiles, kt // 3, 8))


@functools.lru_cache(maxsize=None)
def stack_plan(
    n: int, t: int, d: int, hidden: int, heads: int, depth: int, ctas: int = H100_SMS, elem_bytes: int = 2
) -> StackPlan:
    """:func:`dit_stack`'s plan for N samples of T tokens at width D, MLP
    width ``hidden``, on a grid of ``ctas`` resident CTAs; ``elem_bytes`` 2
    for the bf16 instances, 4 for the f32 ones (k steps of 32, f32 attn, h
    and amod scratch, f32 attention rows). Every split depends on one
    block's shapes and the grid alone, never on depth, so a stack and a
    chain of depth-1 calls sum in the same order; a product splits only as
    far as all its items run at once (the splits of a tile wait on each
    other)."""
    if elem_bytes not in (2, 4):
        raise ValueError(f"elem_bytes must be 2 (bf16) or 4 (f32), got {elem_bytes}")
    m = n * t
    k_step = 128 // elem_bytes
    products = [StackProduct("modulation", n, 6 * d * depth, d, 1, k_step=k_step)]
    for name, cols, k in (("qkv", 3 * d, d), ("out", d, d), ("fc1", hidden, d), ("fc2", d, hidden)):
        tiles = _cdiv(m, STACK_TILE) * _cdiv(cols, STACK_TILE)
        products.append(StackProduct(name, m, cols, k, _split(tiles, _cdiv(k, k_step), ctas), k_step=k_step))
    split = [p for p in products if p.splits > 1]
    tickets = depth * sum(p.tiles for p in split)  # one a tile of every split product of every block
    sizes = {
        "sync": 4 * (STACK_SYNC_DONE + 5 * 8 * _cdiv(m, STACK_TILE) + tickets),
        "mods": n * 6 * d * depth * 4,
        "qkv": m * 3 * d * 4,
        "x1": m * d * 4,
        "partial": sum(p.splits * p.m * p.n * 4 for p in split),
        "attn": m * d * elem_bytes,
        "h": m * hidden * elem_bytes,
        "amod": m * d * elem_bytes,
    }
    layout, offset = {}, 0
    for name, size in sizes.items():
        layout[name] = offset
        offset += _cdiv(size, 256) * 256
    return StackPlan(
        ctas=ctas, depth=depth, products=tuple(products), attention_items=n * heads * _cdiv(t, STACK_QUERY_TILE),
        smem_bytes=STACK_SMEM_BYTES, attention_smem_bytes=2 * stack_attention_smem(d // heads, elem_bytes),
        tickets=tickets, layout=layout, workspace_bytes=offset, tokens=t, heads=heads,
    )


def check_stack_shape(tokens: int, d: int, heads: int) -> None:
    """Raise unless :func:`dit_stack`'s kernel takes T tokens of width D in
    ``heads`` heads: head widths 64 and 72 (the attention tiles' template
    instances, every registry model's), an even T <= STACK_MAX_T (registry
    T is 256, 64, 16 or 4 at 32 x 32 and 16 x 16 latents; the keys stream in
    tiles of 64, so the limit is the one held on the card, not shared
    memory), D a multiple of 8 (TMA rows and 16-byte accesses)."""
    hd = d // heads
    if d % heads or hd not in ATTENTION_HEAD_WIDTHS:
        raise ValueError(f"dit_stack on CUDA takes head widths {ATTENTION_HEAD_WIDTHS}, got D={d} in {heads} heads")
    if tokens > STACK_MAX_T or tokens % 2:
        raise ValueError(f"dit_stack on CUDA takes an even T <= {STACK_MAX_T}, got {tokens}")
    if d % 8:
        raise ValueError(f"dit_stack on CUDA takes D a multiple of 8, got {d}")


def dit_stack_plain(x, a, gains, w_mod, w_qkv, w_out, w1, w2, heads: int):
    """Plain version of :func:`dit_stack`, in the kernel's order: the
    modulation rows of every block first, (N, depth*6D) f32, then each
    block's stages over its columns of them; the same roundings as
    :func:`fused_dit_stack_plain`."""
    depth = w_mod.shape[0]
    n, t, d = x.shape
    mods = torch.cat(
        [mp_gemm_plain(a, w_mod[b], alpha=1.0 / math.sqrt(d), out_dtype=torch.float32) for b in range(depth)], dim=1
    )
    scratch = BlockScratch.allocate(n, t, d, w1.shape[1], w_qkv.dtype, x.device)
    for b in range(depth):
        x = _block_stages(
            x, mods, 6 * d * b, gains[b], w_qkv[b], w_out[b], w1[b], w2[b], heads, scratch, torch.empty_like(x),
            mp_gemm_plain, cosine_attention_plain,
        )
    return x


@functools.lru_cache(maxsize=None)
def _resident_ctas(device_index: int, hd: int, f32: bool = False) -> int:
    from mapdit_tpu_torch.ops.cuda import build

    lib = build.library("dit_stack")
    with torch.cuda.device(device_index):
        ctas = (lib.dit_stack_f32_resident_ctas if f32 else lib.dit_stack_resident_ctas)(hd)
    if ctas < 1:
        _raise_on(-ctas, build.library("dit_stack"), "dit_stack")
    return ctas


def dit_stack(x, a, gains, w_mod, w_qkv, w_out, w1, w2, heads: int, trace: Optional[torch.Tensor] = None):
    """All ``depth`` blocks over depth-stacked weights (leading depth axis;
    gains (depth, 2) f32) in one launch of ``csrc/dit_stack.cu``: x (N, T, D)
    and a (N, D) bf16 with folded bf16 weights (the bf16 instances), or all
    of them f32 (the f32 instances); returns the new stream in x's type. The
    plain version :func:`dit_stack_plain` serves CPU tensors; on the card the
    kernel takes head widths 64 and 72, an even T <= STACK_MAX_T
    (:func:`check_stack_shape`) and raises otherwise, never copying.
    ``trace``, an int64 tensor of the plan's ``trace_words`` on the card,
    receives each CTA's clock at every grid barrier (a stage timeline)."""
    if x.device.type == "cpu":
        return dit_stack_plain(x, a, gains, w_mod, w_qkv, w_out, w1, w2, heads)
    from mapdit_tpu_torch.ops.cuda import build

    weights = (w_mod, w_qkv, w_out, w1, w2)
    _require_cuda(x, a, gains, *weights)
    depth = w_mod.shape[0]
    _check_block_args(x, a, gains, weights, depth)
    n, t, d = x.shape
    hidden = w1.shape[1]
    check_stack_shape(t, d, heads)
    if any(z.data_ptr() % 16 for z in (x, a, *weights)):
        raise ValueError(
            "dit_stack on CUDA reads its operands with TMA and 16-byte loads: they must be 16-byte aligned"
        )
    f32 = x.dtype == torch.float32
    plan = stack_plan(n, t, d, hidden, heads, depth, _resident_ctas(x.get_device(), d // heads, f32),
                      elem_bytes=x.element_size())
    if trace is not None and (
        trace.dtype != torch.int64 or trace.numel() < plan.trace_words or trace.device != x.device
    ):
        raise ValueError(f"trace must be int64 with {plan.trace_words} words on {x.device}")
    lib = build.library("dit_stack")
    work = torch.empty(plan.workspace_bytes, dtype=torch.uint8, device=x.device)
    out = torch.empty_like(x)
    base, at = work.data_ptr(), plan.layout
    splits = [plan.product(name).splits for name in ("qkv", "out", "fc1", "fc2")]
    code = (lib.dit_stack_f32 if f32 else lib.dit_stack)(
        x.data_ptr(), a.data_ptr(), gains.data_ptr(), *(w.data_ptr() for w in weights), out.data_ptr(),
        *(base + at[name] for name in ("mods", "qkv", "x1", "partial", "attn", "h", "amod", "sync")),
        at["mods"] - at["sync"], n, t, d, hidden, heads, depth, *splits, plan.ctas,
        1.0 / math.sqrt(d), 1.0 / math.sqrt(hidden), torch.cuda.current_stream(x.device).cuda_stream,
        None if trace is None else trace.data_ptr(),
    )
    _raise_on(code, lib, "dit_stack")
    LAUNCHES["dit_stack"] += 1
    return out


def _stack_route(x, a, gains, w_mod, w_qkv, w_out, w1, w2, heads: int):
    """The stack forward on the route ``STACK_KERNEL`` picks: :func:`dit_stack`
    (the plain version on the CPU), or on the card with ``STACK_KERNEL =
    False`` :func:`stack_launch_sequence`."""
    if x.device.type == "cuda" and not STACK_KERNEL:
        return stack_launch_sequence(x, a, gains, w_mod, w_qkv, w_out, w1, w2, heads)
    return dit_stack(x, a, gains, w_mod, w_qkv, w_out, w1, w2, heads)


def _fused_dit_block_fwd(x, a, gains, w_mod, w_qkv, w_out, w1, w2, heads: int):
    weights = (w_mod, w_qkv, w_out, w1, w2)
    _check_block_args(x, a, gains, weights, None)
    out = _stack_route(x, a, gains[None], *(w[None] for w in weights), heads)
    if x.device.type == "cuda":
        LAUNCHES["fused_dit_block"] += 1
    return out


def _fused_dit_stack_fwd(x, a, gains, w_mod, w_qkv, w_out, w1, w2, heads: int):
    weights = (w_mod, w_qkv, w_out, w1, w2)
    _check_block_args(x, a, gains, weights, w_mod.shape[0])
    out = _stack_route(x, a, gains, *weights, heads)
    if x.device.type == "cuda":
        LAUNCHES["fused_dit_stack"] += 1
    return out


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
    ``needs``, recomputed from the saved inputs in their own types (PyTorch's
    promotion; on bf16 inputs the recompute runs in bf16, as ``jax.vjp`` of
    the Pallas package's ``_reference`` does) and returned in each input's
    type (None where no gradient is asked for)."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(need) for t, need in zip(inputs, needs)]
        out = fn(*xs, *args)
        wanted = [x for x in xs if x.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, cotangent.to(out.dtype)) if wanted else ())
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
    w_qkv (3D,D), w_out (D,D), w1 (H,D), w2 (D,H). Returns the new stream,
    through :func:`dit_stack` at depth 1; its gradient recomputes through
    :func:`block_reference`."""
    inputs = (x, a, gains, w_mod, w_qkv, w_out, w1, w2)
    if not needs_grad(*inputs):
        return _fused_dit_block_fwd(*inputs, heads)
    return _RecomputedVJP.apply(_fused_dit_block_fwd, block_reference, heads, *inputs)


def fused_dit_stack(x, a, gains, w_mod, w_qkv, w_out, w1, w2, heads: int):
    """All ``depth`` blocks over depth-stacked folded weights (leading depth
    axis on every weight; gains (depth, 2) f32), through :func:`dit_stack`:
    one launch on the card. The gradient recomputes through
    :func:`stack_reference`."""
    inputs = (x, a, gains, w_mod, w_qkv, w_out, w1, w2)
    if not needs_grad(*inputs):
        return _fused_dit_stack_fwd(*inputs, heads)
    return _RecomputedVJP.apply(_fused_dit_stack_fwd, stack_reference, heads, *inputs)
