"""Standalone attention on Hopper: ``fused_attention`` over (B, H, T, D').

Port of ``mapdit_tpu/ops/pallas/attention.py``: ``fused_attention`` over
``_fused_attention_fwd_impl`` (the v2 kernel ``_attention_kernel`` and the
head-pair-packed v3 kernel ``_attention_kernel_packed``; one CUDA kernel,
``csrc/fused_attention.cu``, stands for both). It computes

    softmax(norm(q) . norm(k)^T * scale) . v

with the q/k row normalisation only under ``cosine`` and a max-subtracted
softmax, in f32 or bf16, with the v3 kernel's roundings: normalised q and k
rounded to the input type, p to v's type, every sum in f32.

The kernel addresses q, k, v and the output by their batch, head and token
strides, so the model's transposed views of the split qkv product are read
in place: the wrapper never copies an operand. It raises on a layout the
kernel does not take: a last dimension that is not contiguous, or, in bf16,
a base or stride that is not 16-byte aligned (its 16-byte loads and
stores; every registry width is aligned). The output is allocated in the
operands' own order of dimensions: for q laid out (B, T, H, D') in memory
it is a (B, H, T, D') view of a (B, T, H, D') buffer, so the caller's
``transpose(1, 2).reshape(B, T, D)`` is a view too.

Bound on the H100: memory (each operand read once, the output written
once; 32 flops per byte at T = D' = 64 in bf16). bf16 runs on the tensor
cores over key tiles of 64 at any T, for the head widths of
``ATTENTION_HEAD_WIDTHS``; f32 runs on the f32 pipes with K, V, the query
tile and its logits in shared memory: :func:`query_tile` picks the tile of
query rows, and the wrapper raises with the byte count where even the
smallest tile does not fit. :func:`check_shape` is the domain of both.

For a CUDA tensor the wrapper launches the kernel or raises; for a CPU
tensor it runs :func:`fused_attention_plain`. ``LAUNCHES`` counts launches.
The gradient recomputes through :func:`attention_reference`, the plain
path, as the Pallas kernel's VJP does (it has no backward kernel).
"""

from __future__ import annotations

import ctypes

import torch

from mapdit_tpu_torch.ops.cuda.dit_block import (
    ATTENTION_HEAD_WIDTHS,
    MAX_SMEM_BYTES,
    _DTYPE_CODE,
    _raise_on,
    needs_grad,
    vjp_through,
)
from mapdit_tpu_torch.ops.mp import normalize

LAUNCHES = {"fused_attention": 0}
QUERY_TILES = (64, 32, 16, 8, 4, 2, 1)


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def smem_bytes(t: int, hd: int, qt: int) -> int:
    """Shared memory of one block of the f32 kernel
    (``csrc/fused_attention.cu:smem_bytes``): K, V and the query tile as f32
    rows of hd + 1, and qt x T f32 logits."""
    return ((2 * t + qt) * (hd + 1) + qt * t) * 4


def query_tile(t: int, hd: int) -> int:
    """The f32 kernel's largest tile of query rows (at most 64, at most T)
    whose block fits the card's shared memory. Raises where none does."""
    for qt in QUERY_TILES:
        if qt <= max(t, 1) and smem_bytes(t, hd, qt) <= MAX_SMEM_BYTES:
            return qt
    raise ValueError(
        f"T={t}, head width {hd} needs {smem_bytes(t, hd, 1)} bytes of shared memory for K and V alone; "
        f"the kernel holds at most {MAX_SMEM_BYTES}"
    )


def check_shape(t: int, hd: int, dtype: torch.dtype) -> int:
    """Raise unless the kernel takes T tokens of head width hd in ``dtype``;
    return the f32 kernel's query tile (0 for bf16, which tiles by 64)."""
    if dtype == torch.bfloat16:
        if hd not in ATTENTION_HEAD_WIDTHS:
            raise ValueError(f"fused_attention on the card takes bf16 head widths {ATTENTION_HEAD_WIDTHS}, got {hd}")
        return 0
    return query_tile(t, hd)


def attention_reference(q, k, v, scale: float, cosine: bool):
    """The plain attention path (``ops/attention.py:plain_attention``),
    differentiable; the VJP of :func:`fused_attention` recomputes through
    it."""
    from mapdit_tpu_torch.ops.attention import plain_attention

    return plain_attention(q, k, v, scale, cosine)


def fused_attention_plain(q, k, v, scale: float, cosine: bool = True):
    """Plain version of :func:`fused_attention` with the kernel's roundings
    (module docstring); differentiable."""
    dt = q.dtype
    qf, kf = q.float(), k.float()
    if cosine:
        qf, kf = normalize(qf).to(dt).float(), normalize(kf).to(dt).float()
    logits = (qf @ kf.transpose(-1, -2)) * scale
    p = torch.softmax(logits, dim=-1)
    return (p.to(v.dtype).float() @ v.float()).to(dt)


def _strides(z: torch.Tensor):
    return z.stride(0), z.stride(1), z.stride(2)


def _empty_like_layout(q: torch.Tensor) -> torch.Tensor:
    """An output with q's shape whose memory order follows q's: tokens
    outside heads when q is a transposed (B, T, H, D') view."""
    b, h, t, hd = q.shape
    if h > 1 and t > 1 and q.stride(1) < q.stride(2):
        return torch.empty(b, t, h, hd, dtype=q.dtype, device=q.device).transpose(1, 2)
    return torch.empty(b, h, t, hd, dtype=q.dtype, device=q.device)


def _fused_attention_fwd(q, k, v, scale: float, cosine: bool):
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, scale, cosine)
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"fused_attention takes q, k, v of one shape (B, H, T, D'), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"fused_attention takes f32 or bf16 q, k, v of one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    for z in (q, k, v):
        if z.stride(3) != 1:
            raise ValueError(
                f"fused_attention reads rows whose last dimension is contiguous, got strides {z.stride()}; "
                "it makes no copy of an operand"
            )
        if q.dtype == torch.bfloat16 and (z.data_ptr() % 16 or any(s % 8 for s in z.stride()[:3])):
            raise ValueError(
                f"fused_attention reads bf16 rows with 16-byte loads: the base and the batch, head and token "
                f"strides must be 16-byte aligned, got strides {z.stride()} at offset {z.data_ptr() % 16}; "
                "it makes no copy of an operand"
            )
    for z in (q, k, v):
        if z.device.type != "cuda" or z.device != q.device:
            raise ValueError(f"kernel inputs must share one CUDA device, got {z.device} and {q.device}")
    b, h, t, hd = q.shape
    qt = check_shape(t, hd, q.dtype)
    from mapdit_tpu_torch.ops.cuda import build

    lib = build.library("fused_attention")
    if qt and lib.fused_attention_smem_bytes(t, hd, qt) != smem_bytes(t, hd, qt):
        raise RuntimeError("the shared-memory sizes of fused_attention.cu and its wrapper differ")
    out = _empty_like_layout(q)
    strides = (ctypes.c_longlong * 12)(*_strides(q), *_strides(k), *_strides(v), *_strides(out))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.fused_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPE_CODE[q.dtype], b, h, t, hd, strides,
        float(scale), 1 if cosine else 0, qt, stream,
    )
    _raise_on(code, lib, "fused_attention")
    LAUNCHES["fused_attention"] += 1
    return out


class _FusedAttention(torch.autograd.Function):
    """Kernel forward; backward by autograd through the plain path on the
    saved q, k, v (``_bwd`` of the Pallas package)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, cosine):
        ctx.scale, ctx.cosine = scale, cosine
        ctx.save_for_backward(q, k, v)
        return _fused_attention_fwd(q, k, v, scale, cosine)

    @staticmethod
    def backward(ctx, g):
        grads = vjp_through(attention_reference, ctx.saved_tensors, ctx.needs_input_grad[:3], g, ctx.scale, ctx.cosine)
        return (*grads, None, None)


def fused_attention(q, k, v, scale: float, cosine: bool = True):
    """Attention over (B, H, T, D') q, k, v (f32 or bf16, any batch, head
    and token strides, last dimension contiguous); returns (B, H, T, D') in
    the input type. Its gradient recomputes through
    :func:`attention_reference` in the input type."""
    if not needs_grad(q, k, v):
        return _fused_attention_fwd(q, k, v, scale, cosine)
    return _FusedAttention.apply(q, k, v, scale, cosine)
