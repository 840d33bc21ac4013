"""MLP half-block on Hopper: ``fused_mlp_branch``.

Port of ``mapdit_tpu/ops/pallas/mlp_block.py``: ``fused_mlp_branch`` over
``_fwd_impl`` / ``_kernel``,

    y = mp_sum(x, gate * fc2(mp_silu(fc1(modulate(x, shift, scale, gain)))), 0.3)

The Pallas kernel holds both weight matrices in VMEM beside the
activations; a Hopper block's shared memory cannot, so the half-block is two
launches of the hand-written ``csrc/mp_gemm.cu`` and the elementwise stages
ride them, as in stages 5-6 of ``fused_dit_block``: fc1 with the modulate
prologue (before the rounding to the weights' type) and the MP-SiLU
epilogue, the hidden leaving in the weights' type; fc2 with the
gated-residual epilogue, reading x and writing y in x's type. shift, scale
and gate arrive as (N, D) tensors in x's type and are packed once into one
(N, 3D) f32 row buffer (an exact upcast), the gain is read from device
memory. Only the (N*T, H) hidden passes through device memory between the
two launches.

Bound on the H100: operations (4*N*T*D*H flops on bf16 operands against
x in, y out, the weights and the rows). On the card the kernels take bf16
weights (``mp_gemm``); a float32 model runs ``block_kernel="off"``.

For a CUDA tensor the wrapper launches the kernels or raises; for a CPU
tensor it runs :func:`fused_mlp_branch_plain`. ``LAUNCHES`` counts calls of
the wrapper on the card; each is one ``mp_gemm/fc1`` and one ``mp_gemm/fc2``
launch in ``dit_block.LAUNCHES``. The gradient recomputes through
:func:`mlp_reference` (the Pallas package's ``_reference``; the modulate
denominator is constant in the gain).
"""

from __future__ import annotations

import math

import torch

from mapdit_tpu_torch.ops.cuda.attn_branch import _pack
from mapdit_tpu_torch.ops.cuda.dit_block import (
    RES_T,
    modulate_reference,
    mp_gemm,
    mp_gemm_plain,
    needs_grad,
    vjp_through,
)
from mapdit_tpu_torch.ops.mp import mp_silu, mp_sum

LAUNCHES = {"mlp_branch/fwd": 0}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _check(x, shift, scale, gate, gain, w1, w2):
    n, t, d = x.shape
    hidden = w1.shape[0]
    if w1.shape != (hidden, d) or w2.shape != (d, hidden):
        raise ValueError(f"w1 must be (H, D) and w2 (D, H), got {tuple(w1.shape)}, {tuple(w2.shape)}")
    if any(r.shape != (n, d) for r in (shift, scale, gate)) or gain.numel() != 1:
        raise ValueError("shift, scale and gate must be (N, D) and the gain one value")
    if x.device.type == "cuda" and (
        x.dtype != torch.bfloat16 or w1.dtype != torch.bfloat16 or w2.dtype != torch.bfloat16
    ):
        raise ValueError(
            "the CUDA MLP half-block kernels run bf16 only: x and the weights must be bf16 "
            "(a float32 model runs block_kernel='off')"
        )


def _fwd(x, shift, scale, gate, gain, w1, w2, gemm):
    _check(x, shift, scale, gate, gain, w1, w2)
    rows, g = _pack(shift, scale, gate, gain)
    n, t, d = x.shape
    hidden = w1.shape[0]
    xf = x.contiguous().reshape(n * t, d)
    h = gemm(
        xf, w1.contiguous(), alpha=1.0 / math.sqrt(d), out_dtype=w1.dtype, modulate=(rows, 0, d, g), silu=True,
        tokens=t, site="fc1",
    )
    y = gemm(
        h, w2.contiguous(), alpha=1.0 / math.sqrt(hidden), out_dtype=x.dtype, residual=(xf, rows, 2 * d), tokens=t,
        site="fc2",
    )
    return y.reshape(n, t, d)


def mlp_fwd(x, shift, scale, gate, gain, w1, w2):
    """The MLP half-block forward. x (N, T, D); shift, scale, gate (N, D);
    gain one f32 value; w1 (H, D), w2 (D, H) pre-normalized. Returns the new
    stream in x's type."""
    y = _fwd(x, shift, scale, gate, gain, w1, w2, mp_gemm)
    if x.device.type == "cuda":
        LAUNCHES["mlp_branch/fwd"] += 1
    return y


def fused_mlp_branch_plain(x, shift, scale, gate, gain, w1, w2):
    """Plain version of :func:`fused_mlp_branch`'s forward."""
    return _fwd(x, shift, scale, gate, gain, w1, w2, mp_gemm_plain)


def mlp_reference(x, shift, scale, gate, gain, w1, w2):
    """Plain reference math of the half-block (``_reference``),
    differentiable; the VJP recomputes through it."""
    d, hidden = x.shape[-1], w1.shape[0]
    mod = modulate_reference(x, shift, scale, gain.reshape(()))
    y = mp_silu(mod @ w1.t() / math.sqrt(d)) @ w2.t() / math.sqrt(hidden)
    return mp_sum(x, gate[:, None, :] * y, t=RES_T)


class _MLPBranch(torch.autograd.Function):
    """Kernel forward; backward by autograd through :func:`mlp_reference`
    on the saved inputs (``_bwd`` of the Pallas package)."""

    @staticmethod
    def forward(ctx, *inputs):
        ctx.save_for_backward(*inputs)
        return mlp_fwd(*inputs)

    @staticmethod
    def backward(ctx, dy):
        return tuple(vjp_through(mlp_reference, ctx.saved_tensors, ctx.needs_input_grad, dy))


def fused_mlp_branch(x, shift, scale, gate, gain, w1, w2):
    """The MLP half-block (module docstring); its gradient recomputes
    through :func:`mlp_reference` in the inputs' types."""
    inputs = (x, shift, scale, gate, gain, w1, w2)
    if not needs_grad(*inputs):
        return mlp_fwd(*inputs)
    return _MLPBranch.apply(*inputs)
