"""MLP half-block on Hopper: ``fused_mlp_branch``.

Port of ``mapdit_tpu/ops/pallas/mlp_block.py``: ``fused_mlp_branch`` over
``_fwd_impl`` / ``_kernel``,

    y = mp_sum(x, gate * fc2(mp_silu(fc1(modulate(x, shift, scale, gain)))), 0.3)

On the card a call is ONE persistent launch of ``mlp_branch``
(``csrc/dit_block_tp.cu``, on the work-list machinery of the TP partials
and ``csrc/wide_tile.cuh``'s 128 x 256 tiles; in f32 ``mlp_branch_f32``)
and no other device operation: its list runs the modulate (pre items, into
a scratch of the weights' type), fc1 with the MP-SiLU (the hidden h in the
same type) and fc2 with the gated residual, laid out by :func:`mlp_plan`,
whose words the launch reads and the CPU tests walk. The Pallas kernel keeps both
weight matrices and the hidden activations in VMEM; here h passes through
L2 and device memory. shift, scale and gate are read in place, in x's type
(or f32), as they are; the gain is read from device memory. The rounding
points are those of the route before the kernel (:func:`mlp_launch_sequence`,
two ``mp_gemm`` launches, kept as the yardstick of both forms and never
dispatched): the modulate in f32 rounded once to the weights' type, fc1
summed in f32 and scaled by 1/sqrt(D), MP-SiLU, h in the weights' type; fc2
summed in f32 and scaled by 1/sqrt(H), then the gated residual in f32, y in
x's type (in f32 nothing is rounded).

Bound on the H100: operations (4*N*T*D*H flops on bf16 operands against
x in, y out, the weights and the rows). On the card the kernel takes x and
the weights all bf16, or all f32: a float32 model (the Pallas kernel at
``dtype = w1.dtype = float32``, nothing rounded) runs ``mlp_branch_f32``,
the TP kernels' f32 instance (``csrc/dit_block_tp_f32.cu``) on the same
list with 128 x 128 tiles on the f32 pipes, h and y in f32 (bound: the f32
pipes' 67 TFLOP/s). A mixed set raises.

For a CUDA tensor the wrapper launches the kernel or raises; for a CPU
tensor it runs :func:`fused_mlp_branch_plain`. ``LAUNCHES`` counts, on the
card, wrapper calls (``mlp_branch/fwd``), launches of the kernel
(``mlp_branch/kernel``) and calls of the yardstick
(``mlp_branch/sequence``; its ``mp_gemm`` launches are counted in
``dit_block.LAUNCHES``). The gradient recomputes through
:func:`mlp_reference` (the Pallas package's ``_reference``; the modulate
denominator is constant in the gain).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from mapdit_tpu_torch.ops.cuda.attn_branch import _pack
from mapdit_tpu_torch.ops.cuda.dit_block import (
    H100_SMS,
    RES_T,
    _raise_on,
    _require_cuda,
    modulate_reference,
    mp_gemm,
    mp_gemm_plain,
    needs_grad,
    vjp_through,
)
from mapdit_tpu_torch.ops.cuda.dit_block_tp import (
    _aligned,
    _launch_state,
    _library,
    _resident_ctas,
    _row_operands,
    _scratch,
    _trace_ptr,
    check_tp_shape,
    check_types,
    tp_plan,
)
from mapdit_tpu_torch.ops.mp import mp_silu, mp_sum

LAUNCHES = {"mlp_branch/fwd": 0, "mlp_branch/kernel": 0, "mlp_branch/sequence": 0}


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
    check_types("MLP half-block (row 9)", x, w1, w2)


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


def mlp_launch_sequence(x, shift, scale, gate, gain, w1, w2):
    """Row 9 as the route before the kernel: the rows packed into one f32
    buffer, then two launches of ``mp_gemm`` (fc1 with its modulate
    prologue pass and the MP-SiLU, fc2 with the gated residual; in f32
    ``mp_gemm``'s f32 form). Kept as the yardstick of both kernels; never
    dispatched."""
    y = _fwd(x, shift, scale, gate, gain, w1, w2, mp_gemm)
    if x.device.type == "cuda":
        LAUNCHES["mlp_branch/sequence"] += 1
    return y


def fused_mlp_branch_plain(x, shift, scale, gate, gain, w1, w2):
    """Plain version of :func:`fused_mlp_branch`'s forward."""
    return _fwd(x, shift, scale, gate, gain, w1, w2, mp_gemm_plain)


def mlp_plan(n: int, t: int, d: int, hidden: int, ctas: int = H100_SMS, f32: bool = False):
    """The plan of one launch of ``mlp_branch`` for N samples of T tokens at
    width D and hidden width H on ``ctas`` resident CTAs: the TP kernels'
    plan (``dit_block_tp.tp_plan``) of the list [pre, fc1, fc2] at full
    width, on 128 x 256 tiles; ``f32``: ``mlp_branch_f32``'s, on 128 x 128
    tiles at k steps of 32."""
    return tp_plan("mlp_branch", n, t, d, hidden, ctas=ctas, f32=f32)


@functools.lru_cache(maxsize=None)
def resident_ctas(device_index: int, f32: bool = False) -> int:
    """CTAs of row 9's kernel resident at once on the device (one an SM);
    ``f32``: of its f32 form, the TP kernels' f32 instance without an
    attention stage."""
    if f32:
        return _resident_ctas(device_index, 0, True)
    lib = _library(False)
    with torch.cuda.device(device_index):
        ctas = lib.mlp_branch_resident_ctas()
    if ctas < 1:
        _raise_on(-ctas, lib, "mlp_branch_resident_ctas", "dit_block_tp")
    return ctas


def mlp_branch(x, shift, scale, gate, gain, w1, w2, *, trace: Optional[torch.Tensor] = None):
    """One launch of ``mlp_branch`` (``csrc/dit_block_tp.cu``) on CUDA
    tensors: x (N, T, D), w1 (H, D) and w2 (D, H) all bf16, or all f32 (the
    f32 form ``mlp_branch_f32``); shift, scale, gate (N, D) f32 or bf16 of
    one type; gain a one-element f32 tensor. Returns y (N, T, D) in x's
    type. ``trace``: int64 of :func:`mlp_plan`'s ``trace_words`` on the
    resident CTAs (each CTA's ns by stage), as for the TP kernels."""
    n, t, d = x.shape
    hidden = w1.shape[0]
    _check(x, shift, scale, gate, gain, w1, w2)
    _require_cuda(x, gain, w1, w2)
    check_tp_shape("mlp_branch", t, d, hidden)
    if gain.dtype != torch.float32 or gain.numel() != 1:
        raise ValueError("the modulate gain must be one f32 value")
    shift, scale, gate, rows_bf16 = _row_operands(x, shift, scale, gate)
    _aligned(x, w1, w2)
    f32 = x.dtype == torch.float32
    plan = mlp_plan(n, t, d, hidden, ctas=resident_ctas(x.get_device(), f32), f32=f32)
    words, buffer = _launch_state(plan, x.get_device())
    lib = _library(f32)
    work = torch.empty(plan.workspace_bytes, dtype=torch.uint8, device=x.device)
    y = torch.empty(n, t, d, dtype=x.dtype, device=x.device)
    code = (lib.mlp_branch_f32 if f32 else lib.mlp_branch)(
        x.data_ptr(), w1.data_ptr(), w2.data_ptr(), shift.data_ptr(), shift.stride(0), scale.data_ptr(),
        scale.stride(0), gate.data_ptr(), gate.stride(0), rows_bf16, gain.data_ptr(), y.data_ptr(),
        *(_scratch(plan, work, name) for name in ("amod", "h", "partial_fc1", "partial_fc2")),
        buffer.data_ptr(), words, n, t, d, hidden, plan.ctas, 1.0 / math.sqrt(d), 1.0 / math.sqrt(hidden),
        torch.cuda.current_stream(x.device).cuda_stream, _trace_ptr(plan, trace, x.device),
    )
    _raise_on(code, lib, "mlp_branch", "dit_block_tp")
    LAUNCHES["mlp_branch/kernel"] += 1
    return y


def mlp_fwd(x, shift, scale, gate, gain, w1, w2):
    """The MLP half-block forward. x (N, T, D); shift, scale, gate (N, D);
    gain one f32 value; w1 (H, D), w2 (D, H) pre-normalized. Returns the new
    stream in x's type: the plain version on CPU tensors, one launch of the
    kernel on CUDA tensors (any other device raises, naming CUDA)."""
    if x.device.type == "cpu":
        return fused_mlp_branch_plain(x, shift, scale, gate, gain, w1, w2)
    gain = torch.as_tensor(gain, device=x.device).detach().reshape(1).float().contiguous()
    y = mlp_branch(x.contiguous(), shift, scale, gate, gain, w1.contiguous(), w2.contiguous())
    LAUNCHES["mlp_branch/fwd"] += 1
    return y


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
