"""Tensor-parallel (TP) DiT block islands on Hopper: the three partial
kernels, their plain versions and the islands around them.

Port of the TP islands of ``mapdit_tpu/ops/pallas/dit_block.py``. Each rank
of a mesh's model axis holds a contiguous block of heads (and, under
``mega_tp``, of MLP hidden lanes) and computes the PARTIAL output of a
branch on it; one all-reduce over the model group sums the partials, and
the gated MP residual, linear in the branch, follows replicated in plain
PyTorch, as the JAX package runs it in plain ``jnp`` after its ``psum``.

  * row 6, ``attn_tp_partial`` (``_attn_tp_partial_impl``): modulate ->
    local qkv (N*T, 3*D_l) = h . W_qkv_l^T / sqrt(D) -> cosine attention
    over ``heads_local`` heads -> partial = attn . W_out_l^T / sqrt(D), f32;
    three launches: ``mp_gemm`` with the modulate prologue, the
    ``cosine_attention`` core on the local [q_l | k_l | v_l] buffer, and
    ``mp_gemm`` with no epilogue into f32;
  * row 7, ``block_tp_attn`` (``_block_tp_attn_impl``): the modulation head
    mods = a . W_mod^T / sqrt(D), f32 (N, 6D), the same on every rank, then
    row 6 with shift = mods[:, 0], scale = mods[:, 1], gain = gains[0] read
    from that buffer by the prologue; four launches;
  * row 8, ``mlp_tp_partial`` (``_mlp_tp_partial_impl``): modulate -> local
    fc1 = h . W1_l^T / sqrt(D) -> MP-SiLU -> bf16 -> partial = . W2_l^T *
    inv_h, f32, with inv_h = 1/sqrt(H) of the GLOBAL hidden width; two
    launches of ``mp_gemm``.

The Pallas roundings are kept: the prologue's math in f32, products on
operands of the weights' type with f32 sums, f32 partials (bf16 partials
would put ~1e-3 relative error on the branch). shift and scale given as
rows (rows 6 and 8) are rounded to the weights' type, as the Pallas
kernels' one-hot row select does; row 7's prologue reads its f32
modulation buffer as it is.

Bound on the H100, per rank: the products, 2*N*T*D*(3*D_l + D_l) flops for
rows 6-7 and 4*N*T*D*H_l for row 8, against the activations and the local
weights; at the XL/2 shard shapes (N=8, T=64) a few microseconds either
way, so the first-form ``mp_gemm`` tiles and the launches set the time.

Each wrapper takes its kernels for a CUDA tensor (and raises on what they
do not take) and its plain version for a CPU tensor. ``LAUNCHES`` counts
wrapper calls on the card; their ``mp_gemm`` and ``cosine_attention``
launches are counted in ``dit_block.LAUNCHES`` under the sites named
above. The islands are inference-only, as in the JAX package: under
autograd with an input that requires grad they raise instead of cutting the
graph.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from mapdit_tpu_torch.ops.cuda.dit_block import (
    RES_DENOM,
    RES_T,
    cosine_attention,
    cosine_attention_plain,
    mp_gemm,
    mp_gemm_plain,
    needs_grad,
)

LAUNCHES = {"attn_tp_partial": 0, "block_tp_attn": 0, "mlp_tp_partial": 0}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _gain(gain, device) -> torch.Tensor:
    """One f32 device value, as ``mp_gemm``'s prologue reads it."""
    return torch.as_tensor(gain, dtype=torch.float32, device=device).detach().reshape(1).contiguous()


def _rows(shift, scale, dtype) -> torch.Tensor:
    """(N, 2D) f32 rows [shift | scale], rounded to the weights' type."""
    return torch.cat([shift, scale], dim=1).to(dtype).float().contiguous()


def _check(x, w_in, w_out, n_rows, what):
    n, t, d = x.shape
    if w_in.shape[1] != d or w_out.shape[0] != d or w_out.shape[1] * n_rows != w_in.shape[0]:
        raise ValueError(f"{what}: weights {tuple(w_in.shape)}, {tuple(w_out.shape)} do not fit D={d}")
    if x.device.type == "cuda" and (
        x.dtype != torch.bfloat16 or w_in.dtype != torch.bfloat16 or w_out.dtype != torch.bfloat16
    ):
        raise ValueError(f"the CUDA {what} kernels run bf16 only: x and the weights must be bf16")


def _attn_partial(x, mods, shift_off, scale_off, gain, w_qkv_l, w_out_l, heads_local, gemm, attention):
    """modulate -> local qkv -> cosine attention -> f32 partial out-projection."""
    n, t, d = x.shape
    if w_out_l.shape[1] % heads_local:
        raise ValueError(f"D_l={w_out_l.shape[1]} does not split into {heads_local} heads")
    inv_d = 1.0 / math.sqrt(d)
    qkv = gemm(
        x.reshape(n * t, d), w_qkv_l, alpha=inv_d, out_dtype=torch.float32,
        modulate=(mods, shift_off, scale_off, gain), tokens=t, site="qkv",
    )
    attn = attention(qkv, t, heads_local, w_qkv_l.dtype)
    return gemm(attn, w_out_l, alpha=inv_d, out_dtype=torch.float32, site="out").reshape(n, t, d)


def _attn_tp_partial(x, shift, scale, gain, w_qkv_l, w_out_l, heads_local, gemm, attention):
    _check(x, w_qkv_l, w_out_l, 3, "attn_tp_partial")
    d = x.shape[-1]
    rows = _rows(shift, scale, w_qkv_l.dtype)
    return _attn_partial(
        x.contiguous(), rows, 0, d, _gain(gain, x.device), w_qkv_l.contiguous(), w_out_l.contiguous(),
        heads_local, gemm, attention,
    )


def attn_tp_partial(x, shift, scale, gain, w_qkv_l, w_out_l, heads_local: int):
    """Row 6: one rank's partial of the attention half-block. x (N, T, D);
    shift, scale (N, D); gain one f32 value; w_qkv_l (3*D_l, D) the rank's
    rows of q, k and v stacked; w_out_l (D, D_l). Returns f32 (N, T, D)
    without gate or residual."""
    out = _attn_tp_partial(x, shift, scale, gain, w_qkv_l, w_out_l, heads_local, mp_gemm, cosine_attention)
    if x.device.type == "cuda":
        LAUNCHES["attn_tp_partial"] += 1
    return out


def attn_tp_partial_plain(x, shift, scale, gain, w_qkv_l, w_out_l, heads_local: int):
    """Plain version of :func:`attn_tp_partial`."""
    return _attn_tp_partial(
        x, shift, scale, gain, w_qkv_l, w_out_l, heads_local, mp_gemm_plain, cosine_attention_plain
    )


def _block_tp_attn(x, a, gains, w_mod, w_qkv_l, w_out_l, heads_local, gemm, attention):
    _check(x, w_qkv_l, w_out_l, 3, "block_tp_attn")
    n, t, d = x.shape
    if w_mod.shape != (6 * d, d) or a.shape != (n, d) or gains.shape != (2,):
        raise ValueError(f"w_mod must be (6D, D), a (N, D) and gains (2,), got {tuple(w_mod.shape)}, "
                         f"{tuple(a.shape)}, {tuple(gains.shape)}")
    mods = gemm(a.contiguous(), w_mod.contiguous(), alpha=1.0 / math.sqrt(d), out_dtype=torch.float32,
                site="modulation")
    gains = gains.detach().float().contiguous()
    partial = _attn_partial(
        x.contiguous(), mods, 0, d, gains[0:1], w_qkv_l.contiguous(), w_out_l.contiguous(), heads_local,
        gemm, attention,
    )
    return partial, mods.reshape(n, 6, d)


def block_tp_attn(x, a, gains, w_mod, w_qkv_l, w_out_l, heads_local: int):
    """Row 7: the modulation head (replicated) and row 6 on its first two
    chunks. a (N, D) = mp_silu(c); gains (2,) f32; w_mod (6D, D). Returns
    (partial f32 (N, T, D), mods f32 (N, 6, D))."""
    out = _block_tp_attn(x, a, gains, w_mod, w_qkv_l, w_out_l, heads_local, mp_gemm, cosine_attention)
    if x.device.type == "cuda":
        LAUNCHES["block_tp_attn"] += 1
    return out


def block_tp_attn_plain(x, a, gains, w_mod, w_qkv_l, w_out_l, heads_local: int):
    """Plain version of :func:`block_tp_attn`."""
    return _block_tp_attn(x, a, gains, w_mod, w_qkv_l, w_out_l, heads_local, mp_gemm_plain, cosine_attention_plain)


def _mlp_tp_partial(x, shift, scale, gains, w1_l, w2_l, inv_h, gemm):
    _check(x, w1_l, w2_l, 1, "mlp_tp_partial")
    n, t, d = x.shape
    rows = _rows(shift, scale, w1_l.dtype)
    gain = _gain(torch.as_tensor(gains)[1], x.device)
    h = gemm(
        x.contiguous().reshape(n * t, d), w1_l.contiguous(), alpha=1.0 / math.sqrt(d), out_dtype=w1_l.dtype,
        modulate=(rows, 0, d, gain), silu=True, tokens=t, site="fc1",
    )
    return gemm(h, w2_l.contiguous(), alpha=inv_h, out_dtype=torch.float32, site="fc2").reshape(n, t, d)


def mlp_tp_partial(x, shift, scale, gains, w1_l, w2_l, inv_h: float):
    """Row 8: one rank's partial of the MLP half-block. x (N, T, D) the
    post-attention stream; shift, scale (N, D); gains (2,) (gains[1] is
    used); w1_l (H_l, D); w2_l (D, H_l); inv_h = 1/sqrt(H) of the global
    hidden width. Returns f32 (N, T, D)."""
    out = _mlp_tp_partial(x, shift, scale, gains, w1_l, w2_l, inv_h, mp_gemm)
    if x.device.type == "cuda":
        LAUNCHES["mlp_tp_partial"] += 1
    return out


def mlp_tp_partial_plain(x, shift, scale, gains, w1_l, w2_l, inv_h: float):
    """Plain version of :func:`mlp_tp_partial`."""
    return _mlp_tp_partial(x, shift, scale, gains, w1_l, w2_l, inv_h, mp_gemm_plain)


# ---------------------------------------------------------------------------
# the islands


def _inference_only(what, *tensors):
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{what} is inference-only (no VJP, as in the JAX package); run it under torch.no_grad()"
        )


def gated_residual(x, gate, branch):
    """mp_sum(x, gate * branch, 0.3) in f32 on (N, T, D) x and (N, D) gate
    rows, the expression order of the JAX islands."""
    branch = gate[:, None, :].float() * branch
    return (x + (branch - x) * RES_T) / RES_DENOM


def fused_attn_branch_tp(x, shift, scale, gate, gain, w_qkv_l, w_out_l, *, heads_local: int, group=None):
    """The TP attention half-block (``fused_attn_branch_tp``): row 6 on this
    rank's heads, an all-reduce of the f32 partial over ``group`` (the
    mesh's model group), then the gated MP residual. Returns the new stream
    in x's type, the same on every rank of the group."""
    _inference_only("fused_attn_branch_tp", x, shift, scale, gate, torch.as_tensor(gain), w_qkv_l, w_out_l)
    partial = attn_tp_partial(x, shift, scale, gain, w_qkv_l, w_out_l, heads_local)
    dist.all_reduce(partial, group=group)
    return gated_residual(x.float(), gate, partial).to(x.dtype)


def fused_dit_block_tp(x, a, gains, w_mod, w_qkv_l, w_out_l, w1_l, w2_l, *, heads_local: int,
                       hidden_total: int, group=None):
    """The TP whole block (``fused_dit_block_tp``): row 7, all-reduce, the
    attention residual; row 8 on the bf16 stream, all-reduce, the MLP
    residual on the f32 stream. ``hidden_total`` is the global MLP width H
    (fc2's fan-in). Returns the new stream in x's type."""
    _inference_only("fused_dit_block_tp", x, a, gains, w_mod, w_qkv_l, w_out_l, w1_l, w2_l)
    partial, mods = block_tp_attn(x, a, gains, w_mod, w_qkv_l, w_out_l, heads_local)
    dist.all_reduce(partial, group=group)
    x1 = gated_residual(x.float(), mods[:, 2], partial)
    mlp = mlp_tp_partial(x1.to(x.dtype), mods[:, 3], mods[:, 4], gains, w1_l, w2_l, 1.0 / math.sqrt(hidden_total))
    dist.all_reduce(mlp, group=group)
    return gated_residual(x1, mods[:, 5], mlp).to(x.dtype)
