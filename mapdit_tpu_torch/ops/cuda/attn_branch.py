"""Attention half-block on Hopper: forward, residual forward, fused backward.

Port of the attention half of ``mapdit_tpu/ops/pallas/dit_block.py``:
``fused_attn_branch`` and its three Pallas kernels,

  row 3  ``_attn_fwd_impl`` (forward)            -> :func:`attn_fwd`
  row 5  ``_attn_res_fwd_impl`` (+ p, attn)      -> :func:`attn_res_fwd`
  row 4  ``_attn_bwd_impl`` / ``_attn_bwd_math`` -> :func:`attn_bwd`

with the plain-op backward over the residuals (``_attn_bwd_from_res``) and
the reference VJP. The half-block is

  y = mp_sum(x, gate * out_proj(cosine_attention(qkv(modulate(x)))), 0.3)

with shift, scale and gate packed once into one (N, 3D) f32 row buffer (the
model hands them in as bf16, so the upcast is exact) and the gain read from
device memory. The forwards are three launches: ``mp_gemm`` with the
modulate prologue, ``cosine_attention`` (the residual mode for row 5), and
``mp_gemm`` with the gated-residual epilogue. The fused backward recomputes
the forward and runs the hand VJP in this order (``csrc/attn_branch_bwd.cu``
for the stages between the products):

  h = modulate_fwd(x)                      bf16, also the dW_qkv operand
  qkv = h . Wqkv^T / sqrt(D)               mp_gemm
  attn = cosine_attention(qkv), residual   bf16, also the dW_out operand
  out = attn . Wout^T / sqrt(D)            mp_gemm, f32
  dx0, dout, dgate = gate_residual_bwd(dy, out)          (a)
  dattn = dout . Wout / sqrt(D)            mp_gemm reading W as (K, N)
  dqkv = attention_bwd(qkv, dattn)                       (b)
  dh = dqkv . Wqkv / sqrt(D)               mp_gemm reading W as (K, N)
  dx, dshift, dscale, dgain = modulate_bwd(dh, x, dx0)   (c)
  dWqkv = dqkv^T h / sqrt(D), dWout = dout^T attn / sqrt(D)   torch.matmul, f32

The two dW products are plain matmuls, as the Pallas package leaves them to
XLA outside its kernel. Gradient semantics are the reference's: the modulate
denominator is constant in the gain, ``normalize`` gets the full quotient
VJP. Three roundings are kept apart, as in the Pallas kernels: row 3 divides
after P.V on the unnormalised exponentials; row 5 and the backward's
attention normalise p first and round it to bf16; (b) recomputes the exact
softmax of the pre-normalised bf16 q/k; h, dqkv, attn and dout leave as bf16.

Every wrapper takes its kernel for a CUDA tensor (raising on what it does not
take) and its plain PyTorch version for a CPU tensor. ``LAUNCHES`` counts
launches; :func:`reset_launch_counts` zeroes them.
"""

from __future__ import annotations

import math

import torch

from mapdit_tpu_torch.ops.cuda.dit_block import (
    RES_DENOM,
    RES_T,
    NORM_EPS,
    MAX_SMEM_BYTES,
    _DTYPE_CODE,
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
from mapdit_tpu_torch.ops.mp import mp_sum

LAUNCHES = {
    "attn_bwd/gate_residual": 0,
    "attn_bwd/attention": 0,
    "attn_bwd/modulate_fwd": 0,
    "attn_bwd/modulate_bwd": 0,
    "attn_branch/fwd": 0,
    "attn_branch/res_fwd": 0,
    "attn_branch/bwd": 0,
}
BWD_IMPLS = ("pallas", "residual", "reference")
DX_FAC = (1.0 - RES_T) / RES_DENOM
DB_FAC = RES_T / RES_DENOM
_LIB = "attn_branch_bwd"


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
# (a) gated MP residual backward


def gate_residual_bwd_plain(dy, out, rows, gate_off, tokens, out_dtype):
    """Plain version of :func:`gate_residual_bwd`."""
    m, d = out.shape
    dyf = dy.reshape(m, d).float()
    db = dyf * DB_FAC
    dgate = (db * out).reshape(m // tokens, tokens, d).sum(dim=1)
    dout = (db * _rows(rows[:, gate_off : gate_off + d], tokens)).to(out_dtype)
    return dyf * DX_FAC, dout, dgate


def gate_residual_bwd(dy, out, rows, gate_off, tokens, out_dtype):
    """Backward of y = (x + (gate*out - x)*0.3)/sqrt(0.58) over flat
    (N*T, D) rows: dy (x's type), out f32, rows (N, *) f32 holding gate at
    ``gate_off``. Returns dx0 = dy*0.7/rd (f32), dout = dy*0.3/rd*gate
    (``out_dtype``) and the per-sample dgate rows (N, D) f32."""
    if out.device.type == "cpu":
        return gate_residual_bwd_plain(dy, out, rows, gate_off, tokens, out_dtype)
    m, d = out.shape
    n = m // tokens
    if out.dtype != torch.float32 or dy.numel() != m * d or dy.dtype not in _DTYPE_CODE:
        raise ValueError("gate_residual_bwd takes f32 out and f32/bf16 dy of the same size")
    if out_dtype != torch.bfloat16:
        raise ValueError("gate_residual_bwd writes bf16 dout")
    if gate_off + d > rows.shape[1]:
        raise ValueError("gate offset runs past the rows")
    _check_rows(rows, n)
    dx0 = torch.empty(m, d, dtype=torch.float32, device=out.device)
    dout = torch.empty(m, d, dtype=torch.bfloat16, device=out.device)
    dgate = torch.empty(n, d, dtype=torch.float32, device=out.device)
    _require_cuda(dy, out, rows, dx0, dout, dgate)
    lib = _lib()
    code = lib.gate_residual_bwd(
        dy.data_ptr(), _DTYPE_CODE[dy.dtype], out.data_ptr(), rows.data_ptr(), rows.shape[1], gate_off,
        dx0.data_ptr(), dout.data_ptr(), dgate.data_ptr(), n, tokens, d, _stream(out),
    )
    _raise_on(code, lib, "gate_residual_bwd", _LIB)
    LAUNCHES["attn_bwd/gate_residual"] += 1
    return dx0, dout, dgate


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


def attention_bwd(qkv, dattn, tokens, heads, out_dtype):
    """Attention backward over the flat f32 qkv product (N*T, 3D) and the
    f32 cotangent of the pre-projection attention (N*T, D); returns dqkv
    (N*T, 3D) in ``out_dtype`` (bf16 on the card), heads as column slices."""
    if qkv.device.type == "cpu":
        return attention_bwd_plain(qkv, dattn, tokens, heads, out_dtype)
    nt, d3 = qkv.shape
    d = d3 // 3
    if qkv.dtype != torch.float32 or d3 != 3 * d or d % heads or nt % tokens:
        raise ValueError(f"attention_bwd takes f32 (N*T, 3D) qkv, got {qkv.dtype} {tuple(qkv.shape)}")
    if dattn.dtype != torch.float32 or dattn.shape != (nt, d) or out_dtype != torch.bfloat16:
        raise ValueError("attention_bwd takes f32 (N*T, D) dattn and writes bf16 dqkv")
    hd = d // heads
    _require_cuda(qkv, dattn)
    lib = _lib()
    smem = lib.attention_bwd_smem_bytes(tokens, hd)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"T={tokens}, hd={hd} needs {smem} bytes of shared memory; the kernel holds at most {MAX_SMEM_BYTES}"
        )
    dqkv = torch.empty(nt, d3, dtype=torch.bfloat16, device=qkv.device)
    _require_cuda(qkv, dattn, dqkv)
    code = lib.attention_bwd(qkv.data_ptr(), dattn.data_ptr(), dqkv.data_ptr(), nt // tokens, tokens, heads, hd,
                             _stream(qkv))
    _raise_on(code, lib, "attention_bwd", _LIB)
    LAUNCHES["attn_bwd/attention"] += 1
    return dqkv


# ---------------------------------------------------------------------------
# (c) modulate forward and backward


def _modulate_rows(rows, d, tokens):
    return _rows(rows[:, :d], tokens), _rows(rows[:, d : 2 * d], tokens)


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
    returns h in ``out_dtype`` (bf16 on the card)."""
    if x.device.type == "cpu":
        return modulate_fwd_plain(x, rows, gain, tokens, out_dtype)
    m, d = x.shape
    if x.dtype not in _DTYPE_CODE or out_dtype != torch.bfloat16:
        raise ValueError("modulate_fwd takes f32/bf16 x and writes bf16 h")
    _check_rows(rows, m // tokens)
    if rows.shape[1] < 2 * d:
        raise ValueError("rows must hold shift and scale")
    gain = _gain_value(gain)
    h = torch.empty(m, d, dtype=torch.bfloat16, device=x.device)
    _require_cuda(x, rows, gain, h)
    lib = _lib()
    code = lib.modulate_fwd(x.data_ptr(), _DTYPE_CODE[x.dtype], rows.data_ptr(), rows.shape[1], 0, d,
                            gain.data_ptr(), h.data_ptr(), m // tokens, tokens, d, _stream(x))
    _raise_on(code, lib, "modulate_fwd", _LIB)
    LAUNCHES["attn_bwd/modulate_fwd"] += 1
    return h


def modulate_bwd_plain(dh, x, rows, gain, dx0, tokens):
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
    dx = (dx0 + du * scale).to(x.dtype)
    dscale = (du * xf).reshape(n, tokens, d).sum(dim=1)
    return dx, dshift, dscale, dgain


def modulate_bwd(dh, x, rows, gain, dx0, tokens):
    """Backward of :func:`modulate_fwd` with the denominator constant in the
    gain, plus the residual's direct path: dh f32 (N*T, D), x as given to
    the forward, dx0 f32. Returns dx = dx0 + du*scale (x's type), the dshift
    and dscale rows (N, D) f32 and dgain (1,) f32, summed over the batch in a
    fixed order."""
    if x.device.type == "cpu":
        return modulate_bwd_plain(dh, x, rows, gain, dx0, tokens)
    m, d = x.shape
    n = m // tokens
    if dh.dtype != torch.float32 or dx0.dtype != torch.float32 or dh.shape != (m, d) or dx0.shape != (m, d):
        raise ValueError("modulate_bwd takes f32 (N*T, D) dh and dx0")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError("modulate_bwd takes f32/bf16 x")
    _check_rows(rows, n)
    gain = _gain_value(gain)
    _require_cuda(dh, x, rows, gain, dx0)
    lib = _lib()
    dev = x.device
    dx = torch.empty_like(x)
    dshift = torch.empty(n, d, dtype=torch.float32, device=dev)
    dscale = torch.empty(n, d, dtype=torch.float32, device=dev)
    partial = torch.empty(lib.modulate_bwd_partials(n, d), dtype=torch.float32, device=dev)
    dgain = torch.empty(1, dtype=torch.float32, device=dev)
    _require_cuda(dh, x, rows, gain, dx0, dx, dshift, dscale, partial, dgain)
    code = lib.modulate_bwd(
        dh.data_ptr(), x.data_ptr(), _DTYPE_CODE[x.dtype], rows.data_ptr(), rows.shape[1], 0, d, gain.data_ptr(),
        dx0.data_ptr(), dx.data_ptr(), dshift.data_ptr(), dscale.data_ptr(), partial.data_ptr(), dgain.data_ptr(),
        n, tokens, d, _stream(x),
    )
    _raise_on(code, lib, "modulate_bwd", _LIB)
    LAUNCHES["attn_bwd/modulate_bwd"] += 1
    return dx, dshift, dscale, dgain


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
    if x.device.type == "cuda" and (
        x.dtype != torch.bfloat16 or w_qkv.dtype != torch.bfloat16 or w_out.dtype != torch.bfloat16
    ):
        raise ValueError(
            "the CUDA attention half-block kernels run bf16 only: x and the weights must be bf16 "
            "(a float32 model runs block_kernel='off')"
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


def attn_fwd(x, shift, scale, gate, gain, w_qkv, w_out, heads: int):
    """Row 3: the attention half-block forward. x (N,T,D); shift, scale,
    gate (N,D); gain one f32 value; w_qkv (3D,D), w_out (D,D) folded.
    Returns the new stream in x's type."""
    y = _fwd(x, shift, scale, gate, gain, w_qkv, w_out, heads, False, mp_gemm, cosine_attention)
    if x.device.type == "cuda":
        LAUNCHES["attn_branch/fwd"] += 1
    return y


def attn_fwd_plain(x, shift, scale, gate, gain, w_qkv, w_out, heads: int):
    """Plain version of :func:`attn_fwd`."""
    return _fwd(x, shift, scale, gate, gain, w_qkv, w_out, heads, False, mp_gemm_plain, cosine_attention_plain)


def attn_res_fwd(x, shift, scale, gate, gain, w_qkv, w_out, heads: int):
    """Row 5: :func:`attn_fwd` that also returns the residuals of the plain
    backward, the probabilities p (N, heads, T, T) f32 (normalised before
    P.V) and the pre-projection attention (N, T, D) in the weights' type."""
    out = _fwd(x, shift, scale, gate, gain, w_qkv, w_out, heads, True, mp_gemm, cosine_attention)
    if x.device.type == "cuda":
        LAUNCHES["attn_branch/res_fwd"] += 1
    return out


def attn_res_fwd_plain(x, shift, scale, gate, gain, w_qkv, w_out, heads: int):
    """Plain version of :func:`attn_res_fwd`."""
    return _fwd(x, shift, scale, gate, gain, w_qkv, w_out, heads, True, mp_gemm_plain, cosine_attention_plain)


def _bwd_sequence(dy, x, rows, gain, w_qkv, w_out, heads, gemm, attention, gate_bwd, attn_bwd_k, mod_fwd, mod_bwd):
    n, t, d = x.shape
    inv_d = 1.0 / math.sqrt(d)
    dt = w_qkv.dtype
    f32 = torch.float32
    xf = x.reshape(n * t, d)
    h = mod_fwd(xf, rows, gain, t, dt)
    qkv = gemm(h, w_qkv, alpha=inv_d, out_dtype=f32, site="qkv")
    attn = attention(qkv, t, heads, dt, normalize_first=True)
    out = gemm(attn, w_out, alpha=inv_d, out_dtype=f32, site="out")
    dx0, dout, dgate = gate_bwd(dy.reshape(n * t, d), out, rows, 2 * d, t, dt)
    dattn = gemm(dout, w_out, alpha=inv_d, out_dtype=f32, w_kn=True, site="dattn")
    dqkv = attn_bwd_k(qkv, dattn, t, heads, dt)
    dh = gemm(dqkv, w_qkv, alpha=inv_d, out_dtype=f32, w_kn=True, site="dh")
    dx, dshift, dscale, dgain = mod_bwd(dh, xf, rows, gain, dx0, t)
    dw_qkv = (dqkv.t().float() @ h.float()) * inv_d
    dw_out = (dout.t().float() @ attn.float()) * inv_d
    return dx.reshape(n, t, d), dshift, dscale, dgate, dgain, dw_qkv, dw_out


def _bwd(dy, x, shift, scale, gate, gain, w_qkv, w_out, heads, kernels):
    _check(x, shift, scale, gate, gain, w_qkv, w_out, heads)
    rows, g = _pack(shift, scale, gate, gain)
    return _bwd_sequence(dy.contiguous(), x.contiguous(), rows, g, w_qkv.contiguous(), w_out.contiguous(), heads,
                         *kernels)


_KERNELS = (mp_gemm, cosine_attention, gate_residual_bwd, attention_bwd, modulate_fwd, modulate_bwd)
_PLAIN = (mp_gemm_plain, cosine_attention_plain, gate_residual_bwd_plain, attention_bwd_plain, modulate_fwd_plain,
          modulate_bwd_plain)


def attn_bwd(dy, x, shift, scale, gate, gain, w_qkv, w_out, heads: int):
    """Row 4: the fused backward. Returns the f32 cotangents (dx in x's
    type) of x, shift, scale, gate, gain (shape (1,)), w_qkv and w_out."""
    grads = _bwd(dy, x, shift, scale, gate, gain, w_qkv, w_out, heads, _KERNELS)
    if x.device.type == "cuda":
        LAUNCHES["attn_branch/bwd"] += 1
    return grads


def attn_bwd_plain(dy, x, shift, scale, gate, gain, w_qkv, w_out, heads: int):
    """Plain version of :func:`attn_bwd`."""
    return _bwd(dy, x, shift, scale, gate, gain, w_qkv, w_out, heads, _PLAIN)


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
    dx0, dout, dgate = gate_residual_bwd_plain(dy, out, rows, 2 * d, t, f32)
    dattn = mp_gemm_plain(dout, w_out, alpha=inv_d, out_dtype=f32, w_kn=True)
    dqkv = _attention_vjp(qkv, dattn, t, heads, w_qkv.dtype, p=p)
    dh = mp_gemm_plain(dqkv, w_qkv, alpha=inv_d, out_dtype=f32, w_kn=True)
    dx, dshift, dscale, dgain = modulate_bwd_plain(dh, xf, rows, g, dx0, t)
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
