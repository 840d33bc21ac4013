"""The kernel VJPs' recompute (``ops/cuda/dit_block.py:vjp_through``) on bf16
inputs, against the JAX twins' ``jax.vjp`` on the same values (the Pallas
forwards in interpret mode on the CPU).

The JAX package recomputes the backward in the saved inputs' own types
(``mapdit_tpu/ops/pallas/mlp_block.py:133-135``, ``dit_block.py:1824-1826``,
``attention.py:211-213``); so does the port: its gradients are, bit for bit,
autograd through the plain reference run on the bf16 inputs, and not the
float32 recompute rounded back to bf16. That type check is what fails when
the recompute goes back to float32: the JAX comparisons below cannot tell
the two apart, since the float32 recompute lies as near JAX's bf16 VJP as
the bf16 one does (both packages round to bf16 after every operation but
decompose some of them differently: softmax, normalize, SiLU).

Against JAX's bf16 VJP, single elements land a bf16 ulp (2^-8 relative)
apart and carry it through the products: relative L2 within 2e-2 for every
cotangent array; both packages' bf16 VJPs also lie within 2e-2 of JAX's
float32 VJP, the rule ``chip_smoke.py`` holds the kernels' gradients to.
The gains' cotangents are sums over the whole batch that cancel; JAX sums
them in bf16 (0.19 and 0.62 relative L2 from its own float32 VJP), the
port in f32 over bf16 terms, so they are held to JAX's VJP of the same
function on float32 copies of the same bf16 values, within 1e-1 relative
L2 (the port reads 1.7e-2 and 4.4e-2). Run as a script, the module prints
every reading.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapdit_tpu.ops.pallas import attention as jat
from mapdit_tpu.ops.pallas import dit_block as jdb
from mapdit_tpu.ops.pallas import mlp_block as jmb
from mapdit_tpu_torch.ops.cuda import attention as tat
from mapdit_tpu_torch.ops.cuda import dit_block as tdb
from mapdit_tpu_torch.ops.cuda import mlp_block as tmb

N, T, D, HEADS, H = 4, 16, 64, 2, 256
TOL, GAIN_TOL = 2e-2, 1e-1


def _weight(rng, *shape):
    m = rng.normal(size=shape).astype(np.float32)
    return m * np.sqrt(shape[-1]) / (np.linalg.norm(m, axis=-1, keepdims=True) + 1e-4)


def _block(rng):
    args = [rng.normal(size=(N, T, D)), rng.normal(size=(N, D)), rng.uniform(0.1, 0.9, size=(2,)),
            _weight(rng, 6 * D, D), _weight(rng, 3 * D, D), _weight(rng, D, D), _weight(rng, H, D),
            _weight(rng, D, H)]
    return (args, (N, T, D), (2,), lambda *a: jdb.fused_dit_block(*a, HEADS),
            lambda *a: tdb.fused_dit_block(*a, HEADS), lambda *a: tdb.block_reference(*a, HEADS))


def _mlp(rng):
    args = [rng.normal(size=(N, T, D)), *(rng.normal(size=(N, D)) for _ in range(3)), np.array(0.37),
            _weight(rng, H, D), _weight(rng, D, H)]
    return args, (N, T, D), (4,), jmb.fused_mlp_branch, tmb.fused_mlp_branch, tmb.mlp_reference


def _attention(rng):
    shape, scale = (2, HEADS, T, 32), 1 / np.sqrt(32)
    args = [rng.normal(size=shape) for _ in range(3)]
    return (args, shape, (), lambda q, k, v: jat.fused_attention(q, k, v, scale, True),
            lambda q, k, v: tat.fused_attention(q, k, v, scale, True),
            lambda q, k, v: tat.attention_reference(q, k, v, scale, True))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _gradients(case):
    """(port's bf16 gradients, autograd of the reference on the bf16 inputs,
    the float32 recompute rounded to bf16, JAX's bf16 VJP, JAX's VJP on
    float32 copies of the same bf16 values, the gain slots)."""
    args, out_shape, gain_slots, jax_fn, port_fn, reference = case(np.random.default_rng(11))
    args = [np.asarray(a, np.float32) for a in args]
    cot = np.random.default_rng(12).normal(size=out_shape).astype(np.float32)

    def jax_vjp(dtype):
        _, pullback = jax.vjp(jax_fn, *[jnp.asarray(a, jnp.bfloat16).astype(dtype) for a in args])
        return [np.asarray(g.astype(jnp.float32)) for g in pullback(jnp.asarray(cot, jnp.bfloat16).astype(dtype))]

    inputs = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in args]
    cot_t = torch.from_numpy(cot).to(torch.bfloat16)
    got = torch.autograd.grad(port_fn(*inputs), inputs, cot_t)
    in_bf16 = [a.detach().requires_grad_() for a in inputs]
    same = torch.autograd.grad(reference(*in_bf16), in_bf16, cot_t)
    in_f32 = [a.detach().float().requires_grad_() for a in inputs]
    f32 = [g.to(torch.bfloat16) for g in torch.autograd.grad(reference(*in_f32), in_f32, cot_t.float())]
    return got, same, f32, jax_vjp(jnp.bfloat16), jax_vjp(jnp.float32), gain_slots


CASES = {"fused_dit_block": _block, "fused_mlp_branch": _mlp, "fused_attention": _attention}


@pytest.mark.parametrize("case", list(CASES.values()), ids=list(CASES))
def test_bf16_vjp_recomputes_in_bf16_and_matches_jax(case):
    got, same, f32, want, want_f32, gain_slots = _gradients(case)

    # the recompute in the inputs' type: autograd through the reference on
    # the bf16 inputs gives the same bits; the float32 recompute does not
    for i, (g, s) in enumerate(zip(got, same)):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g, s, rtol=0, atol=0, msg=f"cotangent {i} is not the bf16 recompute")
    assert any(not torch.equal(g, f) for g, f in zip(got, f32)), "the gradients are the float32 recompute's"

    for i, (g, w, w32) in enumerate(zip(got, want, want_f32)):
        if i in gain_slots:
            err = _rel(g.float().numpy(), w32)
            assert err <= GAIN_TOL, f"gain cotangent {i}: rel L2 {err:.3e} from JAX's f32 VJP > {GAIN_TOL}"
        else:
            err = _rel(g.float().numpy(), w)
            assert err <= TOL, f"cotangent {i}: rel L2 {err:.3e} from JAX's bf16 VJP > {TOL}"
            # chip_smoke.py's GRAD_TOL rule, held by both packages' bf16 VJPs
            # against JAX's float32 one
            for who, v in (("the port's", g.float().numpy()), ("JAX's", w)):
                err = _rel(v, w32)
                assert err <= TOL, f"cotangent {i}: {who} bf16 VJP {err:.3e} from JAX's f32 VJP > {TOL}"


if __name__ == "__main__":
    # the readings behind the tolerances: relative L2 of each cotangent
    # (JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_vjp.py)
    for name, case in CASES.items():
        got, _, f32, want, want_f32, gain_slots = _gradients(case)
        for i, (g, f, w, w32) in enumerate(zip(got, f32, want, want_f32)):
            g, f = g.float().numpy(), f.float().numpy()
            print(f"{name} cotangent {i}{' (gain)' if i in gain_slots else ''}: port-JAX_bf16 {_rel(g, w):.3e} "
                  f"f32_recompute-JAX_bf16 {_rel(f, w):.3e} port-JAX_f32 {_rel(g, w32):.3e} "
                  f"JAX_bf16-JAX_f32 {_rel(w, w32):.3e}")
