"""Save the outputs of the kernels that run at 32 x 32 latents (T = 256), at
the shapes of their earlier domains (T <= 64, T dividing 128 for
out_gate_residual_bwd), at fixed seeds, or hold them bit
for bit to a file saved that way, so that two checkouts can be compared on
one card:

    PYTHONPATH=<other checkout> python mapdit_tpu_torch/tools/stack_bits.py --save other.pt
    python -m mapdit_tpu_torch.tools.stack_bits --compare other.pt

The cases: ``dit_stack`` (rows 1 and 2: ``fused_dit_block`` and
``fused_dit_stack``) at chip_smoke.py's phase 3 stack shapes of T <= 64;
rows 3, 5 and 4's one-launch kernels (``attn_branch.attn_fwd``,
``attn_res_fwd``, ``attn_bwd``, csrc/attn_branch.cu) at the S/2 training
shape and chip_smoke.py's BRANCH_BWD_SHAPES; ``attention_bwd`` at T = 64
and 4, ``out_gate_residual_bwd`` at T = 64, 16, 4 and 128 (split K among
them) and ``modulate_fwd`` and ``modulate_bwd`` at the S/2 training shape;
the bf16 ``mp_gemm`` instances at the five S/2 products with their
epilogues, a split-K product, the MN-major W of the dattn and dh products
and a ragged shape, and the bf16 ``cosine_attention`` in both modes at S/2
and at T = 256 (the kernels whose sources gained f32 forms beside them).
Each draws from a seed of its own.
``--compare`` prints one line an output and exits 1 unless every output has
the saved bits (``torch.equal``).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

# name -> (model, N, depth, T)
STACK = {"S2": ("DiT-S/2", 64, 12, 64), "B2": ("DiT-B/2", 64, 12, 64), "XL2": ("DiT-XL/2", 8, 28, 64),
         "B4:T16": ("DiT-B/4", 32, 2, 16), "XL8:T4": ("DiT-XL/8", 16, 2, 4), "S2:N3": ("DiT-S/2", 3, 2, 64)}
# name -> (N, T, D, heads)
BRANCH = {"s2": (256, 64, 384, 6), "b2": (8, 64, 768, 12), "xl": (4, 64, 1152, 16), "n3": (3, 64, 384, 6),
          "t16": (8, 16, 768, 12), "t4": (8, 4, 1152, 16), "t2": (5, 2, 384, 6)}
# name -> (N, T, heads, hd)
ATTN_BWD = {"t64": (256, 64, 6, 64), "t64-head-72": (32, 64, 16, 72), "t4-head-72": (8, 4, 16, 72)}
# mp_gemm: name -> (M, N, K, A type, modulate prologue, epilogue, W read as
# (K, N), tokens a sample); C is f32 where the epilogue is none, else bf16
GEMM = {"modulation": (64, 2304, 384, "bf16", False, None, False, 1),
        "qkv": (4096, 1152, 384, "bf16", True, None, False, 64),
        "out": (4096, 384, 384, "bf16", False, "residual-bf16", False, 64),
        "fc1": (4096, 1536, 384, "f32", True, "silu", False, 64),
        "fc2": (4096, 384, 1536, "bf16", False, "residual-f32", False, 64),
        "xl-split": (8, 6912, 1152, "bf16", False, None, False, 1),
        "dattn-w_kn": (16384, 384, 384, "bf16", False, None, True, 64),
        "dh-w_kn": (16384, 384, 1152, "bf16", False, None, True, 64),
        "ragged": (200, 328, 392, "f32", True, "residual-f32", False, 8)}
# cosine_attention: name -> (N, T, heads, hd, residual mode)
COSINE = {"s2": (64, 64, 6, 64, False), "s2-residual": (64, 64, 6, 64, True), "t256": (16, 256, 6, 64, False),
          "t256-residual": (4, 256, 6, 64, True), "xl": (8, 64, 16, 72, False)}
# name -> (N, T, D)
OUT_GATE = {"t64": (256, 64, 384), "t16": (256, 16, 768), "t4": (8, 4, 1152), "t128": (64, 128, 384),
            "t64-n3": (3, 64, 384), "t64-n257": (257, 64, 384)}
# the modulate passes: (N, T, D), the S/2 training shape
MODULATE = (256, 64, 384)


def _normal(gen, dev, *shape):
    return torch.randn(*shape, generator=gen, device=dev)


def stack_outputs(dev, out: dict) -> None:
    from mapdit_tpu_torch.models.registry import DIT_MODELS
    from mapdit_tpu_torch.ops.cuda import dit_block as k
    from mapdit_tpu_torch.ops.mp import mp_silu, normalize

    bf = torch.bfloat16
    for i, (name, (model, n, depth, t)) in enumerate(STACK.items()):
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        d, heads = DIT_MODELS[model]["hidden_size"], DIT_MODELS[model]["num_heads"]
        x = _normal(gen, dev, n, t, d).to(bf)
        a = mp_silu(_normal(gen, dev, n, d)).to(bf)
        gains = torch.rand(depth, 2, generator=gen, device=dev) * 0.6 + 0.2
        ws = [normalize(_normal(gen, dev, depth, r, c)).to(bf).contiguous()
              for r, c in ((6 * d, d), (3 * d, d), (d, d), (4 * d, d), (d, 4 * d))]
        out[f"fused_dit_stack:{name}"] = k.fused_dit_stack(x, a, gains, *ws, heads).cpu()
        out[f"fused_dit_block:{name}"] = k.fused_dit_block(x, a, gains[0], *(w[0] for w in ws), heads).cpu()
        del ws


def branch_outputs(dev, out: dict) -> None:
    from mapdit_tpu_torch.ops.cuda import attn_branch as ab
    from mapdit_tpu_torch.ops.mp import normalize

    bf = torch.bfloat16
    for i, (name, (n, t, d, heads)) in enumerate(BRANCH.items()):
        gen = torch.Generator(device=dev).manual_seed(200 + i)
        x = _normal(gen, dev, n, t, d).to(bf)
        shift, scale, gate = (_normal(gen, dev, n, d).to(bf) for _ in range(3))
        gain = torch.tensor(0.37, device=dev)
        wq, wo = (normalize(_normal(gen, dev, *s)).to(bf).contiguous() for s in ((3 * d, d), (d, d)))
        dy = _normal(gen, dev, n, t, d).to(bf)
        if ab.branch_route(x, wq, wo, heads, dy) != "kernel":
            raise AssertionError(f"attn_bwd:{name}: not the one-launch kernel's route")
        args = (x, shift, scale, gate, gain, wq, wo, heads)
        for j, z in enumerate(ab.attn_bwd(dy, *args)):
            out[f"attn_branch/bwd:{name}:{j}"] = z.cpu()
        out[f"attn_branch/fwd:{name}"] = ab.attn_fwd(*args).cpu()
        for j, z in enumerate(ab.attn_res_fwd(*args)):
            out[f"attn_branch/res_fwd:{name}:{j}"] = z.cpu()


def pass_outputs(dev, out: dict) -> None:
    from mapdit_tpu_torch.ops.cuda import attn_branch as ab
    from mapdit_tpu_torch.ops.mp import normalize

    bf = torch.bfloat16
    for i, (name, (n, t, heads, hd)) in enumerate(ATTN_BWD.items()):
        gen = torch.Generator(device=dev).manual_seed(300 + i)
        d = heads * hd
        qkv, dattn = _normal(gen, dev, n * t, 3 * d), _normal(gen, dev, n * t, d)
        out[f"attention_bwd:{name}"] = ab.attention_bwd(qkv, dattn, t, heads, bf).cpu()
    for i, (name, (n, t, d)) in enumerate(OUT_GATE.items()):
        gen = torch.Generator(device=dev).manual_seed(400 + i)
        attn, dy = (_normal(gen, dev, n * t, d).to(bf) for _ in range(2))
        w = normalize(_normal(gen, dev, d, d)).to(bf).contiguous()
        rows = _normal(gen, dev, n, 3 * d)
        for j, z in enumerate(ab.out_gate_residual_bwd(attn, w, dy, rows, 2 * d, t)):
            out[f"out_gate_residual_bwd:{name}:{j}"] = z.cpu()
    gen = torch.Generator(device=dev).manual_seed(450)
    n, t, d = MODULATE
    x, dy = (_normal(gen, dev, n * t, d).to(bf) for _ in range(2))
    rows, dh = _normal(gen, dev, n, 3 * d), _normal(gen, dev, n * t, d)
    gain = torch.tensor([0.37], device=dev)
    out["modulate_fwd"] = ab.modulate_fwd(x, rows, gain, t, bf).cpu()
    for j, z in enumerate(ab.modulate_bwd(dh, x, rows, gain, dy, t)):
        out[f"modulate_bwd:{j}"] = z.cpu()


def forward_outputs(dev, out: dict) -> None:
    from mapdit_tpu_torch.ops.cuda import dit_block as k
    from mapdit_tpu_torch.ops.mp import normalize

    types = {"bf16": torch.bfloat16, "f32": torch.float32}
    for i, (name, (m, n, kk, a_dt, modulated, epilogue, w_kn, tokens)) in enumerate(GEMM.items()):
        gen = torch.Generator(device=dev).manual_seed(500 + i)
        a = _normal(gen, dev, m, kk).to(types[a_dt])
        w = normalize(_normal(gen, dev, n, kk)).to(torch.bfloat16)
        w = w.t().contiguous() if w_kn else w
        mods = _normal(gen, dev, m // tokens, 2 * kk + n)
        kw = dict(alpha=1 / kk**0.5, out_dtype=torch.float32 if epilogue is None else torch.bfloat16, tokens=tokens,
                  w_kn=w_kn)
        if modulated:
            kw["modulate"] = (mods, 0, kk, torch.tensor([0.37], device=dev))
        if epilogue == "silu":
            kw["silu"] = True
        elif epilogue is not None:
            kw["residual"] = (_normal(gen, dev, m, n).to(types[epilogue.split("-")[1]]), mods, 2 * kk)
        out[f"mp_gemm:{name}"] = k.mp_gemm(a, w, **kw).cpu()
    for i, (name, (n, t, heads, hd, residual)) in enumerate(COSINE.items()):
        gen = torch.Generator(device=dev).manual_seed(600 + i)
        qkv = _normal(gen, dev, n * t, 3 * heads * hd)
        probs = torch.empty(n, heads, t, t, device=dev) if residual else None
        out[f"cosine_attention:{name}"] = k.cosine_attention(qkv, t, heads, torch.bfloat16, normalize_first=residual,
                                                             probs=probs).cpu()
        if residual:
            out[f"cosine_attention:{name}:p"] = probs.cpu()


def outputs(dev) -> dict:
    out = {}
    stack_outputs(dev, out)
    branch_outputs(dev, out)
    pass_outputs(dev, out)
    forward_outputs(dev, out)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    what = p.add_mutually_exclusive_group(required=True)
    what.add_argument("--save", help="write the outputs here")
    what.add_argument("--compare", help="hold the outputs to this file's")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("stack_bits: no CUDA device", file=sys.stderr)
        return 2
    import mapdit_tpu_torch

    print(f"[stack-bits] package={os.path.dirname(mapdit_tpu_torch.__file__)}", flush=True)
    got = outputs(torch.device("cuda", torch.cuda.current_device()))
    if args.save:
        os.makedirs(os.path.dirname(os.path.abspath(args.save)), exist_ok=True)
        torch.save(got, args.save)
        print(f"[stack-bits] saved {len(got)} outputs to {args.save}", flush=True)
        return 0
    want = torch.load(args.compare)
    same = {key: key in want and torch.equal(z, want[key]) for key, z in got.items()}
    for key, ok in same.items():
        print(f"[stack-bits] {key} same_bits={ok}", flush=True)
    ok = all(same.values()) and set(want) == set(got)
    print(f"[stack-bits] outputs={len(got)} saved={len(want)} same_bits={sum(same.values())} ok={ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
