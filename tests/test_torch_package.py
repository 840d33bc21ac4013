"""Package rules of the port: it stands alone (no JAX, no mapdit_tpu), its
entry points default to CUDA, and its kernel wrappers never launch on CPU
tensors."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import mapdit_tpu_torch
from mapdit_tpu_torch.diffusion import create_diffusion
from mapdit_tpu_torch.models import build_config, init_model
from mapdit_tpu_torch.ops.cuda import attn_branch, dit_block
from mapdit_tpu_torch.runtime import build_sample_fn

PKG = pathlib.Path(mapdit_tpu_torch.__file__).parent
REPO = PKG.parent
XS2 = dict(in_channels=4, input_size=16, num_classes=10)


def _modules():
    return sorted(
        "mapdit_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )


def test_import_loads_no_jax():
    """Every module of the port (the training modules, the attention
    half-block and the new diffusion math among them) imports in a fresh
    interpreter without bringing in jax, flax or mapdit_tpu (this test
    process has them loaded, hence the subprocess)."""
    for mod in ("training.state", "training.data", "training.ema", "training.lr", "diffusion.dmath",
                "ops.cuda.attn_branch"):
        assert f"mapdit_tpu_torch.{mod}" in _modules()
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'mapdit_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.startswith("ok"), proc.stderr


def test_sources_import_nothing_of_jax():
    for path in list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "flax", "mapdit_tpu"), f"{path}: imports {name}"


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = build_config("DiT-XS/8", **XS2)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_diffusion("4")
    model = init_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_sample_fn(cfg, model.state_dict(), create_diffusion("4", device="cpu"))
    from mapdit_tpu_torch.training import create_optimizer, create_train_state, warmup_flat_invsqrt

    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(cfg, create_optimizer(warmup_flat_invsqrt(1e-2, 5, 50)))


def test_kernel_counts_stay_zero_on_cpu():
    dit_block.reset_launch_counts()
    attn_branch.reset_launch_counts()
    cfg = build_config("DiT-XS/2", **XS2)
    model = init_model(cfg, device="cpu")
    for kernel in ("mega", "mega_stack"):
        sample = build_sample_fn(
            cfg.replace(block_kernel=kernel), model.state_dict(), create_diffusion("2", device="cpu"),
            cfg_scale=1.5, clip_denoised=True, device="cpu",
        )
        out = sample(torch.zeros(4, 4, 16, 16), torch.tensor([1, 2, 10, 10]), torch.Generator().manual_seed(0))
        assert np.isfinite(out.numpy()).all()
    for bwd in attn_branch.BWD_IMPLS:
        model = init_model(cfg.replace(block_kernel="mega_attn", attn_bwd=bwd), device="cpu")
        out = model(torch.zeros(2, 4, 16, 16), torch.tensor([3.0, 7.0]), torch.tensor([1, 2]))
        out.square().sum().backward()
        assert np.isfinite(out.detach().numpy()).all()
    assert all(v == 0 for v in dit_block.LAUNCHES.values()), dit_block.LAUNCHES
    assert all(v == 0 for v in attn_branch.LAUNCHES.values()), attn_branch.LAUNCHES


def test_kernel_wrappers_do_not_fall_back_off_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises; on a
    device that is not CUDA it raises before anything is built."""
    a = torch.empty(8, 16, device="meta")
    w = torch.empty(4, 16, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        dit_block.mp_gemm(a, w, alpha=1.0, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        dit_block.cosine_attention(torch.empty(8, 48, device="meta"), 4, 2, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        dit_block.mp_gemm(a, torch.empty(16, 4, dtype=torch.bfloat16, device="meta"), alpha=1.0,
                          out_dtype=torch.float32, w_kn=True)
    with pytest.raises(ValueError, match="CUDA"):
        dit_block.cosine_attention(torch.empty(8, 48, device="meta"), 4, 2, torch.bfloat16, normalize_first=True,
                                   probs=torch.empty(2, 2, 4, 4, device="meta"))
    bf = torch.bfloat16
    n, t, d, heads = 2, 4, 16, 2
    x = torch.empty(n * t, d, dtype=bf, device="meta")
    rows = torch.empty(n, 3 * d, device="meta")
    gain = torch.empty(1, device="meta")
    f32 = torch.empty(n * t, d, device="meta")
    qkv = torch.empty(n * t, 3 * d, device="meta")
    calls = [
        lambda: attn_branch.gate_residual_bwd(x, f32, rows, 2 * d, t, bf),
        lambda: attn_branch.attention_bwd(qkv, f32, t, heads, bf),
        lambda: attn_branch.modulate_fwd(x, rows, gain, t, bf),
        lambda: attn_branch.modulate_bwd(f32, x, rows, gain, f32, t),
    ]
    xb = torch.empty(n, t, d, dtype=bf, device="meta")
    r = torch.empty(n, d, dtype=bf, device="meta")
    branch_args = (xb, r, r, r, torch.empty((), device="meta"), torch.empty(3 * d, d, dtype=bf, device="meta"),
                   torch.empty(d, d, dtype=bf, device="meta"), heads)
    calls += [
        lambda: attn_branch.attn_fwd(*branch_args),
        lambda: attn_branch.attn_res_fwd(*branch_args),
        lambda: attn_branch.attn_bwd(xb, *branch_args),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()


@pytest.mark.parametrize(
    "overrides, item",
    [
        (dict(use_cosine_attention=False), "A.2"),
        (dict(modulation="rotation"), "A.2"),
        (dict(block_kernel="mega_attn_tp"), "B.10"),
        (dict(block_kernel="pallas"), "B.8"),
        (dict(attention_impl="pallas"), "B.9"),
    ],
)
def test_unported_options_name_their_roadmap_item(overrides, item):
    with pytest.raises(NotImplementedError, match=item):
        build_config("DiT-XS/2", **XS2, **overrides)


def test_unported_sampler_raises():
    cfg = build_config("DiT-XS/2", **XS2)
    with pytest.raises(NotImplementedError, match="A.7"):
        build_sample_fn(cfg, {}, create_diffusion("2", device="cpu"), sampler="dpm++", device="cpu")


def test_registry_has_the_fifteen_models():
    from mapdit_tpu.models.registry import DIT_MODELS as JAX_MODELS
    from mapdit_tpu_torch.models.registry import DIT_MODELS

    assert DIT_MODELS == JAX_MODELS and len(DIT_MODELS) == 15
