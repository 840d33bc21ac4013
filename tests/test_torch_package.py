"""Package rules of the port: it stands alone (no JAX, no mapdit_tpu), its
entry points default to CUDA, and its kernel wrappers never launch on CPU
tensors."""

import ast
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import mapdit_tpu_torch
from mapdit_tpu_torch.diffusion import create_diffusion
from mapdit_tpu_torch.models import build_config, init_model
from mapdit_tpu_torch.ops.cuda import attn_branch, dit_block, dit_block_tp, mlp_block
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
                "ops.cuda.attn_branch", "ops.cuda.attention", "ops.cuda.mlp_block", "train", "training.checkpoint",
                "training.native_loader", "training.device_prefetch", "training.telemetry",
                "diffusion.timestep_sampler", "utils.experiment", "utils.logging", "parallel", "parallel.mesh",
                "ops.cuda.dit_block_tp", "diffusion.dpm_solver", "diffusion.unipc", "models.vae", "utils.safetensors",
                "utils.image", "utils.class_names", "sample", "sample_ema", "sample_fid", "serve", "diffusion.distill",
                "distill", "download_data", "tools.fid", "tools.distribution_probe", "tools.guidance_sweep",
                "tools.run_fid50k"):
        assert f"mapdit_tpu_torch.{mod}" in _modules()
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'mapdit_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.startswith("ok"), proc.stderr


def test_sources_import_nothing_of_jax():
    """No source of the port, and not chip_smoke.py, imports JAX, the JAX
    package or a module of the repository's tools/ (the port keeps its own
    copies, mapdit_tpu_torch/tools/)."""
    for path in list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "flax", "optax", "orbax", "mapdit_tpu", "tools"), (
                    f"{path}: imports {name}")


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
        lambda: attn_branch.out_gate_residual_bwd(x, torch.empty(d, d, dtype=bf, device="meta"), x, rows, 2 * d, t),
        lambda: attn_branch.attention_bwd(qkv, f32, t, heads, bf),
        lambda: attn_branch.modulate_fwd(x, rows, gain, t, bf),
        lambda: attn_branch.modulate_bwd(f32, x, rows, gain, f32, t),
        lambda: attn_branch.dw_gemm(x, x, 0.25),
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
    # the tensor-parallel partials on a shard of half the heads / hidden lanes
    d_l, gains = d // 2, torch.empty(2, device="meta")
    w_qkv_l, w_out_l = (torch.empty(*s, dtype=bf, device="meta") for s in ((3 * d_l, d), (d, d_l)))
    w1_l, w2_l = (torch.empty(*s, dtype=bf, device="meta") for s in ((2 * d, d), (d, 2 * d)))
    calls += [
        lambda: dit_block_tp.attn_tp_partial(xb, r, r, gain, w_qkv_l, w_out_l, 1),
        lambda: dit_block_tp.block_tp_attn(xb, r, gains, torch.empty(6 * d, d, dtype=bf, device="meta"), w_qkv_l,
                                           w_out_l, 1),
        lambda: dit_block_tp.mlp_tp_partial(xb, r, r, gains, w1_l, w2_l, 0.125),
    ]
    # the two kernels' own wrappers
    calls += [
        lambda: dit_block_tp.tp_attn(xb, r, r, gain, w_qkv_l, w_out_l, 1),
        lambda: dit_block_tp.tp_mlp(xb, r, r, gain, w1_l, w2_l, 0.125),
    ]
    # and at T > 64, the attention partials' launch-sequence route
    x_long = torch.empty(n, 2 * 64 + 2, d, dtype=bf, device="meta")
    calls += [
        lambda: dit_block_tp.attn_tp_partial(x_long, r, r, gain, w_qkv_l, w_out_l, 1),
        lambda: dit_block_tp.block_tp_attn(x_long, r, gains, torch.empty(6 * d, d, dtype=bf, device="meta"),
                                           w_qkv_l, w_out_l, 1),
    ]
    # the persistent stack kernel, alone and as the stack's and the block's route
    hid = 4 * d
    stacked = [torch.empty(1, *shape, dtype=bf, device="meta") for shape in
               ((6 * d, d), (3 * d, d), (d, d), (hid, d), (d, hid))]
    g1 = torch.empty(1, 2, device="meta")
    calls += [
        lambda: dit_block.dit_stack(xb, r, g1, *stacked, heads),
        lambda: dit_block.fused_dit_stack(xb, r, g1, *stacked, heads),
        lambda: dit_block.fused_dit_block(xb, r, gains, *(w[0] for w in stacked), heads),
    ]
    # row 9's kernel, alone and as the MLP half-block's route
    w1, w2 = (torch.empty(*s, dtype=bf, device="meta") for s in ((hid, d), (d, hid)))
    calls += [
        lambda: mlp_block.mlp_branch(xb, r, r, r, gain, w1, w2),
        lambda: mlp_block.fused_mlp_branch(xb, r, r, r, gain, w1, w2),
    ]
    before, before_tp, before_mlp = dict(dit_block.LAUNCHES), dict(dit_block_tp.LAUNCHES), dict(mlp_block.LAUNCHES)
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert dit_block.LAUNCHES == before
    assert dit_block_tp.LAUNCHES == before_tp
    assert mlp_block.LAUNCHES == before_mlp


@pytest.mark.parametrize("tokens, hd, what", [(64, 48, "head widths"), (16, 80, "head widths"), (257, 64, "T <= 256"),
                                              (512, 72, "T <= 256")])
def test_attention_bwd_raises_off_its_card_domain(tokens, hd, what):
    """On the card attention_bwd takes head widths 64 and 72 and T up to
    256 (32 x 32 latents at patch 2); a tensor off the CPU outside that
    raises naming CUDA and the limit, before anything is built or
    launched."""
    heads, n = 2, 2
    qkv = torch.empty(n * tokens, 3 * heads * hd, device="meta")
    dattn = torch.empty(n * tokens, heads * hd, device="meta")
    before = dict(attn_branch.LAUNCHES)
    with pytest.raises(ValueError, match=f"CUDA.*{what}"):
        attn_branch.attention_bwd(qkv, dattn, tokens, heads, torch.bfloat16)
    assert attn_branch.LAUNCHES == before


def test_attention_bwd_takes_every_registry_head():
    """Every registry model's head width at input sizes 16 and 32 (T = 256,
    64, 16, 4) lies in the card kernel's domain, and so do T = 128 (the
    last of the form with p in shared memory) and a ragged T = 144 of the
    form past it."""
    from mapdit_tpu_torch.models.registry import DIT_MODELS

    for name, spec in DIT_MODELS.items():
        hd = spec["hidden_size"] // spec["num_heads"]
        for size in (16, 32):
            attn_branch.check_attention_bwd_shape((size // spec["patch_size"]) ** 2, hd)
        for tokens in (128, 144, attn_branch.ATTENTION_BWD_MAX_T):
            attn_branch.check_attention_bwd_shape(tokens, hd)


def _cli_run(tmp_path, flags):
    from mapdit_tpu_torch import train

    return train.main(train.build_parser().parse_args(
        ["--data-path", "synthetic:16", "--results-dir", str(tmp_path), "--device", "cpu", "--model", "DiT-XS/8",
         *flags]))


@pytest.mark.parametrize(
    "overrides, item",
    [
        (["--fsdp", "true", "--num-steps", "1", "--batch-size", "8", "--num-classes", "10", "--log-every", "1",
          "--ckpt-every", "1", "--ema-snapshot-every", "0", "--checkpointer", "torch-sync"], None),
        (["--n-model", "2"], "torchrun --nproc-per-node N"),
        (["--multihost", "true"], "RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT"),
        (["--checkpointer", "orbax"], "torch-sharded"),
        (["--block-kernel", "mega_tp"], "--block-kernel mega_tp is an inference-only TP layout"),
    ],
)
def test_unported_options_name_their_roadmap_item(overrides, item, tmp_path, monkeypatch):
    """The train CLI's multi-device flags on one process: ``--fsdp true``
    runs (a data axis of 1 shards nothing) and writes its checkpoint;
    ``--n-model > 1`` (tensor-parallel training) splits the model over the
    ranks of a process group, and one process raises naming the torchrun
    launch; ``--multihost true`` without torchrun's variables
    raises naming them; ``--checkpointer orbax`` names the port's sharded
    format; a TP island exits with the JAX CLI's words (``train.py:124-129``
    of the JAX package). (Under torchrun: tests/test_torch_train_cli_dp.py.)"""
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    if item is None:
        exp = _cli_run(tmp_path, overrides)
        assert (pathlib.Path(exp) / "checkpoints" / "0000001.pt").is_file()
        return
    with pytest.raises((NotImplementedError, ValueError, SystemExit), match=item):
        _cli_run(tmp_path, overrides)


@pytest.mark.parametrize(
    "overrides",
    [
        dict(scan_blocks=True),
        dict(remat=True, use_cosine_attention=False),
        ["--remat", "true"],
        ["--scan-blocks", "true"],
    ],
    ids=["config-scan_blocks", "config-remat-vanilla-attention", "cli-remat", "cli-scan-blocks"],
)
def test_remat_and_scan_blocks_options_run(overrides, tmp_path):
    """The options that raised naming A.6 until the port took them: a config
    override (a dict) builds a model whose forward is finite, and a flag of
    the train CLI (a list) runs one CPU step and writes its checkpoint."""
    if isinstance(overrides, dict):
        cfg = build_config("DiT-XS/8", **XS2, **overrides)
        model = init_model(cfg, seed=0, device="cpu")
        out = model(torch.randn(2, 4, 16, 16), torch.full((2,), 10.0), torch.ones(2, dtype=torch.long))
        assert out.shape == (2, 8, 16, 16) and torch.isfinite(out).all()
        assert any(p.ndim == 3 for p in model.parameters()) == cfg.scan_blocks
    else:
        try:
            exp = _cli_run(tmp_path, [*overrides, "--num-steps", "1", "--batch-size", "4", "--num-classes", "10",
                                      "--log-every", "1", "--ckpt-every", "1", "--ema-snapshot-every", "0"])
            assert "(step=0000001)" in open(f"{exp}/log.txt").read()
            assert (pathlib.Path(exp) / "checkpoints" / "0000001.pt").exists()
        finally:
            shutil.rmtree(tmp_path, ignore_errors=True)


def test_unported_sampler_raises():
    """A sampler the JAX package does not have raises naming the ROADMAP
    item that ported the others (ddpm, ddim, dpm++ and unipc run)."""
    cfg = build_config("DiT-XS/2", **XS2)
    with pytest.raises(NotImplementedError, match="Beyond-reference samplers"):
        build_sample_fn(cfg, {}, create_diffusion("2", device="cpu"), sampler="heun", device="cpu")


def test_registry_has_the_fifteen_models():
    from mapdit_tpu.models.registry import DIT_MODELS as JAX_MODELS
    from mapdit_tpu_torch.models.registry import DIT_MODELS

    assert DIT_MODELS == JAX_MODELS and len(DIT_MODELS) == 15
