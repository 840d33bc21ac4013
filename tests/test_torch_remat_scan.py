"""remat and the scan_blocks layout of the port (models/dit.py) against the
JAX package: the forward and gradients under remat (tests/test_model.py's
tolerances) and against JAX ``remat=True``, the stacked layout's forward
against JAX ``scan_blocks=True`` on the same stacked weights (1e-4), the
converters, the projection of 3-D weights, telemetry across layouts, the
JAX package's rules under scan_blocks, the train CLI's resume in the
stacked layout and a JAX scan-layout train state carried over. CPU, XS
sizes; on CPU tensors the kernel wrappers run their plain versions."""

import os
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapdit_tpu.models import DiT as JaxDiT
from mapdit_tpu.models import build_config as jax_build_config
from mapdit_tpu.models import init_model as jax_init_model
from mapdit_tpu.models.dit import project_weights as jax_project_weights
from mapdit_tpu.models.dit import stack_block_params as jax_stack_block_params
from mapdit_tpu.models.dit import unstack_block_params as jax_unstack_block_params
from mapdit_tpu.training.telemetry import weight_magnitudes as jax_weight_magnitudes
from mapdit_tpu_torch.diffusion import create_diffusion
from mapdit_tpu_torch.models import DiT, build_config, init_model
from mapdit_tpu_torch.models.blocks import stack_auto_ok
from mapdit_tpu_torch.models.dit import project_weights, stack_block_params, unstack_block_params
from mapdit_tpu_torch.runtime import build_cached_sample_fn, build_sample_fn, resolve_run_config
from mapdit_tpu_torch.training.telemetry import make_activation_probe, weight_magnitudes
from mapdit_tpu_torch.utils.weights import state_dict_from_jax

XS2 = dict(in_channels=4, input_size=16, num_classes=10)
# several workers share the machine's cores (tests/test_torch_train.py)
torch.set_num_threads(2)
KERNEL_PATHS = {
    "off": dict(block_kernel="off"),
    "mega_attn+pallas": dict(block_kernel="mega_attn", attn_bwd="pallas"),
    "mega_attn+residual": dict(block_kernel="mega_attn", attn_bwd="residual"),
}


@pytest.fixture(autouse=True)
def _drop_tmp_path(tmp_path):
    """Each test's files go when it ends (a failing test's too)."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def jax_xs8():
    """JAX DiT-XS/8 variables (per-block layout) with the block gains drawn
    away from their zero init, and one input batch."""
    cfg = jax_build_config("DiT-XS/8", **XS2)
    _, variables = jax_init_model(cfg, seed=0)
    rng = np.random.default_rng(5)
    params = dict(variables["params"])
    for i in range(cfg.depth):
        blk = dict(params[f"blocks_{i}"])
        blk["gain_msa"], blk["gain_mlp"] = (jnp.asarray(v, jnp.float32) for v in rng.uniform(0.1, 0.9, 2))
        params[f"blocks_{i}"] = blk
    x = rng.normal(size=(2, 4, 16, 16)).astype(np.float32)
    t = np.array([100.0, 700.0], np.float32)
    y = np.array([1, 10], np.int32)
    return cfg, dict(variables, params=params), (x, t, y)


def _port_model(cfg, sd):
    model = DiT(cfg).eval()
    model.load_state_dict(sd)
    return model


def _inputs(inputs):
    x, t, y = inputs
    return torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y.astype(np.int64))


def _loss_and_grads(model, inputs):
    model.zero_grad(set_to_none=True)
    loss = (model(*inputs) ** 2).sum()
    loss.backward()
    return loss.detach(), {name: p.grad.clone() for name, p in model.named_parameters()}


def _jax_loss_and_grads(cfg, variables, inputs):
    x, t, y = (jnp.asarray(a) for a in inputs)

    def f(params):
        return jnp.sum(JaxDiT(cfg).apply({"params": params, "constants": variables["constants"]}, x, t, y) ** 2)

    value, grads = jax.value_and_grad(f)(variables["params"])
    return float(value), state_dict_from_jax({"params": grads})


def _assert_grads_close(got, want, rel=2e-4):
    for name, w in want.items():
        g = got[name].detach().numpy().reshape(w.shape)
        scale = float(np.abs(w.numpy()).max()) or 1.0
        assert np.abs(g - w.numpy()).max() <= rel * scale, (name, np.abs(g - w.numpy()).max(), scale)


@pytest.mark.parametrize("path", list(KERNEL_PATHS))
def test_remat_and_scan_blocks_keep_loss_and_gradients(jax_xs8, path):
    """remat on and off, in the per-block and the stacked layout, give the
    same loss and gradients (the stacked ones unstacked): within
    tests/test_model.py's remat tolerances, and here bit for bit, on the
    plain path and through the attention half-block under both of its
    backwards."""
    jcfg, variables, inputs = jax_xs8
    sd = state_dict_from_jax(variables, build_config("DiT-XS/8", **XS2))
    base = build_config("DiT-XS/8", **XS2, **KERNEL_PATHS[path])
    inputs = _inputs(inputs)
    v0, g0 = _loss_and_grads(_port_model(base, sd), inputs)
    for overrides in (dict(remat=True), dict(scan_blocks=True), dict(scan_blocks=True, remat=True)):
        cfg = base.replace(**overrides)
        model = _port_model(cfg, stack_block_params(sd, cfg.depth) if cfg.scan_blocks else sd)
        v1, g1 = _loss_and_grads(model, inputs)
        if cfg.scan_blocks:
            g1 = unstack_block_params(g1, cfg.depth)
        np.testing.assert_allclose(v1.numpy(), v0.numpy(), rtol=1e-6)
        assert torch.equal(v1, v0), overrides
        assert g1.keys() == g0.keys()
        for name in g0:
            np.testing.assert_allclose(g1[name].numpy(), g0[name].numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
            assert torch.equal(g1[name], g0[name]), (overrides, name)


def test_remat_matches_jax_remat(jax_xs8):
    """The port under remat against JAX ``remat=True`` on the same weights:
    the loss within 2e-4 relative, each gradient within 2e-4 of its
    tensor's largest element (tests/test_torch_train.py's rule)."""
    jcfg, variables, inputs = jax_xs8
    cfg = build_config("DiT-XS/8", **XS2, remat=True)
    want_v, want_g = _jax_loss_and_grads(jcfg.replace(remat=True), variables, inputs)
    got_v, got_g = _loss_and_grads(_port_model(cfg, state_dict_from_jax(variables, cfg)), _inputs(inputs))
    np.testing.assert_allclose(float(got_v), want_v, rtol=2e-4)
    _assert_grads_close(got_g, want_g)


def test_scan_blocks_forward_and_gradients_match_jax(jax_xs8):
    """JAX ``scan_blocks=True`` on its stacked variables against the port's
    stacked layout on the same arrays (converted by state_dict_from_jax):
    the forward within 1e-4 (tests/test_model.py), the gradients of the
    stacked parameters by the rule above."""
    jcfg, variables, inputs = jax_xs8
    scfg = jcfg.replace(scan_blocks=True)
    svars = dict(variables, params=jax_stack_block_params(variables["params"], jcfg.depth))
    want = np.asarray(JaxDiT(scfg).apply(svars, *(jnp.asarray(a) for a in inputs)))
    cfg = build_config("DiT-XS/8", **XS2, scan_blocks=True)
    model = _port_model(cfg, state_dict_from_jax(svars, cfg))
    assert model.state_dict()["blocks.attn.qkv_proj.weight"].shape == (cfg.depth, 768, 256)
    with torch.no_grad():
        got = model(*_inputs(inputs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    want_v, want_g = _jax_loss_and_grads(scfg, svars, inputs)
    got_v, got_g = _loss_and_grads(model, _inputs(inputs))
    np.testing.assert_allclose(float(got_v), want_v, rtol=2e-4)
    _assert_grads_close(got_g, want_g)


def test_converters_round_trip_and_match_jax(jax_xs8):
    """stack_block_params / unstack_block_params: an exact round trip in
    both directions, keys in the models' own order, and the stacked dict is
    the JAX converter's output by the port's names."""
    jcfg, variables, _ = jax_xs8
    cfg = build_config("DiT-XS/8", **XS2)
    sd = state_dict_from_jax(variables, cfg)
    stacked = stack_block_params(sd, cfg.depth)
    want = state_dict_from_jax(dict(variables, params=jax_stack_block_params(variables["params"], cfg.depth)), cfg)
    assert stacked.keys() == want.keys()
    for name in want:
        assert torch.equal(stacked[name], want[name]), name
    per_block_keys, stacked_keys = list(DiT(cfg).state_dict()), list(DiT(cfg.replace(scan_blocks=True)).state_dict())
    assert list(stack_block_params(dict.fromkeys(per_block_keys, torch.zeros(2)), cfg.depth)) == stacked_keys
    assert list(unstack_block_params(dict.fromkeys(stacked_keys, torch.zeros(cfg.depth)), cfg.depth)) == per_block_keys
    back = unstack_block_params(stacked, cfg.depth)
    assert back.keys() == sd.keys()
    for name in sd:
        assert torch.equal(back[name], sd[name]), name
    again = stack_block_params(back, cfg.depth)
    assert all(torch.equal(again[name], stacked[name]) for name in stacked)
    jax_back = jax_unstack_block_params(jax_stack_block_params(variables["params"], cfg.depth), cfg.depth)
    for name, value in state_dict_from_jax({"params": jax_back}).items():
        assert torch.equal(back[name], value), name


def test_one_seed_gives_the_same_weights_in_both_layouts():
    """The port's seed rule: init_model in the stacked layout draws depth
    per-block inits in the per-block layout's order, so unstacking it gives
    init_model's per-block weights exactly (JAX's nn.scan splits its keys,
    so its two layouts differ)."""
    cfg = build_config("DiT-XS/8", **XS2)
    per_block = init_model(cfg, seed=7, device="cpu").state_dict()
    stacked = init_model(cfg.replace(scan_blocks=True), seed=7, device="cpu").state_dict()
    back = unstack_block_params(stacked, cfg.depth)
    assert back.keys() == per_block.keys()
    for name in per_block:
        assert torch.equal(back[name], per_block[name]), name


def test_project_weights_normalises_stacked_weights(jax_xs8):
    """project_weights on the stacked layout: every row of every depth of a
    3-D weight at norm sqrt(in_dim), the same bits as projecting the
    per-block layout, and JAX's project_weights on the stacked tree within
    1e-6; the gains are left as they are."""
    jcfg, variables, _ = jax_xs8
    cfg = build_config("DiT-XS/8", **XS2)
    sd = state_dict_from_jax(variables, cfg)
    per_block = _port_model(cfg, sd)
    stacked = _port_model(cfg.replace(scan_blocks=True), stack_block_params(sd, cfg.depth))
    project_weights(per_block, cfg)
    project_weights(stacked, cfg.replace(scan_blocks=True))
    w = stacked.state_dict()["blocks.mlp.net.0.weight"]
    assert w.ndim == 3
    torch.testing.assert_close(w.norm(dim=-1), torch.full(w.shape[:2], w.shape[-1] ** 0.5), rtol=1e-5, atol=0)
    want = stack_block_params(per_block.state_dict(), cfg.depth)
    got = stacked.state_dict()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    jax_projected = jax_project_weights(jax_stack_block_params(variables["params"], cfg.depth),
                                        jcfg.replace(scan_blocks=True))
    for name, value in state_dict_from_jax({"params": jax_projected}).items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=1e-6, atol=1e-6, err_msg=name)
    assert torch.equal(got["blocks.gain_msa"], sd["blocks.0.gain_msa"].new_tensor(
        [sd[f"blocks.{i}.gain_msa"] for i in range(cfg.depth)]))


def test_telemetry_matches_across_layouts(jax_xs8):
    """weight_magnitudes of the stacked layout equal the per-block layout's
    and the JAX function's on the stacked tree (rtol 1e-6, JAX's
    tests/test_telemetry.py); the activation probe gives the same per-block
    RMS in both layouts and under remat, one value a block."""
    jcfg, variables, _ = jax_xs8
    cfg = build_config("DiT-XS/8", **XS2)
    sd = state_dict_from_jax(variables, cfg)
    stacked_sd = stack_block_params(sd, cfg.depth)
    per_block = weight_magnitudes({k: v for k, v in sd.items() if k != "pos_embed"})
    stacked = weight_magnitudes({k: v for k, v in stacked_sd.items() if k != "pos_embed"})
    want = jax_weight_magnitudes(jax_stack_block_params(variables["params"], cfg.depth))
    assert per_block.keys() == stacked.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(float(stacked[key]), float(per_block[key]), rtol=1e-6, err_msg=key)
        np.testing.assert_allclose(float(stacked[key]), float(want[key]), rtol=1e-6, err_msg=key)

    diffusion = create_diffusion("", device="cpu")
    rng = np.random.default_rng(2)
    batch = {"mean": rng.normal(size=(4, 4, 16, 16)).astype(np.float32),
             "std": np.full((4, 4, 16, 16), 0.1, np.float32), "y": np.arange(4) % 10}
    outs = {}
    for name, overrides, weights in (("per-block", {}, sd), ("scan", dict(scan_blocks=True), stacked_sd),
                                     ("remat", dict(remat=True), sd)):
        c = cfg.replace(**overrides)
        probe = make_activation_probe(c, diffusion, stats_mean=np.zeros(4), stats_std=np.ones(4))
        outs[name] = probe(_port_model(c, weights), batch, torch.Generator().manual_seed(0))
    assert outs["per-block"]["block_rms"].shape == (cfg.depth,)
    for name in ("scan", "remat"):
        for key in ("block_rms", "out_rms"):
            torch.testing.assert_close(outs[name][key], outs["per-block"][key], rtol=2e-5, atol=0)


def test_jax_rules_under_scan_blocks():
    """The JAX package's rules, kept: auto never promotes to mega_stack
    under scan_blocks (blocks.py:177; the per-block kernels run on the
    views), an explicit mega_stack raises (runtime.py:189), span caching
    raises (runtime.py:448, dit.py:178), and tensor parallelism on the
    stacked layout raises naming its ROADMAP item."""
    from mapdit_tpu_torch.runtime import _mesh_config

    cuda = torch.device("cuda")  # the policy reads the device's type only
    cfg = build_config("DiT-S/2", in_channels=4, input_size=16, compute_dtype="bfloat16", fold_weights=True)
    assert stack_auto_ok(cfg, 32, cuda)
    assert not stack_auto_ok(cfg.replace(scan_blocks=True), 32, cuda)
    scan = cfg.replace(scan_blocks=True, block_kernel="auto")
    assert resolve_run_config(scan, batch_hint=32, device=cuda).block_kernel == "auto"
    assert resolve_run_config(cfg.replace(block_kernel="auto"), batch_hint=32, device=cuda).block_kernel == "mega_stack"
    with pytest.raises(ValueError, match="mega_stack replaces scan_blocks"):
        resolve_run_config(scan.replace(block_kernel="mega_stack"), batch_hint=32, device=cuda)
    xs = build_config("DiT-XS/8", **XS2, scan_blocks=True)
    sd = init_model(xs, seed=0, device="cpu").state_dict()
    with pytest.raises(ValueError, match="scan_blocks=False"):
        build_cached_sample_fn(xs, sd, create_diffusion("4", device="cpu"), cache_interval=2, device="cpu")
    model = _port_model(xs, sd)
    with pytest.raises(ValueError, match="scan_blocks=False"):
        model(torch.zeros(1, 4, 16, 16), torch.zeros(1), torch.zeros(1, dtype=torch.long), span=(1, 3))
    with pytest.raises(NotImplementedError, match="Multi-GPU layouts, the rest"):
        _mesh_config(xs, True, SimpleNamespace(n_model=2), "cpu")
    with pytest.raises(NotImplementedError, match="Multi-GPU layouts, the rest"):
        model.load_tensor_parallel({}, None)


@pytest.mark.parametrize("sampler", ["ddpm", "dpm++"])
def test_scan_blocks_chain_matches_the_per_block_chain(sampler):
    """A CFG chain of the stacked layout (folded: its 3-D weights
    normalised a depth at a time) against the per-block layout's on the
    same weights, draws and generator: the same bits."""
    cfg = build_config("DiT-XS/8", **XS2)
    sd = init_model(cfg, seed=1, device="cpu").state_dict()
    diffusion = create_diffusion("5", device="cpu")
    gen = torch.Generator().manual_seed(3)
    z = torch.randn(4, 4, 16, 16, generator=gen)
    y = torch.tensor([1, 2, 10, 10])
    outs = []
    for c, weights in ((cfg, sd), (cfg.replace(scan_blocks=True), stack_block_params(sd, cfg.depth))):
        fn = build_sample_fn(c, weights, diffusion, cfg_scale=4.0, sampler=sampler, clip_denoised=True, batch_hint=2,
                             device="cpu")
        outs.append(fn(z, y, torch.Generator().manual_seed(4)))
    assert torch.equal(outs[1], outs[0])


def test_train_cli_resumes_the_stacked_layout_bit_for_bit(tmp_path):
    """The train CLI with --scan-blocks true --remat true on the attention
    half-block path: 4 steps in one run equal 2 steps, a checkpoint,
    --resume and 2 more, bit for bit (parameters, EMA trees, Adam moments,
    generator); the checkpoint and the EMA snapshots hold the stacked
    layout."""
    from mapdit_tpu_torch import train

    def run(results, *flags):
        return train.main(train.build_parser().parse_args([
            "--device", "cpu", "--data-path", "synthetic:32", "--model", "DiT-XS/8", "--num-classes", "10",
            "--batch-size", "4", "--num-lin-warmup", "1", "--start-decay", "4", "--log-every", "2",
            "--checkpointer", "torch-sync", "--scan-blocks", "true", "--remat", "true", "--block-kernel", "mega_attn",
            "--results-dir", str(results), *flags]))

    def load(exp, step):
        return torch.load(os.path.join(exp, "checkpoints", f"{step:07d}.pt"), weights_only=True)

    whole = run(tmp_path / "whole", "--num-steps", "4", "--ckpt-every", "4", "--ema-snapshot-every", "2")
    first = run(tmp_path / "first", "--num-steps", "2", "--ckpt-every", "2", "--ema-snapshot-every", "0")
    second = run(tmp_path / "second", "--num-steps", "4", "--ckpt-every", "4", "--ema-snapshot-every", "0",
                 "--resume", first)
    a, b = load(second, 4), load(whole, 4)
    assert a["model"]["blocks.attn.qkv_proj.weight"].shape == (6, 768, 256)
    for part in ("model", *(f"ema/{k}" for k in a["ema"])):
        ta = a["model"] if part == "model" else a["ema"][part[4:]]
        tb = b["model"] if part == "model" else b["ema"][part[4:]]
        assert ta.keys() == tb.keys()
        for name in ta:
            assert torch.equal(ta[name], tb[name]), (part, name)
    assert a["step"] == b["step"] == 4 and torch.equal(a["generator"], b["generator"])
    for sa, sb in zip(a["optimizer"]["state"].values(), b["optimizer"]["state"].values()):
        for key in sa:
            assert torch.equal(sa[key], sb[key]), key
    with np.load(os.path.join(whole, "ema", "0.050_0000002.npz")) as snap:
        assert snap["blocks.mlp.net.2.weight"].shape == (6, 256, 1024)


def test_jax_scan_train_state_carries_over(tmp_path):
    """A JAX scan_blocks TrainState after one step, handed to the port in
    both layouts: train_state_from_jax on the stacked trees equals, once
    unstacked, the same call on JAX's unstacked trees (parameters, Adam
    moments, EMA trees, all exact); tools/convert_jax_checkpoint.py carries
    the JAX scan run's checkpoint into a stacked port checkpoint that
    restores to the same tensors and that the port's CLI resumes."""
    import importlib.util
    import pathlib

    from mapdit_tpu.diffusion import create_diffusion as jax_create_diffusion
    from mapdit_tpu.training import create_optimizer as jax_create_optimizer
    from mapdit_tpu.training import create_train_state as jax_create_train_state
    from mapdit_tpu.training import make_train_step as jax_make_train_step
    from mapdit_tpu.training import warmup_flat_invsqrt as jax_schedule
    from mapdit_tpu.training.checkpoint import save_state as jax_save_state
    from mapdit_tpu.training.data import SyntheticLatentDataset as JaxSyntheticLatentDataset
    from mapdit_tpu.utils import save_config as jax_save_config
    from mapdit_tpu_torch import train as train_cli
    from mapdit_tpu_torch.training import checkpoint as ckpt
    from mapdit_tpu_torch.training import create_optimizer, create_train_state, warmup_flat_invsqrt
    from mapdit_tpu_torch.utils.weights import train_state_from_jax

    jcfg = jax_build_config("DiT-XS/8", scan_blocks=True, **XS2)
    ds = JaxSyntheticLatentDataset(num_examples=16, num_classes=10)
    jtx = jax_create_optimizer(jax_schedule(1e-2, 5, 50))
    jstep = jax.jit(jax_make_train_step(jcfg, jax_create_diffusion(""), jtx, stats_mean=jnp.asarray(ds.stats["mean"]),
                                        stats_std=jnp.asarray(ds.stats["std"])))
    jstate, _ = jstep(jax_create_train_state(jcfg, jtx, seed=0), next(ds.batches(batch_size=8, seed=0)))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    adam = jstate.opt_state[0]
    trees = dict(params=to_np(jstate.params), mu=to_np(adam.mu), nu=to_np(adam.nu),
                 ema={k: to_np(v) for k, v in jstate.ema.items()})
    depth = jcfg.depth
    unstacked = {k: jax_unstack_block_params(v, depth) for k, v in trees.items() if k != "ema"}
    unstacked["ema"] = {k: jax_unstack_block_params(v, depth) for k, v in trees["ema"].items()}
    cfg = build_config("DiT-XS/8", **XS2)
    tx = create_optimizer(warmup_flat_invsqrt(1e-2, 5, 50))
    common = dict(constants=to_np(jstate.constants), count=int(adam.count), step=int(jstate.step), device="cpu")
    stacked_state = train_state_from_jax(cfg.replace(scan_blocks=True), tx, **trees, **common)
    flat_state = train_state_from_jax(cfg, tx, **unstacked, **common)

    def views(state):
        named = dict(state.model.named_parameters())
        out = {"params": {k: p.detach() for k, p in named.items()},
               "mu": {k: state.optimizer.state[p]["exp_avg"] for k, p in named.items()},
               "nu": {k: state.optimizer.state[p]["exp_avg_sq"] for k, p in named.items()}}
        out.update({f"ema/{k}": v for k, v in state.ema.items()})
        return out

    got, want = views(stacked_state), views(flat_state)
    assert got["params"]["blocks.attn.qkv_proj.weight"].shape == (depth, 768, 256)
    assert got.keys() == want.keys()
    for part in want:
        back = unstack_block_params(got[part], depth)
        assert back.keys() == want[part].keys(), part
        for name in want[part]:
            assert torch.equal(back[name], want[part][name]), (part, name)

    spec = importlib.util.spec_from_file_location(
        "convert_jax_checkpoint", pathlib.Path(__file__).resolve().parents[1] / "tools" / "convert_jax_checkpoint.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    jax_dir, out_dir = tmp_path / "jax" / "000-DiT-XS-8", tmp_path / "torch" / "000-DiT-XS-8"
    (jax_dir / "checkpoints").mkdir(parents=True)
    jax_save_config(str(jax_dir), dict(model="DiT-XS/8", **XS2, lr=1e-2, num_steps=50, num_lin_warmup=5,
                                       start_decay=50, seed=0, scan_blocks=True, block_kernel="auto",
                                       stats_mean=[float(v) for v in ds.stats["mean"]]))
    assert tool.main(["--checkpoint", jax_save_state(str(jax_dir), 1, jstate), "--output-dir", str(out_dir)]) == 0
    restored = ckpt.restore_state(ckpt.latest_checkpoint(str(out_dir)),
                                  create_train_state(cfg.replace(scan_blocks=True), tx, seed=3, device="cpu"))
    for part, tensors in views(restored).items():
        for name, value in tensors.items():
            assert torch.equal(value, got[part][name]), (part, name)
    exp = train_cli.main(train_cli.build_parser().parse_args([
        "--device", "cpu", "--data-path", "synthetic:16", "--results-dir", str(tmp_path / "resumed"), "--model",
        "DiT-XS/8", "--num-classes", "10", "--batch-size", "8", "--num-steps", "2", "--log-every", "1",
        "--ckpt-every", "100", "--ema-snapshot-every", "0", "--scan-blocks", "true", "--resume", str(out_dir)]))
    log = open(f"{exp}/log.txt").read()
    assert "at step 1" in log and "(step=0000002)" in log
