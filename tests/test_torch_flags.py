"""The port over the ``use_*`` flag grid and the three modulation kinds,
against the JAX package on carried weights: the model forward (2e-4), one
train step (the tolerances of tests/test_torch_train.py), the scope of
``project_weights`` (tests/test_ablation_grid.py), short CFG chains (2e-3,
as tests/test_torch_sample.py) and parameter counts. CPU, float32, tiny
sizes; inputs and weight perturbations come from seeded numpy."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapdit_tpu.diffusion import create_diffusion as jax_create_diffusion
from mapdit_tpu.diffusion.gaussian import GaussianDiffusion as JaxGaussianDiffusion
from mapdit_tpu.models import DiT as JaxDiT
from mapdit_tpu.models import build_config as jax_build_config
from mapdit_tpu.models import init_model as jax_init_model
from mapdit_tpu.models.dit import param_count as jax_param_count
from mapdit_tpu.models.dit import project_weights as jax_project_weights
from mapdit_tpu.ops import mp as jmp
from mapdit_tpu.runtime import build_sample_fn as jax_build_sample_fn
from mapdit_tpu.training import create_optimizer as jax_create_optimizer
from mapdit_tpu.training import create_train_state as jax_create_train_state
from mapdit_tpu.training import make_train_step as jax_make_train_step
from mapdit_tpu.training import warmup_flat_invsqrt as jax_schedule
from mapdit_tpu.training.data import SyntheticLatentDataset as JaxSyntheticLatentDataset
from mapdit_tpu_torch.diffusion import create_diffusion
from mapdit_tpu_torch.models import DiT, build_config, init_model
from mapdit_tpu_torch.models.blocks import (
    kernel_policy,
    modulation_dims,
    resolve_block_kernel_tp,
    stack_auto_ok,
    use_attn_halfkernel,
    use_fused_mlp,
    use_megakernel,
)
from mapdit_tpu_torch.models.dit import project_weights
from mapdit_tpu_torch.ops import mp
from mapdit_tpu_torch.runtime import build_sample_fn
from mapdit_tpu_torch.training import create_optimizer, create_train_state, make_train_step, warmup_flat_invsqrt
from mapdit_tpu_torch.utils.weights import state_dict_from_jax

XS2 = dict(in_channels=4, input_size=16, num_classes=10)
TOL = dict(rtol=2e-4, atol=2e-4)
FLAG_NAMES = (
    "use_cosine_attention",
    "use_weight_normalization",
    "use_forced_weight_normalization",
    "use_mp_residual",
    "use_mp_silu",
    "use_no_layernorm",
    "use_mp_pos_enc",
    "use_mp_embedding",
)
VANILLA = {f: False for f in FLAG_NAMES}
GRID = (
    [{f: False} for f in FLAG_NAMES]
    + [VANILLA]
    + [dict(modulation=m, use_no_layernorm=n) for m in ("adaln", "rotation", "rotation_scale") for n in (True, False)]
)


def _id(overrides):
    if overrides == VANILLA:
        return "vanilla"
    return ",".join(f"{k}={v}" for k, v in overrides.items()) or "all-on"


def _tiny(build, **overrides):
    """The tiny config of tests/test_ablation_grid.py: 2 blocks, width 64
    (rotation needs an even width), 2 heads."""
    return build("DiT-XS/8", **XS2).replace(depth=2, hidden_size=64, num_heads=2, **overrides)


def _perturbed(params, seed=11, amount=0.1):
    """Seeded noise on every leaf: zero-initialised heads and gains would
    make a vanilla model's output, and every rotation, trivial."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(np.asarray(v) + amount * rng.normal(size=v.shape).astype(np.float32)) for v in leaves]
    )


def _inputs(n=4, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4, 16, 16)).astype(np.float32)
    t = np.array([3.0, 250.0, 500.0, 999.0], np.float32)[:n]
    y = np.array([1, 2, 10, 10], np.int32)[:n]
    return x, t, y


def _torch_inputs(inputs):
    x, t, y = inputs
    return torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y.astype(np.int64))


def _jax_variables(jcfg, seed=3):
    _, variables = jax_init_model(jcfg, seed=seed)
    return dict(variables, params=_perturbed(variables["params"]))


def _assert_close(got, want):
    """2e-4, relative to the output's largest element where that exceeds 1
    (without weight normalization the perturbed weights give outputs in the
    hundreds, and an element near a zero crossing then misses 2e-4 of its
    own size by float32 rounding alone)."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, **TOL)


def _port_model(cfg, variables):
    model = DiT(cfg).eval()
    model.load_state_dict(state_dict_from_jax(variables, cfg))  # strict
    return model


def test_rotate_pairs_matches_jax_and_keeps_pair_norms():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 8)).astype(np.float32)
    theta = rng.normal(size=(3, 4)).astype(np.float32) * 2
    got = mp.rotate_pairs(torch.from_numpy(x), torch.from_numpy(theta))
    np.testing.assert_allclose(got.numpy(), np.asarray(jmp.rotate_pairs(x, theta)), rtol=1e-6, atol=1e-6)
    pairs = lambda z: np.linalg.norm(np.asarray(z).reshape(3, 5, 4, 2), axis=-1)  # noqa: E731
    np.testing.assert_allclose(pairs(got), pairs(x), rtol=1e-5)
    torch.testing.assert_close(mp.rotate_pairs(torch.from_numpy(x), torch.zeros(3, 4)), torch.from_numpy(x))


@pytest.mark.parametrize("overrides", GRID, ids=_id)
def test_forward_matches_jax_over_the_flag_grid(overrides):
    """Each flag off alone, all off (vanilla DiT), and the three modulations
    with and without the MP style, on perturbed carried weights."""
    jcfg = _tiny(jax_build_config, **overrides)
    variables = _jax_variables(jcfg)
    inputs = _inputs()
    want = np.asarray(JaxDiT(jcfg).apply(variables, *map(jnp.asarray, inputs)))
    assert np.abs(want).max() > 1e-2
    cfg = _tiny(build_config, **overrides)
    assert cfg.flags_dict() == jcfg.flags_dict() and cfg.mp_style == jcfg.mp_style
    with torch.no_grad():
        got = _port_model(cfg, variables)(*_torch_inputs(inputs))
    _assert_close(got.numpy(), want)


@pytest.mark.parametrize("overrides", [dict(modulation="rotation_scale"), VANILLA], ids=_id)
def test_forward_with_cfg_matches_jax(overrides):
    jcfg = _tiny(jax_build_config, **overrides)
    variables = _jax_variables(jcfg)
    x, t, y = _inputs()
    want = np.asarray(JaxDiT(jcfg).apply(variables, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y), 4.0,
                                         method=JaxDiT.forward_with_cfg))
    cfg = _tiny(build_config, **overrides)
    with torch.no_grad():
        got = _port_model(cfg, variables).forward_with_cfg(*_torch_inputs((x, t, y)), 4.0)
    _assert_close(got.numpy(), want)


@pytest.mark.parametrize("block_kernel", ["auto", "mega", "mega_attn", "mega_stack", "pallas"])
@pytest.mark.parametrize("overrides", [dict(modulation="rotation_scale"), dict(use_cosine_attention=False)], ids=_id)
def test_kernel_names_on_other_families_take_the_generic_path(block_kernel, overrides):
    """A family the block kernels do not compute runs the generic path
    under every block_kernel, as in the JAX package: never the MP-adaln
    arithmetic of the kernels. (Without cosine attention the MLP half is
    still MP-adaln, so ``pallas`` keeps its kernel there.)"""
    jcfg = _tiny(jax_build_config, block_kernel=block_kernel, **overrides)
    variables = _jax_variables(jcfg)
    inputs = _inputs()
    want = np.asarray(JaxDiT(jcfg).apply(variables, *map(jnp.asarray, inputs)))
    cfg = _tiny(build_config, block_kernel=block_kernel, **overrides)
    folded = cfg.replace(fold_weights=True, compute_dtype="bfloat16")
    assert kernel_policy(folded, 64, torch.device("cuda")) == "off"
    assert not use_megakernel(folded, 64, torch.device("cuda")) and not use_attn_halfkernel(cfg)
    assert use_fused_mlp(cfg) == (block_kernel == "pallas" and cfg.modulation == "adaln")
    with torch.no_grad():
        got = _port_model(cfg, variables)(*_torch_inputs(inputs))
    _assert_close(got.numpy(), want)


def test_policy_takes_the_kernels_for_their_family_only():
    cfg = build_config("DiT-S/2", **XS2, compute_dtype="bfloat16", fold_weights=True, block_kernel="auto")
    assert kernel_policy(cfg, 64, torch.device("cuda")) == "mega"
    assert use_megakernel(cfg, 64, torch.device("cuda"))
    for overrides in GRID:
        if overrides == dict(modulation="adaln", use_no_layernorm=True):
            continue
        other = cfg.replace(**overrides)
        family = all(getattr(other, f) for f in ("use_cosine_attention", "use_weight_normalization", "use_mp_residual",
                                                 "use_mp_silu", "use_no_layernorm")) and other.modulation == "adaln"
        assert (kernel_policy(other, 64, torch.device("cuda")) == "mega") == family, overrides
    with pytest.raises(ValueError, match="mega_stack"):
        build_sample_fn(cfg.replace(modulation="rotation", block_kernel="mega_stack", fold_weights=False), {},
                        create_diffusion("2", device="cpu"), device="cpu")


@pytest.mark.parametrize(
    "model, input_size, want",
    [
        ("DiT-S/2", 16, "mega"),
        ("DiT-B/2", 16, "mega"),
        ("DiT-L/2", 16, "mega"),
        ("DiT-XL/2", 16, "mega"),
        ("DiT-XL/2", 32, "off"),  # T = 256, past the auto policy's T <= 64
    ],
)
def test_auto_takes_the_fastest_measured_path(model, input_size, want):
    """What ``auto`` resolves to for folded bf16 and float32 programs on
    CUDA (a torch.device("cuda") needs no card): in bf16 the whole-block
    kernels at every registry size at T = 64, promoted to ``mega_stack``
    with a batch hint, and the ``mega_tp`` island on a model axis of 2 --
    the fastest paths measured on the H100 at S/2, B/2 and XL/2 (PERF.md);
    in float32 the same at S/2 only, the plain path from B/2 up, where
    ``off`` led the f32 kernels (F32_WEIGHT_BUDGET); never the attention
    half-block. A float32 model on a model axis follows the same policy, as
    JAX's resolver does: ``mega_tp`` at S/2 (its islands run the f32
    instances), the plain path from B/2 up; the CPU stays on the plain
    path."""
    cfg = build_config(model, in_channels=4, input_size=input_size, num_classes=1000, compute_dtype="bfloat16",
                       fold_weights=True, block_kernel="auto")
    cuda, t = torch.device("cuda"), cfg.num_patches
    for dtype, w in (("bfloat16", want), ("float32", want if model == "DiT-S/2" else "off")):
        c = cfg.replace(compute_dtype=dtype)
        assert kernel_policy(c, t, cuda) == w
        assert use_megakernel(c, t, cuda) == (w == "mega")
        assert not use_attn_halfkernel(c)
        assert stack_auto_ok(c, 32, cuda) == (w == "mega") and not stack_auto_ok(c, None, cuda)
    assert resolve_block_kernel_tp(cfg, True, 2, cuda) == {"mega": "mega_tp", "off": "off"}[want]
    f32_want = want if model == "DiT-S/2" else "off"
    assert resolve_block_kernel_tp(cfg.replace(compute_dtype="float32"), True, 2, cuda) == {
        "mega": "mega_tp", "off": "off"}[f32_want]
    cpu = torch.device("cpu")
    for other in (cfg, cfg.replace(compute_dtype="float32")):
        assert kernel_policy(other, t, cpu) == "off"
        assert not stack_auto_ok(other, 32, cpu)
        assert resolve_block_kernel_tp(other, True, 2, cpu) == "off"


# ---------------------------------------------------------------------------
# training


def _jax_draws(state, batch, num_timesteps):
    """The draws of the JAX step (mapdit_tpu/training/state.py:171-190)."""
    _, rng_noise, rng_t, _, rng_post = jax.random.split(state.rng, 5)
    mean = jnp.asarray(batch["mean"])
    return {
        "posterior_eps": np.asarray(jax.random.normal(rng_post, mean.shape, mean.dtype)),
        "t": np.asarray(jax.random.randint(rng_t, (mean.shape[0],), 0, num_timesteps)),
        "noise": np.asarray(jax.random.normal(rng_noise, mean.shape, mean.dtype)),
    }


def _unused_gains(cfg, names):
    """The modulation gains, which classic adaLN-Zero arithmetic ignores."""
    if cfg.modulation == "adaln" and not cfg.mp_style:
        return {k for k in names if k.split(".")[-1].startswith("gain_")}
    return set()


def _to_jax_tree(tensors, like):
    """Port tensors (by state-dict name) as a JAX tree shaped like ``like``."""
    leaves, treedef = jax.tree_util.tree_flatten(like)
    index = state_dict_from_jax({"params": jax.tree_util.tree_unflatten(treedef, list(range(len(leaves))))})
    by_leaf = {int(v): k for k, v in index.items()}
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(tensors[by_leaf[i]].detach().numpy()) for i in range(len(leaves))]
    )


@pytest.mark.parametrize("overrides", [dict(modulation="rotation_scale"), VANILLA], ids=_id)
def test_train_step_matches_jax(overrides):
    """One step with the JAX step's draws on perturbed carried weights:
    loss, mse, vb and gradient norm at 2e-4 relative; the update (Adam,
    EMA, projection by the flags) against the JAX package's own update
    functions applied to the port's gradients (1e-3 lr); parameters (biases
    among them) and EMA trees against the JAX step's within 2.1 lr (Adam's
    first step is about lr * sign(g))."""
    import optax

    from mapdit_tpu.training import ema as jax_ema

    jcfg = _tiny(jax_build_config, **overrides)
    ds = JaxSyntheticLatentDataset(num_examples=32, num_classes=10)
    jtx = jax_create_optimizer(jax_schedule(1e-2, 5, 50))
    jstep = jax.jit(jax_make_train_step(
        jcfg, jax_create_diffusion(""), jtx, stats_mean=jnp.asarray(ds.stats["mean"]),
        stats_std=jnp.asarray(ds.stats["std"]), model_train=False,
    ))
    jstate = jax_create_train_state(jcfg, jtx, seed=0)
    params = _perturbed(jstate.params)
    jstate = jstate.replace(params=params, opt_state=jtx.init(params),
                            ema={k: jax.tree_util.tree_map(jnp.array, params) for k in jstate.ema})
    cfg = _tiny(build_config, **overrides)
    tx = create_optimizer(warmup_flat_invsqrt(1e-2, 5, 50))
    state = create_train_state(cfg, tx, seed=0, device="cpu", state_dict=state_dict_from_jax(
        {"params": jstate.params, "constants": jstate.constants}, cfg))
    step = make_train_step(cfg, create_diffusion("", device="cpu"), tx, ds.stats["mean"], ds.stats["std"],
                           model_train=False)
    batch = next(ds.batches(batch_size=8, seed=0))
    draws = _jax_draws(jstate, batch, 1000)
    opt_state, emas = jstate.opt_state, dict(jstate.ema)
    jstate, jm = jstep(jstate, batch)
    m = step(state, batch, draws=draws)
    for key in ("loss", "mse", "vb", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=2e-4, err_msg=key)
    named = dict(state.model.named_parameters())
    assert any(k.endswith(".bias") for k in named) == (not cfg.use_weight_normalization)
    # vanilla adaln has no use for the gains: no gradient here, zeros in JAX
    assert {k for k, p in named.items() if p.grad is None} == _unused_gains(cfg, named)
    grads = _to_jax_tree({k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in named.items()}, params)
    updates, opt_state = jtx.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    emas = {k: jax_ema.ema_update(emas[k], params, jax_ema.make_beta_fn(float(k))(jnp.asarray(1))) for k in emas}
    params = jax_project_weights(params, jcfg)
    lr = warmup_flat_invsqrt(1e-2, 5, 50)(0)

    def close(got, want, bound, what):
        for name, w in want.items():
            err = np.abs(got[name].detach().numpy() - w.numpy()) / lr
            assert err.max(initial=0) < bound, (what, name, err.max())

    close(state.params, state_dict_from_jax({"params": params}), 1e-3, "update")
    close(state.params, state_dict_from_jax({"params": jstate.params}), 2.1, "params")
    for key, tree in state.ema.items():
        close(tree, state_dict_from_jax({"params": emas[key]}), 1e-3, f"ema {key} update")
        close(tree, state_dict_from_jax({"params": jstate.ema[key]}), 2.1, f"ema {key}")


@pytest.mark.parametrize("overrides", GRID, ids=_id)
def test_train_steps_run_over_the_flag_grid(overrides):
    """make_train_step takes a few steps on every flag set: finite loss and
    gradients, every parameter (biases too) reached by the optimizer."""
    cfg = _tiny(build_config, **overrides)
    ds = JaxSyntheticLatentDataset(num_examples=32, num_classes=10)
    tx = create_optimizer(warmup_flat_invsqrt(1e-2, 3, 50))
    state = create_train_state(cfg, tx, seed=0, device="cpu")
    before = {k: p.detach().clone() for k, p in state.params.items()}
    step = make_train_step(cfg, create_diffusion("", device="cpu"), tx, ds.stats["mean"], ds.stats["std"])
    batches = ds.batches(batch_size=8, seed=0)
    metrics = [step(state, next(batches)) for _ in range(3)]
    assert all(np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0 for m in metrics)
    moved = {k for k, p in state.params.items() if not torch.equal(p, before[k])}
    assert moved == set(before) - _unused_gains(cfg, before), set(before) - moved


PROJECTION_SETS = [
    {},
    {"use_forced_weight_normalization": False},
    {"use_weight_normalization": False},
    {"use_mp_embedding": False},
    {"use_weight_normalization": False, "use_mp_embedding": False},
    {"modulation": "rotation_scale"},
]


@pytest.mark.parametrize("overrides", PROJECTION_SETS, ids=_id)
def test_projection_touches_exactly_flag_scoped_leaves(overrides):
    """The scope of tests/test_ablation_grid.py: 2-D ``weight`` leaves under
    ``use_weight_normalization`` (the class table under
    ``use_mp_embedding``), both only with forced weight normalization; and
    the same leaves the JAX package's ``project_weights`` changes."""
    cfg = _tiny(build_config, **overrides)
    model = init_model(cfg, seed=0, device="cpu")
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    project_weights(model, cfg)
    changed = {k for k, p in model.named_parameters() if not torch.allclose(p, before[k])}
    expected = set()
    for name, p in before.items():
        if not name.endswith(".weight") or p.ndim != 2:
            continue
        flag = cfg.use_mp_embedding if name == "y_embedder.embedding.weight" else cfg.use_weight_normalization
        if flag and cfg.use_forced_weight_normalization:
            expected.add(name)
    assert changed == expected, (changed - expected, expected - changed)
    assert bool(changed) == (cfg.use_forced_weight_normalization and (cfg.use_weight_normalization or cfg.use_mp_embedding))

    jcfg = _tiny(jax_build_config, **overrides)
    _, variables = jax_init_model(jcfg, seed=0)
    was = state_dict_from_jax({"params": variables["params"]})
    now = state_dict_from_jax({"params": jax_project_weights(variables["params"], jcfg)})
    assert {k for k in was if not torch.allclose(was[k], now[k])} == expected
    assert set(was) == set(before)


# ---------------------------------------------------------------------------
# chains, folding, parameter counts, config


def det_noise(t, shape):
    idx = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    return torch.cos(idx * 0.01 + t[0].float())


def jax_det_noise(t, shape):
    idx = jnp.arange(np.prod(shape), dtype=jnp.float32).reshape(shape)
    return jnp.cos(idx * 0.01 + t[0].astype(jnp.float32))


CHAIN_PATHS = {
    "P1-adaln-both-kernels": dict(block_kernel="pallas", attention_impl="pallas"),
    "P2-rotation_scale-attention-kernel": dict(modulation="rotation_scale", attention_impl="pallas"),
}


@pytest.mark.parametrize("overrides", list(CHAIN_PATHS.values()), ids=list(CHAIN_PATHS))
def test_cfg_chain_matches_jax(monkeypatch, overrides):
    """8 steps of the half-CFG chain at DiT-XS/2 through the standalone
    attention kernel (and the MLP half-block kernel on the adaln family)
    against the eager JAX chain, whose Pallas kernels run in interpret
    mode; gains drawn away from 0 so the modulations act."""
    jcfg = jax_build_config("DiT-XS/2", **XS2, **overrides)
    _, variables = jax_init_model(jcfg, seed=3)
    rng = np.random.default_rng(3)
    params = dict(variables["params"])
    for i in range(jcfg.depth):
        blk = dict(params[f"blocks_{i}"])
        blk["gain_msa"], blk["gain_mlp"] = (jnp.asarray(v, jnp.float32) for v in rng.uniform(0.1, 0.9, 2))
        params[f"blocks_{i}"] = blk
    variables = dict(variables, params=params)
    noise = np.random.default_rng(7).normal(size=(4, 4, 16, 16)).astype(np.float32)
    y = np.array([1, 2, 10, 10], np.int32)
    monkeypatch.setattr(
        JaxGaussianDiffusion, "p_sample_loop_fast",
        functools.partialmethod(JaxGaussianDiffusion.p_sample_loop_fast, noise_fn=jax_det_noise),
    )
    with jax.disable_jit():
        want = np.asarray(
            jax_build_sample_fn(jcfg, variables, jax_create_diffusion("8"), cfg_scale=4.0, clip_denoised=True)(
                jnp.asarray(noise), jnp.asarray(y), jax.random.PRNGKey(0)))
    cfg = build_config("DiT-XS/2", **XS2, **overrides)
    sample = build_sample_fn(cfg, state_dict_from_jax(variables, cfg), create_diffusion("8", device="cpu"),
                             cfg_scale=4.0, clip_denoised=True, noise_fn=det_noise, device="cpu")
    assert sample.run_cfg.fold_weights and sample.run_cfg.block_kernel == cfg.block_kernel
    got = sample(torch.from_numpy(noise), torch.from_numpy(y.astype(np.int64))).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_nothing_folds_without_weight_normalization():
    """With weight normalization off and ``use_mp_embedding`` on the runtime
    folds nothing: the class table stays as stored and is normalized in the
    graph at every step."""
    cfg = _tiny(build_config, use_weight_normalization=False)
    model = init_model(cfg, seed=0, device="cpu")
    sd = model.state_dict()
    sample = build_sample_fn(cfg, sd, create_diffusion("2", device="cpu"), cfg_scale=1.5, clip_denoised=True,
                             noise_fn=det_noise, device="cpu")
    assert not sample.run_cfg.fold_weights
    unfolded = build_sample_fn(cfg, sd, create_diffusion("2", device="cpu"), cfg_scale=1.5, clip_denoised=True,
                               noise_fn=det_noise, fold=False, device="cpu")
    z, y = torch.from_numpy(_inputs()[0]), torch.tensor([1, 2, 10, 10])
    torch.testing.assert_close(sample(z, y), unfolded(z, y), rtol=0, atol=0)
    table = model.y_embedder.embedding
    torch.testing.assert_close(table(torch.tensor([3])).norm(), torch.tensor(8.0), rtol=1e-3, atol=0)


@pytest.mark.parametrize("model_name", ["DiT-XS/8", "DiT-S/2"])
def test_parameter_counts_match_jax_by_family(model_name):
    """Rotation heads are narrower (``modulation_dims``: 4D rows for
    rotation, 5D for rotation_scale, 6D for adaln), so the rotation
    families have fewer parameters; each count equals the JAX package's."""
    counts = {}
    for modulation in ("adaln", "rotation", "rotation_scale"):
        jcfg = jax_build_config(model_name, **XS2, modulation=modulation)
        shapes = jax.eval_shape(lambda jcfg=jcfg: jax_init_model(jcfg, seed=0)[1]["params"])
        cfg = build_config(model_name, **XS2, modulation=modulation)
        counts[modulation] = sum(p.numel() for p in DiT(cfg).parameters())
        assert counts[modulation] == jax_param_count(shapes), modulation
        d = cfg.hidden_size
        assert sum(modulation_dims(cfg, True)) * 2 == {"adaln": 6, "rotation": 3, "rotation_scale": 5}[modulation] * d
    assert counts["rotation"] < counts["rotation_scale"] < counts["adaln"]
    d, depth = cfg.hidden_size, cfg.depth
    assert counts["adaln"] - counts["rotation_scale"] == depth * d * d + d * d // 2


def test_vanilla_model_has_the_vanilla_state_dict():
    """All flags off: biases beside the weights, a P-wide ``x_embedder``
    without the ones column, no Fourier constants, no output scales,
    zero-initialised modulation heads and output head; the JAX tree maps
    onto exactly these keys and shapes."""
    cfg = _tiny(build_config, **VANILLA)
    model = init_model(cfg, seed=0, device="cpu")
    sd = model.state_dict()
    assert sd["x_embedder.weight"].shape == (64, 8 * 8 * 4) and "x_embedder.bias" in sd
    assert not any("t_embedder.embedding" in k or "_scale." in k for k in sd)
    for name in ("blocks.0.modulation.1", "final_layer.modulation.1", "final_layer.linear"):
        assert not sd[f"{name}.weight"].any() and not sd[f"{name}.bias"].any()
    w = sd["blocks.0.attn.qkv_proj.weight"]
    assert 0 < w.abs().max() <= (6.0 / (64 + 192)) ** 0.5
    assert abs(float(sd["y_embedder.embedding.weight"].std()) - 0.02) < 5e-3
    _, variables = jax_init_model(_tiny(jax_build_config, **VANILLA), seed=0)
    carried = state_dict_from_jax(variables, cfg)
    assert {k: v.shape for k, v in carried.items()} == {k: v.shape for k, v in sd.items()}
    with torch.no_grad():
        out = model(*_torch_inputs(_inputs()))
    assert not out.any()  # adaLN-Zero: the untrained vanilla model returns 0
