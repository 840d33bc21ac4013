"""The port's training path against the reference goldens and the JAX
package: loss and gradients (tests/golden/gradients.npz, the tolerances of
tests/test_gradients.py) on the plain path and through the attention
half-block kernels, make_train_step against the JAX step with the same
draws, the schedule, the EMA math (tests/golden/ema_math.npz) and the
synthetic dataset. CPU, XS sizes; on CPU tensors the kernel wrappers run
their plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapdit_tpu.diffusion import create_diffusion as jax_create_diffusion
from mapdit_tpu.models import build_config as jax_build_config
from mapdit_tpu.training import create_optimizer as jax_create_optimizer
from mapdit_tpu.training import create_train_state as jax_create_train_state
from mapdit_tpu.training import make_train_step as jax_make_train_step
from mapdit_tpu.training import warmup_flat_invsqrt as jax_schedule
from mapdit_tpu.training.data import SyntheticLatentDataset as JaxSyntheticLatentDataset
from mapdit_tpu.training.data import batch_index_stream as jax_batch_index_stream
from mapdit_tpu_torch.diffusion import create_diffusion
from mapdit_tpu_torch.models import DiT, build_config, init_model
from mapdit_tpu_torch.training import (
    SyntheticLatentDataset,
    batch_index_stream,
    create_optimizer,
    create_train_state,
    default_schedule_steps,
    ema_key,
    make_train_step,
    warmup_flat_invsqrt,
)
from mapdit_tpu_torch.training import ema as ema_lib
from mapdit_tpu_torch.utils.weights import state_dict_from_jax

XS2 = dict(in_channels=4, input_size=16, num_classes=10)
KERNEL_PATHS = [dict(block_kernel="off"), dict(block_kernel="mega_attn", attn_bwd="pallas"),
                dict(block_kernel="mega_attn", attn_bwd="residual")]


def _ids(paths):
    return ["-".join(v for v in p.values()) for p in paths]


@pytest.mark.parametrize("overrides", KERNEL_PATHS, ids=_ids(KERNEL_PATHS))
def test_training_loss_gradients_match_golden(golden, overrides):
    """Full training-loss backward at the reference's weights and inputs:
    in-graph weight normalization, the gains' detached denominators, the
    frozen-mean VB term, the MPScale heads and the eps-MSE objective."""
    g = golden("gradients")
    sd = {k[len("sd."):]: torch.from_numpy(v) for k, v in g.items() if k.startswith("sd.")}
    model = DiT(build_config("DiT-XS/2", **XS2, **overrides))
    model.load_state_dict(sd)
    diffusion = create_diffusion("", device="cpu")
    terms = diffusion.training_losses(
        model, torch.from_numpy(g["x0"]), torch.from_numpy(g["t"]).long(),
        model_kwargs={"y": torch.from_numpy(g["y"]).long()}, noise=torch.from_numpy(g["noise"]),
    )
    loss = terms["loss"].mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(g["loss"]), rtol=1e-4)
    params = dict(model.named_parameters())
    for name in (k[len("grad."):] for k in g if k.startswith("grad.")):
        ref = g[f"grad.{name}"]
        scale = np.abs(ref).max() + 1e-8
        np.testing.assert_allclose(
            params[name].grad.numpy() / scale, ref / scale, rtol=5e-3, atol=2e-4, err_msg=name
        )


@pytest.mark.parametrize("attn_bwd", ["pallas", "residual"])
def test_mega_attn_model_gradients_match_off(attn_bwd):
    base = build_config("DiT-XS/2", **XS2)
    sd = init_model(base, seed=3, device="cpu").state_dict()
    gen = torch.Generator().manual_seed(0)
    x, t, y = torch.randn(2, 4, 16, 16, generator=gen), torch.full((2,), 100.0), torch.ones(2, dtype=torch.long)

    def grads(cfg):
        model = DiT(cfg)
        model.load_state_dict(sd)
        model(x, t, y).square().sum().backward()
        return {k: p.grad for k, p in model.named_parameters()}

    want = grads(base)
    got = grads(base.replace(block_kernel="mega_attn", attn_bwd=attn_bwd))
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=1e-4, atol=1e-4, msg=name)


# ---------------------------------------------------------------------------
# make_train_step against the JAX step


def _jax_draws(state, batch, num_timesteps):
    """The draws of the JAX step (mapdit_tpu/training/state.py:171-190)."""
    _, rng_noise, rng_t, _, rng_post = jax.random.split(state.rng, 5)
    mean = jnp.asarray(batch["mean"])
    return {
        "posterior_eps": np.asarray(jax.random.normal(rng_post, mean.shape, mean.dtype)),
        "t": np.asarray(jax.random.randint(rng_t, (mean.shape[0],), 0, num_timesteps)),
        "noise": np.asarray(jax.random.normal(rng_noise, mean.shape, mean.dtype)),
    }


def _to_jax_tree(tensors, like):
    """Port tensors (by state-dict name) as a JAX tree shaped like ``like``."""
    leaves, treedef = jax.tree_util.tree_flatten(like)
    index = state_dict_from_jax({"params": jax.tree_util.tree_unflatten(treedef, list(range(len(leaves))))})
    by_leaf = {int(v): k for k, v in index.items()}
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(tensors[by_leaf[i]].detach().numpy()) for i in range(len(leaves))]
    )


def _assert_close_in_lr(got, want, lr, bound, what):
    for name, w in want.items():
        err = np.abs(got[name].detach().numpy() - w.numpy()) / lr
        assert err.max(initial=0) < bound, (what, name, err.max())


@pytest.fixture(scope="module")
def jax_trainer():
    cfg = jax_build_config("DiT-XS/2", depth=2, **XS2)
    ds = JaxSyntheticLatentDataset(num_examples=32, num_classes=10)
    tx = jax_create_optimizer(jax_schedule(1e-2, 5, 50))
    step = jax.jit(jax_make_train_step(
        cfg, jax_create_diffusion(""), tx, stats_mean=jnp.asarray(ds.stats["mean"]),
        stats_std=jnp.asarray(ds.stats["std"]), model_train=False,
    ))
    return cfg, ds, tx, step


@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_matches_jax(jax_trainer, steps):
    """Metrics against the JAX step with the same draws (2e-4 relative);
    the update (Adam, EMA, projection) against the JAX package's own update
    functions applied to the port's gradients (1e-3 lr); and parameters and
    EMA trees against the JAX step's within 2.1 lr: Adam's first step is
    about lr * sign(g), so an element whose gradient sits at the noise floor
    of the two implementations' sums may step the other way (2 lr), and the
    projection then rescales its row slightly."""
    import optax

    from mapdit_tpu.models.dit import project_weights as jax_project_weights
    from mapdit_tpu.training import ema as jax_ema

    jcfg, ds, jtx, jstep = jax_trainer
    jstate = jax_create_train_state(jcfg, jtx, seed=0)
    cfg = build_config("DiT-XS/2", depth=2, **XS2)
    sd = state_dict_from_jax({"params": jstate.params, "constants": jstate.constants}, cfg)
    tx = create_optimizer(warmup_flat_invsqrt(1e-2, 5, 50))
    state = create_train_state(cfg, tx, seed=0, device="cpu", state_dict=sd)
    step = make_train_step(cfg, create_diffusion("", device="cpu"), tx, ds.stats["mean"], ds.stats["std"],
                           model_train=False)
    params, opt_state, emas = jstate.params, jstate.opt_state, dict(jstate.ema)
    batches = ds.batches(batch_size=8, seed=0)
    for i in range(steps):
        batch = next(batches)
        draws = _jax_draws(jstate, batch, 1000)
        jstate, jm = jstep(jstate, batch)
        m = step(state, batch, draws=draws)
        for key in ("loss", "mse", "vb", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=2e-4, err_msg=f"step {i} {key}")
        grads = _to_jax_tree({k: p.grad for k, p in state.model.named_parameters()}, params)
        updates, opt_state = jtx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        emas = {k: jax_ema.ema_update(emas[k], params, jax_ema.make_beta_fn(float(k))(jnp.asarray(i + 1)))
                for k in emas}
        params = jax_project_weights(params, jcfg)
    assert state.step == int(jstate.step) == steps
    lr = warmup_flat_invsqrt(1e-2, 5, 50)(0)
    _assert_close_in_lr(state.params, state_dict_from_jax({"params": params}), lr, 1e-3, "update")
    _assert_close_in_lr(state.params, state_dict_from_jax({"params": jstate.params}), lr, 2.1, "params")
    for key, tree in state.ema.items():
        _assert_close_in_lr(tree, state_dict_from_jax({"params": emas[key]}), lr, 1e-3, f"ema {key} update")
        _assert_close_in_lr(tree, state_dict_from_jax({"params": jstate.ema[key]}), lr, 2.1, f"ema {key}")


def test_first_step_gradients_match_jax(jax_trainer):
    """The gradients the first step takes, held tightly (2e-4 of each
    tensor's largest element) against jax.grad of the same loss."""
    from mapdit_tpu.models import DiT as JaxDiT

    jcfg, ds, jtx, _ = jax_trainer
    jstate = jax_create_train_state(jcfg, jtx, seed=0)
    batch = next(ds.batches(batch_size=8, seed=0))
    draws = _jax_draws(jstate, batch, 1000)
    x = (batch["mean"] + draws["posterior_eps"] * batch["std"] - ds.stats["mean"].reshape(1, -1, 1, 1)) / (
        ds.stats["std"].reshape(1, -1, 1, 1))
    diffusion = jax_create_diffusion("")

    def loss_fn(params):
        def model_fn(xt, tt, y):
            return JaxDiT(jcfg).apply({"params": params, "constants": jstate.constants}, xt, tt, y)

        return jnp.mean(diffusion.training_losses(
            model_fn, jnp.asarray(x), jnp.asarray(draws["t"]), model_kwargs={"y": jnp.asarray(batch["y"])},
            noise=jnp.asarray(draws["noise"]))["loss"])

    want = state_dict_from_jax({"params": jax.grad(loss_fn)(jstate.params)})
    cfg = build_config("DiT-XS/2", depth=2, **XS2)
    tx = create_optimizer(warmup_flat_invsqrt(1e-2, 5, 50))
    state = create_train_state(cfg, tx, device="cpu", state_dict=state_dict_from_jax(
        {"params": jstate.params, "constants": jstate.constants}, cfg))
    make_train_step(cfg, create_diffusion("", device="cpu"), tx, ds.stats["mean"], ds.stats["std"],
                    model_train=False)(state, batch, draws=draws)
    for name, p in state.model.named_parameters():
        w = want[name].numpy()
        scale = np.abs(w).max() + 1e-12
        np.testing.assert_allclose(p.grad.numpy() / scale, w / scale, rtol=0, atol=2e-4, err_msg=name)


def test_loss_falls_and_weights_stay_projected():
    cfg = build_config("DiT-XS/8", **XS2, block_kernel="mega_attn")
    ds = SyntheticLatentDataset(num_examples=64, num_classes=10)
    tx = create_optimizer(warmup_flat_invsqrt(1e-2, 5, 50))
    state = create_train_state(cfg, tx, seed=0, device="cpu")
    step = make_train_step(cfg, create_diffusion("", device="cpu"), tx, ds.stats["mean"], ds.stats["std"])
    batches = ds.batches(batch_size=16, seed=0)
    losses = [float(step(state, next(batches))["loss"]) for _ in range(24)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-6:]) < np.mean(losses[:6]), losses
    w = state.params["blocks.0.attn.qkv_proj.weight"].detach()
    torch.testing.assert_close(w.norm(dim=-1), torch.full((w.shape[0],), w.shape[1] ** 0.5), rtol=1e-3, atol=0)
    ema_w = state.ema[ema_key(0.05)]["blocks.0.attn.qkv_proj.weight"]
    assert not torch.allclose(ema_w, w) and torch.isfinite(ema_w).all()


def test_unported_training_options_name_their_roadmap_item():
    cfg = build_config("DiT-XS/8", **XS2)
    tx = create_optimizer(warmup_flat_invsqrt(1e-2, 5, 50))
    diffusion = create_diffusion("", device="cpu")
    with pytest.raises(NotImplementedError, match="A.6"):
        make_train_step(cfg, diffusion, tx, grad_accum=2)
    with pytest.raises(NotImplementedError, match="A.10"):
        make_train_step(cfg, diffusion, tx, timestep_sampler="loss-second-moment")
    with pytest.raises(NotImplementedError, match="A.6"):
        build_config("DiT-XS/8", **XS2, remat=True)


# ---------------------------------------------------------------------------
# schedule, EMA math, data


def test_schedule_matches_jax():
    warmup, start_decay = default_schedule_steps(15000)
    assert (warmup, start_decay) == (100, 1500)
    got, want = warmup_flat_invsqrt(1e-2, warmup, start_decay), jax_schedule(1e-2, warmup, start_decay)
    for step in [0, 1, 50, 98, 99, 100, 1000, 1499, 1500, 3000, 15000]:
        assert got(step) == float(want(step)), step


def test_ema_math_matches_golden(golden):
    g = golden("ema_math")
    np.testing.assert_allclose(ema_lib.std_to_gamma(g["stds"]), g["gammas"], rtol=1e-9)
    np.testing.assert_allclose(ema_lib.gamma_to_std(g["gammas"]), g["roundtrip"], rtol=1e-9)
    ts = np.arange(1, 2001)
    np.testing.assert_allclose(ema_lib.calc_beta(0.05, ts), g["beta_005"], rtol=1e-9)
    np.testing.assert_allclose(ema_lib.calc_beta(0.1, ts), g["beta_01"], rtol=1e-9)
    w = ema_lib.solve_weights(g["solve_ts"], ema_lib.std_to_gamma(g["solve_in_stds"]), np.array([10000.0]),
                              ema_lib.std_to_gamma(0.07))
    np.testing.assert_allclose(w, g["solve_weights"], rtol=1e-6)
    beta = ema_lib.make_beta_fn(0.05)
    assert beta(1) == 0.0
    np.testing.assert_allclose([beta(s) for s in (2, 10, 2000)], g["beta_005"][[1, 9, 1999]], rtol=1e-6)


def test_synthetic_dataset_is_bit_identical_to_jax():
    got, want = SyntheticLatentDataset(num_examples=40, num_classes=7, seed=3), JaxSyntheticLatentDataset(
        num_examples=40, num_classes=7, seed=3)
    for attr in ("labels", "means", "stds"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))
    for key in ("mean", "std"):
        np.testing.assert_array_equal(got.stats[key], want.stats[key])
    a, b = got.batches(8, seed=1), want.batches(8, seed=1)
    for _ in range(7):
        x, y = next(a), next(b)
        for key in ("mean", "std", "y"):
            np.testing.assert_array_equal(x[key], y[key])
    s1 = batch_index_stream(40, 8, seed=2, process_index=1, process_count=2, start_step=3)
    s2 = jax_batch_index_stream(40, 8, seed=2, process_index=1, process_count=2, start_step=3)
    for _ in range(6):
        np.testing.assert_array_equal(next(s1), next(s2))
