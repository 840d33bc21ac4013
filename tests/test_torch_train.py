"""The port's training path against the reference goldens and the JAX
package: loss and gradients (tests/golden/gradients.npz, the tolerances of
tests/test_gradients.py) on the plain path and through the attention
half-block kernels, make_train_step against the JAX step with the same
draws, the schedule, the EMA math (tests/golden/ema_math.npz) and the
synthetic dataset. CPU, XS sizes; on CPU tensors the kernel wrappers run
their plain versions."""

import shutil

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
# The suite runs several worker processes on a few cores, and XS-size models
# gain nothing from a wide intra-op pool: with the default (one thread per
# core in every worker) the training tests oversubscribe the machine.
torch.set_num_threads(2)
KERNEL_PATHS = [dict(block_kernel="off"), dict(block_kernel="mega_attn", attn_bwd="pallas"),
                dict(block_kernel="mega_attn", attn_bwd="residual")]


@pytest.fixture(autouse=True)
def _drop_tmp_path(tmp_path):
    """Each test's files go when it ends (a failing test's too): the tier-1
    run's tests write GBs of checkpoints and weights, and pytest keeps the
    last three runs' directories, so they filled the disk."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


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
    """What training still lacks raises with its ROADMAP item (the CLI's
    flags: test_torch_package.py); gradient accumulation, the
    loss-second-moment sampler and remat (test_torch_remat_scan.py) no
    longer do."""
    cfg = build_config("DiT-XS/8", **XS2)
    tx = create_optimizer(warmup_flat_invsqrt(1e-2, 5, 50))
    diffusion = create_diffusion("", device="cpu")
    make_train_step(cfg, diffusion, tx, grad_accum=2)
    make_train_step(cfg, diffusion, tx, timestep_sampler="loss-second-moment")
    with pytest.raises(ValueError, match="timestep sampler"):
        make_train_step(cfg, diffusion, tx, timestep_sampler="second-loss")


# ---------------------------------------------------------------------------
# gradient accumulation, clipping, the loss-second-moment sampler, the
# hand-over of a JAX TrainState


def _port_state(jstate, cfg, tx, **kw):
    sd = state_dict_from_jax({"params": jstate.params, "constants": jstate.constants}, cfg)
    return create_train_state(cfg, tx, seed=0, device="cpu", state_dict=sd, **kw)


def _params(state):
    return {k: v.detach().clone() for k, v in state.params.items()}


def test_grad_accum_matches_jax_and_unaccumulated(jax_trainer):
    """grad_accum=4 against the JAX step with grad_accum=4 (metrics 2e-4
    relative, parameters within 2.1 lr, see test_train_step_matches_jax) and
    against the port's own grad_accum=1 on the same draws: the averaged
    gradients agree to 1e-5 of each tensor's largest element (f32 sums in
    another order), grad_norm to 1e-5 relative, and the parameters after the
    step to 1e-5 absolute wherever the gradient is above that noise floor
    (Adam's first update is lr * g / (|g| + eps): below the floor its sign,
    and so the update, is not determined)."""
    jcfg, ds, jtx, _ = jax_trainer
    jstep = jax.jit(jax_make_train_step(
        jcfg, jax_create_diffusion(""), jtx, stats_mean=jnp.asarray(ds.stats["mean"]),
        stats_std=jnp.asarray(ds.stats["std"]), model_train=False, grad_accum=4,
    ))
    jstate = jax_create_train_state(jcfg, jtx, seed=0)
    cfg = build_config("DiT-XS/2", depth=2, **XS2)
    tx = create_optimizer(warmup_flat_invsqrt(1e-2, 5, 50))
    batch = next(ds.batches(batch_size=8, seed=0))
    draws = _jax_draws(jstate, batch, 1000)
    diffusion = create_diffusion("", device="cpu")
    out = {}
    for accum in (1, 4):
        state = _port_state(jstate, cfg, tx)
        step = make_train_step(cfg, diffusion, tx, ds.stats["mean"], ds.stats["std"], model_train=False,
                               grad_accum=accum)
        m = step(state, batch, draws=draws)
        out[accum] = (m, {k: p.grad.clone() for k, p in state.model.named_parameters()}, _params(state), state)
    jstate2, jm = jstep(jstate, batch)
    m1, g1, p1, _ = out[1]
    m4, g4, p4, state4 = out[4]
    for key in ("loss", "mse", "vb", "grad_norm"):
        np.testing.assert_allclose(float(m4[key]), float(jm[key]), rtol=2e-4, err_msg=key)
        np.testing.assert_allclose(float(m4[key]), float(m1[key]), rtol=1e-5, err_msg=key)
    lr = warmup_flat_invsqrt(1e-2, 5, 50)(0)
    _assert_close_in_lr(state4.params, state_dict_from_jax({"params": jstate2.params}), lr, 2.1, "params vs JAX")
    for name in g1:
        scale = float(g1[name].abs().max()) + 1e-12
        np.testing.assert_allclose(g4[name].numpy() / scale, g1[name].numpy() / scale, rtol=0, atol=1e-5, err_msg=name)
        settled = g1[name].abs() > 1e-5 * scale + 1e-7
        np.testing.assert_allclose(p4[name][settled].numpy(), p1[name][settled].numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
    with pytest.raises(ValueError, match="divide"):
        make_train_step(cfg, diffusion, tx, ds.stats["mean"], ds.stats["std"], grad_accum=3)(state4, batch, draws=draws)


def test_grad_clip_matches_optax(jax_trainer):
    """The clipped gradients are optax.clip_by_global_norm of the unclipped
    ones (1e-6 relative: clip / max(norm, clip) against (g / norm) * clip),
    grad_norm stays the unclipped norm, a clip above the norm changes
    nothing, and the step agrees with the JAX step built with the same
    grad_clip (metrics 2e-4, parameters within 2.1 lr)."""
    import optax

    jcfg, ds, _, _ = jax_trainer
    cfg = build_config("DiT-XS/2", depth=2, **XS2)
    diffusion = create_diffusion("", device="cpu")
    schedule = warmup_flat_invsqrt(1e-2, 5, 50)
    jstate = jax_create_train_state(jcfg, jax_create_optimizer(jax_schedule(1e-2, 5, 50)), seed=0)
    batch = next(ds.batches(batch_size=8, seed=0))
    draws = _jax_draws(jstate, batch, 1000)

    def run(clip):
        tx = create_optimizer(schedule, grad_clip=clip)
        state = _port_state(jstate, cfg, tx)
        m = make_train_step(cfg, diffusion, tx, ds.stats["mean"], ds.stats["std"], model_train=False)(
            state, batch, draws=draws)
        return m, {k: p.grad.clone() for k, p in state.model.named_parameters()}, state

    m0, g0, _ = run(None)
    norm = float(m0["grad_norm"])
    clip = 0.25 * norm
    m1, g1, state1 = run(clip)
    assert float(m1["grad_norm"]) == norm
    tree = {k: jnp.asarray(v.numpy()) for k, v in g0.items()}
    want, _ = optax.clip_by_global_norm(clip).update(tree, optax.EmptyState())
    for name in g0:
        np.testing.assert_allclose(g1[name].numpy(), np.asarray(want[name]), rtol=1e-6, atol=1e-12, err_msg=name)
    _, g2, _ = run(4.0 * norm)
    for name in g0:
        assert torch.equal(g2[name], g0[name]), name
    assert create_optimizer(schedule, grad_clip=0.0).grad_clip is None

    jtx = jax_create_optimizer(jax_schedule(1e-2, 5, 50), grad_clip=clip)
    jstep = jax.jit(jax_make_train_step(jcfg, jax_create_diffusion(""), jtx, stats_mean=jnp.asarray(ds.stats["mean"]),
                                        stats_std=jnp.asarray(ds.stats["std"]), model_train=False))
    jstate_c = jax_create_train_state(jcfg, jtx, seed=0)
    jstate2, jm = jstep(jstate_c, batch)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(jm["grad_norm"]), rtol=2e-4)
    _assert_close_in_lr(state1.params, state_dict_from_jax({"params": jstate2.params}), schedule(0), 2.1, "params")


def test_loss_second_moment_sampler_matches_jax(jax_trainer):
    """The resampler's history update is the JAX package's sequential fold
    bit for bit (repeated timesteps in a batch, rows that overflow), its
    weights agree to 1e-6 relative before and after warm-up, and a train
    step with the sampler on agrees with the JAX step on the timesteps the
    JAX step drew (loss 2e-4 relative, the new history rows 2e-4)."""
    from mapdit_tpu.diffusion.timestep_sampler import LossSecondMomentResampler as JaxResampler
    from mapdit_tpu_torch.diffusion.timestep_sampler import LossSecondMomentResampler, UniformSampler

    rng = np.random.default_rng(0)
    jr, tr = JaxResampler(12, 4), LossSecondMomentResampler(12, 4)
    js, ts = jr.init_state(), tr.init_state("cpu")
    for it in range(8):
        t = rng.integers(0, 12 if it % 2 else 3, 30)
        losses = rng.random(30).astype(np.float32)
        js = jr.update_with_local_losses(js, jnp.asarray(t), jnp.asarray(losses))
        ts = tr.update_with_local_losses(ts, torch.from_numpy(t), torch.from_numpy(losses))
        np.testing.assert_array_equal(ts.history.numpy(), np.asarray(js.history))
        np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
        np.testing.assert_allclose(tr.weights(ts).numpy(), np.asarray(jr.weights(js)), rtol=1e-6)
    assert bool((ts.counts == 4).all())
    gen = torch.Generator().manual_seed(0)
    t, w = tr.sample(ts, gen, 64)
    p = tr.weights(ts)
    torch.testing.assert_close(w, 1.0 / (12 * (p / p.sum())[t]))
    _, jw = jr.sample(js, jax.random.PRNGKey(0), 64)
    t_given, w_given = tr.sample(ts, gen, 64, t=t)
    assert torch.equal(t_given, t) and torch.equal(w_given, w)
    assert np.asarray(jw).shape == (64,)
    t_u, w_u = UniformSampler(12).sample(gen, 5)
    assert t_u.shape == (5,) and bool((w_u == 1).all())

    jcfg, ds, jtx, _ = jax_trainer
    jstep = jax.jit(jax_make_train_step(
        jcfg, jax_create_diffusion(""), jtx, stats_mean=jnp.asarray(ds.stats["mean"]),
        stats_std=jnp.asarray(ds.stats["std"]), model_train=False, timestep_sampler="loss-second-moment",
    ))
    jstate = jax_create_train_state(jcfg, jtx, seed=0, timestep_sampler="loss-second-moment")
    cfg = build_config("DiT-XS/2", depth=2, **XS2)
    tx = create_optimizer(warmup_flat_invsqrt(1e-2, 5, 50))
    state = _port_state(jstate, cfg, tx, timestep_sampler="loss-second-moment")
    step = make_train_step(cfg, create_diffusion("", device="cpu"), tx, ds.stats["mean"], ds.stats["std"],
                           model_train=False, timestep_sampler="loss-second-moment")
    batch = next(ds.batches(batch_size=8, seed=0))
    draws = _jax_draws(jstate, batch, 1000)
    _, _, rng_t, _, _ = jax.random.split(jstate.rng, 5)
    draws["t"] = np.asarray(JaxResampler(1000).sample(jstate.sampler_state, rng_t, 8)[0])
    jstate2, jm = jstep(jstate, batch)
    m = step(state, batch, draws=draws)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-4)
    np.testing.assert_array_equal(state.sampler_state.counts.numpy(), np.asarray(jstate2.sampler_state.counts))
    np.testing.assert_allclose(state.sampler_state.history.numpy(), np.asarray(jstate2.sampler_state.history),
                               rtol=2e-4, atol=1e-6)


def _jax_state_trees(jstate):
    """A JAX TrainState as the numpy trees train_state_from_jax takes."""
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    adam = jstate.opt_state[0]
    return dict(params=to_np(jstate.params), constants=to_np(jstate.constants), mu=to_np(adam.mu), nu=to_np(adam.nu),
                count=int(adam.count), ema={k: to_np(v) for k, v in jstate.ema.items()}, step=int(jstate.step))


def test_train_state_from_jax_continues_the_run(jax_trainer):
    """Two JAX steps, the state handed over, then one more step in both
    packages on the same draws: the handed-over state equals the JAX one
    exactly, and after the third step the parameters and both EMA trees agree
    within 0.1 of the step's learning rate, 6e-4 absolute (a fresh first step
    is held to 2.1 lr in test_train_step_matches_jax because the sign of
    Adam's update is open at the gradients' noise floor; the carried moments
    settle it, and what is left is the two packages' gradient rounding
    through m / sqrt(v): 1.3e-4 at most here, on single elements of the
    modulation heads, whose gradients are smallest)."""
    from mapdit_tpu_torch.utils.weights import train_state_from_jax

    jcfg, ds, jtx, jstep = jax_trainer
    jstate = jax_create_train_state(jcfg, jtx, seed=0)
    batches = ds.batches(batch_size=8, seed=0)
    for _ in range(2):
        jstate, _ = jstep(jstate, next(batches))
    cfg = build_config("DiT-XS/2", depth=2, **XS2)
    tx = create_optimizer(warmup_flat_invsqrt(1e-2, 5, 50))
    state = train_state_from_jax(cfg, tx, **_jax_state_trees(jstate), device="cpu")
    assert state.step == 2 and set(state.ema) == set(jstate.ema)
    for name, w in state_dict_from_jax({"params": jstate.params}).items():
        assert torch.equal(state.params[name].detach(), w), name
    for key in state.ema:
        for name, w in state_dict_from_jax({"params": jstate.ema[key]}).items():
            assert torch.equal(state.ema[key][name], w), (key, name)
    batch = next(batches)
    draws = _jax_draws(jstate, batch, 1000)
    jstate3, jm = jstep(jstate, batch)
    m = make_train_step(cfg, create_diffusion("", device="cpu"), tx, ds.stats["mean"], ds.stats["std"],
                        model_train=False)(state, batch, draws=draws)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-4)
    assert state.step == int(jstate3.step) == 3
    lr = warmup_flat_invsqrt(1e-2, 5, 50)(2)
    _assert_close_in_lr(state.params, state_dict_from_jax({"params": jstate3.params}), lr, 0.1, "params")
    for key in state.ema:
        _assert_close_in_lr(state.ema[key], state_dict_from_jax({"params": jstate3.ema[key]}), lr, 0.1, f"ema {key}")


def test_convert_jax_checkpoint_roundtrips_a_jax_run(tmp_path):
    """tools/convert_jax_checkpoint.py: the msgpack checkpoint of a 2-step
    JAX run (DiT-XS/8 with gradient clipping, so the Adam state sits inside
    an optax chain) becomes a port checkpoint that restores, bit for bit, to
    the JAX state (parameters, Adam moments and count, EMA trees, step), and
    that the port's CLI resumes from."""
    import importlib.util
    import pathlib

    from mapdit_tpu.training.checkpoint import save_state as jax_save_state
    from mapdit_tpu.utils import save_config as jax_save_config
    from mapdit_tpu_torch import train as train_cli
    from mapdit_tpu_torch.training import checkpoint as ckpt

    spec = importlib.util.spec_from_file_location(
        "convert_jax_checkpoint", pathlib.Path(__file__).resolve().parents[1] / "tools" / "convert_jax_checkpoint.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    jcfg = jax_build_config("DiT-XS/8", **XS2)
    ds = JaxSyntheticLatentDataset(num_examples=32, num_classes=10)
    jtx = jax_create_optimizer(jax_schedule(1e-2, 5, 50), grad_clip=1.0)
    jstep = jax.jit(jax_make_train_step(jcfg, jax_create_diffusion(""), jtx, stats_mean=jnp.asarray(ds.stats["mean"]),
                                        stats_std=jnp.asarray(ds.stats["std"])))
    jstate = jax_create_train_state(jcfg, jtx, seed=0)
    batches = ds.batches(batch_size=8, seed=0)
    for _ in range(2):
        jstate, _ = jstep(jstate, next(batches))
    jax_dir, out_dir = tmp_path / "jax" / "000-DiT-XS-8", tmp_path / "torch" / "000-DiT-XS-8"
    (jax_dir / "checkpoints").mkdir(parents=True)
    jax_save_config(str(jax_dir), dict(model="DiT-XS/8", **XS2, lr=1e-2, num_steps=50, num_lin_warmup=5,
                                       start_decay=50, seed=0, grad_clip=1.0, block_kernel="auto",
                                       stats_mean=[float(v) for v in ds.stats["mean"]]))
    src = jax_save_state(str(jax_dir), 2, jstate)
    assert tool.main(["--checkpoint", src, "--output-dir", str(out_dir)]) == 0
    dst = ckpt.latest_checkpoint(str(out_dir))
    assert dst.endswith("checkpoints/0000002.pt") and (out_dir / "config.yaml").exists()

    cfg = build_config("DiT-XS/8", **XS2)
    tx = create_optimizer(warmup_flat_invsqrt(1e-2, 5, 50), grad_clip=1.0)
    state = ckpt.restore_state(dst, create_train_state(cfg, tx, seed=3, device="cpu"))
    assert state.step == 2
    adam = jstate.opt_state[1][0]
    named = dict(state.model.named_parameters())
    for tree, pick in ((jstate.params, lambda n: named[n].detach()),
                       (adam.mu, lambda n: state.optimizer.state[named[n]]["exp_avg"]),
                       (adam.nu, lambda n: state.optimizer.state[named[n]]["exp_avg_sq"]),
                       *((jstate.ema[k], lambda n, k=k: state.ema[k][n]) for k in jstate.ema)):
        for name, w in state_dict_from_jax({"params": tree}).items():
            assert torch.equal(pick(name), w), name
    assert all(float(s["step"]) == int(adam.count) == 2 for s in state.optimizer.state.values())
    exp = train_cli.main(train_cli.build_parser().parse_args([
        "--device", "cpu", "--data-path", "synthetic:32", "--results-dir", str(tmp_path / "resumed"), "--model",
        "DiT-XS/8", "--num-classes", "10", "--batch-size", "8", "--num-steps", "4", "--log-every", "1",
        "--ckpt-every", "100", "--ema-snapshot-every", "0", "--grad-clip", "1.0", "--resume", str(out_dir)]))
    log = open(f"{exp}/log.txt").read()
    assert "at step 2" in log and "(step=0000004)" in log


# ---------------------------------------------------------------------------
# checkpoints and the EMA ledger


def _small_state(**kw):
    cfg = build_config("DiT-XS/8", **XS2)
    ds = SyntheticLatentDataset(num_examples=32, num_classes=10)
    tx = create_optimizer(warmup_flat_invsqrt(1e-2, 5, 50))
    state = create_train_state(cfg, tx, seed=0, device="cpu", **kw)
    step = make_train_step(cfg, create_diffusion("", device="cpu"), tx, ds.stats["mean"], ds.stats["std"], **kw)
    return cfg, tx, ds, state, step


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}/{i}")
    else:
        assert a == b, path


@pytest.mark.parametrize("sampler", ["uniform", "loss-second-moment"])
def test_checkpoint_roundtrip_is_bit_exact(tmp_path, sampler):
    """save_state / restore_state carry the whole TrainState bit for bit
    (model, Adam moments and counts, EMA trees, step, generator, sampler
    history), and the restored run takes the same next steps."""
    from mapdit_tpu_torch.training import checkpoint as ckpt

    cfg, tx, ds, state, step = _small_state(timestep_sampler=sampler)
    batches = ds.batches(batch_size=8, seed=0)
    for _ in range(3):
        step(state, next(batches))
    path = ckpt.save_state(str(tmp_path), state.step, state)
    assert path.endswith("checkpoints/0000003.pt") and ckpt.latest_checkpoint(str(tmp_path)) == path
    saved = ckpt.map_tensors(ckpt.state_tree(state), torch.clone)
    fresh = create_train_state(cfg, tx, seed=1, device="cpu", timestep_sampler=sampler)
    restored = ckpt.restore_state(path, fresh)
    _assert_trees_equal(ckpt.state_tree(restored), saved)
    rest = [next(batches) for _ in range(2)]
    for b in rest:
        want, got = step(state, b), step(restored, b)
        assert torch.equal(want["loss"], got["loss"])
    _assert_trees_equal(ckpt.state_tree(restored), ckpt.state_tree(state))
    other = create_train_state(cfg, tx, seed=1, device="cpu",
                               timestep_sampler="uniform" if sampler != "uniform" else "loss-second-moment")
    with pytest.raises(ValueError, match="sampler"):
        ckpt.restore_state(path, other)


def test_checkpoint_writes_are_atomic_and_async_errors_surface(tmp_path):
    """A partial ``.tmp`` write is invisible to latest_checkpoint; the
    background saver writes the same file as save_state from a snapshot
    taken at submit time; a failed background write raises at close()."""
    from mapdit_tpu_torch.training import checkpoint as ckpt

    cfg, tx, ds, state, step = _small_state()
    exp = str(tmp_path)
    assert ckpt.latest_checkpoint(exp) is None
    ckpt.save_state(exp, 2, state)
    (tmp_path / "checkpoints" / "0000009.pt.tmp").write_bytes(b"partial")
    assert ckpt.latest_checkpoint(exp) == ckpt.checkpoint_path(exp, 2)

    saver = ckpt.AsyncStateSaver()
    before = ckpt.map_tensors(ckpt.state_tree(state), torch.clone)
    path = saver.save(exp, 5, state)
    step(state, next(ds.batches(batch_size=8, seed=0)))  # the live state moves on while the write runs
    saver.close()
    assert ckpt.latest_checkpoint(exp) == path
    _assert_trees_equal(torch.load(path, weights_only=True), before)

    writer = ckpt.AsyncTreeWriter()

    def fail(host):
        raise OSError("disk full")

    writer.submit({"w": torch.ones(2)}, fail)
    with pytest.raises(OSError, match="disk full"):
        writer.close()
    writer.submit({"w": torch.ones(2)}, fail)
    writer._thread.join(timeout=30)
    with pytest.raises(OSError, match="disk full"):
        writer.submit({"w": torch.ones(2)}, lambda host: None)
    seen = []
    for i in range(5):  # more submits than snapshots may be in flight
        writer.submit({"w": torch.full((2,), float(i))}, lambda host: seen.append(float(host["w"][0])))
    writer.close()
    assert seen == [0.0, 1.0, 2.0, 3.0, 4.0]


def test_posthoc_ema_matches_golden(golden, tmp_path):
    """calculate_posthoc_ema over a ledger at the golden's snapshot times and
    stds reconstructs std 0.07 with the golden's least-squares weights
    (1e-3 relative: the snapshots are fp16 on disk), returns an exact
    snapshot as it is, and reads the ledger's names."""
    g = golden("ema_math")
    ema_dir = str(tmp_path / "ema")
    rng = np.random.default_rng(0)
    snaps = []
    for std, t in zip(g["solve_in_stds"], g["solve_ts"]):
        tree = {"blocks.0.attn.qkv_proj.weight": torch.from_numpy(rng.normal(size=(6, 4)).astype(np.float32)),
                "final_layer.gain_mod": torch.tensor(float(rng.normal()))}
        path = ema_lib.save_snapshot(ema_dir, float(std), int(t), tree)
        assert path.endswith(f"{std:.3f}_{int(t):07d}.npz")
        snaps.append(tree)
    (tmp_path / "ema" / "0.050_0020000.npz.tmp.npz").write_bytes(b"partial")
    listed = ema_lib.list_snapshots(ema_dir)
    assert len(listed) == 10 and listed[0][:2] == (0.05, 1000)
    got = ema_lib.calculate_posthoc_ema(0.07, ema_dir)
    for name in snaps[0]:
        want = sum(w * s[name].numpy().astype(np.float16).astype(np.float64)
                   for w, s in zip(g["solve_weights"].ravel(), snaps))
        assert got[name].dtype == np.float32 and got[name].shape == snaps[0][name].shape
        np.testing.assert_allclose(got[name], want, rtol=1e-3, atol=1e-4, err_msg=name)
    exact = ema_lib.calculate_posthoc_ema(0.1, ema_dir)
    np.testing.assert_array_equal(exact["final_layer.gain_mod"],
                                  snaps[-1]["final_layer.gain_mod"].numpy().astype(np.float16).astype(np.float32))
    with pytest.raises(FileNotFoundError):
        (tmp_path / "empty").mkdir()
        ema_lib.calculate_posthoc_ema(0.07, str(tmp_path / "empty"))


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
