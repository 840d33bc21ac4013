"""The port's progressive distillation (mapdit_tpu_torch/diffusion/distill.py,
python -m mapdit_tpu_torch.distill) and the consumers of a distilled student,
on the CPU at XS sizes.

Held to the live JAX package: the grids (uniform and karras), the
odd-length refusal, the ``diffusion_from_map`` tables (1e-6),
``student_diffusion_from_config``; then, on one DiT-XS/2 teacher built by
the JAX package (depth 2, gains drawn) and carried across by
``state_dict_from_jax``, ``make_teacher_fn`` at cfg 1.0 and 1.5,
``two_step_target`` and ``make_distill_losses`` per sample (f32, rel L2
1e-5), and one distill train step against JAX's on the same t and noise (the
metrics, the gradients and the update at tests/test_torch_train.py's
tolerances). The port alone: the twin of
tests/test_distill.py's learning test, the teacher bit-identical after
student steps, the CLI (two stages, a chained run, both refusals), and
``sample``, ``sample_fid``, ``sample_ema`` and the server on a student."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mapdit_tpu.diffusion import distill as jd
from mapdit_tpu.models import DiT as JaxDiT
from mapdit_tpu.models import build_config as jax_build_config
from mapdit_tpu.models import init_model as jax_init_model
from mapdit_tpu.training import create_optimizer as jax_create_optimizer
from mapdit_tpu.training import create_train_state as jax_create_train_state
from mapdit_tpu.training import make_train_step as jax_make_train_step
from mapdit_tpu_torch import distill, sample, sample_ema, sample_fid, serve, train
from mapdit_tpu_torch.diffusion import create_diffusion
from mapdit_tpu_torch.diffusion import distill as td
from mapdit_tpu_torch.models import build_config, init_model
from mapdit_tpu_torch.models.dit import project_weights
from mapdit_tpu_torch.runtime import build_sample_fn
from mapdit_tpu_torch.training import create_optimizer, create_train_state, make_train_step
from mapdit_tpu_torch.utils.experiment import load_config, save_config
from mapdit_tpu_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)  # as tests/test_torch_train.py: workers share the cores
CPU = torch.device("cpu")
XS2 = dict(in_channels=4, input_size=16, num_classes=10)
REL = 1e-5  # f32 rel L2 of the distillation functions against JAX's


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(autouse=True)
def _drop_tmp_path(tmp_path):
    """Each test's files go when it ends (a failing test's too): the tier-1
    run's tests write GBs of checkpoints and weights, and pytest keeps the
    last three runs' directories, so they filled the disk."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


# ---------------------------------------------------------------------------
# grids and tables


@pytest.mark.parametrize("schedule", ["uniform", "karras"])
@pytest.mark.parametrize("base_steps", [8, 16, 32, 64])
def test_grids_match_jax(base_steps, schedule):
    m = td.base_timestep_map(base_steps, schedule)
    assert m == jd.base_timestep_map(base_steps, schedule) and m == sorted(m) and len(m) == base_steps
    rounds = 0
    while len(m) % 2 == 0:
        rounds += 1
        m = td.halved_map(m)
        assert m == jd.halved_map(jd.distilled_map(base_steps, rounds - 1, schedule))
        assert m == td.distilled_map(base_steps, rounds, schedule) == jd.distilled_map(base_steps, rounds, schedule)
    assert m[-1] == td.base_timestep_map(base_steps, schedule)[-1]  # the chain's start kept


def test_odd_length_refused_as_in_jax():
    for halved in (td.halved_map, jd.halved_map):
        with pytest.raises(ValueError, match="odd-length"):
            halved(list(range(7)))
    with pytest.raises(ValueError, match="odd-length"):
        td.distilled_map(12, 3)


@pytest.mark.parametrize("rounds", [0, 1, 3])
@pytest.mark.parametrize("schedule", ["uniform", "karras"])
def test_diffusion_from_map_tables_match_jax(schedule, rounds):
    m = td.distilled_map(16, rounds, schedule)
    got, want = td.diffusion_from_map(m, device=CPU), jd.diffusion_from_map(m)
    assert got.num_timesteps == want.num_timesteps == len(m)
    assert got.timestep_map.tolist() == np.asarray(want.timestep_map).tolist() == m
    for name in ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_recip_alphas_cumprod",
                 "sqrt_recipm1_alphas_cumprod", "posterior_log_variance_clipped", "log_betas"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=1e-6,
                                   err_msg=name)
    # acp at index i is the original process's at m[i]
    full = create_diffusion("", device=CPU)
    np.testing.assert_allclose(got.alphas_cumprod.numpy(), full.alphas_cumprod.numpy()[m], rtol=1e-6)


def test_student_diffusion_from_config_roundtrip():
    args = {"distill_base_steps": 32, "distill_base_schedule": "karras", "distill_rounds": 2}
    got, want = td.student_diffusion_from_config(args, device=CPU), jd.student_diffusion_from_config(args)
    assert got.num_timesteps == want.num_timesteps == 8
    assert got.timestep_map.tolist() == np.asarray(want.timestep_map).tolist() == td.distilled_map(32, 2, "karras")
    np.testing.assert_allclose(got.alphas_cumprod.numpy(), np.asarray(want.alphas_cumprod), rtol=1e-6)


# ---------------------------------------------------------------------------
# the loss on one teacher carried across


@pytest.fixture(scope="module")
def teacher():
    """A DiT-XS/2 (depth 2) of the JAX package's init with its block gains
    drawn away from zero, the port's copy of it, the grids of one stage
    (8 -> 4 steps) in both packages, and inputs drawn with numpy."""
    jcfg = jax_build_config("DiT-XS/2", depth=2, compute_dtype="float32", **XS2)
    _, variables = jax_init_model(jcfg, seed=5)
    rng = np.random.default_rng(5)
    params = dict(variables["params"])
    for i in range(jcfg.depth):
        blk = dict(params[f"blocks_{i}"])
        blk["gain_msa"], blk["gain_mlp"] = (jnp.asarray(v, jnp.float32) for v in rng.uniform(0.2, 0.8, 2))
        params[f"blocks_{i}"] = blk
    variables = dict(variables, params=params)
    cfg = build_config("DiT-XS/2", depth=2, compute_dtype="float32", **XS2)
    sd = state_dict_from_jax(variables, cfg)
    model = init_model(cfg, device=CPU)
    model.load_state_dict(sd)
    m = td.base_timestep_map(8)
    diffusions = {
        "port": (td.diffusion_from_map(m, device=CPU), td.diffusion_from_map(td.halved_map(m), device=CPU)),
        "jax": (jd.diffusion_from_map(m), jd.diffusion_from_map(jd.halved_map(m))),
    }
    n = 8
    inputs = {
        "x0": rng.normal(size=(n, 4, 16, 16)).astype(np.float32),
        "noise": rng.normal(size=(n, 4, 16, 16)).astype(np.float32),
        "t": np.arange(n) % 4,  # every student index, twice
        "y": rng.integers(0, 10, n),
    }
    return dict(jcfg=jcfg, variables=variables, cfg=cfg, sd=sd, model=model, diffusions=diffusions, inputs=inputs)


def _teacher_fns(teacher, cfg_scale):
    jfn = jd.make_teacher_fn(JaxDiT(teacher["jcfg"]), teacher["variables"]["params"], teacher["variables"]["constants"],
                             10, cfg_scale)
    return td.make_teacher_fn(teacher["model"], 10, cfg_scale), jfn


def _both(inputs, *keys):
    """Each input as (torch tensor, jax array)."""
    out = []
    for key in keys:
        v = inputs[key]
        out.append((torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i" else v), jnp.asarray(v)))
    return out


@pytest.mark.parametrize("cfg_scale", [1.0, 1.5])
def test_make_teacher_fn_matches_jax(teacher, cfg_scale):
    fn, jfn = _teacher_fns(teacher, cfg_scale)
    (x, jx), (y, jy) = _both(teacher["inputs"], "x0", "y")
    t = np.linspace(5.0, 995.0, x.shape[0]).astype(np.float32)
    got = fn(x, torch.from_numpy(t), y)
    assert not got.requires_grad
    assert rel(got.numpy(), jfn(jx, jnp.asarray(t), jy)) <= REL


@pytest.mark.parametrize("cfg_scale", [1.0, 1.5])
def test_two_step_target_and_losses_match_jax_per_sample(teacher, cfg_scale):
    fn, jfn = _teacher_fns(teacher, cfg_scale)
    (d_t, d_s), (jd_t, jd_s) = teacher["diffusions"]["port"], teacher["diffusions"]["jax"]
    (x0, jx0), (noise, jnoise), (t, jt), (y, jy) = _both(teacher["inputs"], "x0", "noise", "t", "y")
    x_t = d_s.q_sample(x0, t, noise)
    target = td.two_step_target(d_t, d_s, fn, x_t, t, {"y": y})
    want = jd.two_step_target(jd_t, jd_s, jfn, jd_s.q_sample(jx0, jt, jnoise), jt, {"y": jy})
    assert all(rel(target[i].numpy(), want[i]) <= REL for i in range(x0.shape[0]))

    # the student is the teacher's copy: the losses per sample
    def model_fn(xt, tt, y):
        return teacher["model"](xt, tt, y)

    def jmodel_fn(xt, tt, y):
        return JaxDiT(teacher["jcfg"]).apply(teacher["variables"], xt, tt, y)

    got = td.make_distill_losses(d_t, d_s, fn)(model_fn, x0, t, {"y": y}, noise)
    jgot = jd.make_distill_losses(jd_t, jd_s, jfn)(jmodel_fn, jx0, jt, {"y": jy}, jnoise)
    for key in ("loss", "mse"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(jgot[key]), rtol=REL, err_msg=key)
    with pytest.raises(ValueError, match="pre-drawn noise"):
        td.make_distill_losses(d_t, d_s, fn)(model_fn, x0, t, {"y": y})


def test_two_step_target_lands_where_the_teacher_pair_lands(teacher):
    """One student DDIM step whose pred_xstart is the target lands on the
    teacher pair's result at every student index, the last (a_s = 1)
    included, through the port's own ddim_sample."""
    fn, _ = _teacher_fns(teacher, 1.5)
    d_t, d_s = teacher["diffusions"]["port"]
    (x0, _), (noise, _), (t, _), (y, _) = _both(teacher["inputs"], "x0", "noise", "t", "y")
    x_t = d_s.q_sample(x0, t, noise)
    target = td.two_step_target(d_t, d_s, fn, x_t, t, {"y": y})
    eps = d_s._predict_eps_from_xstart(x_t, t, target)
    one = d_s.ddim_sample(lambda xx, tt, y: torch.cat([eps, torch.zeros_like(eps)], 1), x_t, t, clip_denoised=False,
                          model_kwargs={"y": y})["sample"]
    two = d_t.ddim_sample(fn, x_t, 2 * t + 1, clip_denoised=False, model_kwargs={"y": y})["sample"]
    two = d_t.ddim_sample(fn, two, 2 * t, clip_denoised=False, model_kwargs={"y": y})["sample"]
    assert rel(one.numpy(), two.numpy()) <= REL


def _to_jax_tree(tensors, like):
    """Port tensors (by state-dict name) as a JAX tree shaped like ``like``."""
    leaves, treedef = jax.tree_util.tree_flatten(like)
    index = state_dict_from_jax({"params": jax.tree_util.tree_unflatten(treedef, list(range(len(leaves))))})
    by_leaf = {int(v): k for k, v in index.items()}
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(tensors[by_leaf[i]].detach().numpy()) for i in range(len(leaves))])


def test_distill_train_step_matches_jax(teacher):
    """One make_train_step(losses_fn=make_distill_losses(...)) step of each
    package from the same teacher copy on the same t and noise. The held
    tolerances are tests/test_torch_train.py's: the metrics against the
    jitted JAX step at 2e-4 relative, the gradients against jax.grad of the
    same loss at 2e-4 of each tensor's largest element, and the update
    (parameters and both EMAs) against the JAX package's own Adam, EMA and
    projection applied to the port's gradients within 1e-3 lr. (Against the
    JAX step's parameters element for element the plain step's 2.1 lr
    reads 2.19 lr on one qkv element here: Adam's first step divides g by
    |g| + 1e-8, so an element at the gradients' noise floor moves by up to
    2 lr either way, and the projection then rescales its row.)"""
    from mapdit_tpu.models.dit import project_weights as jax_project_weights
    from mapdit_tpu.training import ema as jax_ema

    (d_t, d_s), (jd_t, jd_s) = teacher["diffusions"]["port"], teacher["diffusions"]["jax"]
    fn, jfn = _teacher_fns(teacher, 1.5)
    jlosses = jd.make_distill_losses(jd_t, jd_s, jfn)
    lr = 1e-3
    jtx = jax_create_optimizer(optax.constant_schedule(lr))
    jstate = jax_create_train_state(teacher["jcfg"], jtx, seed=1)
    params0, constants = teacher["variables"]["params"], teacher["variables"]["constants"]
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.array, params0), constants=constants,
                            ema={k: jax.tree_util.tree_map(jnp.array, params0) for k in jstate.ema})
    jstep = jax.jit(jax_make_train_step(teacher["jcfg"], jd_s, jtx, losses_fn=jlosses, model_train=False))
    batch = {"x": teacher["inputs"]["x0"], "y": teacher["inputs"]["y"].astype(np.int32)}
    _, rng_noise, rng_t, _, _ = jax.random.split(jstate.rng, 5)
    draws = {"t": np.asarray(jax.random.randint(rng_t, (8,), 0, d_s.num_timesteps)),
             "noise": np.asarray(jax.random.normal(rng_noise, batch["x"].shape, jnp.float32))}
    _, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    tx = create_optimizer(lambda step: lr)
    state = create_train_state(teacher["cfg"], tx, seed=1, device=CPU, state_dict=teacher["sd"])
    step = make_train_step(teacher["cfg"], d_s, tx, losses_fn=td.make_distill_losses(d_t, d_s, fn), model_train=False)
    m = step(state, batch, draws=draws)
    for key in ("loss", "mse", "vb", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=2e-4, atol=1e-12, err_msg=key)
    assert float(m["vb"]) == 0.0  # the distillation loss has no VB term

    def loss_fn(params):
        def model_fn(xt, tt, y):
            return JaxDiT(teacher["jcfg"]).apply({"params": params, "constants": constants}, xt, tt, y)

        return jnp.mean(jlosses(model_fn, jnp.asarray(batch["x"]), jnp.asarray(draws["t"]),
                                {"y": jnp.asarray(batch["y"])}, jnp.asarray(draws["noise"]))["loss"])

    want = state_dict_from_jax({"params": jax.grad(loss_fn)(params0)})
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    for name, w in want.items():
        scale = np.abs(w.numpy()).max() + 1e-12
        np.testing.assert_allclose(grads[name].numpy() / scale, w.numpy() / scale, rtol=0, atol=2e-4, err_msg=name)

    updates, _ = jtx.update(_to_jax_tree(grads, params0), jtx.init(params0), params0)
    params = optax.apply_updates(params0, updates)
    emas = {k: jax_ema.ema_update(params0, params, jax_ema.make_beta_fn(float(k))(jnp.asarray(1))) for k in state.ema}
    params = jax_project_weights(params, teacher["jcfg"])
    for what, got, tree in [("params", state.params, params)] + [(k, state.ema[k], emas[k]) for k in emas]:
        for name, w in state_dict_from_jax({"params": tree}).items():
            err = np.abs(got[name].detach().numpy() - w.numpy()).max() / lr
            assert err < 1e-3, (what, name, err)


def test_distill_train_step_learns_and_leaves_the_teacher(teacher):
    """The twin of tests/test_distill.py's learning test on the port: twelve
    steps on a fixed batch lower the held-out loss of every student index,
    the loss and gradient norm stay finite, the weights stay projected, and
    the teacher's tensors are bit-identical afterwards (the student and
    every EMA hold their own copies)."""
    cfg = build_config("DiT-XS/8", in_channels=4, input_size=8, num_classes=4, compute_dtype="float32")
    teacher_model = init_model(cfg, seed=0, device=CPU)
    before = {k: v.clone() for k, v in teacher_model.state_dict().items()}
    m = td.base_timestep_map(8)
    d_t, d_s = td.diffusion_from_map(m, device=CPU), td.diffusion_from_map(td.halved_map(m), device=CPU)
    losses_fn = td.make_distill_losses(d_t, d_s, td.make_teacher_fn(teacher_model, cfg.num_classes, 1.5))
    tx = create_optimizer(lambda step: 3e-4)
    state = create_train_state(cfg, tx, seed=1, device=CPU, state_dict=teacher_model.state_dict())
    shared = {p.data_ptr() for p in teacher_model.parameters()}
    assert not shared & {p.data_ptr() for p in state.model.parameters()}
    assert not shared & {t.data_ptr() for tree in state.ema.values() for t in tree.values()}
    step = make_train_step(cfg, d_s, tx, losses_fn=losses_fn, model_train=False)

    gen = torch.Generator().manual_seed(7)
    x0 = torch.randn(8, 4, 8, 8, generator=gen)
    y = torch.randint(0, 4, (8,), generator=gen)
    t_eval = torch.arange(8) % d_s.num_timesteps
    noise = torch.randn(x0.shape, generator=gen)

    def eval_loss():
        with torch.no_grad():
            return losses_fn(lambda xt, tt, y: state.model(xt, tt, y), x0, t_eval, {"y": y}, noise)["loss"].mean()

    first = float(eval_loss())
    for _ in range(12):
        metrics = step(state, {"x": x0, "y": y})
        assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    assert np.isfinite(first) and float(eval_loss()) < first
    stored = {k: v.clone() for k, v in state.model.state_dict().items()}
    with torch.no_grad():
        project_weights(state.model, cfg)
    assert max(float((state.model.state_dict()[k] - v).abs().max()) for k, v in stored.items()) < 1e-5
    assert all(torch.equal(teacher_model.state_dict()[k], v) for k, v in before.items())


# ---------------------------------------------------------------------------
# the CLI and the consumers of its students


@pytest.fixture(scope="module")
def teacher_exp(tmp_path_factory):
    """A 12-step DiT-XS/8 run of the port's train CLI (10 classes, EMA
    snapshots at 4, 8 and 12)."""
    results = tmp_path_factory.mktemp("results")
    flags = ["--device", "cpu", "--data-path", "synthetic:64", "--model", "DiT-XS/8", "--num-classes", "10",
             "--batch-size", "8", "--num-lin-warmup", "2", "--start-decay", "8", "--num-steps", "12",
             "--log-every", "6", "--ckpt-every", "12", "--ema-snapshot-every", "4",
             "--results-dir", str(results)]
    yield train.main(train.build_parser().parse_args(flags))
    shutil.rmtree(results, ignore_errors=True)


def run_distill(teacher_dir, results, *flags):
    argv = ["--device", "cpu", "--teacher", teacher_dir, "--data-path", "synthetic:64", "--results-dir", str(results),
            "--batch-size", "8", "--log-every", "1", *flags]
    return distill.main(distill.build_parser().parse_args(argv))


@pytest.fixture(scope="module")
def students(teacher_exp, tmp_path_factory):
    """Two stages (8 -> 4 -> 2 steps, guidance baked at 1.5), with every
    stage's teacher model kept as the CLI built it."""
    teachers = []
    make = distill.make_teacher_fn

    def spy(model, num_classes, cfg_scale):
        teachers.append((model, cfg_scale))
        return make(model, num_classes, cfg_scale)

    distill.make_teacher_fn = spy
    results = tmp_path_factory.mktemp("distilled")
    try:
        dirs = run_distill(teacher_exp, results, "--base-steps", "8", "--stages", "2", "--steps-per-stage", "3",
                           "--cfg-scale", "1.5")
    finally:
        distill.make_teacher_fn = make
    yield dirs, teachers
    shutil.rmtree(results, ignore_errors=True)


def test_cli_writes_two_stages(teacher_exp, students):
    dirs, teachers = students
    assert [os.path.basename(d) for d in dirs] == ["000-DiT-XS-8-distill4", "001-DiT-XS-8-distill2"]
    for rounds, (d, steps) in enumerate(zip(dirs, (4, 2)), start=1):
        args = load_config(d)
        assert {k: args[k] for k in args if k.startswith("distill_")} == {
            "distill_base_steps": 8, "distill_base_schedule": "uniform", "distill_rounds": rounds,
            "distill_cfg_scale": 1.5, "distill_teacher": os.path.abspath(teacher_exp), "distill_num_steps": steps}
        assert args["stats_mean"] == load_config(teacher_exp)["stats_mean"]
        assert sorted(os.listdir(d)) == ["checkpoints", "config.yaml", "constants.pt", "ema"]
        assert sorted(os.listdir(os.path.join(d, "ema"))) == ["0.050_0000003.npz", "0.100_0000003.npz"]
        assert os.listdir(os.path.join(d, "checkpoints")) == ["0000003.pt"]
    # stage 1's teacher is the run's EMA, untouched by the student's steps;
    # stage 2's is stage 1's raw student, at scale 1
    want = sample.load_variables(teacher_exp, load_config(teacher_exp))
    assert [s for _, s in teachers] == [1.5, 1.0]
    assert all(torch.equal(teachers[0][0].state_dict()[k], v) for k, v in want.items())
    raw = torch.load(os.path.join(dirs[0], "checkpoints", "0000003.pt"), weights_only=True)["model"]
    assert all(torch.equal(teachers[1][0].state_dict()[k], v) for k, v in raw.items())


def test_cli_chains_and_refuses(students, tmp_path):
    dirs, _ = students
    (chained,) = run_distill(dirs[1], tmp_path / "c", "--base-steps", "2", "--stages", "1", "--steps-per-stage", "1")
    args = load_config(chained)
    assert (args["distill_rounds"], args["distill_num_steps"], args["distill_base_steps"]) == (3, 1, 8)
    assert args["distill_cfg_scale"] == 1.5  # the baked scale stays in effect
    with pytest.raises(SystemExit, match="baked exactly once"):
        run_distill(dirs[1], tmp_path / "r", "--base-steps", "2", "--stages", "1", "--cfg-scale", "2.0")
    with pytest.raises(SystemExit, match="teacher's own grid"):
        run_distill(dirs[1], tmp_path / "r", "--base-steps", "4", "--stages", "1")


def test_cli_defaults_to_cuda(teacher_exp, tmp_path, monkeypatch):
    args = distill.build_parser().parse_args(["--teacher", teacher_exp, "--data-path", "synthetic:8",
                                              "--results-dir", str(tmp_path)])
    assert (args.device, args.base_steps, args.stages, args.steps_per_stage, args.lr) == ("cuda", 64, 4, 2000, 2e-3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        distill.main(args)


def spy_sample_fn(monkeypatch, module):
    """Record every build_sample_fn call of ``module``: its diffusion's step
    count, sampler and cfg_scale, and the rows of each chain call."""
    calls = []

    def spy(cfg, sd, diffusion, **kw):
        fn = build_sample_fn(cfg, sd, diffusion, **kw)
        call = {"steps": diffusion.num_timesteps, "sampler": kw["sampler"], "cfg_scale": kw["cfg_scale"], "rows": []}
        calls.append(call)

        def run(z, y, gen):
            call["rows"].append(z.shape[0])
            return fn(z, y, gen)

        return run

    monkeypatch.setattr(module, "build_sample_fn", spy)
    return calls


def test_sample_on_a_student(students, tmp_path, monkeypatch, capsys):
    """The requested ddpm 250 at CFG 4 runs as ddim on the student's two
    steps at cfg 1, on the four conditional rows alone."""
    student = students[0][1]
    calls = spy_sample_fn(monkeypatch, sample)
    out = sample.main(sample.build_parser().parse_args(
        ["--device", "cpu", "--result-dir", student, "--use-vae", "false", "--class-label", "3",
         "--output-file", str(tmp_path / "s.png")]))
    printed = capsys.readouterr().out
    assert "forcing --sampler ddim at its 2-step grid (requested ddpm/250)" in printed
    assert "forcing --cfg-scale 1" in printed
    assert calls == [{"steps": 2, "sampler": "ddim", "cfg_scale": None, "rows": [4]}]
    assert os.path.isfile(out)
    for flags in (["--cache-interval", "2"], ["--cfg-interval", "0.3", "3.0"],
                  ["--save-trajectory", str(tmp_path / "t.png")]):
        with pytest.raises(ValueError, match="distilled students"):
            sample.main(sample.build_parser().parse_args(
                ["--device", "cpu", "--result-dir", student, "--use-vae", "false", "--class-label", "3", *flags]))


def test_sample_fid_and_sample_ema_on_a_student(students, tmp_path, monkeypatch, capsys):
    student = students[0][1]
    calls = spy_sample_fn(monkeypatch, sample_fid)
    path = sample_fid.main(sample_fid.build_parser().parse_args(
        ["--device", "cpu", "--result-dir", student, "--use-vae", "false", "--num-classes", "10", "--num-samples", "6",
         "--batch-size", "4", "--sampler", "dpm++"]))
    assert "forcing ddim at its 2-step grid, cfg 1" in capsys.readouterr().out
    assert calls == [{"steps": 2, "sampler": "ddim", "cfg_scale": None, "rows": [4, 4]}]
    with np.load(path) as f:
        assert f["arr_0"].shape == (6, 16, 16, 4) and f["arr_0"].dtype == np.uint8
    with pytest.raises(ValueError, match="distilled students"):
        sample_fid.main(sample_fid.build_parser().parse_args(
            ["--device", "cpu", "--result-dir", student, "--use-vae", "false", "--num-classes", "10",
             "--cfg-interval", "0.3", "3.0"]))
    # the JAX sample_ema.py has no student branch: the requested protocol
    grid = sample_ema.main(sample_ema.build_parser().parse_args(
        ["--device", "cpu", "--result-dir", student, "--use-vae", "false", "--class-label", "3",
         "--sampler", "dpm++", "--num-sampling-steps", "3", "--output-file", str(tmp_path / "e.png")]))
    assert os.path.isfile(grid)


def test_server_on_a_student(students, tmp_path):
    """Every request runs the student's ddim 2 at cfg 1 (one program a
    bucket), equal bit for bit to build_sample_fn on the student diffusion
    and the host preamble's z; /info carries the distilled block; the
    accelerator fields are refused. The latent statistics are set to mean
    0, std 2**-13 in a copy, as in tests/test_torch_serve.py, so the served
    values carry the chain's bits."""
    import shutil

    student = str(tmp_path / "student")
    shutil.copytree(students[0][1], student)
    args = load_config(student)
    args.update(stats_mean=[0.0] * 4, stats_std=[2.0**-13] * 4)
    save_config(student, args)
    service = serve.SamplerService(student, buckets=(1, 4), coalesce_ms=0.0, device="cpu")
    try:
        assert service.info()["distilled"] == {"steps": 2, "rounds": 2, "baked_cfg_scale": 1.5}
        got = service.sample([1, 2], 250, "ddpm", 4.0, seed=3)
        assert service.sample([5], 20, "dpm++", 1.0, seed=3, schedule="karras").shape == (1, 4, 16, 16)
        assert sorted(service._fns) == sorted(
            ("ddim", 2, 1.0, bucket, "uniform", 0, None, "hold", None) for bucket in (1, 4))
        z = torch.cat([serve.draw(3, (2, 4, 16, 16), CPU), torch.zeros(2, 4, 16, 16)])
        fn = build_sample_fn(sample.run_config(args, None), sample.load_variables(student, args),
                             td.student_diffusion_from_config(args, device=CPU), sampler="ddim", batch_hint=4,
                             device=CPU)
        want = fn(z, torch.tensor([1, 2, 0, 0]), serve.generator(0, CPU))[:2].numpy()
        assert np.isfinite(want).all() and np.abs(want * 2.0**-13).max() < 1
        np.testing.assert_array_equal(got, sample.decode_latents(want, args, False))
        for kw in (dict(cache_interval=2), dict(cfg_interval=[0.3, 3.0])):
            with pytest.raises(ValueError, match="distilled student"):
                service.sample([1], 4, "dpm++", 4.0, **kw)
    finally:
        service.close()
