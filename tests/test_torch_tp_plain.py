"""Tensor parallelism of the plain path: every family and flag set on a
mesh's model axis (``build_sample_fn(mesh=)`` where ``auto`` resolves to
``off``, as it does off the card and outside the islands), held against the
JAX package's GSPMD layout on the virtual CPU devices of
``tests/conftest.py`` (the twins of ``tests/test_parallel.py:424
test_dp4_tp2_matches_single_device_chain`` and ``:457
test_pure_tp_mesh_dp1``).

  * the plain layout's shards against the slices JAX ``param_sharding``
    gives each model device of the same folded tree;
  * on four spawned gloo ranks (one spawn; the bodies in
    ``tests/torch_tp_plain_ranks.py``, which imports no JAX): the model
    call (f32, 1e-5) and a 4-step CFG chain on the injected noise (the
    bounds of ``tests/test_model.py:392-411``) on (1, 2) and (2, 2), for the
    vanilla family (every ``use_*`` flag off), MP adaln, rotation,
    rotation_scale, MP without cosine attention and a width whose heads do
    not split; the cached chain on a data axis against JAX's cached chain
    under the data sharding (``serve.py:683-699`` of the JAX package) and
    against the port's one-device chain;
  * the refusals that remain, and the collectives of the plain path under
    autograd (the train step's parity: tests/test_torch_tp_train.py).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch_tp_plain_ranks as ranks
from mapdit_tpu.diffusion import create_diffusion as jax_create_diffusion
from mapdit_tpu.diffusion.gaussian import GaussianDiffusion as JaxGaussianDiffusion
from mapdit_tpu.models import build_config as jax_build_config
from mapdit_tpu.models import init_model as jax_init_model
from mapdit_tpu.parallel import batch_sharding
from mapdit_tpu.parallel import make_mesh as jax_make_mesh
from mapdit_tpu.parallel.mesh import param_sharding
from mapdit_tpu.runtime import build_cached_sample_fn as jax_build_cached_sample_fn
from mapdit_tpu.runtime import build_model_fn as jax_build_model_fn
from mapdit_tpu.runtime import build_sample_fn as jax_build_sample_fn
from mapdit_tpu.runtime import fold_weights_for_inference as jax_fold
from mapdit_tpu_torch.diffusion import create_diffusion
from mapdit_tpu_torch.models import DiT, build_config
from mapdit_tpu_torch.parallel import Mesh, spawn
from mapdit_tpu_torch.parallel.mesh import PLAIN_TP, plain_tp_splits, shard_state_dict
from mapdit_tpu_torch.runtime import build_cached_sample_fn, build_sample_fn
from mapdit_tpu_torch.utils.weights import state_dict_from_jax

XS8 = ranks.XS8
VANILLA = {f: False for f in ("use_cosine_attention", "use_weight_normalization", "use_forced_weight_normalization",
                              "use_mp_residual", "use_mp_silu", "use_no_layernorm", "use_mp_pos_enc",
                              "use_mp_embedding")}
FAMILIES = {
    "vanilla": VANILLA,
    "mp-adaln": dict(),
    "rotation": dict(modulation="rotation"),
    "rotation_scale": dict(modulation="rotation_scale"),
    "mp-no-cosine": dict(use_cosine_attention=False),
    # 3 heads: the attention stays whole on every rank, the MLP (hidden 384) splits
    "heads-unsplit": dict(num_heads=3, hidden_size=96),
}
CHAIN_CASES = {("vanilla", (1, 2)), ("rotation_scale", (1, 2)), ("heads-unsplit", (1, 2)), ("mp-adaln", (2, 2))}


def _jax_variables(overrides, seed=0):
    """XS/8 variables of a family, every leaf drawn from numpy at the shapes
    of JAX ``init_model`` (traced only): weights N(0, 1) under weight
    normalization and N(0, 0.05) without (so the vanilla family's
    zero-initialised heads carry signal), biases N(0, 0.02), the gains in
    [0.2, 0.8] (they start at 0), Fourier constants as MPFourier draws
    them."""
    jcfg = jax_build_config("DiT-XS/8", **XS8).replace(**overrides)
    shapes = jax.eval_shape(lambda: jax_init_model(jcfg, seed=0)[1])
    rng = np.random.default_rng(seed + 100)

    def draw(path, leaf):
        name = getattr(path[-1], "key", None)
        if name in ("gain_msa", "gain_mlp", "gain_mod"):
            value = rng.uniform(0.2, 0.8, size=leaf.shape)
        elif name == "bias":
            value = rng.normal(0.0, 0.02, size=leaf.shape)
        elif name == "shift":
            value = rng.uniform(0.0, 2 * np.pi, size=leaf.shape)
        elif name == "scale":
            value = rng.normal(0.0, 2 * np.pi, size=leaf.shape)
        else:
            value = rng.normal(0.0, 1.0 if jcfg.use_weight_normalization else 0.05, size=leaf.shape)
        return jnp.asarray(value.astype(np.float32))

    return jcfg, jax.tree_util.tree_map_with_path(draw, dict(shapes))


# ---------------------------------------------------------------------------
# the weight layout


def _shard_of(arr, mesh, m):
    devices = list(mesh.devices[0])
    return next(np.asarray(s.data) for s in arr.addressable_shards if devices.index(s.device) == m)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_plain_layout_matches_jax_param_sharding(family, tp):
    """Each model rank's tensors of the plain layout against the shard its
    device receives of the same folded tree under JAX ``param_sharding``:
    fc1 on its rows, out-proj and fc2 on their input columns, everything
    outside the blocks' attention and MLP replicated. JAX splits qkv flat
    on its 3D rows (GSPMD regroups them); the port splits it by heads on the
    (3, D, D) view, so each rank attends over whole heads: its shard is the
    (3, D, D) view's slice of the same tensor. JAX replicates every bias; the
    port splits the column-parallel ones (qkv, fc1) with their rows and
    keeps the row-parallel ones whole. Halves whose heads (hidden width) do
    not divide stay whole."""
    overrides = FAMILIES[family]
    jcfg, variables = _jax_variables(overrides)
    folded = jax_fold(variables["params"], jcfg) if jcfg.use_weight_normalization else variables["params"]
    cfg = build_config("DiT-XS/8", **XS8).replace(**overrides)
    cfg = cfg.replace(fold_weights=cfg.use_weight_normalization)
    sd = state_dict_from_jax({"params": folded, "constants": variables.get("constants", {})}, cfg)
    mesh = jax_make_mesh(n_data=1, n_model=tp, devices=jax.devices()[:tp])
    sharded = jax.device_put(folded, param_sharding(folded, mesh))
    attn_split, mlp_split = plain_tp_splits(cfg, tp)
    d = cfg.hidden_size
    for m in range(tp):
        local = shard_state_dict(sd, cfg, Mesh(1, tp, m, torch.device("cpu")), PLAIN_TP)
        assert local.keys() == sd.keys()
        jax_local = state_dict_from_jax(
            {"params": jax.tree_util.tree_map(lambda a: _shard_of(a, mesh, m), sharded), "constants": {}})
        for key, value in local.items():
            names = key.split(".")
            module = ".".join(names[2:-1]) if names[0] == "blocks" else ""
            split_mlp = mlp_split and module in ("mlp.net.0", "mlp.net.2")
            split_attn = attn_split and module in ("attn.qkv_proj", "attn.out_proj")
            if module == "attn.qkv_proj" and split_attn:
                d_l = d // tp
                view = sd[key].reshape(3, d, *sd[key].shape[1:])[:, m * d_l : (m + 1) * d_l]
                np.testing.assert_array_equal(value.numpy(), view.reshape(3 * d_l, *sd[key].shape[1:]).numpy())
                if names[-1] == "weight":  # JAX splits the same tensor's rows
                    assert jax_local[key].shape == (3 * d // tp, d), jax_local[key].shape
            elif names[-1] == "bias" and split_mlp and module == "mlp.net.0":
                h_l = value.shape[0]
                np.testing.assert_array_equal(value.numpy(), sd[key][m * h_l : (m + 1) * h_l].numpy())
            elif names[-1] == "bias" or key not in jax_local:
                assert value is sd[key], key  # row-parallel biases, buffers and constants stay whole
            elif split_mlp or split_attn:
                np.testing.assert_array_equal(value.numpy(), jax_local[key].numpy(), err_msg=f"rank {m} {key}")
            else:
                assert value is sd[key], key
                if module.startswith(("attn", "mlp")):
                    continue  # the port keeps a half whole where its heads (width) do not divide
                np.testing.assert_array_equal(value.numpy(), jax_local[key].numpy(), err_msg=f"rank {m} {key}")


# ---------------------------------------------------------------------------
# four spawned gloo ranks


def _jax_det_noise(t, shape):
    idx = jnp.arange(np.prod(shape), dtype=jnp.float32).reshape(shape)
    return jnp.cos(idx * 0.01 + t[0].astype(jnp.float32))


def _inputs(rng, n):
    z = rng.normal(size=(n, 4, 16, 16)).astype(np.float32)
    y = np.arange(n, dtype=np.int64) % 10
    return np.concatenate([z, z]), np.concatenate([y, np.full((n,), 10, np.int64)])


def _jax_chain(jcfg, variables, z, y, layout):
    """JAX build_sample_fn(mesh=) under GSPMD on the (data, model) layout of
    the virtual CPU devices, the batch on the data axis, ddpm on the
    injected noise; op by op (jax.disable_jit), as tests/test_torch_tp.py
    runs its JAX chains: XLA's fusions of the jitted chain reassociate
    sums, which the 4-step chain's first step amplifies ~156x (its jitted
    chains differ from its own eager ones by a mean 9e-5 to 2e-4 here, the
    port's one-device chains from the eager ones by under 1e-6)."""
    mesh = jax_make_mesh(n_data=layout[0], n_model=layout[1], devices=jax.devices()[: layout[0] * layout[1]])
    fn = jax_build_sample_fn(jcfg, variables, jax_create_diffusion(ranks.CHAIN_STEPS), cfg_scale=ranks.CFG_SCALE,
                             clip_denoised=True, mesh=mesh)
    with jax.set_mesh(mesh), jax.disable_jit():
        out = fn(jax.device_put(jnp.asarray(z), batch_sharding(mesh)),
                 jax.device_put(jnp.asarray(y.astype(np.int32)), batch_sharding(mesh)), jax.random.PRNGKey(0))
    return np.asarray(out)


def _jax_cached_chain(jcfg, variables, z, y, seed, n_data):
    """JAX build_cached_sample_fn (ddpm, interval 2) on PRNGKey(seed), op by
    op, as the JAX server runs it (``serve.py:683-699``): under a (n_data,
    1) mesh with the batch on the data axis where it divides, else on one
    device. Returns (chain, its step noise a step in chain order)."""
    fn = jax_build_cached_sample_fn(jcfg, variables, jax_create_diffusion(ranks.CHAIN_STEPS),
                                    cfg_scale=ranks.CFG_SCALE, cache_interval=2, clip_denoised=True, sampler="ddpm")
    key = jax.random.PRNGKey(seed)
    n_pre = len(z) // 2
    zz, yy = jnp.asarray(z), jnp.asarray(y.astype(np.int32))
    with jax.disable_jit():
        if n_pre % n_data == 0:
            mesh = jax_make_mesh(n_data=n_data, n_model=1, devices=jax.devices()[:n_data])
            with jax.set_mesh(mesh):
                out = fn(jax.device_put(zz, batch_sharding(mesh)), jax.device_put(yy, batch_sharding(mesh)), key)
        else:
            out = fn(zz, yy, key)
    draws = []
    for _ in range(int(ranks.CHAIN_STEPS)):  # the chain splits its key once a step
        key, step_key = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(step_key, (n_pre, *z.shape[1:]), jnp.float32)))
    return np.asarray(out), draws


def test_plain_path_tp_matches_jax_gspmd_on_spawned_ranks(monkeypatch):
    """One spawn of four gloo ranks on the CPU for every case (module
    docstring): each family on (1, 2) and the vanilla and MP adaln families
    on (2, 2), against JAX's model and GSPMD chain on the same weights; the
    cached chain on a (4, 1) data axis against JAX's cached chain on the
    same step noise and against the port's one-device chain under the same
    generator."""
    monkeypatch.setattr(
        JaxGaussianDiffusion, "p_sample_loop_fast",
        functools.partialmethod(JaxGaussianDiffusion.p_sample_loop_fast, noise_fn=_jax_det_noise),
    )
    rng = np.random.default_rng(7)
    plain = []
    for family, layout in [(f, (1, 2)) for f in FAMILIES] + [("vanilla", (2, 2)), ("mp-adaln", (2, 2))]:
        overrides = FAMILIES[family]
        jcfg, variables = _jax_variables(overrides, seed=len(plain))
        cfg = build_config("DiT-XS/8", **XS8).replace(**overrides)
        z, y = _inputs(rng, 4)
        t = rng.uniform(0, 999, size=(8,)).astype(np.float32)
        model_fn = jax_build_model_fn(jcfg, variables, cfg_scale=ranks.CFG_SCALE)
        plain.append(dict(
            name=f"{family} {layout}", overrides=overrides, layout=layout, z=z, y=y, t=t,
            sd={k: v.numpy() for k, v in state_dict_from_jax(variables, cfg).items()},
            model_ref=np.asarray(model_fn(jnp.asarray(z), jnp.asarray(t), jnp.asarray(y.astype(np.int32)))),
            # the op-by-op GSPMD chains take seconds each: four cover both
            # layouts, biases, the rotations and an unsplit half
            chain_ref=_jax_chain(jcfg, variables, z, y, layout) if (family, layout) in CHAIN_CASES else None,
        ))

    cfg = build_config("DiT-XS/8", **XS8)
    jcfg, variables = _jax_variables({}, seed=20)
    sd = state_dict_from_jax(variables, cfg)
    runs = []
    for n, seed in ((4, 3), (2, 4)):  # 4 rows split over the (4, 1) data axis, 2 run whole
        zz, yy = _inputs(rng, n)
        jax_ref, draws = _jax_cached_chain(jcfg, variables, zz, yy, seed, n_data=4)
        fn = build_cached_sample_fn(cfg, sd, create_diffusion(ranks.CHAIN_STEPS, device="cpu"),
                                    cfg_scale=ranks.CFG_SCALE, cache_interval=2, clip_denoised=True, sampler="ddpm",
                                    device="cpu")
        want = fn(torch.from_numpy(zz), torch.from_numpy(yy), torch.Generator().manual_seed(seed)).numpy()
        runs.append(dict(z=zz, y=yy, seed=seed, want=want, jax_ref=jax_ref, draws=draws))
    cached = dict(sd={k: v.numpy() for k, v in sd.items()}, runs=runs)
    spawn(ranks.run_cases, 4, args=(plain, cached), device="cpu")


# ---------------------------------------------------------------------------
# what stays refused, and autograd


def test_plain_path_refuses_autograd(monkeypatch):
    """Autograd is no longer refused: the plain layout trains (the step's
    parity on four ranks is tests/test_torch_tp_train.py). On raw
    weight-normalized shards of a model rank, with the model group's
    all-reduce recorded (and the sum of a group of one), a forward makes
    per block two row-norm sums (out-proj, fc2) and two partial sums, and
    the backward two input-gradient sums (qkv, fc1) and the two row norms'
    gradient sums; without gradients the forward makes the same four and no
    graph. Every gradient lands on a shard-shaped parameter."""
    from mapdit_tpu_torch.models import layers

    calls = []

    def all_reduce(tensor, group=None):
        assert group is mesh.model_group
        calls.append(tuple(tensor.shape))

    monkeypatch.setattr(layers.dist, "all_reduce", all_reduce)
    cfg = build_config("DiT-XS/8", **XS8)
    model = DiT(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    mesh = Mesh(1, 2, 0, torch.device("cpu"), None, object())
    model.load_tensor_parallel(shard_state_dict(sd, cfg, mesh, PLAIN_TP), mesh)
    x, t, y = torch.randn(2, 4, 16, 16), torch.full((2,), 10.0), torch.ones(2, dtype=torch.int64)
    with torch.no_grad():
        model(x, t, y)
    assert len(calls) == 4 * cfg.depth, len(calls)
    calls.clear()
    model(x, t, y).square().mean().backward()
    assert len(calls) == 8 * cfg.depth, len(calls)
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.shape == p.shape and torch.isfinite(p.grad).all(), name
    assert model.blocks[0].attn.out_proj.weight.shape == (cfg.hidden_size, cfg.hidden_size // 2)


@pytest.mark.parametrize("kernel", ["mega", "mega_attn", "mega_stack", "auto", "pallas"])
def test_plain_layout_refuses_single_device_kernels(kernel):
    """Loading the plain layout by hand takes block_kernel off only: the
    block kernels take whole weights (JAX refuses every explicit Pallas
    kernel on a model axis, ``runtime.py:692-697``)."""
    cfg = build_config("DiT-XS/8", fold_weights=True, block_kernel=kernel, **XS8)
    model = DiT(cfg)
    mesh = Mesh(1, 2, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="single-device kernel"):
        model.load_tensor_parallel(shard_state_dict(model.state_dict(), cfg, mesh, PLAIN_TP), mesh)


def test_cached_chain_refuses_a_model_axis():
    cfg = build_config("DiT-XS/8", **XS8)
    with pytest.raises(ValueError, match="tensor-parallel"):
        build_cached_sample_fn(cfg, {}, create_diffusion("4", device="cpu"), mesh=Mesh(1, 2, 0, torch.device("cpu")))
