"""The tensor-parallel sampling layout of the port: the three partial kernels'
plain versions against the Pallas kernels (interpret mode) and their jnp
references, the partials' algebra, the weight shards against the slices
JAX's islands receive, the islands and ``build_sample_fn(mesh=)`` on four
spawned gloo ranks against JAX and the port's unsharded chain, the plain
path on unfolded weights and the scan_blocks layout on two spawned ranks,
the ``auto`` resolver and the refusals that remain.

Shapes are those of ``tests/test_parallel.py``'s island tests. The ranks'
bodies live in ``tests/torch_tp_ranks.py``, which imports no JAX: every JAX
reference is computed here and handed to the ranks as numpy arrays.
"""

import functools
import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import torch_tp_plain_ranks
import torch_tp_ranks
from mapdit_tpu.diffusion import create_diffusion as jax_create_diffusion
from mapdit_tpu.diffusion.gaussian import GaussianDiffusion as JaxGaussianDiffusion
from mapdit_tpu.models import blocks as jax_blocks
from mapdit_tpu.models import build_config as jax_build_config
from mapdit_tpu.models import init_model as jax_init_model
from mapdit_tpu.ops.pallas import dit_block as jdb
from mapdit_tpu.parallel import make_mesh as jax_make_mesh
from mapdit_tpu.runtime import build_sample_fn as jax_build_sample_fn
from mapdit_tpu.runtime import fold_weights_for_inference as jax_fold
from mapdit_tpu_torch.diffusion import create_diffusion
from mapdit_tpu_torch.models import DiT, build_config
from mapdit_tpu_torch.models.blocks import resolve_block_kernel_tp
from mapdit_tpu_torch.ops.cuda import attn_branch, dit_block_tp
from mapdit_tpu_torch.ops.cuda.dit_block import block_reference
from mapdit_tpu_torch.parallel import Mesh, shard_state_dict, spawn
from mapdit_tpu_torch.parallel.mesh import shard_tensor
from mapdit_tpu_torch.runtime import build_sample_fn
from mapdit_tpu_torch.utils.weights import state_dict_from_jax

XS8 = torch_tp_ranks.XS8
KERNEL_TOL = 5e-5  # the Pallas partial kernels against their jnp references (tests/test_parallel.py)
ALGEBRA_TOL = 1e-4


def _rand(rng, *shape, scale=1.0, shift=0.0):
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, *wants, tol):
    for want in wants:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the three plain versions against the Pallas kernels, no process group


@pytest.mark.parametrize("wrapper", ["plain", "wrapper-on-cpu"])
def test_attn_tp_partial_matches_pallas(wrapper):
    rng = np.random.default_rng(1)
    n, t, d, heads_local, d_l = 4, 16, 128, 2, 64
    x = _rand(rng, n, t, d)
    shift, scale = _rand(rng, n, d, scale=0.1), _rand(rng, n, d, scale=0.1, shift=1.0)
    w_qkv_l, w_out_l = _rand(rng, 3 * d_l, d, scale=1 / math.sqrt(d)), _rand(rng, d, d_l, scale=1 / math.sqrt(d))
    gain = 0.2
    fn = dit_block_tp.attn_tp_partial_plain if wrapper == "plain" else dit_block_tp.attn_tp_partial
    got = fn(*_t(x, shift, scale), torch.tensor(gain), *_t(w_qkv_l, w_out_l), heads_local)
    args = (*_j(x, shift, scale), jnp.float32(gain), *_j(w_qkv_l, w_out_l), heads_local)
    assert got.dtype == torch.float32 and got.shape == (n, t, d)
    _close(got, jdb._attn_tp_partial_impl(*args), jdb._attn_tp_partial_reference(*args), tol=KERNEL_TOL)


@pytest.mark.parametrize("wrapper", ["plain", "wrapper-on-cpu"])
def test_block_tp_attn_matches_pallas(wrapper):
    rng = np.random.default_rng(13)
    n, t, d, heads_local, d_l = 4, 16, 128, 2, 64
    x, a = _rand(rng, n, t, d), _rand(rng, n, d)
    gains = np.asarray([0.3, 0.6], np.float32)
    w_mod = _rand(rng, 6 * d, d, scale=1 / math.sqrt(d))
    w_qkv_l, w_out_l = _rand(rng, 3 * d_l, d, scale=1 / math.sqrt(d)), _rand(rng, d, d_l, scale=1 / math.sqrt(d))
    fn = dit_block_tp.block_tp_attn_plain if wrapper == "plain" else dit_block_tp.block_tp_attn
    partial, mods = fn(*_t(x, a, gains, w_mod, w_qkv_l, w_out_l), heads_local)
    want_partial, want_mods = jdb._block_tp_attn_impl(*_j(x, a, gains, w_mod, w_qkv_l, w_out_l), heads_local)
    mods_ref = (jnp.asarray(a) @ jnp.asarray(w_mod).T) / np.sqrt(d)
    partial_ref = jdb._attn_tp_partial_reference(
        jnp.asarray(x), mods_ref[:, :d], mods_ref[:, d : 2 * d], gains[0], *_j(w_qkv_l, w_out_l), heads_local
    )
    assert mods.shape == (n, 6, d) and mods.dtype == torch.float32
    _close(mods, want_mods, mods_ref.reshape(n, 6, d), tol=KERNEL_TOL)
    _close(partial, want_partial, partial_ref, tol=KERNEL_TOL)


@pytest.mark.parametrize("wrapper", ["plain", "wrapper-on-cpu"])
def test_mlp_tp_partial_matches_pallas(wrapper):
    rng = np.random.default_rng(12)
    n, t, d, h_l = 4, 16, 128, 192
    x = _rand(rng, n, t, d)
    shift, scale = _rand(rng, n, d, scale=0.1), _rand(rng, n, d, scale=0.1, shift=1.0)
    gains = np.asarray([0.7, 0.2], np.float32)  # the kernel reads gains[1]
    w1_l, w2_l = _rand(rng, h_l, d, scale=1 / math.sqrt(d)), _rand(rng, d, h_l, scale=1 / math.sqrt(2 * h_l))
    inv_h = 1.0 / math.sqrt(2 * h_l)
    fn = dit_block_tp.mlp_tp_partial_plain if wrapper == "plain" else dit_block_tp.mlp_tp_partial
    got = fn(*_t(x, shift, scale, gains, w1_l, w2_l), inv_h)
    _close(
        got,
        jdb._mlp_tp_partial_impl(*_j(x, shift, scale, gains, w1_l, w2_l), inv_h),
        jdb._mlp_tp_partial_reference(*_j(x, shift, scale), gains[1], *_j(w1_l, w2_l), inv_h),
        tol=KERNEL_TOL,
    )


def _block_inputs(seed=14, n=4, t=16, d=128, hidden=256):
    rng = np.random.default_rng(seed)
    return dict(
        x=_rand(rng, n, t, d), a=_rand(rng, n, d), gains=np.asarray([0.3, 0.6], np.float32),
        w_mod=_rand(rng, 6 * d, d, scale=1 / math.sqrt(d)), w_qkv=_rand(rng, 3 * d, d, scale=1 / math.sqrt(d)),
        w_out=_rand(rng, d, d, scale=1 / math.sqrt(d)), w1=_rand(rng, hidden, d, scale=1 / math.sqrt(d)),
        w2=_rand(rng, d, hidden, scale=1 / math.sqrt(hidden)), shift=_rand(rng, n, d, scale=0.1),
        scale=_rand(rng, n, d, scale=0.1, shift=1.0), gate=_rand(rng, n, d, scale=0.1),
    )


@pytest.mark.parametrize("tp", [2, 4])
def test_partials_sum_to_the_unsharded_block(tp):
    """The tp shards' partials summed, then the replicated residuals (the
    islands' arithmetic without the all-reduce), equal the unsharded block:
    the port's block_reference / attn_reference and JAX's _reference /
    _attn_reference."""
    heads = 4
    v = _block_inputs()
    a = {k: torch.from_numpy(x) for k, x in v.items()}
    hidden = v["w1"].shape[0]
    shards = [
        dict(qkv=shard_tensor(a["w_qkv"], "qkv", tp, m), out=shard_tensor(a["w_out"], "cols", tp, m),
             w1=shard_tensor(a["w1"], "rows", tp, m), w2=shard_tensor(a["w2"], "cols", tp, m))
        for m in range(tp)
    ]
    parts = [dit_block_tp.block_tp_attn_plain(a["x"], a["a"], a["gains"], a["w_mod"], s["qkv"], s["out"], heads // tp)
             for s in shards]
    mods = parts[0][1]
    x1 = dit_block_tp.gated_residual(a["x"], mods[:, 2], sum(p for p, _ in parts))
    mlp = sum(dit_block_tp.mlp_tp_partial_plain(x1, mods[:, 3], mods[:, 4], a["gains"], s["w1"], s["w2"],
                                                1 / math.sqrt(hidden)) for s in shards)
    got = dit_block_tp.gated_residual(x1, mods[:, 5], mlp)
    want_port = block_reference(a["x"], a["a"], a["gains"], a["w_mod"], a["w_qkv"], a["w_out"], a["w1"], a["w2"], heads)
    want_jax = jdb._reference(*_j(v["x"], v["a"], v["gains"], v["w_mod"], v["w_qkv"], v["w_out"], v["w1"], v["w2"]),
                              heads)
    _close(got, want_port, want_jax, tol=ALGEBRA_TOL)

    partial = sum(dit_block_tp.attn_tp_partial_plain(a["x"], a["shift"], a["scale"], a["gains"][0], s["qkv"], s["out"],
                                                     heads // tp) for s in shards)
    got = dit_block_tp.gated_residual(a["x"], a["gate"], partial)
    branch = (v["x"], v["shift"], v["scale"], v["gate"])
    _close(
        got,
        attn_branch.attn_reference(*(a[k] for k in ("x", "shift", "scale", "gate")), a["gains"][0], a["w_qkv"],
                                   a["w_out"], heads),
        jdb._attn_reference(*_j(*branch), v["gains"][0], *_j(v["w_qkv"], v["w_out"]), heads),
        tol=ALGEBRA_TOL,
    )


# ---------------------------------------------------------------------------
# the weight shards against JAX's island specs


def _jax_variables(seed=0):
    """XS/8 variables with the block gains drawn (they start at 0, which
    switches the modulations' shift off)."""
    cfg = jax_build_config("DiT-XS/8", **XS8)
    _, variables = jax_init_model(cfg, seed=seed)
    rng = np.random.default_rng(seed + 100)

    def draw(path, leaf):
        name = getattr(path[-1], "key", None)
        return jnp.float32(rng.uniform(0.2, 0.8)) if name in ("gain_msa", "gain_mlp") else leaf

    return cfg, jax.tree_util.tree_map_with_path(draw, variables)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kernel", ["mega_attn_tp", "mega_tp"])
def test_shard_state_dict_matches_jax_island_slices(tp, kernel):
    """Each model rank's tensors equal the shard its device receives of the
    folded tree under the island's specs: qkv as (3, D, D) under
    P(None, 'model', None), out-proj and fc2 under P(None, 'model'), fc1
    under P('model', None); the rest replicated."""
    jcfg, variables = _jax_variables()
    folded = {"params": jax_fold(variables["params"], jcfg), "constants": variables.get("constants", {})}
    cfg = build_config("DiT-XS/8", fold_weights=True, **XS8)
    sd = state_dict_from_jax(folded, cfg)
    d = cfg.hidden_size
    mesh = jax_make_mesh(n_data=1, n_model=tp, devices=jax.devices()[:tp])
    model_devices = list(mesh.devices[0])
    mega_tp = kernel == "mega_tp"
    specs = {
        "attn.qkv_proj.weight": (P(None, "model", None), lambda w: w.reshape(3, d, d)),
        "attn.out_proj.weight": (P(None, "model"), lambda w: w),
        "mlp.net.0.weight": (P("model", None) if mega_tp else P(), lambda w: w),
        "mlp.net.2.weight": (P(None, "model") if mega_tp else P(), lambda w: w),
        "modulation.1.weight": (P(), lambda w: w),
    }
    for m in range(tp):
        local = shard_state_dict(sd, cfg, Mesh(1, tp, m, torch.device("cpu")), kernel)
        assert local.keys() == sd.keys()
        for i in range(cfg.depth):
            for suffix, (spec, view) in specs.items():
                arr = jax.device_put(view(jnp.asarray(sd[f"blocks.{i}.{suffix}"].numpy())), NamedSharding(mesh, spec))
                want = next(np.asarray(s.data) for s in arr.addressable_shards if model_devices.index(s.device) == m)
                got = local[f"blocks.{i}.{suffix}"].numpy()
                np.testing.assert_array_equal(got.reshape(want.shape), want, err_msg=f"rank {m} blocks.{i}.{suffix}")
        for key in ("x_embedder.weight", "y_embedder.embedding.weight", "final_layer.linear.weight"):
            assert local[key] is sd[key]


# ---------------------------------------------------------------------------
# four spawned gloo ranks


def _jax_det_noise(t, shape):
    idx = jnp.arange(np.prod(shape), dtype=jnp.float32).reshape(shape)
    return jnp.cos(idx * 0.01 + t[0].astype(jnp.float32))


def _chain_inputs(rng, n):
    z = _rand(rng, n, 4, 16, 16)
    y = np.arange(n, dtype=np.int64) % 10
    return np.concatenate([z, z]), np.concatenate([y, np.full((n,), 10, np.int64)])


def test_islands_and_mesh_chains_on_spawned_ranks(monkeypatch):
    """In one spawn of four gloo ranks on the CPU: fused_dit_block_tp and
    fused_attn_branch_tp on a (2, 2) mesh against JAX _reference and
    _attn_reference (1e-4); then build_sample_fn(mesh=) at DiT-XS/8 on the
    (2, 2) and (1, 4) layouts with each island, and a pre-CFG batch of 1
    that the (2, 2) data axis does not divide, each against the port's
    unsharded chain under the same generator (1e-4) and against JAX's eager
    chain on the injected noise (2e-3; ROADMAP C says why eager); then ddim
    at eta 1 (the step noise drawn at the global shape, each rank keeping
    its rows) and dpm++ with limited-interval guidance on the mesh, each
    against the unsharded chain."""
    v = _block_inputs()
    heads = 4
    islands = dict(
        inputs=v, heads=heads,
        block_ref=np.asarray(jdb._reference(*_j(*(v[k] for k in ("x", "a", "gains", "w_mod", "w_qkv", "w_out",
                                                                  "w1", "w2"))), heads)),
        attn_ref=np.asarray(jdb._attn_reference(*_j(v["x"], v["shift"], v["scale"], v["gate"]), v["gains"][0],
                                                *_j(v["w_qkv"], v["w_out"]), heads)),
    )

    jcfg, variables = _jax_variables()
    cfg = build_config("DiT-XS/8", **XS8)
    sd = {k: t.numpy() for k, t in state_dict_from_jax(variables, cfg).items()}
    monkeypatch.setattr(
        JaxGaussianDiffusion, "p_sample_loop_fast",
        functools.partialmethod(JaxGaussianDiffusion.p_sample_loop_fast, noise_fn=_jax_det_noise),
    )
    jax_chain = jax_build_sample_fn(jcfg, variables, jax_create_diffusion(torch_tp_ranks.CHAIN_STEPS),
                                    cfg_scale=torch_tp_ranks.CFG_SCALE, clip_denoised=True)
    # the unsharded chain of each island is the single-device kernel path
    # with the same arithmetic: the whole block (mega) or its attention half
    def port_chain(kernel, **sampler):
        # the unsharded chain of each island is the single-device kernel
        # path with the same arithmetic: the whole block (mega) or its
        # attention half
        single = {"mega_tp": "mega", "mega_attn_tp": "mega_attn"}[kernel]
        return build_sample_fn(cfg.replace(block_kernel=single), {k: torch.from_numpy(a) for k, a in sd.items()},
                               create_diffusion(torch_tp_ranks.CHAIN_STEPS, device="cpu"),
                               cfg_scale=torch_tp_ranks.CFG_SCALE, clip_denoised=True, device="cpu", **sampler)

    rng = np.random.default_rng(5)
    chains = []
    for i, (layout, kernel, n, sampler) in enumerate(
        [((2, 2), "mega_attn_tp", 4, {}), ((2, 2), "mega_tp", 4, {}), ((1, 4), "mega_attn_tp", 4, {}),
         ((1, 4), "mega_tp", 4, {}), ((2, 2), "mega_attn_tp", 1, {}),
         ((2, 2), "mega_tp", 4, dict(sampler="ddim", eta=1.0)),
         ((2, 2), "mega_attn_tp", 4, dict(sampler="dpm++", cfg_interval=(0.5, 10.0)))]
    ):
        z, y = _chain_inputs(rng, n)
        seed = 10 + i
        jax_ref = None
        if not sampler:
            with jax.disable_jit():
                jax_ref = np.asarray(jax_chain(jnp.asarray(z), jnp.asarray(y.astype(np.int32)),
                                               jax.random.PRNGKey(0)))
        port_ref = port_chain(kernel, **sampler)(*_t(z, y), torch.Generator().manual_seed(seed)).numpy()
        chains.append(dict(name=f"{layout} {kernel} batch {n}x2 {sampler}", layout=layout, kernel=kernel, z=z, y=y,
                           seed=seed, sampler=sampler, port_ref=port_ref, jax_ref=jax_ref))
    spawn(torch_tp_ranks.run_cases, 4, args=(islands, chains, sd), device="cpu")


# ---------------------------------------------------------------------------
# the auto resolver and the refusals


@pytest.mark.parametrize(
    "overrides, folded, tp, want",
    [
        (dict(), True, 2, "mega_tp"),
        (dict(mlp_ratio=4.0078125), True, 4, "mega_attn_tp"),  # hidden 1026: heads split, hidden does not
        (dict(), True, 5, "off"),  # heads + 1
        (dict(), True, 1, "off"),
        (dict(), False, 2, "off"),  # unfolded (training) weights never take an island
        (dict(block_kernel="off"), True, 2, "off"),  # explicit values pass through
        (dict(block_kernel="mega_attn_tp"), True, 2, "mega_attn_tp"),
    ],
)
def test_auto_resolution_matches_jax(monkeypatch, overrides, folded, tp, want):
    """The table of tests/test_parallel.py's faked-TPU resolver test, the
    port's CUDA branch against JAX's TPU branch; off CUDA the port resolves
    to ``off``, as JAX does off-TPU."""

    class _FakeTpu:
        platform = "tpu"

    monkeypatch.setattr(jax_blocks.jax, "devices", lambda: [_FakeTpu()])
    kw = {"block_kernel": "auto", **overrides}
    jcfg = jax_build_config("DiT-XS/8", **XS8).replace(**kw)
    cfg = build_config("DiT-XS/8", compute_dtype="bfloat16", **XS8).replace(**kw)
    assert jax_blocks.resolve_block_kernel_tp(jcfg, folded=folded, tp=tp) == want
    assert resolve_block_kernel_tp(cfg, folded, tp, "cuda") == want
    assert resolve_block_kernel_tp(cfg, folded, tp, "cpu") == (want if "block_kernel" in overrides else "off")


def _cpu_mesh(n_data, n_model):
    return Mesh(n_data, n_model, 0, torch.device("cpu"))


@pytest.mark.parametrize("kernel", ["mega", "mega_stack", "mega_attn", "pallas"])
def test_mesh_refuses_single_device_kernels(kernel):
    cfg = build_config("DiT-XS/8", block_kernel=kernel, **XS8)
    with pytest.raises(ValueError, match="single-device kernel"):
        build_sample_fn(cfg, {}, create_diffusion("2", device="cpu"), mesh=_cpu_mesh(2, 2))


@pytest.mark.parametrize(
    "overrides",
    [dict(block_kernel="mega_tp", modulation="rotation"), dict(block_kernel="mega_attn_tp", use_cosine_attention=False)],
)
def test_mesh_refuses_the_plain_path_and_other_families(overrides):
    """What a model axis still refuses: an island named on a family it does
    not hard-code. (The plain path runs every family, on folded weights in
    test_torch_tp_plain.py, on unfolded ones and the scan_blocks layout in
    test_mesh_runs_unfolded_and_scan_blocks_weights.)"""
    cfg = build_config("DiT-XS/8", **XS8).replace(**overrides)
    with pytest.raises(ValueError, match="hard-codes"):
        build_sample_fn(cfg, {}, create_diffusion("2", device="cpu"), mesh=_cpu_mesh(1, 2))


# the chains a model axis refused before the cross-rank row norm, and the
# island on the stacked layout: (name, overrides, fold, the kernel it runs)
PLAIN_CHAINS = [("off-unfolded", dict(block_kernel="off"), False, "off"),
                ("auto-scan_blocks", dict(block_kernel="auto", scan_blocks=True), True, "off"),
                ("mega_tp-scan_blocks", dict(block_kernel="mega_tp", scan_blocks=True), True, "mega_tp")]


@pytest.fixture(scope="module")
def plain_chains(tmp_path_factory):
    """Every PLAIN_CHAINS case on two spawned gloo ranks (one spawn), with
    its one-device chain on the same weights beside it."""
    out = tmp_path_factory.mktemp("tp_plain_chains")
    rng = np.random.default_rng(31)
    cases, want = [], {}
    for name, overrides, fold, kernel in PLAIN_CHAINS:
        cfg = build_config("DiT-XS/8", **XS8).replace(**overrides)
        model = DiT(cfg)
        model.reset_parameters(torch.Generator().manual_seed(5))
        with torch.no_grad():  # the gains start at 0: draw them, so the branches count
            for key, p in model.named_parameters():
                if key.rsplit(".", 1)[-1] in ("gain_msa", "gain_mlp"):
                    p.uniform_(0.2, 0.8, generator=torch.Generator().manual_seed(len(key)))
        sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
        z, y = _chain_inputs(rng, 2)
        fn = build_sample_fn(cfg.replace(block_kernel="off"), sd, create_diffusion(torch_tp_ranks.CHAIN_STEPS,
                             device="cpu"), cfg_scale=torch_tp_ranks.CFG_SCALE, clip_denoised=True, fold=fold,
                             device="cpu", noise_fn=torch_tp_ranks.det_noise)
        with torch.no_grad():
            call = fn.prepared["model"].forward_with_cfg(torch.from_numpy(z), torch.full((z.shape[0],), 500.0),
                                                         torch.from_numpy(y), torch_tp_ranks.CFG_SCALE)
        want[name] = dict(call=call.numpy(), chain=fn(torch.from_numpy(z), torch.from_numpy(y)).numpy())
        cases.append(dict(name=name, overrides=overrides, fold=fold, kernel=kernel, z=z, y=y,
                          sd={k: v.numpy() for k, v in sd.items()}))
    try:
        spawn(torch_tp_ranks.plain_chain_cases, 2, args=(cases, str(out)), device="cpu")
        got = {name: dict(np.load(out / f"{name}.npz")) for name, *_ in PLAIN_CHAINS}
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return got, want


@pytest.mark.parametrize("name", [c[0] for c in PLAIN_CHAINS])
def test_mesh_runs_unfolded_and_scan_blocks_weights(plain_chains, name):
    """On a (1, 2) mesh the plain path takes unfolded weight-normalized
    weights (out-proj and fc2 column slices normalized by their whole rows'
    norm, the squares summed over the model group) and the scan_blocks
    layout (the 3-D stacks split one axis later), and the mega_tp island
    takes the stacked layout too: the model call at 1e-5 and the 4-step
    chain at the bounds of test_torch_tp_plain.py, against the one-device
    chain on the same weights."""
    got, want = plain_chains
    np.testing.assert_allclose(got[name]["call"], want[name]["call"], err_msg=name, **torch_tp_plain_ranks.MODEL_TOL)
    torch_tp_plain_ranks.chain_bounds(got[name]["chain"], want[name]["chain"], name)


def test_mesh_refuses_unfolded_weights_and_misplaced_islands():
    cfg = build_config("DiT-XS/8", block_kernel="mega_tp", **XS8)
    with pytest.raises(ValueError, match="folded"):
        build_sample_fn(cfg, {}, create_diffusion("2", device="cpu"), fold=False, mesh=_cpu_mesh(1, 2))
    with pytest.raises(ValueError, match="model axis"):
        build_sample_fn(cfg, {}, create_diffusion("2", device="cpu"), mesh=_cpu_mesh(4, 1))
    with pytest.raises(ValueError, match="mesh="):
        build_sample_fn(cfg, {}, create_diffusion("2", device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="folded"):
        shard_state_dict({}, cfg, _cpu_mesh(1, 2), "mega_tp")
    for kernel in ("mega_attn_tp", "mega_tp"):
        # a block of an unfolded model refuses its island before it looks for a mesh
        model = DiT(cfg.replace(block_kernel=kernel)).eval()
        with pytest.raises(ValueError, match="folded"), torch.no_grad():
            model.blocks[0](torch.zeros(2, cfg.num_patches, cfg.hidden_size), torch.zeros(2, cfg.hidden_size))
        model = DiT(cfg.replace(block_kernel=kernel, fold_weights=True)).eval()
        with pytest.raises(RuntimeError, match="needs a mesh"), torch.no_grad():
            model.blocks[0](torch.zeros(2, cfg.num_patches, cfg.hidden_size), torch.zeros(2, cfg.hidden_size))


def test_islands_refuse_autograd():
    """Inference-only, as in the JAX package: an input that requires grad
    under autograd raises instead of cutting the graph."""
    a = {k: torch.from_numpy(x) for k, x in _block_inputs().items()}
    w_qkv = shard_tensor(a["w_qkv"], "qkv", 2, 0).requires_grad_()
    w_out = shard_tensor(a["w_out"], "cols", 2, 0)
    with pytest.raises(RuntimeError, match="inference-only"):
        dit_block_tp.fused_dit_block_tp(a["x"], a["a"], a["gains"], a["w_mod"], w_qkv, w_out, a["w1"], a["w2"],
                                        heads_local=2, hidden_total=256)
    with pytest.raises(RuntimeError, match="inference-only"):
        dit_block_tp.fused_attn_branch_tp(a["x"], a["shift"], a["scale"], a["gate"], torch.tensor(0.3, requires_grad=True),
                                          w_qkv.detach(), w_out, heads_local=2)
