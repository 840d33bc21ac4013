"""The port's sampling entry points (python -m mapdit_tpu_torch.sample,
.sample_ema, .sample_fid) on the CPU, in process, on an experiment the
port's train CLI wrote (DiT-XS/8, 12 steps, EMA snapshots): every sampler
flag, the seed rule, the VAE path, the artifacts, the PNG writer against the
JAX package's PIL grid, decode_latents against the JAX script's, the weight
loading paths, and the refused flags. A distilled student's sampling is
tests/test_torch_distill.py's; sample_fid's parallel-in-time and mesh
layouts are tests/test_torch_pit.py's and tests/test_torch_dp_sample.py's."""

import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from mapdit_tpu_torch import sample, sample_ema, sample_fid, train
from mapdit_tpu_torch.models.vae import init_vae
from mapdit_tpu_torch.utils.image import save_image_grid
from mapdit_tpu_torch.utils.safetensors import save_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)  # as tests/test_torch_train_cli.py: workers share the cores


@pytest.fixture(autouse=True)
def _drop_tmp_path(tmp_path):
    """Each test's files go when it ends (a failing test's too): the tier-1
    run's tests write GBs of checkpoints and weights, and pytest keeps the
    last three runs' directories, so they filled the disk."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """A 12-step DiT-XS/8 run of the port's train CLI: checkpoint 12, EMA
    snapshots at 4, 8 and 12."""
    results = tmp_path_factory.mktemp("results")
    flags = ["--device", "cpu", "--data-path", "synthetic:64", "--model", "DiT-XS/8", "--num-classes", "10",
             "--batch-size", "8", "--num-lin-warmup", "2", "--start-decay", "8", "--num-steps", "12",
             "--log-every", "6", "--ckpt-every", "12", "--ema-snapshot-every", "4",
             "--results-dir", str(results)]
    yield train.main(train.build_parser().parse_args(flags))
    shutil.rmtree(results, ignore_errors=True)


@pytest.fixture(scope="module")
def vae_path(tmp_path_factory):
    """A random-weight VAE of the port's init, through the port's writer."""
    vae_dir = tmp_path_factory.mktemp("vae")
    path = str(vae_dir / "vae.safetensors")
    save_file({k: v.numpy() for k, v in init_vae(0).state_dict().items()}, path)
    yield path
    shutil.rmtree(vae_dir, ignore_errors=True)


def jax_script(name):
    """A JAX root script as a module (its name would clash with the port's)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(REPO, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run(module, exp, tmp_path, *flags, out="out.png"):
    argv = ["--device", "cpu", "--result-dir", exp, "--use-vae", "false", "--num-sampling-steps", "4", *flags]
    if module is sample:  # clipped: an untrained model's unclipped chain overflows
        argv += ["--clip-denoised", "true", "--cfg-scale", "1.5"]
    if module is not sample_fid:
        argv += ["--class-label", "3", "--output-file", str(tmp_path / out)]
    else:
        argv += ["--num-classes", "10"]
    return module.main(module.build_parser().parse_args(argv))


def grid(path):
    return np.asarray(Image.open(path))


@pytest.mark.parametrize("flags", [
    [],
    ["--sampler", "ddim", "--eta", "1.0"],
    ["--sampler", "dpm++", "--time-schedule", "karras"],
    ["--sampler", "unipc", "--cfg-interval", "0.3", "3.0"],
    ["--cache-interval", "2", "--cache-mode", "hold"],
    ["--sampler", "dpm++", "--cache-interval", "2", "--cfg-interval", "0.3", "3.0"],
    ["--sampler", "dpm++", "--dynamic-threshold", "0.99"],
    ["--ckpt", "0000012", "--clip-denoised", "false", "--cfg-scale", "1.0"],
    ["--ema-std", "0.08", "--block-kernel", "off"],
], ids=lambda f: "-".join(a.lstrip("-") for a in f) or "default")
def test_sample_cli_writes_the_grid(exp, tmp_path, flags):
    """Four samples of one class as a 2 x 2 grid of 16 x 16 four-channel
    latents (no VAE), padding 2."""
    img = grid(run(sample, exp, tmp_path, *flags))
    assert img.shape == (2 * 18 + 2, 2 * 18 + 2, 4) and img.dtype == np.uint8
    assert img[2:18, 2:18].std() > 0


def test_sample_cli_seed_rule(exp, tmp_path):
    """One generator seeded from --seed draws z and the step noise: the same
    seed writes the same grid, another seed another."""
    a = grid(run(sample, exp, tmp_path, "--seed", "7", out="a.png"))
    b = grid(run(sample, exp, tmp_path, "--seed", "7", out="b.png"))
    c = grid(run(sample, exp, tmp_path, "--seed", "8", out="c.png"))
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_sample_cli_trajectory(exp, tmp_path):
    traj = str(tmp_path / "traj.png")
    run(sample, exp, tmp_path, "--save-trajectory", traj)
    assert grid(traj).shape == (4 * 18 + 2, 4 * 18 + 2, 4)  # 4 samples x min(8, 4 steps) frames


def test_sample_cli_with_vae(exp, tmp_path, vae_path):
    """Through the VAE: RGB images of 8 x 8 pixels a latent pixel."""
    img = grid(run(sample, exp, tmp_path, "--use-vae", "true", "--vae-path", vae_path, "--num-sampling-steps", "2"))
    assert img.shape == (2 * 130 + 2, 2 * 130 + 2, 3)


def test_sample_cli_without_vae_weights_writes_latents(exp, tmp_path, capsys):
    img = grid(run(sample, exp, tmp_path, "--use-vae", "true", "--vae-path", str(tmp_path / "absent.safetensors")))
    assert img.shape[2] == 4 and "no VAE weights" in capsys.readouterr().out


def test_sample_ema_cli(exp, tmp_path):
    """Eight samples at each of the five EMA stds, a column per std; the
    latents are the same in every column."""
    img = grid(run(sample_ema, exp, tmp_path, "--sampler", "dpm++"))
    assert img.shape == (8 * 18 + 2, 5 * 18 + 2, 4)
    assert not np.array_equal(img[2:18, 2:18], img[2:18, 20:36])


@pytest.mark.parametrize("cfg_scale", ["1.0", "1.5"])
def test_sample_fid_cli(exp, cfg_scale):
    """The uint8 NHWC arr_0 npz in <result-dir>/fid_samples/, cut to
    --num-samples; CFG only above scale 1."""
    path = run(sample_fid, exp, None, "--num-samples", "5", "--batch-size", "2", "--cfg-scale", cfg_scale,
               "--output-file", f"s{cfg_scale}.npz")
    assert path == os.path.join(exp, "fid_samples", f"s{cfg_scale}.npz")
    with np.load(path) as f:
        arr = f["arr_0"]
    assert arr.dtype == np.uint8 and arr.shape == (5, 16, 16, 4)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_matches_jax_grid(tmp_path, channels):
    """The port's PNG, decoded by PIL, equals the JAX package's PIL-written
    grid of the same batch pixel for pixel (NaNs and out-of-range values
    included)."""
    from mapdit_tpu.utils.image import save_image_grid as jax_save_image_grid

    batch = np.random.default_rng(channels).normal(size=(5, channels, 9, 7)).astype(np.float32) * 1.5
    batch[0, 0, 0, 0] = np.nan
    save_image_grid(batch, tmp_path / "port.png", nrow=3)
    jax_save_image_grid(batch, tmp_path / "jax.png", nrow=3)
    a, b = Image.open(tmp_path / "port.png"), Image.open(tmp_path / "jax.png")
    assert a.mode == b.mode and np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("use_vae", [True, False])
def test_decode_latents_matches_jax(exp, vae_path, use_vae):
    """Denormalization, the VAE decode and the clip against the JAX script's
    decode_latents on the same latents and weights."""
    jax_sample = jax_script("sample")
    args = {"stats_mean": [0.1, -0.2, 0.3, 0.0], "stats_std": [1.5, 0.5, 2.0, 1.0]}
    z = np.random.default_rng(4).normal(size=(2, 4, 8, 8)).astype(np.float32)
    want = jax_sample.decode_latents(z, args, use_vae, vae_path)
    got = sample.decode_latents(z, args, use_vae, vae_path, device="cpu")
    assert got.shape == ((2, 3, 64, 64) if use_vae else z.shape)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    raw = sample.decode_latents(z, args, False, clip=False)
    assert np.abs(raw).max() > 1.0


def test_load_variables(exp, tmp_path):
    """The EMA at a snapshot's std is that snapshot (plus the buffers of
    constants.pt); --ckpt loads the port's checkpoint and the reference's
    {"model": state_dict} with torch.compile's prefix; a JAX .msgpack
    checkpoint names the converter."""
    from mapdit_tpu_torch.utils.experiment import load_config

    args = load_config(exp)
    sd = sample.load_variables(exp, args, None, 0.05)
    with np.load(os.path.join(exp, "ema", "0.050_0000012.npz")) as snap:
        for name in snap.files:
            np.testing.assert_array_equal(sd[name].numpy(), snap[name].astype(np.float32))
    constants = torch.load(os.path.join(exp, "constants.pt"), weights_only=True)
    assert all(torch.equal(sd[k], v.float()) for k, v in constants.items())
    ckpt = sample.load_variables(exp, args, "0000012")
    tree = torch.load(os.path.join(exp, "checkpoints", "0000012.pt"), weights_only=True)
    assert ckpt.keys() == sd.keys() == tree["model"].keys()

    ref = tmp_path / "ref"
    (ref / "checkpoints").mkdir(parents=True)
    for name in ("config.yaml",):
        (ref / name).write_text(open(os.path.join(exp, name)).read())
    torch.save({"model": {f"_orig_mod.{k}": v for k, v in tree["model"].items()}}, ref / "checkpoints" / "0000005.pt")
    got = sample.load_variables(str(ref), args, "0000005")
    assert all(torch.equal(got[k], tree["model"][k].float()) for k in got)
    (ref / "checkpoints" / "0000009.msgpack").write_bytes(b"")
    with pytest.raises(FileNotFoundError, match="convert_jax_checkpoint"):
        sample.load_variables(str(ref), args, "0000009")


def test_deferred_and_refused_flags(exp, tmp_path, monkeypatch):
    """The JAX scripts' refusals hold: sample_fid's layout refusals (JAX
    sample_fid.py:82-106: parallel-in-time needs ddim at eta 0 and the
    gspmd layout without a cfg interval, shard_map is data-parallel only)
    and the port's own, --n-model > 1 outside torchrun; the sampling CLIs'
    (a distilled student's: tests/test_torch_distill.py)."""
    for flags, match in (
        (["--pit-window", "4"], "--sampler ddim --eta 0"),
        (["--pit-window", "4", "--sampler", "ddim", "--eta", "1.0"], "--sampler ddim --eta 0"),
        (["--pit-window", "4", "--sampler", "ddim", "--cfg-interval", "0.3", "3.0"], "gspmd layout only"),
        (["--n-model", "2", "--kernel-sharding", "shard_map"], "data-parallel only"),
        (["--n-model", "2"], "torchrun"),
    ):
        with pytest.raises(SystemExit, match=match):
            run(sample_fid, exp, tmp_path, "--num-samples", "2", *flags)
    with pytest.raises(ValueError, match="--save-trajectory"):
        run(sample, exp, tmp_path, "--sampler", "ddim", "--save-trajectory", str(tmp_path / "t.png"))
    with pytest.raises(ValueError, match="--cache-interval"):
        run(sample, exp, tmp_path, "--sampler", "unipc", "--cache-interval", "2")
    with pytest.raises(SystemExit):
        sample.build_parser().parse_args(["--result-dir", exp, "--dynamic-threshold", "1.5"])
    with pytest.raises(SystemExit, match="config.yaml"):
        run(sample, str(tmp_path), tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sample.main(sample.build_parser().parse_args(["--result-dir", exp]))
