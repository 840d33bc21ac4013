"""The port's data path and the tools that read model outputs against the
JAX package: save_dataset read by both packages' loaders, the encode step
of download_data against the JAX encoder on the same random VAE weights
(tools/fake_vae.py) and flips, the fid metrics against tools/fid.py, the
distribution probe's data, metrics and JSON against
tools/distribution_probe.py, the probe end to end in process at a tiny
budget, the guidance sweep and the FID protocol runner on a train-CLI run.
CPU, XS sizes; learning itself is held on the card (chip_smoke.py phase
8e)."""

import importlib.util
import json
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapdit_tpu.training.data import LatentDataset as JaxLatentDataset
from mapdit_tpu.training.data import save_dataset as jax_save_dataset
from mapdit_tpu_torch import sample_fid, train
from mapdit_tpu_torch.download_data import encode_batches, mog_stats, preprocess
from mapdit_tpu_torch.tools import distribution_probe as probe
from mapdit_tpu_torch.tools import fid, guidance_sweep, run_fid50k
from mapdit_tpu_torch.training.data import LatentDataset, save_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
# several workers share the machine's cores (tests/test_torch_train.py)
torch.set_num_threads(2)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_fid = _jax_tool("fid")
jax_probe = _jax_tool("distribution_probe")


@pytest.fixture(autouse=True)
def _drop_tmp_path(tmp_path):
    """Each test's files go when it ends (a failing test's too)."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


# ------------------------------------------------------------------ data


def _posterior(seed=0, n=24):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 4, 8, 8)).astype(np.float32)
    stds = (0.1 + 0.05 * rng.random((n, 4, 8, 8))).astype(np.float32)
    labels = rng.integers(0, 5, n).astype(np.int64)
    return means, stds, labels, mog_stats(means, stds)


def test_save_dataset_is_read_alike_by_both_loaders(tmp_path):
    """The port's save_dataset writes the JAX save_dataset's files (the
    same arrays), and the port's and the JAX package's LatentDataset read
    them back to the same batches."""
    means, stds, labels, stats = _posterior()
    save_dataset(str(tmp_path / "port"), means, stds, labels, stats)
    jax_save_dataset(str(tmp_path / "jax"), means, stds, labels, stats)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for name in ("posterior_means.npy", "posterior_stds.npy", "labels.npy"):
        a, b = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    port, jax_ds = LatentDataset(str(tmp_path / "port")), JaxLatentDataset(str(tmp_path / "port"))
    assert len(port) == len(jax_ds) == 24 and port.channels == 4 and port.data_size == 8
    for key in ("mean", "std"):
        assert np.array_equal(port.stats[key], stats[key]) and np.array_equal(jax_ds.stats[key], stats[key])
    for a, b, _ in zip(port.batches(8, seed=3), jax_ds.batches(8, seed=3), range(4)):
        for key in ("mean", "std", "y"):
            assert np.array_equal(a[key], b[key]), key


@pytest.fixture(scope="module")
def fake_vae(tmp_path_factory):
    """tools/fake_vae.py's random weights written as .safetensors."""
    from safetensors.numpy import save_file

    from fake_vae import fabricate_state_dict

    vae_dir = tmp_path_factory.mktemp("vae")
    path = str(vae_dir / "vae.safetensors")
    save_file(fabricate_state_dict(0), path)
    yield path
    shutil.rmtree(vae_dir, ignore_errors=True)


def test_encode_matches_the_jax_encoder(fake_vae):
    """download_data's encode of uint8 32 x 32 images in two batches against
    the JAX script's per-batch body (flip with the numpy rng, [-1, 1], NCHW,
    the JAX encoder) on the same weights and seed: posterior means and stds
    within 1e-4, the same labels, and the mixture statistics of the JAX
    script's formula."""
    from mapdit_tpu.models.vae import load_encoder as jax_load_encoder
    from mapdit_tpu_torch.models.vae import load_encoder

    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    labels = np.arange(6) % 3
    batches = [(images[:4], labels[:4]), (images[4:], labels[4:])]
    means, stds, got_labels = encode_batches(load_encoder(fake_vae, "cpu"), batches, 6, 32, seed=7, device="cpu")

    jax_encoder, flips = jax_load_encoder(fake_vae), np.random.default_rng(7)
    want_means, want_stds = [], []
    for imgs, _ in batches:
        imgs = imgs.astype(np.float32)
        flip = flips.random(len(imgs)) < 0.5
        imgs[flip] = imgs[flip][:, :, ::-1]
        imgs = (imgs / 127.5 - 1.0).transpose(0, 3, 1, 2)
        mean, std = jax_encoder(jnp.asarray(imgs))
        want_means.append(np.asarray(mean))
        want_stds.append(np.asarray(std))
    assert means.shape == stds.shape == (6, 4, 4, 4)
    np.testing.assert_allclose(means, np.concatenate(want_means), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(stds, np.concatenate(want_stds), rtol=1e-4, atol=1e-4)
    assert np.array_equal(got_labels, labels)
    mu_bar = means.mean(axis=(0, 2, 3))
    var = (stds**2).mean(axis=(0, 2, 3)) + ((means - mu_bar[None, :, None, None]) ** 2).mean(axis=(0, 2, 3))
    stats = mog_stats(means, stds)
    assert np.array_equal(stats["mean"], mu_bar) and np.array_equal(stats["std"], np.sqrt(var))
    # the flips: an image drawn to flip comes out mirrored
    x = preprocess(images[:2], np.random.default_rng(0))
    flipped = np.random.default_rng(0).random(2) < 0.5
    for i in range(2):
        want = images[i, :, ::-1] if flipped[i] else images[i]
        assert np.array_equal(x[i], want.astype(np.float32).transpose(2, 0, 1) / 127.5 - 1.0)


def test_download_data_refuses_without_weights_or_datasets(fake_vae, tmp_path, monkeypatch):
    """main ends with a SystemExit naming what is missing: the VAE weights,
    or the datasets package (absent on the card), which only main imports."""
    from mapdit_tpu_torch import download_data

    parser = download_data.build_parser()
    with pytest.raises(SystemExit, match="SD-VAE weights not found"):
        download_data.main(parser.parse_args(["--output-dir", str(tmp_path / "out"), "--vae-path",
                                              str(tmp_path / "missing.safetensors"), "--device", "cpu"]))
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(SystemExit, match="needs the datasets package"):
        download_data.main(parser.parse_args(["--output-dir", str(tmp_path / "out"), "--vae-path", fake_vae,
                                              "--dataset", "imagefolder:" + str(tmp_path), "--device", "cpu"]))
    assert not (tmp_path / "out").exists()


# ------------------------------------------------------------------- fid


def test_fid_functions_match_the_jax_tool(tmp_path, monkeypatch):
    """frechet_distance, activation_stats, kid_score, precision_recall and
    the random-projection features against tools/fid.py on the same arrays
    (the same code: equal to 1e-12); the statistics files refuse to mix
    extractors; --features inception raises rather than fall back."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (40, 8, 8, 3), dtype=np.uint8)
    ref = rng.integers(0, 256, (32, 8, 8, 3), dtype=np.uint8)
    f1, f2 = fid.random_projection_features(images), fid.random_projection_features(ref)
    assert np.array_equal(f1, jax_fid.random_projection_features(images))
    mu1, s1 = fid.activation_stats(f1)
    mu2, s2 = fid.activation_stats(f2)
    for got, want in zip((mu1, s1), jax_fid.activation_stats(f1)):
        assert np.array_equal(got, want)
    np.testing.assert_allclose(fid.frechet_distance(mu1, s1, mu2, s2), jax_fid.frechet_distance(mu1, s1, mu2, s2),
                               rtol=1e-12)
    np.testing.assert_allclose(fid.kid_score(f1, f2, subset_size=16, n_subsets=5),
                               jax_fid.kid_score(f1, f2, subset_size=16, n_subsets=5), rtol=1e-12)
    assert fid.precision_recall(f2, f1) == jax_fid.precision_recall(f2, f1)

    samples, ref_path, stats = tmp_path / "a.npz", tmp_path / "b.npz", tmp_path / "stats.npz"
    np.savez(samples, arr_0=images)
    np.savez(ref_path, arr_0=ref)
    fid.main(["--make-stats", str(ref_path), "--out", str(stats), "--features", "random-proj"])
    with np.load(stats) as f:
        assert str(f["features"]) == "random-proj"
    scores = fid.main(["--samples", str(samples), "--ref-stats", str(stats), "--features", "random-proj"])
    np.testing.assert_allclose(scores["fid"], jax_fid.frechet_distance(mu1, s1, mu2, s2), rtol=1e-9)
    scores = fid.main(["--samples", str(samples), "--ref-samples", str(ref_path), "--features", "random-proj",
                       "--metric", "all", "--kid-subset-size", "16", "--kid-subsets", "5"])
    assert set(scores) == {"fid", "kid", "kid_std", "precision", "recall"}
    with pytest.raises(SystemExit, match="refusing to compare"):
        fid.main(["--samples", str(samples), "--ref-stats", str(stats), "--features", "inception"])
    monkeypatch.setitem(sys.modules, "torchvision", None)
    with pytest.raises(RuntimeError, match="random-proj"):
        fid.inception_features(images, device="cpu")


# ------------------------------------------------------ distribution probe


def test_probe_data_and_metrics_match_the_jax_tool(tmp_path):
    """make_data writes the JAX tool's dataset and ground truth for the same
    arguments; dist_metrics, conditioning_signal, finite_json and rel_l2
    give the JAX tool's values on the same arrays."""
    gt = probe.make_data(str(tmp_path / "port"), classes=4, examples=256, input_size=8)
    want = jax_probe.make_data(str(tmp_path / "jax"), classes=4, examples=256, input_size=8)
    for key in want:
        assert np.array_equal(gt[key], want[key]), key
    for name in ("posterior_means.npy", "posterior_stds.npy", "labels.npy"):
        assert np.array_equal(np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)), name
    for name in ("stats.npz", "ground_truth.npz"):
        with np.load(tmp_path / "port" / name) as a, np.load(tmp_path / "jax" / name) as b:
            assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files), name
    with pytest.raises(ValueError, match="zero examples"):
        probe.make_data(str(tmp_path / "empty"), classes=64, examples=8, input_size=8)

    rng = np.random.default_rng(0)
    lat = gt["class_means"][:, None, :, None, None] + 0.3 * rng.normal(size=(4, 16, 4, 8, 8)).astype(np.float32)
    lat[1, 3, 0, 0, 0] = np.nan
    # NaN is not equal to itself: compare the JSON-safe forms
    assert probe.finite_json(probe.dist_metrics(lat, gt)) == jax_probe.finite_json(jax_probe.dist_metrics(lat, gt))
    clean = np.nan_to_num(lat)
    assert probe.dist_metrics(clean, gt) == jax_probe.dist_metrics(clean, gt)
    assert probe.rel_l2(clean, clean + 1) == jax_probe.rel_l2(clean, clean + 1)
    sig = probe.conditioning_signal(gt, float(gt["total_std"]), 8, n=64, t_stride=200)
    assert sig == jax_probe.conditioning_signal(gt, float(gt["total_std"]), 8, n=64, t_stride=200)
    row = {"a": float("nan"), "b": [1.0, float("inf")], "c": {"d": 2.0}}
    assert probe.finite_json(row) == jax_probe.finite_json(row) == {"a": None, "b": [1.0, None], "c": {"d": 2.0}}


def test_probe_runs_end_to_end_in_process(tmp_path):
    """The probe at a tiny budget on the CPU: the train CLI in this process
    with the arguments run_train passes to its subprocess, then the probe
    with --skip-train, the init baseline and --grid: its one JSON line has
    the JAX tool's keys, finite trained metrics and one row a grid config
    (the JAX grid less its parallel-in-time rows)."""
    work = str(tmp_path)
    argv = ["--work-dir", work, "--model", "DiT-XS/4", "--classes", "4", "--input-size", "8", "--train-steps", "8",
            "--batch-size", "16", "--samples-per-class", "2", "--num-sampling-steps", "4", "--examples", "64",
            "--device", "cpu", "--train-args", "--device cpu"]
    args = probe.build_parser().parse_args(argv)
    data_dir, results_dir = os.path.join(work, "data"), os.path.join(work, "results")
    probe.make_data(data_dir, args.classes, args.examples, args.input_size)
    cli = train.build_parser().parse_args(probe.train_argv(args, data_dir, results_dir))
    assert (cli.device, cli.num_steps, cli.ckpt_every, cli.num_classes) == ("cpu", 8, 8, 4)
    train.main(cli)
    out = probe.main(argv + ["--skip-train", "--grid"])
    assert json.loads(json.dumps(out)) == out
    for key in ("metric", "model", "classes", "train_steps", "batch_size", "sampler", "samples_per_class",
                "chance_acc", "mean_err_trained", "std_ratio_trained", "label_acc_trained", "mean_err_init",
                "std_ratio_init", "label_acc_init", "conditioning_signal", "run_dir", "grid"):
        assert key in out, key
    assert out["sampler"] == "dpm++:4:karras" and out["run_dir"].endswith("000-DiT-XS-4")
    assert all(np.isfinite(out[k]) for k in ("mean_err_trained", "std_ratio_trained", "label_acc_trained"))
    assert [row["config"] for row in out["grid"]] == [g[1] for g in probe.GRID] and len(out["grid"]) == 13


# --------------------------------------------- sweep and the FID protocol


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A 2-step DiT-XS/8 train-CLI run with EMA snapshots (1000 classes,
    sample_fid's default)."""
    results = tmp_path_factory.mktemp("tiny_run")
    yield train.main(train.build_parser().parse_args([
        "--device", "cpu", "--data-path", "synthetic:16", "--results-dir", str(results), "--model", "DiT-XS/8",
        "--num-classes", "1000", "--batch-size", "8", "--num-steps", "2", "--log-every", "1", "--ckpt-every", "2",
        "--ema-snapshot-every", "1"]))
    shutil.rmtree(results, ignore_errors=True)


def test_guidance_sweep_scores_every_point(tiny_run, tmp_path, monkeypatch):
    """The sweep over CFG 1.5 and CFG 4.0 with the interval 0.3:3.0 (the
    card's two points): each point's sample_fid arguments (here run in
    process in place of the subprocess) write its npz, and each row is
    finite and scored against the reference set with the port's fid."""
    def in_process(args, cfg_scale, interval, out_npz):
        sample_fid.main(sample_fid.build_parser().parse_args(
            guidance_sweep.sample_fid_argv(args, cfg_scale, interval, out_npz)))

    monkeypatch.setattr(guidance_sweep, "run_grid_point", in_process)
    ref = sample_fid.main(sample_fid.build_parser().parse_args([
        "--result-dir", tiny_run, "--use-vae", "false", "--num-samples", "8", "--batch-size", "4",
        "--num-sampling-steps", "4", "--sampler", "dpm++", "--seed", "9", "--device", "cpu",
        "--output-file", str(tmp_path / "ref.npz")]))
    rows = guidance_sweep.main([
        "--result-dir", tiny_run, "--ref-samples", ref, "--cfg-scales", "1.5,4.0", "--cfg-intervals",
        "none,0.3:3.0", "--num-samples", "8", "--batch-size", "4", "--steps", "4",
        "--features", "random-proj", "--device", "cpu", "--out", str(tmp_path / "sweep.jsonl")])
    assert [(r["cfg_scale"], r["cfg_interval"]) for r in rows] == [
        (1.5, None), (1.5, [0.3, 3.0]), (4.0, None), (4.0, [0.3, 3.0])]
    for row in rows:
        assert all(np.isfinite(row[k]) for k in ("fid", "kid", "kid_std", "precision", "recall")), row
        assert fid.load_samples(row["sample_npz"]).shape == (8, 16, 16, 4)
    assert [json.loads(line) for line in open(tmp_path / "sweep.jsonl")] == rows


def test_run_fid50k_drives_sample_fid_and_reads_its_peak_rss(tiny_run):
    """The protocol runner at 4 samples: sample_fid in a subprocess (250
    DDPM steps, CFG 1.5, clipped), its peak resident memory read, the npz's
    shape, and the random-projection FID of the samples against their own
    statistics (~0: sqrtm's rounding)."""
    report = run_fid50k.main(["--result-dir", tiny_run, "--num-samples", "4", "--batch-size", "4",
                              "--output-file", "fid4.npz", "--device", "cpu"])
    assert report["shape"] == [4, 16, 16, 4] and report["peak_rss_kb"] > 100_000
    assert abs(report["fid"]) < 1e-3 and os.path.exists(report["stats"])
