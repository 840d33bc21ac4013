"""The port's SD-VAE (models/vae.py) against the JAX package's on the same
diffusers-layout weights (tools/fake_vae.py's fabricate_state_dict), its key
mapping, and the port's safetensors reader and writer against the
safetensors package."""

import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapdit_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from mapdit_tpu.models.vae import _torch_key_to_flax, load_vae_variables
from mapdit_tpu_torch.models.vae import (
    AutoencoderKL, diffusers_key, init_vae, load_decoder, load_encoder, load_state_dict,
)
from mapdit_tpu_torch.utils import safetensors as port_st

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
torch.set_num_threads(2)  # a few workers share the machine's cores
TOL = dict(rtol=1e-4, atol=1e-4)
LEGACY = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}


@pytest.fixture(autouse=True)
def _drop_tmp_path(tmp_path):
    """Each test's files go when it ends (a failing test's too): the tier-1
    run's tests write GBs of checkpoints and weights, and pytest keeps the
    last three runs' directories, so they filled the disk."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """fabricate_state_dict(0) as numpy arrays, the same written as
    .safetensors by the safetensors package, and the JAX variables the JAX
    loader reads from that file."""
    from safetensors.numpy import save_file

    from fake_vae import fabricate_state_dict

    sd = fabricate_state_dict(0)
    vae_dir = tmp_path_factory.mktemp("vae")
    path = str(vae_dir / "vae.safetensors")
    save_file(sd, path)
    yield sd, path, load_vae_variables(path)
    shutil.rmtree(vae_dir, ignore_errors=True)


def test_decode_matches_jax(weights):
    sd, _, variables = weights
    z = np.random.default_rng(0).normal(size=(2, 4, 8, 8)).astype(np.float32)
    want = np.asarray(JaxAutoencoderKL().apply(variables, jnp.asarray(z), method=JaxAutoencoderKL.decode))
    with torch.no_grad():
        got = load_state_dict(AutoencoderKL(), sd).decode(torch.from_numpy(z)).numpy()
    assert got.shape == (2, 3, 64, 64)
    np.testing.assert_allclose(got, want, **TOL)


def test_encode_matches_jax(weights):
    sd, _, variables = weights
    x = np.random.default_rng(1).uniform(-1, 1, size=(2, 3, 64, 64)).astype(np.float32)
    want = JaxAutoencoderKL().apply(variables, jnp.asarray(x), method=JaxAutoencoderKL.encode)
    with torch.no_grad():
        got = load_state_dict(AutoencoderKL(), sd).encode(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert g.shape == (2, 4, 8, 8)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_loaders_read_both_formats(weights, tmp_path):
    """load_decoder / load_encoder read .safetensors through the port's own
    reader and .pt through torch.load, and give None for a missing path."""
    sd, path, _ = weights
    pt = str(tmp_path / "vae.pt")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, pt)
    z = torch.from_numpy(np.random.default_rng(2).normal(size=(1, 4, 8, 8)).astype(np.float32))
    outs = [load_decoder(p, device="cpu")(z) for p in (path, pt)]
    assert torch.equal(*outs)
    x = torch.zeros(1, 3, 32, 32)
    mean, std = load_encoder(path, device="cpu")(x)
    assert mean.shape == (1, 4, 4, 4) and bool((std > 0).all())
    for missing in (None, "", str(tmp_path / "absent.safetensors")):
        assert load_decoder(missing, device="cpu") is None and load_encoder(missing, device="cpu") is None


def test_key_coverage(weights):
    """The module's parameters are exactly the diffusers checkpoint's keys,
    each of which the JAX loader maps too."""
    sd, _, _ = weights
    assert set(AutoencoderKL().state_dict()) == set(sd)
    for key in sd:
        base = key.rsplit(".", 1)[0]
        base = base[: -len(".0")] if base.endswith("to_out.0") else base
        assert _torch_key_to_flax(base) is not None, key


def test_legacy_attention_names_load(weights):
    """query/key/value/proj_attn (older diffusers) load as to_q/to_k/to_v/
    to_out.0, as the JAX loader accepts both."""
    sd, _, _ = weights
    legacy = {}
    for key, value in sd.items():
        for new, old in LEGACY.items():
            key = key.replace(f"attentions.0.{new}.", f"attentions.0.{old}.")
        legacy[key] = value
    assert legacy.keys() != sd.keys()
    assert {diffusers_key(k) for k in legacy} == set(sd)
    a, b = load_state_dict(AutoencoderKL(), sd), load_state_dict(AutoencoderKL(), legacy)
    for name, value in a.state_dict().items():
        assert torch.equal(value, b.state_dict()[name]), name


def test_unmapped_and_missing_keys_raise(weights):
    sd, _, _ = weights
    with pytest.raises(KeyError, match="unmapped"):
        load_state_dict(AutoencoderKL(), {**sd, "decoder.mid_block.attentions.0.rel_pos.weight": np.zeros(3)})
    partial = dict(sd)
    partial.pop("decoder.conv_out.bias")
    with pytest.raises(KeyError, match="missing"):
        load_state_dict(AutoencoderKL(), partial)


def test_init_vae_is_seeded():
    state = torch.random.get_rng_state()
    a, b, c = init_vae(0), init_vae(0), init_vae(1)
    assert torch.equal(torch.random.get_rng_state(), state)
    for name, value in a.state_dict().items():
        assert torch.equal(value, b.state_dict()[name])
    assert not torch.equal(a.decoder.conv_in.weight, c.decoder.conv_in.weight)


def test_safetensors_writer_against_package(tmp_path):
    """The port writes what the safetensors package reads, and reads what
    it writes: F32, F16, I64 and (read only) BF16, with metadata."""
    import safetensors.numpy as st_np
    import safetensors.torch as st_torch

    rng = np.random.default_rng(3)
    arrays = {"a.weight": rng.normal(size=(3, 5)).astype(np.float32), "b": rng.normal(size=(7,)).astype(np.float16),
              "c.idx": np.arange(6, dtype=np.int64).reshape(2, 3), "d.scalar": np.array(2.5, np.float32),
              "e.empty": np.zeros((0, 4), np.float32)}
    path = str(tmp_path / "port.safetensors")
    port_st.save_file(arrays, path, metadata={"format": "np"})
    read = st_np.load_file(path)
    assert read.keys() == arrays.keys()
    for name, value in arrays.items():
        assert read[name].dtype == value.dtype and read[name].shape == value.shape
        np.testing.assert_array_equal(read[name], value)

    ref = str(tmp_path / "ref.safetensors")
    bf = torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32)).to(torch.bfloat16)
    st_torch.save_file({"bf": bf, **{k: torch.from_numpy(v) for k, v in arrays.items()}}, ref, metadata={"x": "y"})
    got = port_st.load_file(ref)
    np.testing.assert_array_equal(got["bf"], bf.float().numpy())
    for name, value in arrays.items():
        assert got[name].dtype == value.dtype
        np.testing.assert_array_equal(got[name], value)
    with pytest.raises(ValueError, match="dtype"):
        port_st.save_file({"x": np.zeros(2, np.float64)}, str(tmp_path / "bad.safetensors"))
