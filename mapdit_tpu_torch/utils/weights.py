"""Carry weights across: the JAX package's variables -> the port's state dict.

The port's modules use the reference's state-dict names, so a reference
state dict (for example the goldens' ``sd.*`` arrays) loads as it is, and a
JAX ``{'params', 'constants'}`` tree maps over by renaming alone: every
weight is stored (out, in) in both. This module keeps its own copy of the
name table of ``mapdit_tpu/utils/torch_import.py``, extended to every flag
family: each ``weight`` may have a ``bias`` beside it (weight normalization
off); a ``scan_blocks`` tree's ``params/blocks/...`` leaves, stacked on a
leading depth axis, map onto the port's stacked ``blocks.<name>`` entries;
the Fourier constants exist only under ``use_mp_embedding`` and the
output scales only in the MP style; the shapes (the ones column of
``x_embedder``, the 4D / 5D / 6D rows of a modulation head) come with the
arrays.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

# (reference state-dict key, JAX variable path); {0} is the block index
_NAMES = [
    ("x_embedder.weight", "params/x_embedder/weight"),
    ("t_embedder.mlp.net.0.weight", "params/t_embedder/mlp/fc1/weight"),
    ("t_embedder.mlp.net.2.weight", "params/t_embedder/mlp/fc2/weight"),
    ("t_embedder.embedding.scale", "constants/t_embedder/fourier/scale"),
    ("t_embedder.embedding.shift", "constants/t_embedder/fourier/shift"),
    ("y_embedder.embedding.weight", "params/y_embedder/embedding/weight"),
    ("blocks.{0}.attn.qkv_proj.weight", "params/blocks_{0}/attn/qkv_proj/weight"),
    ("blocks.{0}.attn.out_proj.weight", "params/blocks_{0}/attn/out_proj/weight"),
    ("blocks.{0}.mlp.net.0.weight", "params/blocks_{0}/mlp/fc1/weight"),
    ("blocks.{0}.mlp.net.2.weight", "params/blocks_{0}/mlp/fc2/weight"),
    ("blocks.{0}.modulation.1.weight", "params/blocks_{0}/modulation/linear/weight"),
    ("blocks.{0}.gain_msa", "params/blocks_{0}/gain_msa"),
    ("blocks.{0}.gain_mlp", "params/blocks_{0}/gain_mlp"),
    ("final_layer.linear.weight", "params/final_layer/linear/weight"),
    ("final_layer.modulation.1.weight", "params/final_layer/modulation/linear/weight"),
    ("final_layer.gain_mod", "params/final_layer/gain_mod"),
    ("final_layer.mean_scale.linear.weight", "params/final_layer/mean_scale/linear/weight"),
    ("final_layer.mean_scale.reference", "params/final_layer/mean_scale/reference"),
    ("final_layer.sigma_scale.linear.weight", "params/final_layer/sigma_scale/linear/weight"),
    ("final_layer.sigma_scale.reference", "params/final_layer/sigma_scale/reference"),
]
# the scan_blocks layout: one stacked entry for every block entry
_NAMES += [
    (key.replace("blocks.{0}.", "blocks."), path.replace("blocks_{0}/", "blocks/"))
    for key, path in _NAMES
    if "{0}" in key
]
# a linear without weight normalization has a bias beside its weight
_NAMES += [
    (key[: -len("weight")] + "bias", path[: -len("weight")] + "bias")
    for key, path in _NAMES
    if key.endswith(".weight") and "embedding" not in key
]
_PATTERNS = [
    (re.compile("^" + re.escape(path).replace(re.escape("{0}"), r"(\d+)") + "$"), key)
    for key, path in _NAMES
]


def _flatten(tree: Mapping, prefix: str, out: Dict[str, np.ndarray]) -> None:
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        if isinstance(v, Mapping):
            _flatten(v, path, out)
        else:
            out[path] = np.asarray(v)


def state_dict_from_jax(variables: Mapping, cfg=None) -> Dict[str, torch.Tensor]:
    """The port's state dict (float32 tensors) for a JAX variables tree of
    arrays. With ``cfg`` it also holds the ``pos_embed`` buffer, regenerated
    from the config, so ``load_state_dict`` can be strict."""
    flat: Dict[str, np.ndarray] = {}
    for collection in ("params", "constants"):
        _flatten(variables.get(collection, {}), collection, flat)
    sd: Dict[str, torch.Tensor] = {}
    unmatched = []
    for path, value in flat.items():
        for pattern, key in _PATTERNS:
            m = pattern.match(path)
            if m:
                sd[key.format(*m.groups())] = torch.from_numpy(np.array(value, dtype=np.float32))
                break
        else:
            unmatched.append(path)
    if unmatched:
        raise KeyError(f"JAX variables with no port name: {unmatched[:10]}")
    if cfg is not None:
        from mapdit_tpu_torch.models.dit import pos_embed_buffer

        sd["pos_embed"] = pos_embed_buffer(cfg)
    return sd


def _named(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX ``params``-shaped tree by the port's state-dict names."""
    return state_dict_from_jax({"params": tree})


def train_state_from_jax(
    cfg,
    tx,
    params: Mapping,
    constants: Mapping,
    mu: Mapping,
    nu: Mapping,
    count: int,
    ema: Mapping[str, Mapping],
    step: int,
    seed: int = 0,
    sampler_state: Mapping = None,
    device=None,
):
    """The port's ``TrainState`` for a JAX ``TrainState`` handed over as
    numpy trees: ``params`` and ``constants``, Adam's first and second
    moments ``mu`` / ``nu`` (shaped like ``params``) and its update
    ``count``, every EMA tree by its std key ("0.050"), the ``step``, and the
    loss-second-moment sampler's ``{"history", "counts"}`` where the run used
    it. The generator is seeded with ``seed``: the two packages' random
    streams differ, so a continued run draws new noise. With it both
    packages continue one run."""
    from mapdit_tpu_torch.diffusion.timestep_sampler import LossHistoryState
    from mapdit_tpu_torch.training.state import create_train_state

    state = create_train_state(
        cfg, tx, seed=seed, ema_stds=tuple(float(k) for k in ema), device=device,
        timestep_sampler="uniform" if not sampler_state else "loss-second-moment",
        num_timesteps=1000 if not sampler_state else int(np.asarray(sampler_state["history"]).shape[0]),
        state_dict=state_dict_from_jax({"params": params, "constants": constants}, cfg),
    )
    dev = state.generator.device
    first, second = _named(mu), _named(nu)
    for name, p in state.model.named_parameters():
        # torch.optim.Adam's own layout: the step count as a float32 scalar
        # on the CPU, the moments beside the parameter
        state.optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": first[name].to(device=dev, dtype=p.dtype).reshape(p.shape).clone(),
            "exp_avg_sq": second[name].to(device=dev, dtype=p.dtype).reshape(p.shape).clone(),
        }
    with torch.no_grad():
        for key, tree in ema.items():
            named = _named(tree)
            for name, tensor in state.ema[f"{float(key):.3f}"].items():
                tensor.copy_(named[name].reshape(tensor.shape))
    state.step = int(step)
    if sampler_state:
        state.sampler_state = LossHistoryState(
            history=torch.from_numpy(np.array(sampler_state["history"], dtype=np.float32)).to(dev),
            counts=torch.from_numpy(np.array(sampler_state["counts"], dtype=np.int32)).to(dev),
        )
    return state
