"""Experiment directory + config.yaml round trip, port of
``mapdit_tpu/utils/experiment.py``.

The layout is ``<results>/<NNN>-<model-name>/{config.yaml, log.txt,
checkpoints/, ema/}``. The train-time config (the argparse namespace plus the
dataset-derived in_channels / input_size / stats) is dumped as YAML and is
the source of truth for model construction. Where PyYAML is not installed
the file is written and read by a small writer and reader of this module:
one ``key: value`` line per entry, values in YAML's flow syntax, which any
YAML reader takes too.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict

try:
    import yaml
except ImportError:  # config.yaml then goes through _dump_flow / _load_simple
    yaml = None

from mapdit_tpu_torch.models.config import DiTConfig
from mapdit_tpu_torch.models.registry import build_config

# Config keys consumed by model construction; everything else in the YAML is
# training/runtime metadata.
_MODEL_KEYS = (
    "in_channels",
    "input_size",
    "num_classes",
    "mlp_ratio",
    "class_dropout_prob",
    "learn_sigma",
    "use_cosine_attention",
    "use_weight_normalization",
    "use_forced_weight_normalization",
    "use_mp_residual",
    "use_mp_silu",
    "use_no_layernorm",
    "use_mp_pos_enc",
    "use_mp_embedding",
    "modulation",
    "compute_dtype",
    "attention_impl",
    "block_kernel",
    "attn_bwd",
    "remat",
    "scan_blocks",
)


def setup_experiment(model_name: str, results_dir: str) -> str:
    os.makedirs(results_dir, exist_ok=True)
    index = len(glob.glob(os.path.join(results_dir, "*")))
    exp_dir = os.path.join(results_dir, f"{index:03d}-{model_name.replace('/', '-')}")
    os.makedirs(os.path.join(exp_dir, "checkpoints"), exist_ok=True)
    return exp_dir


def _flow(value) -> str:
    """One value in YAML flow syntax: its JSON text, with a float's exponent
    form given the mantissa dot YAML 1.1 asks for (1e-05 -> 1.0e-05)."""
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_flow(v) for v in value) + "]"
    text = json.dumps(value)
    if isinstance(value, float) and "e" in text and "." not in text:
        text = text.replace("e", ".0e")
    return text


def _dump_flow(args: Dict[str, Any]) -> str:
    """``key: value`` lines, sorted by key as yaml.dump sorts them."""
    return "".join(f"{key}: {_flow(args[key])}\n" for key in sorted(args))


def _scalar(text: str):
    text = text.strip()
    try:
        return json.loads(text)
    except ValueError:
        pass
    if text in ("null", "~", ""):
        return None
    if text.lower() in ("true", "false"):
        return text.lower() == "true"
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text[1:-1] if len(text) >= 2 and text[0] == text[-1] == "'" else text


def _load_simple(text: str) -> Dict[str, Any]:
    """Reads what :func:`_dump_flow` and what ``yaml.dump`` write for a flat
    config: ``key: scalar`` lines, flow lists, and block lists (``- item``
    lines under a bare ``key:``)."""
    out: Dict[str, Any] = {}
    key = None
    for line in text.splitlines():
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        if line.lstrip().startswith("- ") and key is not None:
            if not isinstance(out[key], list):
                out[key] = []
            out[key].append(_scalar(line.lstrip()[2:]))
            continue
        key, sep, value = line.partition(":")
        if not sep:
            raise ValueError(f"config.yaml: cannot read line {line!r}")
        key = key.strip()
        out[key] = _scalar(value)
    return out


def save_config(exp_dir: str, args: Dict[str, Any]) -> None:
    with open(os.path.join(exp_dir, "config.yaml"), "w") as f:
        if yaml is not None:
            yaml.dump(args, f)
        else:
            f.write(_dump_flow(args))


def load_config(exp_dir: str) -> Dict[str, Any]:
    with open(os.path.join(exp_dir, "config.yaml")) as f:
        return yaml.safe_load(f) if yaml is not None else _load_simple(f.read())


def config_from_args(args: Dict[str, Any]) -> DiTConfig:
    """Rebuild the DiTConfig a training run used from its config.yaml dict."""
    overrides = {k: args[k] for k in _MODEL_KEYS if k in args}
    return build_config(args["model"], **overrides)


def percentile_arg(s: str) -> float:
    """argparse type of the (0, 1] quantile flags (--dynamic-threshold):
    an out-of-range value fails at parse time."""
    import argparse

    v = float(s)
    if not 0.0 < v <= 1.0:
        raise argparse.ArgumentTypeError(f"{s!r}: must be in (0, 1]")
    return v
