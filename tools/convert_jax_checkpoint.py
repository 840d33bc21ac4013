#!/usr/bin/env python
"""Convert a JAX-package checkpoint (``checkpoints/<step>.msgpack``) into the
PyTorch port's checkpoint (``checkpoints/<step>.pt``).

    python tools/convert_jax_checkpoint.py --checkpoint results/000-DiT-S-2/checkpoints/0050000.msgpack \\
        --output-dir results_torch/000-DiT-S-2

The model is built from the ``config.yaml`` beside the checkpoint's
``checkpoints/`` directory (or ``--config-dir``). Parameters, constants,
Adam's moments and count, every EMA tree, the step and the timestep
sampler's history carry over through
``mapdit_tpu_torch.utils.weights.train_state_from_jax``; the random stream
does not (the port's generator is seeded with the run's seed), so
``python -m mapdit_tpu_torch.train --resume <output-dir>`` continues the run
with new noise. ``config.yaml`` is copied along. Runs on the CPU.
"""

import argparse
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _adam_state(opt_state):
    """The ``{count, mu, nu}`` entry of a serialized optax state (nested
    under the chain's positions)."""
    if isinstance(opt_state, dict):
        if "mu" in opt_state and "nu" in opt_state:
            return opt_state
        for value in opt_state.values():
            found = _adam_state(value)
            if found is not None:
                return found
    return None


def convert(checkpoint: str, output_dir: str, config_dir: str = None) -> str:
    """Write the port's checkpoint for the JAX ``checkpoint`` file into
    ``output_dir/checkpoints/`` and return its path."""
    from flax import serialization

    from mapdit_tpu_torch.training import create_optimizer, default_schedule_steps, warmup_flat_invsqrt
    from mapdit_tpu_torch.training.checkpoint import save_state
    from mapdit_tpu_torch.utils.experiment import config_from_args, load_config
    from mapdit_tpu_torch.utils.weights import train_state_from_jax

    config_dir = config_dir or os.path.dirname(os.path.dirname(os.path.abspath(checkpoint)))
    args = load_config(config_dir)
    with open(checkpoint, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    adam = _adam_state(tree["opt_state"])
    if adam is None:
        raise ValueError(f"{checkpoint}: no Adam state (mu, nu) in opt_state")
    warmup, start_decay = default_schedule_steps(args["num_steps"], args.get("num_lin_warmup"), args.get("start_decay"))
    tx = create_optimizer(warmup_flat_invsqrt(args["lr"], warmup, start_decay), grad_clip=args.get("grad_clip"))
    sampler = tree.get("sampler_state")
    state = train_state_from_jax(
        config_from_args(args), tx, tree["params"], tree.get("constants", {}), adam["mu"], adam["nu"],
        int(adam["count"]), tree["ema"], int(tree["step"]), seed=int(args.get("seed", 0)),
        sampler_state=sampler if isinstance(sampler, dict) and "history" in sampler else None, device="cpu",
    )
    os.makedirs(output_dir, exist_ok=True)
    if os.path.abspath(config_dir) != os.path.abspath(output_dir):
        shutil.copy(os.path.join(config_dir, "config.yaml"), os.path.join(output_dir, "config.yaml"))
    return save_state(output_dir, state.step, state)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkpoint", required=True, help="the JAX package's checkpoints/<step>.msgpack")
    parser.add_argument("--output-dir", required=True, help="experiment directory to write checkpoints/<step>.pt into")
    parser.add_argument("--config-dir", default=None,
                        help="directory holding the run's config.yaml (default: the checkpoint's experiment directory)")
    args = parser.parse_args(argv)
    print(convert(args.checkpoint, args.output_dir, args.config_dir))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
