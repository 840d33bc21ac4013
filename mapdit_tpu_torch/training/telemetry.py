"""Magnitude-preservation telemetry (``--log-magnitudes``), port of
``mapdit_tpu/training/telemetry.py``.

* :func:`weight_magnitudes`: over every ``weight`` (2-D, or 3-D stacked
  under ``scan_blocks``) the row RMS
  ``||w_i|| / sqrt(in_dim)`` (which forced weight normalization pins to 1)
  as its deviation from 1, and the magnitude of every learned ``gain*``.
* :func:`make_activation_probe`: one eval-mode forward at mid-noise
  (t = T/2) on the current batch with forward hooks on the blocks (one
  hook on the stacked block under ``scan_blocks``, which fires once a
  depth), reporting the residual stream's RMS after each block and the RMS of the
  model output's eps channels.

Both run once per log interval and go into the ``--metrics-jsonl`` rows.
"""

from __future__ import annotations

from typing import Dict

import torch


@torch.no_grad()
def weight_magnitudes(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Scalar summary (0-d tensors) of the weight and gain magnitudes of
    ``params`` (name -> tensor)."""
    devs, gains = [], []
    for name, p in params.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and p.ndim in (2, 3):
            rms = torch.linalg.vector_norm(p.float(), dim=-1) / p.shape[-1] ** 0.5
            devs.append((rms - 1.0).abs().reshape(-1))
        elif leaf.startswith("gain"):
            gains.append(p.float().abs().reshape(-1))
    out: Dict[str, torch.Tensor] = {}
    if devs:
        d = torch.cat(devs)
        out["w_rms_dev_mean"], out["w_rms_dev_max"] = d.mean(), d.max()
    if gains:
        g = torch.cat(gains)
        out["gain_abs_mean"], out["gain_abs_max"] = g.mean(), g.max()
    return out


def _rms(a: torch.Tensor) -> torch.Tensor:
    return a.float().square().mean().sqrt()


def make_activation_probe(cfg, diffusion, stats_mean=None, stats_std=None):
    """``probe(model, batch, generator) -> {"block_rms": (depth,), "out_rms": ()}``.

    Draws the latent as the train step does (posterior mean + eps*std,
    normalized, or a given ``x``), noises it to the chain's midpoint and runs
    one eval-mode forward; the draws come from ``generator``, not from the
    train state's."""

    @torch.no_grad()
    def probe(model, batch, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        dev = generator.device

        def on_device(v, dtype=torch.float32):
            return torch.as_tensor(v).to(device=dev, dtype=dtype)

        if "x" in batch:
            x = on_device(batch["x"])
        else:
            mean = on_device(batch["mean"])
            x = mean + torch.randn(mean.shape, generator=generator, device=dev) * on_device(batch["std"])
            x = (x - on_device(stats_mean).reshape(1, -1, 1, 1)) / on_device(stats_std).reshape(1, -1, 1, 1)
        t = torch.full((x.shape[0],), diffusion.num_timesteps // 2, dtype=torch.int64, device=dev)
        x_t = diffusion.q_sample(x, t, torch.randn(x.shape, generator=generator, device=dev))
        block_rms = []
        blocks = [model.blocks] if cfg.scan_blocks else model.blocks
        hooks = [blk.register_forward_hook(lambda mod, args, out: block_rms.append(_rms(out))) for blk in blocks]
        try:
            out = model(x_t, t, on_device(batch["y"], torch.int64), train=False)
        finally:
            for h in hooks:
                h.remove()
        return {"block_rms": torch.stack(block_rms), "out_rms": _rms(out[:, : cfg.in_channels])}

    return probe
