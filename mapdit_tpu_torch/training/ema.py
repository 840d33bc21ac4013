"""Karras power-function EMA, port of ``mapdit_tpu/training/ema.py``: the
numpy profile math (float64) copied as it is, the per-step update, in place
on the EMA tensors, and the snapshot ledger.

Snapshots are fp16 ``.npz`` files named ``<std:.3f>_<step:07d>.npz`` in the
experiment's ``ema/`` directory, arrays keyed by the state-dict names of the
parameters. ``calculate_posthoc_ema`` reconstructs an EMA of any std after
training from the ledger.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Tuple

import numpy as np
import torch


def std_to_gamma(std) -> np.ndarray:
    """Solve std^-2 = (gamma+1)/((gamma+2)^2 (gamma+3)) for the largest real
    root of the cubic gamma^3 + 7 gamma^2 + (16 - s) gamma + (12 - s) = 0."""
    std = np.asarray(std, dtype=np.float64)
    s = std.reshape(-1) ** -2.0
    gamma = np.array([np.roots([1.0, 7.0, 16.0 - si, 12.0 - si]).real.max() for si in s])
    return gamma.reshape(std.shape)


def gamma_to_std(gamma) -> np.ndarray:
    gamma = np.asarray(gamma, dtype=np.float64)
    return np.sqrt((gamma + 1.0) / (np.square(gamma + 2.0) * (gamma + 3.0)))


def calc_beta(std, t):
    """Per-step decay beta_t = (1 - 1/t)^(gamma+1) for the power EMA profile."""
    gamma = std_to_gamma(np.asarray(std))
    return (1.0 - 1.0 / t) ** (gamma + 1.0)


def p_dot_p(t_a, gamma_a, t_b, gamma_b):
    """Inner products of power-EMA profiles at snapshot times."""
    t_ratio = t_a / t_b
    t_exp = np.where(t_a < t_b, gamma_b, -gamma_a)
    t_max = np.maximum(t_a, t_b)
    num = (gamma_a + 1.0) * (gamma_b + 1.0) * t_ratio**t_exp
    return num / ((gamma_a + gamma_b + 1.0) * t_max)


def solve_weights(t_i, gamma_i, t_r, gamma_r) -> np.ndarray:
    """Least-squares weights reconstructing the target profile from the
    snapshot profiles."""

    def rv(x):
        return np.asarray(x, np.float64).reshape(-1, 1)

    def cv(x):
        return np.asarray(x, np.float64).reshape(1, -1)

    a = p_dot_p(rv(t_i), rv(gamma_i), cv(t_i), cv(gamma_i))
    b = p_dot_p(rv(t_i), rv(gamma_i), cv(t_r), cv(gamma_r))
    return np.linalg.solve(a, b)


def make_beta_fn(std: float):
    """beta(step) for the 1-indexed train step, evaluated in float32 as the
    JAX package evaluates it on the device; gamma is fixed per std."""
    exponent = np.float32(float(std_to_gamma(std)) + 1.0)
    one = np.float32(1.0)

    def beta_fn(step: int) -> float:
        t = max(np.float32(step), one)
        return float((one - one / t) ** exponent)

    return beta_fn


@torch.no_grad()
def ema_update(ema_params: Dict[str, torch.Tensor], model_params: Dict[str, torch.Tensor], beta: float) -> None:
    """ema <- ema + (model - ema) * beta, in place (one foreach op per
    stage over all tensors): beta weights the model, so beta(1) = 0 keeps
    the EMA at its initial copy. Elementwise, so under FSDP both trees are
    a rank's slices (``TrainState.held``); a snapshot takes the copy
    gathered whole (``DataParallel.gather``)."""
    names = list(ema_params)
    ema = [ema_params[k] for k in names]
    diff = torch._foreach_sub([model_params[k].to(e.dtype) for k, e in zip(names, ema)], ema)
    torch._foreach_mul_(diff, beta)
    torch._foreach_add_(ema, diff)


# ---------------------------------------------------------------------------
# snapshot ledger (host-side IO)


def save_snapshot(ema_dir: str, std: float, step: int, params: Dict[str, torch.Tensor]) -> str:
    """Write one fp16 snapshot of ``params`` (name -> tensor or array)."""
    os.makedirs(ema_dir, exist_ok=True)
    flat = {
        name: (v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)).astype(np.float16)
        for name, v in params.items()
    }
    path = os.path.join(ema_dir, f"{std:.3f}_{step:07d}.npz")
    # Atomic (the tmp name does not match _SNAP_RE): a truncated snapshot
    # would poison every posthoc reconstruction that scans the ledger.
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    return path


_SNAP_RE = re.compile(r"^([0-9]*\.[0-9]+)_(\d+)\.(npz|pt)$")


def list_snapshots(ema_dir: str) -> List[Tuple[float, int, str]]:
    """Ledger scan, (std, step, path) sorted by file name: native ``.npz``
    snapshots and the reference's ``.pt`` ones. Where one (std, step) exists
    in both formats the ``.npz`` wins (sorted() lists it first): duplicates
    would make the least-squares Gram matrix singular."""
    out, seen = [], set()
    for f in sorted(os.listdir(ema_dir)):
        m = _SNAP_RE.match(f)
        if m:
            key = (float(m.group(1)), int(m.group(2)))
            if key in seen:
                continue
            seen.add(key)
            out.append((key[0], key[1], os.path.join(ema_dir, f)))
    return out


def load_snapshot(path: str) -> Dict[str, np.ndarray]:
    """One snapshot as {state-dict name: array}. A ``.pt`` file is a
    reference ledger entry ``{std, t, state_dict}`` whose keys may carry
    torch.compile's ``_orig_mod.`` prefix."""
    if path.endswith(".pt"):
        d = torch.load(path, map_location="cpu", weights_only=True)
        return {k.removeprefix("_orig_mod."): v.numpy() for k, v in d["state_dict"].items()}
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def calculate_posthoc_ema(out_std: float, ema_dir: str) -> Dict[str, np.ndarray]:
    """EMA parameters at an arbitrary std, reconstructed from the snapshot
    ledger by least squares over the profiles' inner products, at the
    ledger's last step. Returns float32 arrays by state-dict name."""
    snaps = list_snapshots(ema_dir)
    if not snaps:
        raise FileNotFoundError(f"No EMA snapshots found in {ema_dir}")
    in_stds = np.array([s for s, _, _ in snaps])
    in_ts = np.array([t for _, t, _ in snaps])
    out_ts = int(in_ts.max())

    exact = (in_stds == out_std) & (in_ts == out_ts)
    if exact.any():
        return {k: v.astype(np.float32) for k, v in load_snapshot(snaps[int(np.argmax(exact))][2]).items()}

    weights = solve_weights(in_ts, std_to_gamma(in_stds), np.array([float(out_ts)]), std_to_gamma(out_std)).flatten()
    acc: Dict[str, np.ndarray] = {}
    for w, (_, _, path) in zip(weights, snaps):
        for name, a in load_snapshot(path).items():
            term = a.astype(np.float32) * float(w)  # a Python float keeps the array float32
            acc[name] = term if name not in acc else acc[name] + term
    return acc
