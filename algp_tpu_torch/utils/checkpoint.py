"""Checkpoint / resume for episodes (the counterpart of
algp_tpu.utils.checkpoint).

Episode state is small — sampled indices, measurements, noise scales,
hyperparameters, pose, remaining budget, rng states — so one .npz holds
it, in the reference's layout (the `KernelParams` as f32 numpy arrays
under the same keys, a deep kernel's weights as `mlp_layers`, `mlp_W{i}`,
`mlp_b{i}`), so a checkpoint of either package loads in the other.
Selection is a pure function of this state, so a resumed run continues
exactly.  `load` puts the params and weights on `device` (the card unless
the caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from algp_tpu_torch.device import resolve_device
from algp_tpu_torch.ops.kernels import KernelParams

_KEYS = (("ls_spatial", "log_ls_spatial"), ("ls_feature", "log_ls_feature"),
         ("outputscale", "log_outputscale"), ("noise", "log_noise"))


@dataclasses.dataclass
class EpisodeState:
    sampled_idx: np.ndarray  # (n,) int64 grid indices sampled so far
    y: np.ndarray  # (n,) measurements
    noise_scale: np.ndarray  # (n,) heteroscedastic variance multipliers
    pose: int  # current grid index of the robot
    budget_left: float
    step: int
    params: Optional[KernelParams] = None  # fitted hyperparameters
    rng_state: Optional[dict] = None  # np.random.Generator bit states
    mlp: Optional[list] = None  # deep-kernel embedding weights [(W, b), …]
    goal_i: int = 0  # next EpisodeConfig.waypoint_goals entry to visit
    # EpisodeConfig.lagged_refit: a refit result not yet consumed by a plan
    pending_params: Optional[KernelParams] = None
    # multi-trait envs: (n, T) all-trait rows of the sampled set, NaN where
    # a visit did not measure a trait; column 0 is `y`
    y_traits: Optional[np.ndarray] = None


def _params_blobs(prefix: str, p: KernelParams) -> dict:
    return {f"{prefix}_{key}": getattr(p, name).detach().cpu().numpy()
            for key, name in _KEYS}


def _params_from(z, prefix: str, device) -> Optional[KernelParams]:
    if f"{prefix}_ls_spatial" not in z:
        return None
    return KernelParams(**{
        name: torch.as_tensor(np.asarray(z[f"{prefix}_{key}"], np.float32),
                              device=device)
        for key, name in _KEYS
    })


def save(path: str, state: EpisodeState) -> None:
    blobs = {
        "sampled_idx": state.sampled_idx,
        "y": state.y,
        "noise_scale": state.noise_scale,
        "pose": np.asarray(state.pose),
        "budget_left": np.asarray(state.budget_left),
        "step": np.asarray(state.step),
        "goal_i": np.asarray(state.goal_i),
    }
    if state.y_traits is not None:
        blobs["y_traits"] = state.y_traits
    if state.params is not None:
        blobs.update(_params_blobs("p", state.params))
    if state.pending_params is not None:
        blobs.update(_params_blobs("q", state.pending_params))
    if state.rng_state is not None:
        blobs["rng_state_json"] = np.frombuffer(
            json.dumps(state.rng_state).encode(), dtype=np.uint8
        )
    if state.mlp is not None:
        blobs["mlp_layers"] = np.asarray(len(state.mlp))
        for i, (W, b) in enumerate(state.mlp):
            blobs[f"mlp_W{i}"] = W.detach().cpu().numpy()
            blobs[f"mlp_b{i}"] = b.detach().cpu().numpy()
    np.savez(path, **blobs)


def load(path: str, device=None) -> EpisodeState:
    device = resolve_device(device)
    with np.load(path) as z:
        rng_state = None
        if "rng_state_json" in z.files:
            rng_state = json.loads(z["rng_state_json"].tobytes().decode())
        mlp = None
        if "mlp_layers" in z.files:
            mlp = [tuple(torch.as_tensor(np.asarray(z[f"mlp_{k}{i}"], np.float32),
                                         device=device) for k in "Wb")
                   for i in range(int(z["mlp_layers"]))]
        return EpisodeState(
            sampled_idx=z["sampled_idx"],
            y=z["y"],
            noise_scale=z["noise_scale"],
            pose=int(z["pose"]),
            budget_left=float(z["budget_left"]),
            step=int(z["step"]),
            params=_params_from(z, "p", device),
            rng_state=rng_state,
            mlp=mlp,
            goal_i=int(z["goal_i"]) if "goal_i" in z.files else 0,
            pending_params=_params_from(z, "q", device),
            y_traits=z["y_traits"] if "y_traits" in z.files else None,
        )
