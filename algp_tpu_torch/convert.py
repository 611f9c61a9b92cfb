"""Carry state between the reference and the port through numpy.

KernelParams go to and from numpy mappings keyed by the field names. The
reference's `KernelParams` has the same field names, so a test hands the
reference's parameters (or its `make_restart_inits` output, with a
leading restart axis) to the port as
`{f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}`.

`icm_params_from_numpy` takes the ICM's parameters the same way, the
kernel's fields under "kernel"; `mlp_from_numpy` takes the deep kernel's
weights as a sequence of (W, b) pairs.

`field_env_like` builds a port FieldEnv on the reference env's truth:
the truth draws of the two packages come from different generators.
`field_env_attrs` takes what it reads as plain picklable values, and
`field_env_from_attrs` builds the env from them in another process (the
ranks of a mesh episode).
"""

from __future__ import annotations

import dataclasses
import types
from typing import Mapping

import numpy as np
import torch

from algp_tpu_torch.config import FieldConfig
from algp_tpu_torch.field import FieldEnv
from algp_tpu_torch.models.coregional import ICMParams
from algp_tpu_torch.ops.kernels import KernelParams

_NAMES = tuple(f.name for f in dataclasses.fields(KernelParams))


def kernel_params_from_numpy(mapping: Mapping, device="cpu") -> KernelParams:
    """f32 tensors on `device` from a mapping of the KernelParams fields."""
    missing = set(_NAMES) - set(mapping)
    if missing:
        raise KeyError(f"missing KernelParams fields: {sorted(missing)}")
    return KernelParams(**{
        name: torch.tensor(np.asarray(mapping[name], np.float32), device=device)
        for name in _NAMES
    })


def kernel_params_to_numpy(params: KernelParams) -> dict:
    """{field name: f32 numpy array} of a KernelParams."""
    return {
        name: getattr(params, name).detach().cpu().numpy() for name in _NAMES
    }


def _tensor(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def icm_params_from_numpy(mapping: Mapping, device="cpu") -> ICMParams:
    """ICMParams from {"kernel": KernelParams fields, "coreg_a": …,
    "log_coreg_kappa": …, "log_noise_t": …}."""
    return ICMParams(
        kernel=kernel_params_from_numpy(mapping["kernel"], device),
        **{name: _tensor(mapping[name], device)
           for name in ("coreg_a", "log_coreg_kappa", "log_noise_t")})


def mlp_from_numpy(layers, device="cpu") -> list:
    """The deep kernel's weights [(W, b), …] as f32 tensors on `device`."""
    return [(_tensor(W, device), _tensor(b, device)) for W, b in layers]


def field_env_like(ref_env, device=None) -> FieldEnv:
    """A port FieldEnv with the reference env's config, traits, features,
    masks, table standardisation and sensing generator state (its next
    `collect` draws the same noise as the reference's).  `X` is built from
    the carried features.  `ref_env` is read by attribute only."""
    cfg = FieldConfig(**{
        f.name: getattr(ref_env.cfg, f.name)
        for f in dataclasses.fields(FieldConfig)
    })
    traits = np.array(ref_env.traits, np.float64)
    if cfg.data_path is None:
        env = FieldEnv(cfg, device=device, truth=traits)
        if not np.array_equal(env.traits, traits):
            raise ValueError("the reference truth is not exact in float32")
    else:
        env = FieldEnv(cfg, device=device)  # reads the table
        env._y_mean = np.array(ref_env._y_mean)
        env._y_std = np.array(ref_env._y_std)
        env.traits = traits
        env.f = traits[:, 0]
        env.f_dev = torch.as_tensor(env.f.astype(np.float32), device=env.device)
    env.features = np.array(ref_env.features, np.float32)
    env.X = torch.cat([env.X[:, :2], torch.as_tensor(env.features, device=env.device)],
                      dim=1)
    env.observed_traits = np.array(ref_env.observed_traits, bool)
    env.observed_mask = np.array(ref_env.observed_mask, bool)
    env.test_mask = np.array(ref_env.test_mask, bool)
    env._rng.bit_generator.state = ref_env._rng.bit_generator.state
    return env


_ENV_ARRAYS = ("traits", "features", "observed_traits", "observed_mask", "test_mask",
               "_y_mean", "_y_std")


def field_env_attrs(env) -> dict:
    """What `field_env_like` reads of an env (the reference's or the
    port's), as numpy arrays and plain values."""
    out = {"cfg": {f.name: getattr(env.cfg, f.name) for f in dataclasses.fields(FieldConfig)},
           "rng_state": env._rng.bit_generator.state}
    out.update({a: np.array(getattr(env, a)) for a in _ENV_ARRAYS if hasattr(env, a)})
    return out


def field_env_from_attrs(attrs: Mapping, device=None) -> FieldEnv:
    """`field_env_like` of the env that `field_env_attrs` read."""
    rng = np.random.default_rng()
    rng.bit_generator.state = attrs["rng_state"]
    ref = types.SimpleNamespace(cfg=types.SimpleNamespace(**attrs["cfg"]), _rng=rng,
                                **{a: attrs[a] for a in _ENV_ARRAYS if a in attrs})
    return field_env_like(ref, device)
