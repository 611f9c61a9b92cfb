"""Covariance kernels: RBF, Matérn 3/2 and 5/2, composite spatial × feature
(the counterpart of algp_tpu.ops.kernels).

Hyperparameters live in unconstrained log space (`KernelParams`, a
dataclass of tensors); the kernel structure is static (`KernelSpec`).
Every function here accepts parameters with leading batch dimensions
(the fit's restart axis): a (R, ds) `log_ls_spatial` gives an (R, n1, n2)
Gram.  This plain path is what the fit differentiates; the large
candidate-grid Gram goes through the CUDA kernel in `ops.gram`, which
evaluates the same closed forms.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

SQRT3 = 1.7320508075688772
SQRT5 = 2.23606797749979

KERNEL_KINDS = ("rbf", "matern32", "matern52")


@dataclasses.dataclass
class KernelParams:
    """Unconstrained (log-space) kernel hyperparameters, f32 tensors.

    log_ls_spatial : (..., ds) ARD log-lengthscales for the spatial dims
    log_ls_feature : (..., df) ARD log-lengthscales for the feature dims
    log_outputscale: (...,) log signal variance of the product kernel
    log_noise      : (...,) log base observation-noise std
    The leading dims (...) are a batch, e.g. the fit's restarts.
    """

    log_ls_spatial: torch.Tensor
    log_ls_feature: torch.Tensor
    log_outputscale: torch.Tensor
    log_noise: torch.Tensor

    @property
    def noise_var(self) -> torch.Tensor:
        return torch.exp(2.0 * self.log_noise)

    @property
    def outputscale(self) -> torch.Tensor:
        return torch.exp(self.log_outputscale)

    def map(self, fn) -> "KernelParams":
        """A new KernelParams with `fn` applied to every field."""
        return KernelParams(**{
            f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)
        })


def _f32_log(v: float, device) -> torch.Tensor:
    # log of the f32-rounded value, taken in f32 as the reference does
    return torch.log(torch.tensor(v, dtype=torch.float32, device=device))


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Static kernel structure: forms + input-column split.

    Inputs X are (n, ds + df): the first `ds` columns are spatial
    coordinates, the remaining `df` per-point features, and

        k(x, x') = s² · k_spatial(x_sp, x'_sp) · k_feature(x_ft, x'_ft)

    with the feature factor ≡ 1 when df == 0.
    """

    spatial_kind: str = "rbf"
    feature_kind: str = "rbf"
    ds: int = 2
    df: int = 0

    def __post_init__(self):
        if self.spatial_kind not in KERNEL_KINDS:
            raise ValueError(f"unknown spatial kernel {self.spatial_kind!r}")
        if self.df and self.feature_kind not in KERNEL_KINDS:
            raise ValueError(f"unknown feature kernel {self.feature_kind!r}")

    @property
    def dim(self) -> int:
        return self.ds + self.df

    def init_params(
        self,
        generator: Optional[torch.Generator] = None,
        ls_spatial: float = 1.0,
        ls_feature: float = 1.0,
        outputscale: float = 1.0,
        noise: float = 0.1,
        perturb: float = 0.0,
        device=None,
    ) -> KernelParams:
        """Initial hyperparameters; `perturb` adds N(0, perturb²) log-space
        noise drawn from `generator` (multi-restart fitting).  The draws
        cannot equal the reference's `jax.random` ones."""
        if generator is not None and device is None:
            device = generator.device
        p = KernelParams(
            log_ls_spatial=_f32_log(ls_spatial, device).expand(self.ds).clone(),
            log_ls_feature=_f32_log(ls_feature, device).expand(self.df).clone(),
            log_outputscale=_f32_log(outputscale, device),
            log_noise=_f32_log(noise, device),
        )
        if perturb and generator is not None:
            p = p.map(lambda l: l + perturb * torch.randn(
                l.shape, generator=generator, dtype=torch.float32,
                device=device,
            ))
        return p


def stationary_form(kind: str, r2: torch.Tensor) -> torch.Tensor:
    """Unit-variance kernel value from the scaled squared distance r².

    Matérn forms take r = √max(r², 1e-20): the clamp keeps the gradient
    finite at r = 0, where ∂√/∂r² diverges.
    """
    if kind == "rbf":
        return torch.exp(-0.5 * r2)
    r = torch.sqrt(torch.clamp_min(r2, 1e-20))
    if kind == "matern32":
        a = SQRT3 * r
        return (1.0 + a) * torch.exp(-a)
    if kind == "matern52":
        a = SQRT5 * r
        return (1.0 + a + (a * a) / 3.0) * torch.exp(-a)
    raise ValueError(f"unknown kernel kind {kind!r}")


def scaled_sqdist(
    x1: torch.Tensor, x2: torch.Tensor, log_ls: torch.Tensor
) -> torch.Tensor:
    """Pairwise ARD-scaled squared distances, (..., n1, n2).

    Direct broadcast differences, never the |a|²+|b|²−2ab form (which
    `torch.cdist` switches to): the input dims are tiny and the direct
    form avoids the f32 cancellation that breaks selection fidelity.
    """
    inv_ls = torch.exp(-log_ls)[..., None, :]
    a = x1 * inv_ls
    b = x2 * inv_ls
    d = a[..., :, None, :] - b[..., None, :, :]
    return torch.sum(d * d, dim=-1)


def gram(
    spec: KernelSpec, params: KernelParams, x1: torch.Tensor, x2: torch.Tensor
) -> torch.Tensor:
    """Cross-covariance matrix K(X1, X2), (..., n1, n2), no noise.  The
    inputs may carry leading batch dims too (the episode's per-set
    blocks, (S, k, dim))."""
    ks = stationary_form(
        spec.spatial_kind,
        scaled_sqdist(x1[..., : spec.ds], x2[..., : spec.ds],
                      params.log_ls_spatial),
    )
    if spec.df:
        kf = stationary_form(
            spec.feature_kind,
            scaled_sqdist(
                x1[..., spec.ds :], x2[..., spec.ds :], params.log_ls_feature
            ),
        )
        ks = ks * kf
    return torch.exp(params.log_outputscale)[..., None, None] * ks


def gram_diag(
    spec: KernelSpec, params: KernelParams, x: torch.Tensor
) -> torch.Tensor:
    """diag K(X, X) — constant for stationary kernels: the outputscale."""
    return torch.exp(params.log_outputscale)[..., None].expand(
        *params.log_outputscale.shape, x.shape[0]
    ).clone()


def gram_with_noise(
    spec: KernelSpec,
    params: KernelParams,
    x: torch.Tensor,
    noise_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K(X, X) + diag(noise).  `noise_scale` (n,) multiplies the base noise
    variance per sample (heteroscedastic sensing modalities)."""
    K = gram(spec, params, x, x)
    nv = params.noise_var[..., None]
    if noise_scale is not None:
        nv = nv * noise_scale
    return K + torch.diag_embed(nv.expand(*K.shape[:-1]))
