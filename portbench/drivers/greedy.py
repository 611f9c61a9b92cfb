"""Closed-loop driver of the main path's selection: one caller sends a
call of `acquisition.greedy_select` with the field's true
hyperparameters, waits until its sites reach the host, and sends the
next.

Every input comes from the run's seed and is made on the device: the
field (a random-Fourier-feature draw of the configuration's kernel), and
for each call a fresh set of distinct pilot cells and their sensed
values.  Each call takes the next set of a pool made in set-up, so every
seed offers the same sizes in another order.

The check (`check`) hands the same inputs to the plain reference
(`portbench/reference/gp.py`, float64), which follows the program's
sites round by round; `control_answer` puts the reference, in float32
with TF32 matmuls, in the program's place.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench.reference import gp as ref

#: sets in the input pool; a window that takes more wraps round
POOL = 4096
#: random Fourier features of the field's draw
FIELD_FEATURES = 4096


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Driver:
    """One run's program, inputs and answers."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.seed = config, int(seed)
        self.dev = torch.device(device)
        self.answers: dict = {}  # call index → what the program returned

    # ------------------------------------------------------------ set-up

    def setup(self) -> None:
        from algp_tpu_torch.ops.kernels import KernelSpec

        c, dev = self.cfg, self.dev
        self.spec = KernelSpec(c["kernel"], ds=2)
        rows, cols = c["num_rows"], c["num_cols"]
        self.n = n = rows * cols
        r, q = np.divmod(np.arange(n), cols)
        self.x = torch.tensor(np.stack([q, r], 1), dtype=torch.float32, device=dev)
        g = torch.Generator(device=dev).manual_seed(self.seed)
        self.f = self._field(g)
        m, P = c["num_pilot"], POOL + 2  # +2: warm-up
        # distinct pilot cells: the m smallest of n uniform keys per set
        keys = torch.empty((256, n), device=dev)
        self.pilots = torch.empty((P, m), dtype=torch.int64, device=dev)
        for lo in range(0, P, 256):
            k = keys[: min(256, P - lo)].uniform_(generator=g)
            self.pilots[lo:lo + 256] = torch.topk(k, m, largest=False).indices
        del keys
        self.y = (self.f[self.pilots] + c["noise_std"] * torch.randn(
            (P, m), generator=g, device=dev)).contiguous()
        self.true = {"log_ls": torch.log(torch.full((2,), float(c["true_ls"]), device=dev)),
                     "log_s2": torch.log(torch.tensor(float(c["true_outputscale"]), device=dev)),
                     "noise_var": float(c["noise_std"]) ** 2}
        _sync(dev)

    def _field(self, g):
        """f(x) = √(2s²/D) Σ cos(ωᵢ·x + bᵢ), ω ~ N(0, I/ℓ²), b ~ U(0, 2π):
        a draw of the RBF prior with D random Fourier features."""
        c, D = self.cfg, FIELD_FEATURES
        if c["kernel"] != "rbf":
            raise ValueError(f"no spectral draw for kernel {c['kernel']!r}")
        w = torch.randn((2, D), generator=g, device=self.dev) / float(c["true_ls"])
        b = 2.0 * math.pi * torch.rand((D,), generator=g, device=self.dev)
        amp = math.sqrt(2.0 * float(c["true_outputscale"]) / D)
        return amp * torch.cos(self.x @ w + b).sum(1)

    def true_params(self):
        from algp_tpu_torch.ops.kernels import KernelParams

        t = self.true
        return KernelParams(log_ls_spatial=t["log_ls"],
                            log_ls_feature=t["log_ls"][:0],
                            log_outputscale=t["log_s2"],
                            log_noise=0.5 * torch.log(torch.tensor(
                                t["noise_var"], device=self.dev)))

    # ------------------------------------------------------------- calls

    def slot(self, i: int) -> int:
        return i % POOL

    def warm(self, seconds: float) -> None:
        """The cell's shapes on the warm-up sets, for at least two calls
        and `seconds`, so the card's clocks settle before the window."""
        t0, k = time.perf_counter(), 0
        while k < 2 or time.perf_counter() - t0 < seconds:
            self._run(POOL + k % 2)
            k += 1
        self.answers.clear()

    def _run(self, k: int):
        """One call on pool set k; returns once its sites are on the host."""
        from algp_tpu_torch import acquisition as acq

        c = self.cfg
        nv = torch.full((self.n,), self.true["noise_var"], device=self.dev)
        sel = acq.greedy_select(
            self.spec, self.true_params(), self.x, nv, self.pilots[k],
            rounds=c["rounds"], num_pilot=c["num_pilot"], strategy=c["strategy"])
        sites = sel.selected.cpu().numpy()  # the closed loop's one wait
        return sites, sel.post_var

    def call(self, i: int) -> None:
        sites, post_var = self._run(self.slot(i))
        self.answers[i] = {"selected": sites, "post_var": post_var, "slot": self.slot(i)}

    def free(self) -> None:
        """Drop the program's cached state before the reference runs."""
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ checks

    def validity(self, a: dict) -> bool:
        """An answer that cannot be right whatever the reference says:
        sites out of range, repeated or among the pilots; a NaN."""
        s = a["selected"]
        pil = set(self.pilots[a["slot"]].tolist())
        return (len(s) == self.cfg["rounds"] and len(set(s.tolist())) == len(s)
                and bool(((s >= 0) & (s < self.n)).all()) and not pil & set(s.tolist()))

    def reference_of(self, k: int, dtype, follow=None) -> dict:
        """The reference's selection on pool set k, in `dtype`; `follow`
        makes it take those sites."""
        c = self.cfg
        x = self.x.to(dtype)
        pil = self.pilots[k]
        nv = torch.full((self.n,), self.true["noise_var"], dtype=dtype, device=self.dev)
        return ref.greedy_mi(c["kernel"], x, nv, pil, nv[pil], self.true["log_ls"].to(dtype),
                             self.true["log_s2"].to(dtype), c["rounds"], follow=follow)

    def control_answer(self, i: int) -> dict:
        """The reference in float32 with TF32 matmuls in the program's
        place, on call i's inputs."""
        k = self.slot(i)
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            r = self.reference_of(k, torch.float32)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        return {"selected": r["selected"].numpy(), "post_var": r["post_var"], "slot": k}

    def check(self, i: int, a: dict) -> dict:
        """The numbers compared for the answer `a` of call i: site_gap
        (the widest gap by which a site's MI score lies below the round's
        best, the reference following the program's sites) and var_gap
        (the largest |Δ posterior variance| over the candidates, in units
        of s²)."""
        r = self.reference_of(self.slot(i), torch.float64, follow=torch.as_tensor(a["selected"]))
        gaps = r["gaps"]
        whole = len(gaps) == len(a["selected"]) and all(map(math.isfinite, gaps))
        s2 = float(torch.exp(self.true["log_s2"]))
        out = {"site_gap": max(gaps) if len(gaps) == len(a["selected"]) else math.inf,
               "var_gap": (float((a["post_var"].to(torch.float64) - r["post_var"]).abs().max())
                           / s2 if whole else math.inf)}
        return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}

    def describe(self, a: dict) -> dict:
        return {}


def faults(traffic: dict) -> dict:
    """The faults that a run of this traffic can have, each a function
    that plants it in the program through a pytest-style `monkeypatch`."""
    return {"state_unchanged": _stale_rounds, "half_batch": _half_pilots,
            "altered_answer": _altered_site}


def _stale_rounds(mp) -> None:
    """A round's conditioning leaves the posterior as it was."""
    from algp_tpu_torch import acquisition as acq

    mp.setattr(acq, "_condition", lambda B, d, col, j1, nv_j, t: (B, d))


def _half_pilots(mp) -> None:
    """The selection conditions on half of the pilots."""
    from algp_tpu_torch import acquisition as acq

    orig = acq._greedy_select

    def half(spec, params, x, nv, pilot_idx, pilot_count, *a, **k):
        return orig(spec, params, x, nv, pilot_idx, pilot_count // 2, *a, **k)
    mp.setattr(acq, "_greedy_select", half)


def _altered_site(mp) -> None:
    """The last site is replaced."""
    from algp_tpu_torch import acquisition as acq

    orig = acq._greedy_select

    def altered(*a, **k):
        res = orig(*a, **k)
        n = int(k.get("n_valid") or a[2].shape[0])
        res.selected[-1] = (res.selected[-1] + n // 2) % n
        return res
    mp.setattr(acq, "_greedy_select", altered)


def make(config: dict, traffic: dict, seed: int, device) -> Driver:
    return Driver(config, traffic, seed, device)

