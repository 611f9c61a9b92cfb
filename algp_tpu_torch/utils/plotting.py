"""Result plotting (the counterpart of algp_tpu.utils.plotting): posterior
mean / variance maps, sample-path overlays, RMSE learning curves.
Matplotlib with the Agg backend, imported only when a figure is drawn,
so nothing here needs a display or matplotlib at import.  Tensors on any
device are copied to the host once each."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _plt():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "the figures of --plots (algp_tpu_torch.utils.plotting) need "
            "matplotlib, which is not installed"
        ) from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def field_maps(env, mean, var, sampled_idx=None, path: Optional[str] = None):
    """Truth / posterior-mean / posterior-std maps side by side, with the
    sampled locations overlaid."""
    plt = _plt()
    nr, nc = env.num_rows, env.num_cols
    fig, axes = plt.subplots(1, 3, figsize=(13, 3.6), constrained_layout=True)
    panels = [
        ("truth", _host(env.f).reshape(nr, nc)),
        ("posterior mean", _host(mean).reshape(nr, nc)),
        ("posterior std", np.sqrt(np.maximum(_host(var), 0)).reshape(nr, nc)),
    ]
    for ax, (title, img) in zip(axes, panels):
        im = ax.imshow(img, origin="lower", aspect="auto")
        ax.set_title(title)
        fig.colorbar(im, ax=ax, shrink=0.85)
        if sampled_idx is not None and title != "truth":
            r, c = np.divmod(_host(sampled_idx), nc)
            ax.plot(c, r, "r.", markersize=3)
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def learning_curves(histories: dict[str, list[dict]], path: Optional[str] = None):
    """RMSE (and mean posterior variance) vs samples, one line per
    strategy."""
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(10, 3.6), constrained_layout=True)
    for name, hist in histories.items():
        # each panel takes its x from the records carrying its own metric:
        # the two keys need not appear in the same records
        ns = [h["n_sampled"] for h in hist if "rmse" in h]
        rmse = [h["rmse"] for h in hist if "rmse" in h]
        ns_mv = [h["n_sampled"] for h in hist if "mean_var" in h]
        mv = [h["mean_var"] for h in hist if "mean_var" in h]
        axes[0].plot(ns, rmse, marker="o", markersize=3, label=name)
        axes[1].plot(ns_mv, mv, marker="o", markersize=3, label=name)
    axes[0].set_xlabel("samples collected"); axes[0].set_ylabel("RMSE")
    axes[1].set_xlabel("samples collected"); axes[1].set_ylabel("mean posterior var")
    axes[0].legend()
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def path_plot(env, node_seqs: list, path: Optional[str] = None):
    """Overlay traversed paths on the field grid."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4), constrained_layout=True)
    nc = env.num_cols
    for k, seq in enumerate(node_seqs):
        r, c = np.divmod(_host(seq), nc)
        ax.plot(c, r, "-o", markersize=2.5, linewidth=1.0, alpha=0.8,
                label=f"step {k}" if len(node_seqs) <= 8 else None)
    ax.set_xlim(-0.5, env.num_cols - 0.5)
    ax.set_ylim(-0.5, env.num_rows - 0.5)
    ax.set_xlabel("range"); ax.set_ylabel("row")
    if len(node_seqs) <= 8:
        ax.legend(fontsize=7)
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig
