"""algp_tpu_torch.utils.plotting and the CLI's --plots / --profile-dir on
the CPU: the twins of tests/test_utils.py's plotting cases, a 6 × 10
episode through the CLI with both flags, and the error when matplotlib is
missing."""

import json
import sys

import numpy as np
import pytest
import torch

from algp_tpu_torch import cli
from algp_tpu_torch.config import FieldConfig
from algp_tpu_torch.field import FieldEnv
from algp_tpu_torch.utils import plotting

EPISODE = ["--preset", "c5_episode", "--rows", "6", "--cols", "10", "--budget", "20",
           "--num-pilot", "6", "--iters", "10", "--device", "cpu"]


def test_plotting_smoke(tmp_path):
    env = FieldEnv(FieldConfig(num_rows=5, num_cols=8, seed=0), device="cpu")
    mean = torch.zeros(env.n)
    var = torch.ones(env.n)
    plotting.field_maps(env, mean, var, sampled_idx=[0, 5, 10],
                        path=str(tmp_path / "maps.png"))
    plotting.learning_curves(
        {"mi": [{"n_sampled": 10, "rmse": 1.0, "mean_var": 0.9},
                {"n_sampled": 20, "rmse": 0.6, "mean_var": 0.5}]},
        path=str(tmp_path / "curves.png"),
    )
    plotting.path_plot(env, [[0, 1, 2, 10], np.asarray([10, 18, 26])],
                       path=str(tmp_path / "paths.png"))
    assert (tmp_path / "maps.png").exists()
    assert (tmp_path / "curves.png").exists()
    assert (tmp_path / "paths.png").exists()


def test_learning_curves_uneven_metric_keys(tmp_path):
    """Histories where 'rmse' and 'mean_var' don't co-occur per record
    plot each panel against its own x."""
    hist = [
        {"n_sampled": 10, "rmse": 1.0, "mean_var": 0.9},
        {"n_sampled": 15, "rmse": 0.8},            # no mean_var
        {"n_sampled": 20, "mean_var": 0.5},        # no rmse
        {"n_sampled": 25, "rmse": 0.6, "mean_var": 0.4},
    ]
    plotting.learning_curves({"mi": hist}, path=str(tmp_path / "c.png"))
    assert (tmp_path / "c.png").exists()


def _summary(capsys, argv):
    assert cli.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_plots_and_profile_dir_write_their_files(tmp_path, capsys):
    """--plots writes run 0's maps and the curves, --profile-dir a
    torch.profiler trace of run 0 holding the episode's ops; tracing
    changes no result."""
    plain = _summary(capsys, EPISODE)
    figs, trace = tmp_path / "figs", tmp_path / "trace"
    traced = _summary(capsys, EPISODE + ["--plots", str(figs), "--profile-dir", str(trace)])
    assert traced == plain
    for name in ("maps_run0.png", "curves.png"):
        assert (figs / name).stat().st_size > 0
    files = list(trace.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "aten::linalg_cholesky_ex" in names


def test_greedy_mode_writes_no_figures(tmp_path, capsys):
    figs, trace = tmp_path / "figs", tmp_path / "trace"
    _summary(capsys, EPISODE + ["--mode", "greedy", "--acq-rounds", "5",
                                "--plots", str(figs), "--profile-dir", str(trace)])
    assert not figs.exists() and not trace.exists()


def test_missing_matplotlib_names_the_flag(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    env = FieldEnv(FieldConfig(num_rows=5, num_cols=8, seed=0), device="cpu")
    with pytest.raises(ImportError, match="--plots"):
        plotting.field_maps(env, np.zeros(env.n), np.ones(env.n))
    with pytest.raises(ImportError, match="matplotlib"):
        cli.main(EPISODE + ["--plots", str(tmp_path / "figs")])
