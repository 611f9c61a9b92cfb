"""algp_tpu_torch.field's phenotype table (read with the csv module)
against algp_tpu.field's (read with pandas): the same features, traits,
per-trait masks, held-out split and standardisation, bit for bit, and
the same errors and warnings."""

import csv
import dataclasses
import warnings

import numpy as np
import pytest

from algp_tpu.config import PRESETS, FieldConfig
from algp_tpu.field import FieldEnv
from algp_tpu_torch.config import PRESETS as TPRESETS
from algp_tpu_torch.config import FieldConfig as TFieldConfig
from algp_tpu_torch.field import FieldEnv as TFieldEnv

@pytest.mark.parametrize("value_cols", [None, ("height", "width", "stand_count")])
def test_table_env_matches_reference(value_cols):
    """c10_table's env read with the csv module equals the reference's
    (read with pandas) bit for bit: features, X, traits, per-trait masks,
    the held-out split (from observed cells only) and the standardisation."""
    cfg = dataclasses.replace(PRESETS["c10_table"].field, value_cols=value_cols)
    ref = FieldEnv(cfg, PRESETS["c10_table"].kernel)
    tcfg = dataclasses.replace(TPRESETS["c10_table"].field, value_cols=value_cols)
    got = TFieldEnv(tcfg, TPRESETS["c10_table"].kernel, device="cpu")
    for name in ("features", "traits", "observed_traits", "observed_mask",
                 "test_mask", "_y_mean", "_y_std", "f"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), name)
    np.testing.assert_array_equal(got.X.numpy(), np.asarray(ref.X))
    assert got.num_traits == (3 if value_cols else 1)
    assert not (got.test_mask & ~got.observed_mask).any()
    assert 0 < (~got.observed_mask).sum() < got.n  # the table has gaps


def _write_csv(path, rows):
    cols = list(dict.fromkeys(k for r in rows for k in r))
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=cols)
        w.writeheader()
        w.writerows(rows)
    return str(path)


def test_table_rmse_excludes_imputed_cells(tmp_path):
    """Missing table cells are mean-imputed for conditioning but never
    count as truth in an RMSE, and the held-out split covers observed
    cells only; the same masks as the reference's."""
    rows, cols = 4, 5
    rec = [{"row": r, "range": c, "height": 10.0 + r + c}
           for r in range(rows) for c in range(cols) if not (r == 0 and c < 3)]
    path = _write_csv(tmp_path / "t.csv", rec)
    env = TFieldEnv(TFieldConfig(num_rows=rows, num_cols=cols, data_path=path),
                    device="cpu")
    ref = FieldEnv(FieldConfig(num_rows=rows, num_cols=cols, data_path=path))
    assert env.observed_mask.sum() == rows * cols - 3
    assert not env.observed_mask[:3].any()
    np.testing.assert_array_equal(env.test_mask, ref.test_mask)
    np.testing.assert_array_equal(env.f, ref.f)
    mean = env.f.copy()
    mean[:3] = 99.0
    assert env.rmse(mean) == pytest.approx(0.0)
    assert env.rmse(mean, test_only=True) == pytest.approx(0.0)
    assert not (env.test_mask & ~env.observed_mask).any()


def test_table_per_trait_masks(tmp_path):
    """A plot with height but no width: its imputed width counts in no
    trait-1 RMSE; masks as the reference's."""
    rec = []
    for r in range(4):
        for c in range(5):
            row = {"row": r, "range": c, "height": 10.0 + r + c}
            if not (r == 0 and c < 3):
                row["width"] = 40.0 + 2 * r + c
            rec.append(row)
    path = _write_csv(tmp_path / "t.csv", rec)
    kw = dict(num_rows=4, num_cols=5, data_path=path, value_cols=("height", "width"))
    env = TFieldEnv(TFieldConfig(**kw), device="cpu")
    ref = FieldEnv(FieldConfig(**kw))
    np.testing.assert_array_equal(env.observed_traits, ref.observed_traits)
    np.testing.assert_array_equal(env.traits, ref.traits)
    assert env.observed_traits[:, 0].all()
    assert env.observed_traits[:, 1].sum() == 20 - 3
    means = env.traits.copy()
    means[:3, 1] = 99.0
    assert env.rmse_traits(means) == pytest.approx([0.0, 0.0])
    assert env.rmse_traits(means, test_only=True)[1] == pytest.approx(0.0)


def test_table_value_column_never_guessed(tmp_path):
    """Without 'height', two non-feature candidates raise as the
    reference raises; exactly one is used (never a feat_* column)."""
    amb = _write_csv(tmp_path / "amb.csv", [
        {"row": 0, "range": 0, "feat_a": 0.1, "yield": 1.0, "width": 4.0},
        {"row": 0, "range": 1, "feat_a": 0.2, "yield": 2.0, "width": 5.0},
        {"row": 1, "range": 0, "feat_a": 0.3, "yield": 3.0, "width": 6.0}])
    for make in (lambda: FieldEnv(FieldConfig(num_rows=2, num_cols=2, data_path=amb)),
                 lambda: TFieldEnv(TFieldConfig(num_rows=2, num_cols=2, data_path=amb),
                                   device="cpu")):
        with pytest.raises(ValueError, match="value column is ambiguous"):
            make()
    ok = _write_csv(tmp_path / "ok.csv", [
        {"row": r, "range": c, "feat_a": 0.1 * (2 * r + c + 1), "yield": 2.0 * r + c + 1}
        for r in range(2) for c in range(2)])
    kw = dict(num_rows=2, num_cols=2, num_features=1, data_path=ok)
    env = TFieldEnv(TFieldConfig(**kw), device="cpu")
    assert np.all(np.diff(env.f) > 0)
    np.testing.assert_array_equal(env.X.numpy(), np.asarray(FieldEnv(FieldConfig(**kw)).X))
    with pytest.raises(ValueError, match="value_cols"):
        TFieldEnv(TFieldConfig(**dict(kw, value_cols=("nope",))), device="cpu")


def test_table_rows_outside_the_grid_warn_and_drop(tmp_path):
    """Rows past either axis are dropped with the reference's warning;
    none wraps into the next row."""
    path = _write_csv(tmp_path / "t.csv", [
        {"row": 0, "range": 0, "height": 1.0}, {"row": 0, "range": 1, "height": 2.0},
        {"row": 1, "range": 0, "height": 3.0}, {"row": 0, "range": 2, "height": 9.0},
        {"row": 5, "range": 0, "height": 9.0}])
    kw = dict(num_rows=2, num_cols=2, data_path=path)
    with pytest.warns(UserWarning, match="2 table rows fall outside the 2x2 grid"):
        env = TFieldEnv(TFieldConfig(**kw), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = FieldEnv(FieldConfig(**kw))
    np.testing.assert_array_equal(env.observed_mask, [True, True, True, False])
    np.testing.assert_array_equal(env.traits, ref.traits)
