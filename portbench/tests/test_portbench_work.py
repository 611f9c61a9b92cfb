"""The yardstick's counts against hand counts at small shapes."""

import pytest

from portbench import work


def test_seed_flops_are_two_thirds_n_cubed():
    f = work.greedy_mi_flops(30, 4, 5)
    assert f["cholesky"] + f["tri_inv"] == pytest.approx(2 * 30 ** 3 / 3)
    assert f["pilot_delete"] == 2 * 30 * 30 * 4
    assert f["precision_columns"] == 5 * 30 * 30
    assert f["gram"] == 30 * 30 * (3 * 2 + 4)


def test_gram_bytes_read_inputs_once_write_output_once():
    # x1 (3, 2), x2 (5, 2), out (3, 5), noise (3,): 4 bytes each
    assert work.gram_bytes(3, 5, 2) == 4 * (6 + 10 + 15)
    assert work.gram_bytes(3, 5, 2, noise=True) == 4 * (6 + 10 + 15 + 3)


def test_roofline_bound_is_the_larger_bound():
    assert work.roofline_bound_s(67e12, 0) == pytest.approx(1.0)
    assert work.roofline_bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert work.roofline_bound_s(67e12, 6.7e12) == pytest.approx(2.0)


def test_main_path_seed_time_at_peak():
    f = work.greedy_mi_flops(10_000, 32, 50)
    seed = f["cholesky"] + f["tri_inv"]
    assert seed == pytest.approx(6.667e11, rel=1e-3)
    assert seed / work.PEAK_FP32_FLOPS == pytest.approx(9.95e-3, rel=1e-3)


def test_adam_fit_flops_hand_count():
    # 2 restarts, 3 steps (+ the final evaluation), n = 4
    assert work.adam_fit_flops(4, 2, 3) == 3 * 2 * 4 * (64 / 3 + 32)
