"""Nothing that `python -m portbench.run` loads is JAX or the JAX package,
compared by whole top-level names (the port's name begins with the JAX
package's, so a prefix would be wrong); and without a card the command
exits non-zero and prints no result."""

import os
import subprocess
import sys
import textwrap

from portbench import harness

ROOT = str(harness.ROOT)


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "algp_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert "algp_tpu" not in harness.forbidden_modules() or "algp_tpu" in {
        n.split(".")[0] for n in sys.modules}
    monkeypatch.setitem(sys.modules, "algp_tpu.fake", object())
    assert "algp_tpu" in harness.forbidden_modules()


def test_a_run_loads_no_jax():
    code = textwrap.dedent("""
        import sys, time, json
        from portbench import harness, run
        from portbench.tests.conftest import small
        m = harness.load_manifest()
        for w in m["workloads"]:
            for traced in (False, True):
                harness.run_cell(m, w["name"], 3, 0.2, traced, "cpu", time.perf_counter(), small(m, w["name"]))
        for name in [e["name"] for e in m["end_to_end"] + m["per_layer"]]:
            harness.metric_reader(name)
        import portbench.calibrate
        print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
    """)
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert "algp_tpu_torch" in loaded and "portbench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "algp_tpu"}


def test_refuses_to_time_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": ROOT}
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "main10k.select", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr
