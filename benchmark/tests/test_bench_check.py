"""The no-JAX guard, the verdict against limits, and the shape of a run's
last line."""
import json

import pytest

from benchmark import check
from bench_small import run_small


@pytest.mark.parametrize("name,refused", [
    ("neural_marionette_tpu_torch", False),
    ("neural_marionette_tpu_torch.x", False),
    ("neural_marionette_tpu", True),
    ("neural_marionette_tpu.x", True),
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("jaxtyping", False), ("torch", False)])
def test_forbidden_modules_compares_whole_top_level_names(name, refused):
    assert check.forbidden_modules({name: None}) == ([name] if refused
                                                     else [])


def test_this_process_loads_no_jax():
    import benchmark.run  # noqa: F401
    import neural_marionette_tpu_torch.api  # noqa: F401
    assert check.forbidden_modules() == []


@pytest.mark.parametrize("value,ok", [(0.5, True), (1.0, True), (1.5, False),
                                      (None, False), (float("nan"), False)])
def test_verdict(value, ok):
    got, compared = check.verdict({"a": value}, {"a": 1.0})
    assert got is ok and compared == {"a": {"value": value, "limit": 1.0}}


def test_worst_leaf_uses_the_median_leaf_as_floor():
    ref = {"a": 1.0, "b": 1e-9, "c": 2.0}
    cand = {"a": 1.0, "b": 2e-9, "c": 2.0}
    assert check.worst_leaf(cand, ref) == pytest.approx(1e-9)


@pytest.mark.parametrize("cell", ["aist_dynamics.serve"])
def test_last_line_shape(cell, tmp_path):
    res = run_small(cell, tmp_path, compute_dtype="float32")
    for k in ("_readings", "_controls", "_detail"):
        res.pop(k)
    line = json.loads(json.dumps(res))
    assert list(line)[:3] == ["correct", "attempted", "failed"]
    assert list(line)[-1] == "compared"
    assert set(line) == {"correct", "attempted", "failed", "metrics",
                         "device", "compared"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["metrics"]) == {"setup_s", "serve_clips_per_s",
                                    "serve_window_ms_p95"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert all(set(c) == {"value", "limit"}
               for c in line["compared"].values())
