"""The benchmark finds its cells, configurations, mixes, metric readers
and limits by name, and a new configuration, mix and metric are new files
and new entries, with no edit to a file that is there."""
import json
import shutil

import pytest

from benchmark.registry import HERE, ROOT, Registry

CELLS = ("aist_detector.train", "aist_dynamics.train", "aist_dynamics.serve")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    r = Registry()
    c = r.cell(cell)
    assert r.config(c["config"])["model"]["grid_size"] == 64
    assert r.traffic(c["traffic"])["driver"] in ("train_loop",
                                                 "stream_closed")
    assert hasattr(r.driver(r.traffic(c["traffic"])["driver"]), "run")
    assert r.limits(cell)
    metrics = r.per_layer(cell)
    assert metrics and all(callable(r.reader(m["name"])) for m in metrics)
    names = {m["name"] for m in r.end_to_end(cell)}
    assert "setup_s" in names and len(names) >= 2
    assert all(m["moves"] in names for m in metrics)


def test_every_metric_has_a_reader_and_every_cell_a_limit_file():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"] + bench["end_to_end"]:
        assert m["name"] == "setup_s" or \
            (HERE / "metrics" / f"{m['name']}.py").is_file()
    for w in bench["workloads"]:
        assert (HERE / "limits" / f"{w['name']}.json").is_file()
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()


def test_throwaway_entries_are_new_files_only(tmp_path):
    """A copy of the benchmark gains a configuration, a mix, a metric and
    a cell as new files plus entries in BENCHMARK.json; the registry finds
    them all, and no file of the copy was edited."""
    here = tmp_path / "benchmark"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((here / "configs" / "aist_dynamics.json").read_text())
    cfg["name"] = "aist_dynamics_b8"
    cfg["model"]["nbatch"] = 8
    (here / "configs" / "aist_dynamics_b8.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "stream_closed.json").read_text())
    mix["B"] = 8
    (here / "traffic" / "stream_b8.json").write_text(json.dumps(mix))
    (here / "metrics" / "windows.serve_b8.py").write_text(
        "def read(rec):\n    return rec.get('windows')\n")
    (here / "metrics" / "serve_b8_windows_per_s.py").write_text(
        "def read(e2e):\n    return e2e.get('windows_per_s')\n")
    (here / "limits" / "aist_dynamics_b8.serve.json").write_text(
        (here / "limits" / "aist_dynamics.serve.json").read_text())
    bench["configs"].append({"name": "aist_dynamics_b8", "source": "x",
                             "file": "benchmark/configs/aist_dynamics_b8.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "aist_dynamics_b8.serve",
                               "config": "aist_dynamics_b8",
                               "traffic": "stream_b8", "chips": 1,
                               "why": "x"})
    bench["end_to_end"][3]["workloads"].append("aist_dynamics_b8.serve")
    bench["end_to_end"].append({"name": "serve_b8_windows_per_s",
                                "unit": "windows/s", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["aist_dynamics_b8.serve"]})
    bench["per_layer"].append({"name": "windows.serve_b8", "unit": "windows",
                               "better": "higher", "source": "host_clock",
                               "layer": "stream", "moves": "serve_clips_per_s",
                               "workloads": ["aist_dynamics_b8.serve"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    r = Registry(tmp_path / "BENCHMARK.json", here)
    c = r.cell("aist_dynamics_b8.serve")
    assert r.config(c["config"])["model"]["nbatch"] == 8
    assert r.traffic(c["traffic"])["B"] == 8
    assert [m["name"] for m in r.per_layer(c["name"])] == ["windows.serve_b8"]
    assert r.reader("windows.serve_b8")({"windows": 7}) == 7
    assert [m["name"] for m in r.end_to_end(c["name"])] == [
        "setup_s", "serve_clips_per_s", "serve_b8_windows_per_s"]
    assert r.reader("serve_b8_windows_per_s")({"windows_per_s": 3.0}) == 3.0
    assert r.limits(c["name"]) == Registry().limits("aist_dynamics.serve")
    assert all(p.read_bytes() == b for p, b in before.items())
