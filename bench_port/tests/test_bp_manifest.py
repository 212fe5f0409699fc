"""BENCHMARK.json: its keys, names and units, and that every configuration,
mix, limit and metric it names resolves by name, so that a cell is added
with new files and entries only."""
import json
import re
import shutil

import pytest
import torch

from bench_port.harness import (BENCH, ROOT, Run, load_cell, load_kind, load_metric,
                                read_metrics)
from bench_port.generator import WindowRecord

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_shapes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= len(MANIFEST["command"]) <= 32 and all(_line(w) for w in MANIFEST["command"])
    for p in MANIFEST["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")
    for w in MANIFEST["command"][1:]:
        assert not w.startswith("/") and ".." not in w.split("/")
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(MANIFEST["paths"][0] + "/")
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in MANIFEST["end_to_end"]}
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MANIFEST[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in MANIFEST["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in MANIFEST[group]}) == len(MANIFEST[group])
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_every_cell_reports_setup_and_an_end_to_end_and_a_layer_metric():
    for w in MANIFEST["workloads"]:
        cell = load_cell(w["name"], MANIFEST)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_everything_named_resolves(cell):
    c = load_cell(cell, MANIFEST)
    assert c.cfg["name"] == next(w["config"] for w in MANIFEST["workloads"]
                                 if w["name"] == cell)
    kind = c.traffic["kind"]
    assert kind in ("serve", "train") or (BENCH / "kinds" / f"{kind}.py").exists()
    assert set(c.limits), f"limits/{cell}.json"
    for m in c.end_to_end + c.per_layer:
        assert callable(load_metric(m["name"]).read)
    for entry in MANIFEST["configs"]:
        assert (ROOT / entry["file"]).exists()


def _fake_run(kind="serve"):
    w = WindowRecord(requests=10, items=640, t_start=0.0, t_end=0.5,
                     latencies=[0.05] * 10, dispatch=[0.01] * 10)
    return Run(kind=kind, window=w, setup_s=3.0, flops_per_step=1e12)


NEW_KIND = """
from bench_port.generator import WindowRecord
from bench_port.harness import Run


def run(cell, seed, seconds, trace, device, *, t0, log, **factories):
    w = WindowRecord(requests=10, items=10 * cell.traffic["batch"], t_start=0.0, t_end=0.5,
                     latencies=[0.05] * 10, dispatch=[0.01] * 10)
    return {"run": Run(kind="serve", window=w, setup_s=3.0, flops_per_step=1e12),
            "attempted": 10, "failed": 0, "checks": {}, "memory_peak_bytes": 0}
"""


@pytest.mark.parametrize("kind", ["serve", "new_kind"])
def test_a_new_cell_needs_only_new_files_and_entries(tmp_path, kind):
    """A cell of a kind that `harness.py` runs, and one of a kind brought as
    a file of its own (`kinds/<kind>.py`), each added with new files and
    entries only."""
    bench = tmp_path / "bench_port"
    for sub in ("configs", "traffic", "metrics", "limits", "kinds"):
        shutil.copytree(BENCH / sub, bench / sub)
    manifest = json.loads(json.dumps(MANIFEST))
    (bench / "traffic" / "serve_b32.json").write_text(json.dumps(
        dict(json.loads((BENCH / "traffic" / "serve_b64.json").read_text()), batch=32,
             kind=kind)))
    if kind != "serve":
        (bench / "kinds" / f"{kind}.py").write_text(NEW_KIND)
    (bench / "limits" / "mano_freihand21.serve_b32.json").write_text(
        (BENCH / "limits" / "smpl_h36m17.serve_b64.json").read_text())
    (bench / "metrics" / "meshes_per_s_new.py").write_text(
        "def read(run):\n    return 2.0 * run.window.items / run.window.seconds\n")
    manifest["workloads"].append({"name": "mano_freihand21.serve_b32",
                                  "config": "mano_freihand21", "traffic": "serve_b32",
                                  "chips": 1, "why": "a new cell"})
    manifest["end_to_end"].append({"name": "meshes_per_s_new", "unit": "meshes/s",
                                   "better": "higher", "bound": 0.05, "source": "host_clock",
                                   "workloads": ["mano_freihand21.serve_b32"]})
    cell = load_cell("mano_freihand21.serve_b32", manifest, bench=bench)
    assert cell.traffic["batch"] == 32 and cell.cfg["num_vertices"] == 778
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "meshes_per_s_new"]
    got = read_metrics(_fake_run(), cell.end_to_end, bench)
    assert got["meshes_per_s_new"]["value"] == pytest.approx(2560.0)
    if kind != "serve":
        res = load_kind(kind, bench).run(cell, 1, 0.5, False, torch.device("cpu"), t0=0.0,
                                         log=print)
        got = read_metrics(res["run"], cell.end_to_end, bench)
        assert got["meshes_per_s_new"]["value"] == pytest.approx(1280.0)


def test_readers_return_nothing_where_nothing_is_read():
    run = _fake_run("serve")
    assert load_metric("train_samples_per_s").read(run) is None
    assert load_metric("band_roofline.serve").read(run) is None   # no trace
    assert load_metric("idle_share.serve").read(run) is None
    assert load_metric("meshes_per_s").read(run) == pytest.approx(1280.0)
    assert load_metric("dispatch_ms.serve").read(run) == pytest.approx(10.0)
    assert load_metric("mfu.serve").read(run) == pytest.approx(100 * 20e12 / 989e12)
