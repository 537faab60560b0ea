"""The manifest, the lookup by name, and the run's refusals (CPU).

    python -m pytest perfbench/tests -q
"""

import json
import re
import shutil
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.manifest import ROOT, Cell, load_manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_manifest_keys_names_and_bounds():
    m = load_manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert m["paths"] == ["perfbench"] and m["command"][1] == "perfbench/run.py"
    assert 1 <= m["run_seconds"] <= 51
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for e in m["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in {"host_clock", "device_trace"}
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in m[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group in ("end_to_end", "per_layer"), entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
                assert entry["source"] in SOURCES
    assert len(names) == len(set(names))
    for p in m["per_layer"]:
        assert p["moves"] in e2e
        for w in p["workloads"]:
            assert w in e2e[p["moves"]].get("workloads", [w])
    four = [w for w in m["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(m["workloads"]) // 4)
    assert len(json.dumps(m)) < 64 * 1024


@pytest.mark.parametrize("name", [w["name"] for w in load_manifest()["workloads"]])
def test_every_cell_resolves_its_files(name):
    cell = Cell(load_manifest(), name)
    assert cell.config["name"] == cell.entry["config"]
    assert cell.traffic["kind"] in ("fit", "diagnostics")
    assert cell.limits
    for trace in (0, 1):
        metrics = cell.metrics(trace)
        assert metrics
        for entry in metrics:
            assert callable(cell.reader(entry["name"]))
    assert "setup_s" in {e["name"] for e in cell.metrics(0)}


def test_new_files_are_picked_up_without_an_edit(tmp_path):
    """A configuration, a traffic mix, limits and a metric added as new
    files, with new manifest entries, resolve by name."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = load_manifest()
    bench = tmp_path / "perfbench"
    config = json.loads((bench / "configs" / "logreg1000_fullrank.json").read_text())
    config["name"] = "logreg200_fullrank"
    config["model"]["dim"] = 200
    (bench / "configs" / "logreg200_fullrank.json").write_text(json.dumps(config))
    (bench / "traffic" / "fit_short.json").write_text(json.dumps(
        {"kind": "fit", "warm_iters": 400, "checked_steps": 50,
         "objective": {"use_path_deriv": True}}))
    (bench / "limits" / "fit.logreg200_fullrank.short.json").write_text(
        json.dumps({"loss_gap": 1.0}))
    (bench / "metrics" / "fits_per_window.py").write_text(
        "def read(ctx):\n    return ctx['window'].get('fits')\n")
    m["configs"].append({"name": "logreg200_fullrank", "source": "https://example.org/x",
                         "file": "perfbench/configs/logreg200_fullrank.json", "reduced": [],
                         "why": "a test"})
    m["workloads"].append({"name": "fit.logreg200_fullrank.short", "config": "logreg200_fullrank",
                           "traffic": "fit_short", "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "fits_per_window", "unit": "fits", "better": "higher",
                           "source": "program_counter", "layer": "device",
                           "moves": "fit_steps_per_s",
                           "workloads": ["fit.logreg200_fullrank.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    cell = Cell(load_manifest(tmp_path), "fit.logreg200_fullrank.short", root=tmp_path)
    assert cell.config["model"]["dim"] == 200
    assert cell.traffic["objective"]["use_path_deriv"] is True
    assert cell.limits == {"loss_gap": 1.0}
    assert "fits_per_window" in {e["name"] for e in cell.metrics(1)}
    assert cell.reader("fits_per_window")({"window": {"fits": 3}}) == 3


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(["jax", "numpy"]) == ["jax"]
    assert harness.forbidden_modules(["jax.numpy", "jaxlib.xla_client"]) == ["jax", "jaxlib"]
    assert harness.forbidden_modules(["viabel_tpu.faso", "flax.linen"]) == ["flax", "viabel_tpu"]
    assert harness.forbidden_modules(["viabel_torch", "viabel_torch.faso", "jaxtyping",
                                      "viabel_tpux", "torch"]) == []


def test_run_refuses_without_a_card(tmp_path):
    """No CUDA card here: a non-zero exit and no result line."""
    proc = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
                           "fit.logreg1000_fullrank.stl", "--seed", "3", "--seconds", "1",
                           "--trace", "0"],
                          capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and perfbench/ has no
    program to run: a non-zero exit and no result line."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "fit.logreg1000_fullrank.stl", "--seed", "3", "--seconds", "1",
                           "--trace", "0"],
                          capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
