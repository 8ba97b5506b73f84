"""BENCHMARK.json against the benchmark's contract, the files it names, the
imports of the harness, and a cell and a metric added by files alone.

    python -m pytest portbench -q
"""

from __future__ import annotations

import ast
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.bench import device, manifest, session

PKG = manifest.PKG
REPO = PKG.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group in ("end_to_end", "per_layer"), entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in BENCH["configs"]:
        for k in c["reduced"]:
            assert NAME.match(k)
    assert len(set(names)) == len(names)


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (REPO / c["file"]).is_file()
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and 1 <= len(m["layer"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher")


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for w in BENCH["workloads"]:
        cell = manifest.load_cell(w["name"], BENCH)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer


def test_per_layer_moves_an_end_to_end_metric_each_listed_cell_reports():
    for m in BENCH["per_layer"]:
        assert "moves" in m and "workloads" in m
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert manifest.reports(moved, cell), (m["name"], cell)
        assert (PKG / "metrics" / f"{m['name']}.py").is_file()


def test_layers_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert len(layers) <= 8
    for layer in layers:
        assert layer == layer.strip() and "\t" not in layer


def test_four_chip_cells_at_most_a_quarter():
    cells = BENCH["workloads"]
    assert sum(w["chips"] == 4 for w in cells) <= max(1, math.floor(len(cells) / 4))
    assert all(w["chips"] in (1, 4) for w in cells)
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(set(pairs)) == len(pairs)


def test_every_cell_has_its_files_and_limits():
    for w in BENCH["workloads"]:
        cell = manifest.load_cell(w["name"], BENCH)
        assert cell.limits and all(v > 0 for v in cell.limits.values())
        assert hasattr(cell.entry, "Entry") and hasattr(cell.config_module, "build_port")


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        tops = {name.split(".", 1)[0] for name in _imports(path)}
        assert not tops & set(device.FORBIDDEN), (path, tops & set(device.FORBIDDEN))


def test_the_reference_imports_nothing_of_the_port():
    for path in (PKG / "reference").rglob("*.py"):
        tops = {name.split(".", 1)[0] for name in _imports(path)}
        assert "v3d_tpu_torch" not in tops and not tops & set(device.FORBIDDEN), path


def test_forbidden_modules_compared_by_whole_top_level_name():
    assert device.forbidden_loaded(["v3d_tpu_torch", "v3d_tpu_torch.ops", "torch"]) == []
    assert device.forbidden_loaded(["jax.numpy", "v3d_tpu.ops", "flax"]) == \
        ["flax", "jax", "v3d_tpu"]


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from portbench.bench import manifest, device, session, control; "
            "[manifest.load_cell(w['name']) for w in manifest.read_json(manifest.BENCHMARK)"
            "['workloads']]; "
            "[manifest.metric_reader(m['name']) for m in manifest.read_json(manifest.BENCHMARK)"
            "['per_layer']]; "
            "import v3d_tpu_torch.apps.generate, v3d_tpu_torch.apps.train_diffusion; "
            "print(device.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code, str(REPO)], capture_output=True,
                         text=True, timeout=300, env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_no_result_and_a_nonzero_exit():
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here: the run would start")
    out = subprocess.run([sys.executable, str(PKG / "run.py"), "--workload", "v3d512.generate",
                          "--seed", str(2**31 + 5), "--seconds", "1"], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 3 and out.stdout == ""
    assert "no result" in out.stderr


def test_a_checkout_without_the_port_gives_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PKG, tmp_path / "portbench", ignore=shutil.ignore_patterns("out", "__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "v3d512.generate",
                          "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={k: v for k, v in os.environ.items()
                                                      if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout == ""


def test_a_cell_and_a_metric_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains a cell (a traffic file, a limits file,
    an entry in BENCHMARK.json) and a per-layer metric (a reader file, an
    entry) and nothing else; the harness finds and runs them."""
    from portbench.tiny import tiny_cell

    shutil.copytree(PKG, tmp_path / "portbench", ignore=shutil.ignore_patterns("out", "__pycache__"))
    pkg = tmp_path / "portbench"
    bench = json.loads(json.dumps(BENCH))
    traffic = json.loads((pkg / "traffic" / "generate.json").read_text())
    traffic["params"]["num_steps"] = 3
    (pkg / "traffic" / "generate3.json").write_text(json.dumps(traffic))
    (pkg / "limits" / "v3d512.generate3.json").write_text(
        (pkg / "limits" / "v3d512.generate.json").read_text())
    (pkg / "metrics" / "requests_timed.py").write_text(
        '"""requests_timed: requests the window completed."""\n\n\n'
        "def read(rec):\n    return rec.units\n")
    bench["workloads"].append({"name": "v3d512.generate3", "config": "v3d512",
                               "traffic": "generate3", "chips": 1, "why": "three steps"})
    bench["end_to_end"][0]["workloads"].append("v3d512.generate3")
    bench["per_layer"].append({"name": "requests_timed", "unit": "requests",
                               "better": "higher", "source": "host_clock", "layer": "entry",
                               "moves": "gen_s", "workloads": ["v3d512.generate3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = manifest.load_cell("v3d512.generate3", bench, pkg)
    assert cell.traffic["params"]["num_steps"] == 3
    assert [m["name"] for m in cell.per_layer] == ["requests_timed"]
    assert {m["name"] for m in cell.end_to_end} == {"gen_s", "peak_gib", "setup_s"}

    cell = tiny_cell("v3d512.generate3", "float32", bench, pkg)
    result = session.run(cell, 2**31 + 3, 0.0, False, device="cpu")
    assert set(result["metrics"]) == {"gen_s", "peak_gib", "setup_s"}
    assert result["correct"], result["checks"]
    rec = session.Record(cell.name, cell.config, cell.traffic, result["attempted"], 1.0,
                         [], None, {}, {})
    assert session.read_per_layer(cell, rec, say=lambda s: None, pkg=pkg) == {
        "requests_timed": {"value": 1.0, "unit": "requests"}}
