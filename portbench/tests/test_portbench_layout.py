"""BENCHMARK.json against the contract's shape, every name resolved to its
file, and the import guard: nothing under portbench/ imports JAX, flax or
the JAX package, and the references import nothing of the program."""
import ast
import json
import re
from pathlib import Path

import pytest

from portbench import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == KEYS
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["portbench"]
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert len(Path(harness.REPO, "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[key]:
            assert NAME.match(e["name"]), e["name"]
            names.append((key, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(set(n for _, n in names if _ in ("end_to_end", "per_layer"))) == \
        len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_its_files(cell):
    w = harness.find(BENCH["workloads"], cell, "workload")
    spec, _ = harness.config_files(w["config"])
    cfg = harness.find(BENCH["configs"], w["config"], "config")
    assert cfg["file"] == f"portbench/configs/{w['config']}.json"
    assert spec["reduced"] == cfg["reduced"]
    traffic = harness.traffic_file(w["traffic"])
    assert hasattr(harness.entry_module(traffic["entry"]), "Entry")
    assert hasattr(harness.reference_module(w["config"]), "__doc__")
    limits = harness.limits_file(cell)
    assert all(v["limit"] > 0 for v in limits.values())


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_what_the_contract_asks(cell):
    e2e = [m["name"] for m in harness.cell_metrics(BENCH, cell, "end_to_end")]
    layers = harness.cell_metrics(BENCH, cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    for m in layers:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_has_a_reader(metric):
    assert callable(harness.metric_module(metric).read)


def _top_level_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    for path in harness.HERE.rglob("*.py"):
        assert not _top_level_imports(path) & set(harness.BANNED), path


def test_references_import_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        assert not _top_level_imports(path) & {"nerf_qa_torch", "portbench", *harness.BANNED}


def test_guard_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "nerf_qa_tpux", types.ModuleType("nerf_qa_tpux"))
    assert "nerf_qa_tpux" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("jaxlib.xla"))
    assert harness.banned_modules() == ["jaxlib.xla"]
