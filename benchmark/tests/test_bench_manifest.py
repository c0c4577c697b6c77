"""BENCHMARK.json against the benchmark's contract, a throwaway cell run
through the harness unedited, and the import guard."""

from __future__ import annotations

import ast
import json
import re
import sys
from pathlib import Path

import pytest

from benchmark import check, kinds, run
from benchmark.tests.tiny import write_root

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|head|expansion|per_tok)")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def man():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_and_units(man):
    assert set(man) == KEYS
    assert man["command"] == ["python3", "-m", "benchmark.run"]
    assert man["paths"] == ["benchmark"]
    assert all(PATH.match(p) and ".." not in p for p in man["paths"])
    rs = man["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits into 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    metrics = man["end_to_end"] + man["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for entry in man["configs"] + man["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in man["end_to_end"]} >= {"setup_s"}
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"


def test_configs_found_and_unreduced(man):
    used = {w["config"] for w in man["workloads"]}
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["why"]) and _line(c["source"])
        assert c["file"].startswith("benchmark/")
        model = json.loads((ROOT / c["file"]).read_text())
        assert {"unet", "vae", "port_preset"} <= set(model)
        assert len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
    files = [c["file"] for c in man["configs"]]
    assert len(files) == len(set(files))


def test_cells_find_their_files_and_metrics(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    pairs = set()
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = run.load_cell(ROOT, w["name"])
        assert cell["limits"] and set(cell["limits"]) <= set(check.NUMBERS)
        kind = kinds.load(cell["traffic"]["kind"])
        assert callable(kind.Program) and callable(kind.Reference)
        reported = {m["name"] for m in cell["e2e"]}
        assert "setup_s" in reported and len(reported) >= 2
        for m in cell["e2e"]:
            assert callable(run.reader(ROOT, m["name"]))
        assert cell["per_layer"], w["name"]
        for m in cell["per_layer"]:
            # the metric's cells report the end-to-end metric it moves
            assert m["moves"] in reported
            assert w["name"] in e2e[m["moves"]].get("workloads",
                                                    [w["name"]])
            assert callable(run.reader(ROOT, m["name"]))
    assert sum(w["chips"] == 4 for w in man["workloads"]) <= max(
        1, len(man["workloads"]) // 4)


def test_files_are_named_from_names():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
        assert NAME.match(p.name), rel


def test_throwaway_cell_runs_through_the_harness(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)          # the prompt cache is cwd-relative
    name = write_root(tmp_path, "sds")
    res = run.run_cell(tmp_path, name, 2 ** 31 + 11, 0.5, False,
                       device="cpu", log=lambda *a, **k: None)
    assert list(res)[-1] == "compared"
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
    assert res["correct"] is True, res["compared"]
    assert set(res["metrics"]) == {"step_ms.sds", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())


def test_import_guard_compares_whole_names(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gsgen_tpu_like", object())
    monkeypatch.setitem(sys.modules, "jaxish.core", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "gsgen_tpu.ops", object())
    assert run.forbidden_modules() == ["gsgen_tpu", "jax"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_program():
    for p in (BENCH / "reference").glob("*.py"):
        assert not set(_imports(p)) & {"gsgen_torch", "gsgen_tpu", "jax",
                                       "jaxlib", "flax"}, p
    for p in BENCH.rglob("*.py"):
        assert not set(_imports(p)) & {"gsgen_tpu", "jax", "jaxlib",
                                       "flax"}, p
