"""The benchmark's files: every configuration and cell loads and agrees
with BENCHMARK.json, and nothing under port_bench imports JAX, the JAX
package or its benchmarks."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path: Path) -> set[str]:
    """Top-level names of every module a file imports (the part before the
    first dot, compared whole)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".", 1)[0])
    return out


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_kept_workload_files_load():
    """Every workload file loads and names a configuration, including the
    files kept for a later cell (``dna256k.tfidf``, ``dna1m.list``,
    ``dna1m.count``)."""
    for path in sorted((ROOT / "port_bench" / "workloads").glob("*.json")):
        wl = json.loads(path.read_text())
        assert (ROOT / "port_bench" / "configs" / f"{wl['config']}.json").is_file()
        assert set(wl["terms"]) <= set(wl["pools"]) and wl["runtime"]["max_batch"] >= 1


CONFIGS = sorted(p.stem for p in (ROOT / "port_bench" / "configs").glob("*.json"))
WORKLOADS = sorted(p.stem for p in (ROOT / "port_bench" / "workloads").glob("*.json"))


@pytest.mark.parametrize("name", CONFIGS)
def test_config_file_loads(name):
    """Every configuration file, in BENCHMARK.json or kept for a later
    cell, states its cuts; an entry of BENCHMARK.json names its file."""
    data = json.loads((ROOT / "port_bench" / "configs" / f"{name}.json").read_text())
    assert data["name"] == name
    entry = next((c for c in BENCH["configs"] if c["name"] == name), None)
    reduced = set(data["reduced"])
    if entry is not None:
        assert entry["file"] == f"port_bench/configs/{name}.json"
        assert set(entry["reduced"]) == reduced
        assert any(w["config"] == name for w in BENCH["workloads"])
    assert reduced <= set(data)
    assert data["index"]["topk_index"] in (True, False)
    assert data["guarantees"]["occ_df_threshold"] > 0
    # the source's own sizes, kept but for the keys that name a cut
    paper = data["paper"]
    assert {k for k in paper if k in data and data[k] != paper[k]} == reduced


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_file_loads(name):
    """Every workload file loads as a cell; one in BENCHMARK.json reports
    every end-to-end metric and a per-layer one."""
    from port_bench.harness.bench import load_cell

    entry = next((w for w in BENCH["workloads"] if w["name"] == name), None)
    if entry is None:
        wl = json.loads((ROOT / "port_bench" / "workloads" / f"{name}.json").read_text())
        assert (ROOT / "port_bench" / "configs" / f"{wl['config']}.json").is_file()
    else:
        loaded = load_cell(name, ROOT)
        wl = loaded.workload
        assert wl["config"] == entry["config"] and entry["chips"] == 1
        assert {m["name"] for m in loaded.end_to_end} == {m["name"] for m in BENCH["end_to_end"]}
        assert loaded.per_layer, "every cell reports a per-layer metric"
    assert sum(wl["kinds"].values()) > 0 and wl["clients"] >= 1
    assert set(wl["limits"]) >= {f"{k}_rows_wrong" for k in wl["kinds"]}


def test_every_metric_has_a_reader_and_moves_an_end_to_end_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert (ROOT / "port_bench" / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e and m["layer"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25


def test_nothing_imports_jax_or_the_jax_package():
    found = {}
    for path in sorted((ROOT / "port_bench").rglob("*.py")):
        bad = _imports(path) & FORBIDDEN
        if bad:
            found[str(path.relative_to(ROOT))] = sorted(bad)
    assert not found


def test_reference_imports_nothing_of_the_program():
    for path in sorted((ROOT / "port_bench" / "reference").rglob("*.py")):
        assert not _imports(path) & (FORBIDDEN | {"repro_torch", "torch"}), path
