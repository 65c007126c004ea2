"""The harness driven on the CPU at a tiny size: a clean run comes out
correct; a run whose timed path is broken underneath (half of a batch
left out, one answer altered where it is produced) comes out not correct;
a cell, configuration and per-layer metric added as files only are run;
the command refuses a machine without a card.

The look for a card is the only part of a run these tests skip: the card
itself is needed only for the numbers, which these tests do not read."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from port_bench.harness import bench
from port_bench.harness.bench import Cell, load_cell, run_cell

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["dna1m.list", "dna256k.topk", "dna256k.tfidf", "dna1m.count", "dna256k.list"]


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    """A short warm-up and one torch thread (several test workers share
    the cores)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(bench, "WARM_MIN", 4)
    monkeypatch.setattr(bench, "WARM_QUIET", 2)
    yield
    torch.set_num_threads(threads)


def _tiny(cell):
    cell.config = dict(cell.config, n_variants=10, base_len=240)
    pools = {k: dict(v, extracts=300, keep=24) for k, v in cell.workload["pools"].items()}
    cell.workload = dict(cell.workload, clients=8, pools=pools,
                         runtime=dict(cell.workload["runtime"], max_batch=4, max_df=6,
                                      max_buf=16, default_deadline_s=60.0))
    return cell


def _cell(name, root=ROOT):
    """A cell of BENCHMARK.json, or one whose files are kept for a later
    entry (``dna1m.list``, ``dna256k.tfidf``, ``dna1m.count``), with every
    metric."""
    bench_json = json.loads((root / "BENCHMARK.json").read_text())
    if any(w["name"] == name for w in bench_json["workloads"]):
        return load_cell(name, root)
    wl = json.loads((root / "port_bench/workloads" / f"{name}.json").read_text())
    cfg = json.loads((root / "port_bench/configs" / f"{wl['config']}.json").read_text())
    return Cell(name, {"config": wl["config"], "chips": 1}, wl, cfg, bench_json["end_to_end"],
                bench_json["per_layer"], root)


def _run(name, seed=2**31 + 11, trace=False, root=ROOT):
    return run_cell(_tiny(_cell(name, root)), seed, 0.25, trace, device="cpu",
                    log=lambda *a: None)


@pytest.mark.parametrize("name", CELLS)
def test_clean_run_is_correct(name):
    result, numbers = _run(name)
    assert result["correct"], numbers
    assert result["attempted"] > 0 and result["failed"] == 0
    # no card: the allocator's count of the index is the card's, and left out
    assert set(result["metrics"]) == {"queries_per_s", "p95_ms", "setup_s"}


def _broken(kind, fault):
    """The service's endpoint of ``kind`` with ``fault`` planted where its
    answer is produced."""
    from repro_torch.serve.retrieval import RetrievalService

    method = {"list": "list_docs_arrays", "topk": "topk_arrays", "tfidf": "tfidf_arrays",
              "count": "count"}[kind]
    original = getattr(RetrievalService, method)

    def endpoint(self, *args, **kwargs):
        if kind == "count":
            df = np.array(original(self, *args, **kwargs))
            if fault == "half_batch":
                df[df.shape[0] // 2:] = 0
            else:
                df[0] = df[0] - 1 if df[0] else 1
            return df
        docs, other = (np.array(x) for x in original(self, *args, **kwargs))
        half = docs.shape[0] // 2
        if fault == "half_batch":
            # the second half of the batch left out: empty rows
            docs[half:] = -1
            other[half:] = 0
        else:
            # one answer altered where it is produced
            if kind == "list":
                docs[0, 0] = docs[0, 0] + 1 if other[0] else 0
                other[0] = max(other[0], 1)
            elif kind == "topk":
                other[0, 0] += 1
            else:
                other[0, 0] = np.float32(other[0, 0] * 1.5 + 1.0)
        return docs, other
    return method, endpoint


@pytest.mark.parametrize("fault", ["half_batch", "altered_answer"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_path_is_not_correct(name, fault, monkeypatch):
    from repro_torch.serve.retrieval import RetrievalService

    kind = next(iter(_cell(name).workload["kinds"]))
    monkeypatch.setattr(RetrievalService, *_broken(kind, fault))
    result, numbers = _run(name)
    assert not result["correct"], numbers
    assert any(v > lim for v, lim in numbers.values())


def test_traced_run_reads_its_metrics():
    result, _ = _run("dna256k.tfidf", trace=True)
    assert result["correct"]
    m = result["metrics"]
    # no card: the device's metrics find nothing to read and are left out
    assert {"runtime_self_ms", "service_ms", "batch_fill_pct", "captures_in_window",
            "build_s", "modeled_bpc"} <= set(m)
    assert not {"device_busy_ms", "kernels_per_batch"} & set(m)
    assert m["captures_in_window"]["value"] == 0 and m["service_ms"]["value"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_cell_added_as_files_only(tmp_path):
    """A new configuration, cell and per-layer metric: new files under
    port_bench and entries in BENCHMARK.json, no harness file edited."""
    for part in ("configs", "workloads", "metrics"):
        shutil.copytree(ROOT / "port_bench" / part, tmp_path / "port_bench" / part)
    bench_json = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "port_bench/configs/dna-p001-256k.json").read_text())
    cfg.update(name="version-p001-tiny", family="version", n_base=3, n_variants=4)
    (tmp_path / "port_bench/configs/version-p001-tiny.json").write_text(json.dumps(cfg))
    wl = json.loads((ROOT / "port_bench/workloads/dna256k.topk.json").read_text())
    wl.update(config="version-p001-tiny", kinds={"list": 1, "topk": 1, "count": 1},
              limits={"list_rows_wrong": 0, "topk_rows_wrong": 0, "count_rows_wrong": 0})
    (tmp_path / "port_bench/workloads/version.mixed.json").write_text(json.dumps(wl))
    (tmp_path / "port_bench/metrics/answers_per_batch.py").write_text(
        "def read(run):\n"
        "    b = run.metrics_after.batches - run.metrics_before.batches\n"
        "    return (run.metrics_after.answered - run.metrics_before.answered) / b\n")
    bench_json["configs"].append({"name": "version-p001-tiny", "source": "test",
                                  "file": "port_bench/configs/version-p001-tiny.json",
                                  "reduced": [], "why": "test"})
    bench_json["workloads"].append({"name": "version.mixed", "config": "version-p001-tiny",
                                    "traffic": "mixed", "chips": 1, "why": "test"})
    bench_json["per_layer"].append({"name": "answers_per_batch", "unit": "count",
                                    "better": "higher", "source": "program_counter",
                                    "layer": "runtime", "moves": "queries_per_s",
                                    "workloads": ["version.mixed"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench_json))
    result, numbers = _run("version.mixed", trace=True, root=tmp_path)
    assert result["correct"] and set(numbers) == {"list_rows_wrong", "topk_rows_wrong",
                                                  "count_rows_wrong", "unanswered"}
    assert result["metrics"]["answers_per_batch"]["value"] > 0


def test_command_refuses_a_machine_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "dna256k.list",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
