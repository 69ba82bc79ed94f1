"""The harness is driven by data: a configuration, a traffic mix, a
per-layer metric and a cell added as new files and entries (in a
temporary copy) run without an edit to any file that is there; and the
command refuses to run without a card or without the program."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from cardbench import harness
from cardbench.tests.conftest import REPO, TINY_CELLS

READER = '''"""tiny_steps.train: steps the window completed, a test's reader."""


def read(ctx):
    if ctx["traffic"]["kind"] != "train":
        return None
    return float(ctx["window"]["steps"])
'''


def _digest(root) -> str:
    h = hashlib.sha256()
    for p in sorted((root / "cardbench").rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(root)).encode())
            h.update(p.read_bytes())
    h.update((root / "BENCHMARK.json").read_bytes())
    return h.hexdigest()


@pytest.fixture
def bench_with_metric(tiny_bench):
    (tiny_bench / "cardbench/layer_metrics/tiny_steps.train.py").write_text(
        READER)
    spec = json.loads((tiny_bench / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": "tiny_steps.train", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "train: train/loop.py",
        "moves": "train_tokens_per_s", "workloads": ["tiny-lm-train"]})
    (tiny_bench / "BENCHMARK.json").write_text(json.dumps(spec))
    return tiny_bench


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_new_cell_runs_from_data(bench_with_metric, cell, traced):
    before = _digest(REPO)
    bench = harness.Bench(bench_with_metric)
    res = harness.run(bench_with_metric, cell, 2 ** 31 + 77, 0.5, traced,
                      "cpu", time.perf_counter())
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    group = "per_layer" if traced else "end_to_end"
    listed = {m["name"] for m in bench.metrics(group, cell)}
    assert set(res["metrics"]) <= listed
    if traced:
        assert "breakdown" in res
        assert {"busy_s", "window_s"} <= set(res["device"])
        if cell == "tiny-lm-train":
            assert res["metrics"]["tiny_steps.train"]["value"] >= 1
    else:
        assert set(res["metrics"]) == listed
        assert res["metrics"]["setup_s"]["value"] > 0
    assert list(res["compared"]) == list(bench.limits(cell))
    assert _digest(REPO) == before


def test_same_seed_same_inputs(tiny_bench):
    """Weights and traffic are functions of the seed."""
    from cardbench import traffic, weights

    cfg = json.loads((tiny_bench / "cardbench/configs/tiny-lm.json")
                     .read_text())
    a, b = weights.draw(cfg, 2 ** 33, "cpu"), weights.draw(cfg, 2 ** 33, "cpu")
    assert all(bool((a[k] == b[k]).all()) for k in a)
    c = weights.draw(cfg, 2 ** 33 + 1, "cpu")
    assert not bool((a["tok_emb"] == c["tok_emb"]).all())
    tr = json.loads((tiny_bench / "cardbench/traffic/tiny-prefill.json")
                    .read_text())
    p, q = (traffic.Prompts(tr, cfg, 12345, "cpu") for _ in range(2))
    assert p.lengths == q.lengths and p.sample == q.sample
    assert bool((p.prompt(5) == q.prompt(5)).all())
    # every block of requests holds each length once
    sizes = p.sizes
    assert sorted(p.lengths[:len(sizes)]) == sizes
    assert p.lengths.index(max(sizes)) in p.sample


def _cli(cwd, env_extra=None):
    env = dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="",
               **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "-m", "cardbench.run", "--workload",
         "spectre350m-train-32k-b4", "--seed", "1", "--seconds", "1"],
        cwd=cwd, capture_output=True, text=True, env=env, timeout=300)


def test_no_card_no_result():
    out = _cli(REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "cardbench", tmp_path / "cardbench")
    out = _cli(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
