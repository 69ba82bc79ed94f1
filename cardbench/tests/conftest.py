"""Shared set-up of the benchmark's own tests.

They run on the CPU with ``python -m pytest cardbench/tests``, at tiny
sizes through the program's plain path; the tests marked ``cuda`` need the
card and skip without one (the fixture ``card`` decides, at run time).

``tiny_bench`` is a temporary copy of ``BENCHMARK.json`` and
``cardbench/`` with three more cells at tiny sizes: a SPECTRE LM and a
hybrid LM in training, the LM in prefill, with limits set from their
readings on the CPU (``TINY_LIMITS``).
"""

from __future__ import annotations

import json
import pathlib
import shutil

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]

TINY = {"vocab_size": 64, "embed_dim": 64, "num_heads": 4, "d_gate": 32,
        "n_fft": 256, "max_seq": 256, "causal_chunk": 64}
# the numbers the tiny cells compare, set between the program's largest
# reading over 8 seeds on the CPU (training: loss 1.6e-4, grad 0.018,
# change 0.008; prefill: logits 0.020, caches 0.015, token gap 0) and the
# control's least over 3 (loss 5.7e-4, grad 0.040, change 0.023; logits
# 0.12, caches 0.15); the faults read more than the control
TINY_LIMITS = {"train": {"loss_gap": 3.5e-4, "grad_gap": 0.03,
                         "change_gap": 0.014},
               "prefill": {"logits_rel": 0.05, "token_gap": 0.1,
                           "cache_rel": 0.05}}
TINY_CELLS = {"tiny-lm-train": ("tiny-lm", "tiny-train"),
              "tiny-hybrid-train": ("tiny-hybrid", "tiny-train"),
              "tiny-lm-prefill": ("tiny-lm", "tiny-prefill")}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips where "
        "torch.cuda.is_available() is false)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


def _dump(path: pathlib.Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


def make_tiny_bench(root: pathlib.Path) -> pathlib.Path:
    """Copy the benchmark into ``root`` and add the tiny cells as new files
    and entries; returns ``root``."""
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "cardbench", root / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cb = root / "cardbench"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    lm = json.loads((cb / "configs/spectre350m-32k-bf16.json").read_text())
    hy = json.loads((cb / "configs/hybrid1b-32k-bf16.json").read_text())
    configs = {"tiny-lm": dict(lm, name="tiny-lm", num_layers=2, **TINY),
               "tiny-hybrid": dict(hy, name="tiny-hybrid", layer_groups=2,
                                   attn_heads=4, attn_window=32, **TINY)}
    for name, cfg in configs.items():
        _dump(cb / f"configs/{name}.json", cfg)
        spec["configs"].append({"name": name, "source": "tiny",
                                "file": f"cardbench/configs/{name}.json",
                                "reduced": [], "why": "a CPU test"})
    train = json.loads((cb / "traffic/train-b4-32k.json").read_text())
    _dump(cb / "traffic/tiny-train.json", dict(train, batch=2, seq=256))
    pre = json.loads((cb / "traffic/prefill-8k-32k.json").read_text())
    _dump(cb / "traffic/tiny-prefill.json", dict(
        pre, lengths={"from": 128, "to": 256, "step": 64}, token_pool=4096,
        sample=2, sample_from_first=3, traced_requests=3))
    for name, (config, traffic) in TINY_CELLS.items():
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": traffic, "chips": 1,
                                  "why": "a CPU test"})
        kind = "prefill" if "prefill" in traffic else "train"
        _dump(cb / f"limits/{name}.json", {"limits": TINY_LIMITS[kind]})
        for group in ("end_to_end", "per_layer"):
            for m in spec[group]:
                cells = m.get("workloads")
                if cells and any(kind in c for c in cells):
                    cells.append(name)
    _dump(root / "BENCHMARK.json", spec)
    return root


@pytest.fixture
def tiny_bench(tmp_path):
    return make_tiny_bench(tmp_path)
