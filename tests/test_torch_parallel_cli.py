"""The port's parallel training from its CLI against the JAX package's
single-device CLI (tests/test_cli_parallel.py's runs): ``train-lm --sp 2
--dp 2`` and ``--pp 2``, 3 steps of the tiny preset at batch 4, seq 256,
``train-hybrid --sp 4`` at seq 1024, batch 2, losses within JAX's rtol
2e-4; the ``--pp 2`` run's gathered checkpoint resumed under ``--dp 2``
and by a single process, which then agree; and
the 2-rank runs driven through torchrun's environment (``RANK``,
``WORLD_SIZE``, ... read by ``distributed_init``), with the same losses on
both ranks, only the primary writing metrics, and JAX's meaning of
``is_primary`` and ``global_batch_slice`` (tests/test_multihost.py).

Both frameworks draw their initial weights differently, so every port run
starts from a step-0 checkpoint holding the JAX CLI's initial weights
(through the weight bridge) and fresh moments, which ``--resume`` reads at
any layout; the data streams are the same by construction.  The ranks run
in spawned processes (tests/torch_parallel_worker.py) while JAX runs its
two references in processes of their own."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import fft_tpu.models.hybrid as jhy
import fft_tpu.models.lm as jlm
from fft_tpu_torch import cli
from fft_tpu_torch.convert import from_jax_params, hybrid_from_jax_params
from fft_tpu_torch.models import hybrid as thy
from fft_tpu_torch.models import lm as tlm
from fft_tpu_torch.train import TrainConfig, train_init
from fft_tpu_torch.train.checkpoint import save_checkpoint
from tests import torch_parallel_worker as worker
from tests.golden_utils import rel_err
from tests.test_torch_convert import jax_lm_config
from tests.test_torch_dist_fft import jit_run

REPO = pathlib.Path(__file__).resolve().parent.parent
RTOL = 2e-4
LM = ["--steps", "3", "--batch", "4", "--seq", "256", "--log-every", "1"]
HYBRID = ["--steps", "3", "--batch", "2", "--seq", "1024", "--log-every",
          "1"]


def _losses(path):
    return [json.loads(line)["loss"]
            for line in pathlib.Path(path).read_text().splitlines()]


def _jit_init(init, cfg):
    """The JAX CLI's initial weights (``init(jax.random.key(0), cfg)``),
    drawn under ``jax.jit``: a third of the eager draw's time here, and
    equal to it to 2e-7 (XLA fuses the scaling)."""
    return jax.tree.map(np.asarray, jit_run(lambda k: init(k, cfg),
                                            jax.random.key(0)))


def _step0(root: pathlib.Path, model, seed: int = 0) -> str:
    """A checkpoint at step 0: ``model``'s weights, the optimizer as the
    CLI's train_init leaves it."""
    save_checkpoint(root, train_init(model, TrainConfig(), seed=seed + 1,
                                     deterministic=True), 0)
    return str(root)


def _jax_cli(argv) -> subprocess.Popen:
    """The JAX package's CLI in a process of its own (both references run
    side by side, and beside the port's ranks), XLA's CPU backend at
    optimisation level 0 (half the compile time; the losses the same at
    rtol 2e-4)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_backend_optimization_level=0")
    return subprocess.Popen(
        [sys.executable, "-c", "import sys; from fft_tpu.cli import main; "
         "main(sys.argv[1:])", *argv], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _port_argv(cmd, base, flags, ckpt, metrics, extra=()):
    return [cmd, "--device", "cpu", *base, *flags, "--ckpt", ckpt,
            "--resume", "--metrics", metrics, *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's runs (4 ranks over a file store, 2 under torchrun's
    environment, spawned first) and JAX's single-device references."""
    tmp = tmp_path_factory.mktemp("cli")
    refs = [_jax_cli(["train-lm", *LM, "--metrics",
                      str(tmp / "jax_lm.jsonl")]),
            _jax_cli(["train-hybrid", *HYBRID, "--metrics",
                      str(tmp / "jax_hybrid.jsonl")])]
    lm_cfg = tlm.tiny_lm_config(seq=256)
    lm = tlm.SpectreLM(lm_cfg)
    lm.load_state_dict(from_jax_params(_jit_init(
        jlm.lm_init, jax_lm_config(lm_cfg)), lm_cfg))
    hy_cfg = thy.hybrid_tiny_config(seq=1024)
    hy = thy.HybridLM(hy_cfg)
    hy.load_state_dict(hybrid_from_jax_params(_jit_init(
        jhy.hybrid_init, jhy.hybrid_tiny_config(seq=1024)), hy_cfg))
    lm0, hy0 = _step0(tmp / "lm0", lm), _step0(tmp / "hy0", hy)
    # each run resumes from its own directory, hard links to one copy
    for src, tag in ((lm0, "sp_dp"), (lm0, "pp"), (hy0, "hybrid")):
        shutil.copytree(src, tmp / tag, copy_function=os.link)
    m = {tag: str(tmp / f"{tag}.jsonl")
         for tag in ("sp_dp", "pp", "dp", "hybrid", "single")}
    four = worker.start(4, {"cli": {"runs": [
        ("sp_dp", _port_argv("train-lm", LM, ["--sp", "2", "--dp", "2"],
                             str(tmp / "sp_dp"), m["sp_dp"])),
        ("hybrid", _port_argv("train-hybrid", HYBRID, ["--sp", "4"],
                              str(tmp / "hybrid"), m["hybrid"]))]}},
        tmp / "four")
    two = worker.start(2, {"cli": {"runs": [
        ("pp", _port_argv("train-lm", LM, ["--pp", "2"], str(tmp / "pp"),
                          m["pp"])),
        ("dp", _port_argv("train-lm", ["--steps", "4", *LM[2:]],
                          ["--dp", "2"], str(tmp / "pp"), m["dp"]))]}},
        tmp / "two", torchrun=True)
    two = [r["cli"] for r in two.results()]
    # the --pp run's step-3 checkpoint, resumed by one process here
    shutil.copytree(tmp / "pp", tmp / "single", copy_function=os.link,
                    ignore=lambda d, names: ["4"] if d == str(tmp / "pp")
                    else [])
    cli.main(_port_argv("train-lm", ["--steps", "4", *LM[2:]], [],
                        str(tmp / "single"), m["single"]))
    for ref in refs:
        out, _ = ref.communicate(timeout=600)
        assert ref.returncode == 0, out[-3000:]
    return dict(tmp=tmp, metrics=m, lm_cfg=lm_cfg, two=two,
                four=[r["cli"] for r in four.results()],
                jax_lm=_losses(tmp / "jax_lm.jsonl"),
                jax_hybrid=_losses(tmp / "jax_hybrid.jsonl"))


def _port(runs, world, tag):
    """The losses of a run, checked the same on every rank and written
    (once) by the primary alone."""
    ranks = runs["four" if world == 4 else "two"]
    logged = [r["runs"][tag] for r in ranks]
    assert all(lg == logged[0] for lg in logged[1:]), logged
    assert _losses(runs["metrics"][tag]) == [r["loss"] for r in logged[0]]
    return [r["step"] for r in logged[0]], [r["loss"] for r in logged[0]]


@pytest.mark.parametrize("world,tag", [(4, "sp_dp"), (2, "pp")])
def test_cli_train_lm_matches_jax(runs, world, tag):
    steps, losses = _port(runs, world, tag)
    assert steps == [0, 1, 2]
    np.testing.assert_allclose(losses, runs["jax_lm"], rtol=RTOL)


def test_cli_train_hybrid_cp_matches_jax(runs):
    steps, losses = _port(runs, 4, "hybrid")
    assert steps == [0, 1, 2]
    np.testing.assert_allclose(losses, runs["jax_hybrid"], rtol=RTOL)


def test_sharded_checkpoint_resumes_at_another_layout(runs):
    """The ``--pp 2`` run writes its step-3 checkpoint gathered from its
    two stages: the single-device format, which a plain model loads
    strictly.  ``--dp 2 --resume`` and a single process's ``--resume``
    (both re-seed the stream at step 3, as the JAX CLI) take a fourth step
    from it: the same loss, and the same AdamW moments after it (each
    restored moment carried into the update) within the gradients'
    1e-4."""
    steps, losses = _port(runs, 2, "dp")
    single = _losses(runs["metrics"]["single"])
    assert steps == [3] and len(single) == 1
    np.testing.assert_allclose(losses, single, rtol=RTOL)
    tmp = runs["tmp"]
    sd = torch.load(tmp / "pp" / "3" / "model.pt", weights_only=True)
    tlm.SpectreLM(runs["lm_cfg"]).load_state_dict(sd, strict=True)
    a = torch.load(tmp / "pp" / "4" / "train.pt", weights_only=True)
    b = torch.load(tmp / "single" / "4" / "train.pt", weights_only=True)
    assert (a["count"], a["step"]) == (b["count"], b["step"]) == (4, 4)
    for moment in ("mu", "nu"):
        assert sorted(a[moment]) == sorted(b[moment])
        for k in a[moment]:
            assert rel_err(a[moment][k], b[moment][k]) < 1e-4, (moment, k)


def test_torchrun_environment_ranks(runs):
    """The 2 ranks under torchrun's environment: process index, primary,
    and each one's half of a global batch of 8."""
    got = [(r["rank"], r["primary"], r["batch_slice"]) for r in runs["two"]]
    assert got == [(0, True, slice(0, 4)), (1, False, slice(4, 8))]
