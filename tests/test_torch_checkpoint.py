"""The port's checkpoints, resume, supervisor and the LM CLI around them,
on the CPU: the round trip of every tensor, the optimizer's count, the step
and the dropout generator, bit for bit; the prune; the async writer's order,
its errors and its snapshot; in-place restore; crash-safe writes;
``train-lm --ckpt/--resume``; the supervisor's restart from an injected
fault, whose losses after the restart equal, bit for bit, a run restored
in-process from the same checkpoint; ``generate --ckpt --vocab``; and two
train steps on BPE batches against JAX's through the weight bridge (1e-4
relative)."""

import contextlib
import dataclasses
import io
import json
import pathlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_tpu.kernels.pallas_causal as pc
import fft_tpu.train as jtrain
from fft_tpu_torch import cli
from fft_tpu_torch.config import SpectreConfig
from fft_tpu_torch.models.lm import (LMConfig, lm_generate, lm_init,
                                     tiny_lm_config)
from fft_tpu_torch.train import TrainConfig, train_init, train_step
from fft_tpu_torch.train import bpe, checkpoint as ck
from fft_tpu_torch.train.data import synthetic_corpus
from fft_tpu_torch.train.native_loader import NativeCharLoader
from fft_tpu_torch.train.supervisor import supervise
from tests.test_torch_convert import jax_lm_config, lm_pair

LOSS_TOL = 1e-4        # a model step against JAX's (tests/test_torch_train.py)


def _tiny(tie: bool = True):
    return LMConfig(
        vocab_size=32, num_layers=2, max_seq=16, tie_embeddings=tie,
        block=SpectreConfig(embed_dim=32, num_heads=4, n_fft=16,
                            pooling_type="mean", wavelet_on_rate=0.0,
                            causal=True, causal_chunk=4, memory_size=4))


def _state(seed=0, steps=2, tcfg=None, tie=True):
    """A small LM's train state after ``steps`` updates (non-zero moments,
    count and step; the generator advanced); ``tie=False``: with its own
    LM head."""
    model = lm_init(_tiny(tie), torch.Generator().manual_seed(seed), "cpu")
    state = train_init(model, tcfg or TrainConfig(warmup_steps=1),
                       seed=seed + 1)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        train_step(state, rng.integers(0, 32, (2, 17)))
    return state


def _tensors(state):
    """Every tensor a resume needs, by name, as independent copies."""
    out = {f"model.{k}": v.clone() for k, v in
           state.model.state_dict().items()}
    names = [n for n, _ in state.model.named_parameters()]
    for key in ("mu", "nu"):
        for n, t in zip(names, getattr(state.optimizer, key)):
            out[f"{key}.{n}"] = t.clone()
    out["generator"] = state.generator.get_state()
    out["count"] = torch.tensor(state.optimizer.count)
    out["step"] = torch.tensor(state.step)
    return out


def _assert_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _quiet(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue()


def _steps(root):
    return sorted(int(p.name) for p in pathlib.Path(root).iterdir()
                  if p.name.isdigit())


# ---------------------------------------------------------------------------
# checkpoint.py
# ---------------------------------------------------------------------------

def test_roundtrip_is_bit_exact(tmp_path):
    state = _state(seed=0, steps=2)
    want = _tensors(state)
    assert state.optimizer.count == 2 and state.step == 2
    path = ck.save_checkpoint(tmp_path / "ck", state, 7)
    assert path == str(tmp_path / "ck" / "7")
    assert ck.latest_step(tmp_path / "ck") == 7
    # plain dicts and tensors: loadable with weights_only
    files = sorted(p.name for p in (tmp_path / "ck" / "7").iterdir())
    assert files == [ck.MODEL_FILE, ck.TRAIN_FILE]
    train = torch.load(tmp_path / "ck" / "7" / ck.TRAIN_FILE,
                       weights_only=True)
    assert sorted(train) == ["count", "generator", "mu", "nu", "step"]
    assert train["generator"]["device"] == "cpu"

    other = _state(seed=3, steps=0)
    params = list(other.model.parameters())
    assert ck.restore_checkpoint(tmp_path / "ck", other) is other
    _assert_equal(_tensors(other), want)
    # in place: the optimizer still holds the model's Parameters
    assert all(a is b for a, b in zip(other.optimizer.params, params))
    assert all(a is b for a, b in zip(params, other.model.parameters()))


def test_untied_head_roundtrip_is_bit_exact(tmp_path):
    """An untied LM's lm_head, its moments and the rest restore bit for
    bit into a fresh state of the same config."""
    state = _state(seed=3, steps=2, tie=False)
    want = _tensors(state)
    assert "model.lm_head" in want and "mu.lm_head" in want
    ck.save_checkpoint(tmp_path / "ck", state, 2)
    fresh = _state(seed=4, steps=0, tie=False)
    ck.restore_checkpoint(tmp_path / "ck", fresh)
    _assert_equal(_tensors(fresh), want)


def test_restored_state_steps_as_the_original(tmp_path):
    """A resumed step moves the model (the optimizer steps the model's own
    Parameters), and two states, one restored, step identically."""
    state = _state(seed=0, steps=2)
    ck.save_checkpoint(tmp_path / "ck", state, 2)
    other = ck.restore_checkpoint(tmp_path / "ck", _state(seed=4, steps=0))
    before = {k: v.clone() for k, v in other.model.state_dict().items()}
    batch = np.random.default_rng(9).integers(0, 32, (2, 17))
    m1 = train_step(state, batch)
    m2 = train_step(other, batch)
    assert float(m1["loss"]) == float(m2["loss"])
    moved = [k for k, v in other.model.state_dict().items()
             if not torch.equal(v, before[k])]
    assert "tok_emb" in moved and len(moved) > 10
    _assert_equal(_tensors(other), _tensors(state))


@pytest.mark.parametrize("keep,kept", [(3, [3, 4, 5]), (2, [4, 5])])
def test_prune_keeps_the_newest(tmp_path, keep, kept):
    state = _state(steps=0)
    for s in (1, 2, 3, 4, 5):
        ck.save_checkpoint(tmp_path / "ck", state, s, keep=keep)
    assert _steps(tmp_path / "ck") == kept


def test_latest_step_ignores_temporary_and_missing(tmp_path):
    assert ck.latest_step(tmp_path / "none") is None
    root = tmp_path / "ck"
    (root / "5").mkdir(parents=True)
    (root / "tmp.9.123.456").mkdir()
    (root / "notes").mkdir()
    assert ck.latest_step(root) == 5
    with pytest.raises(FileNotFoundError):
        ck.restore_checkpoint(tmp_path / "none", _state(steps=0))


def test_a_crash_in_mid_write_leaves_no_step(tmp_path, monkeypatch):
    state = _state(steps=1)
    ck.save_checkpoint(tmp_path / "ck", state, 1)
    real = torch.save
    calls = []

    def dies_on_the_second_file(obj, f, *a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise OSError("disk full")
        return real(obj, f, *a, **kw)

    monkeypatch.setattr(torch, "save", dies_on_the_second_file)
    with pytest.raises(OSError, match="disk full"):
        ck.save_checkpoint(tmp_path / "ck", state, 2)
    assert ck.latest_step(tmp_path / "ck") == 1
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["1"]


def test_async_writer_order_and_roundtrip(tmp_path):
    state = _state(steps=1)
    want = _tensors(state)
    with ck.AsyncCheckpointWriter(tmp_path / "ck", keep=2) as w:
        for s in (1, 2, 3):
            w.save(state, s)
    assert ck.latest_step(tmp_path / "ck") == 3
    assert _steps(tmp_path / "ck") == [2, 3]
    _assert_equal(_tensors(ck.restore_checkpoint(
        tmp_path / "ck", _state(seed=2, steps=0))), want)


def test_async_writer_surfaces_write_errors(tmp_path, monkeypatch):
    state = _state(steps=0)

    def broken(*a, **kw):
        raise OSError("write failed")

    monkeypatch.setattr(torch, "save", broken)
    w = ck.AsyncCheckpointWriter(tmp_path / "ck")
    w.save(state, 1)                   # the failure is on the thread
    with pytest.raises(OSError, match="write failed"):
        w.wait()
    w.wait()                           # raised once
    w.save(state, 2)
    with pytest.raises(OSError, match="write failed"):
        w.save(state, 3)               # the next save raises it too
    target = tmp_path / "notadir"
    target.write_text("occupied")      # a file where the ckpt dir must go
    with pytest.raises(OSError):
        ck.AsyncCheckpointWriter(target).save(state, 1)


def test_async_snapshot_is_taken_before_the_next_step(tmp_path,
                                                      monkeypatch):
    """save, step, then wait: the checkpoint holds the state at save time
    (the snapshot is a copy; AdamW updates the parameters in place)."""
    state = _state(steps=1)
    want = _tensors(state)
    go = threading.Event()
    real = ck._write

    def held(*a, **kw):
        assert go.wait(timeout=60)
        return real(*a, **kw)

    monkeypatch.setattr(ck, "_write", held)
    w = ck.AsyncCheckpointWriter(tmp_path / "ck")
    w.save(state, 1)
    train_step(state, np.random.default_rng(5).integers(0, 32, (2, 17)))
    go.set()
    w.wait()
    assert not torch.equal(state.model.tok_emb, want["model.tok_emb"])
    _assert_equal(_tensors(ck.restore_checkpoint(
        tmp_path / "ck", _state(seed=2, steps=0))), want)


def test_restore_refuses_another_device_generator_and_width(tmp_path):
    state = _state(steps=1)
    ck.save_checkpoint(tmp_path / "ck", state, 1)
    path = tmp_path / "ck" / "1" / ck.TRAIN_FILE
    train = torch.load(path, weights_only=True)
    train["generator"]["device"] = "cuda"
    torch.save(train, path)
    with pytest.raises(ValueError, match="generator"):
        ck.restore_checkpoint(tmp_path / "ck", _state(steps=0))
    # the model alone (serving) needs no generator
    model = lm_init(_tiny(), torch.Generator().manual_seed(7), "cpu")
    ck.restore_model(tmp_path / "ck", model)
    assert torch.equal(model.tok_emb, state.model.tok_emb)
    wide = _wider(_tiny(), 64)
    with pytest.raises(RuntimeError, match="size mismatch"):
        ck.restore_model(tmp_path / "ck",
                         lm_init(wide, torch.Generator().manual_seed(0),
                                 "cpu"))


def _wider(cfg, d):
    return dataclasses.replace(cfg, block=dataclasses.replace(
        cfg.block, embed_dim=d))


# ---------------------------------------------------------------------------
# the CLI and the supervisor (tests/test_checkpoint_cli.py's cases)
# ---------------------------------------------------------------------------

ARGV = ["train-lm", "--device", "cpu", "--steps", "4", "--batch", "2",
        "--seq", "16", "--ckpt-every", "2", "--log-every", "1"]


@pytest.fixture(scope="module")
def text_corpus(tmp_path_factory):
    p = tmp_path_factory.mktemp("text") / "corpus.txt"
    p.write_text(synthetic_corpus(20_000, seed=5), encoding="utf-8")
    return p


def _records(path):
    return [json.loads(ln) for ln in pathlib.Path(path).read_text()
            .splitlines()]


def test_cli_train_ckpt_then_resume_runs_no_new_steps(tmp_path):
    ckdir, metrics = str(tmp_path / "ck"), str(tmp_path / "m.jsonl")
    argv = ARGV + ["--ckpt", ckdir, "--metrics", metrics]
    _quiet(cli.main, argv)
    assert ck.latest_step(ckdir) == 4 and _steps(ckdir) == [2, 4]
    assert [r["step"] for r in _records(metrics)] == [0, 1, 2, 3]
    stamp = (tmp_path / "ck" / "4" / ck.MODEL_FILE).stat().st_mtime_ns
    printed = _quiet(cli.main, argv + ["--resume"])
    assert printed.splitlines()[0] == "resumed at step 4"
    assert len(_records(metrics)) == 4          # 0 new steps
    assert _steps(ckdir) == [2, 4]
    assert (tmp_path / "ck" / "4" / ck.MODEL_FILE).stat().st_mtime_ns \
        == stamp


def test_cli_final_save_off_the_checkpoint_grid(tmp_path):
    ckdir = str(tmp_path / "ck")
    _quiet(cli.main, ARGV[:4] + ["5"] + ARGV[5:] + ["--ckpt", ckdir])
    assert _steps(ckdir) == [2, 4, 5]


def test_supervisor_recovers_bit_for_bit(tmp_path, monkeypatch,
                                         text_corpus):
    """Fault at step 3 of a fresh run, checkpoints every 2: the supervisor
    restarts with --resume from step 2 and finishes 4 steps; steps 2-3's
    losses equal those of the step-2 checkpoint restored in-process and
    stepped on the batches at seed + 2."""
    ckdir, metrics = str(tmp_path / "ck"), str(tmp_path / "m.jsonl")
    argv = ARGV + ["--ckpt", ckdir, "--metrics", metrics, "--data",
                   str(text_corpus), "--seed", "3"]
    monkeypatch.setenv("FFT_TPU_FAULT_STEP", "3")
    attempts, printed = [], []

    def runner(a):
        attempts.append(list(a))
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                cli.main(a)
            return 0
        except RuntimeError as e:
            assert str(e) == "injected fault at step 3"
            return 1
        finally:
            printed.append(buf.getvalue())

    assert supervise(argv, runner=runner, max_restarts=2) == 1
    assert "--resume" in attempts[1] and "--resume" not in attempts[0]
    assert ck.latest_step(ckdir) == 4 and _steps(ckdir) == [2, 4]
    assert printed[1].splitlines()[:2] == ["resumed at step 2",
                                           "using native C++ data loader"]
    recs = _records(metrics)
    assert [r["step"] for r in recs] == [0, 1, 2, 3]

    model = lm_init(tiny_lm_config(seq=16), torch.Generator().manual_seed(3),
                    "cpu")
    state = train_init(model, TrainConfig(learning_rate=3e-4,
                                          total_steps=4), seed=4)
    ck.restore_checkpoint(ckdir, state, step=2)
    assert state.step == 2 and state.optimizer.count == 2
    batches = NativeCharLoader(str(text_corpus), 2, 16, seed=3 + 2)
    for rec in recs[2:]:
        m = train_step(state, next(batches))
        assert float(m["loss"]) == rec["loss"]
        assert float(m["grad_norm"]) == rec["grad_norm"]
    batches.close()
    want = _tensors(state)
    _assert_equal(_tensors(ck.restore_checkpoint(
        ckdir, train_init(lm_init(tiny_lm_config(seq=16),
                                  torch.Generator().manual_seed(0), "cpu"),
                          TrainConfig(), seed=0))), want)


def test_fault_injection_only_on_fresh_runs(tmp_path, monkeypatch):
    monkeypatch.setenv("FFT_TPU_FAULT_STEP", "1")
    with pytest.raises(RuntimeError, match="injected fault at step 1"):
        _quiet(cli.main, ARGV + ["--ckpt", str(tmp_path / "ck")])
    assert ck.latest_step(tmp_path / "ck") is None


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    calls = []

    def runner(a):
        calls.append(list(a))
        return 9

    with pytest.raises(RuntimeError, match="giving up"):
        supervise(["train-lm", "--ckpt", str(tmp_path / "ck")],
                  runner=runner, max_restarts=2)
    assert len(calls) == 3 and calls[0] == ["train-lm", "--ckpt",
                                            str(tmp_path / "ck")]
    assert all(c[-1] == "--resume" and c.count("--resume") == 1
               for c in calls[1:])

    def raising(a):
        raise OSError("device lost")

    with pytest.raises(RuntimeError, match="giving up") as info:
        supervise(["train-lm", "--ckpt", "x"], runner=raising,
                  max_restarts=1)
    assert isinstance(info.value.__cause__, OSError)
    with pytest.raises(ValueError, match="--ckpt"):
        supervise(["train-lm"], runner=runner)


def test_generate_serves_the_checkpoint_through_the_tokenizer(tmp_path):
    """generate --ckpt --vocab prints the prompt and the tokenizer's decode
    of the tokens the restored model generates; another width raises."""
    tokens = tmp_path / "corpus.tokens"
    tok = bpe.tokenize_file(synthetic_corpus(20_000, seed=1), str(tokens),
                            vocab_size=512)
    ckdir = str(tmp_path / "ck")
    _quiet(cli.main, ARGV + ["--ckpt", ckdir, "--data", str(tokens),
                             "--vocab-size", "512"])
    prompt = "chip mesh "
    printed = _quiet(cli.main, [
        "generate", "--device", "cpu", "--seq", "16", "--vocab-size", "512",
        "--ckpt", ckdir, "--vocab", str(tokens), "--prompt", prompt,
        "--steps", "5"])

    cfg = tiny_lm_config(vocab_size=512, seq=16)
    state = train_init(lm_init(cfg, torch.Generator().manual_seed(1), "cpu"),
                       TrainConfig(), seed=1)
    ck.restore_checkpoint(ckdir, state)
    ids = torch.from_numpy(tok.encode(prompt).astype(np.int64))[None]
    assert 0 < ids.shape[1] < len(prompt)
    out = lm_generate(state.model.eval(), ids, steps=5)
    assert printed == prompt + tok.decode(out[0].tolist()) + "\n"
    # the JSON sidecar path works as --vocab too
    assert _quiet(cli.main, [
        "generate", "--device", "cpu", "--seq", "16", "--vocab-size", "512",
        "--ckpt", ckdir, "--vocab", str(bpe.vocab_sidecar(tokens)),
        "--prompt", prompt, "--steps", "5"]) == printed
    with pytest.raises(RuntimeError, match="size mismatch"):
        cli.main(["generate", "--device", "cpu", "--seq", "32",
                  "--vocab-size", "512", "--ckpt", ckdir, "--steps", "1"])


# ---------------------------------------------------------------------------
# two train steps on BPE batches against JAX's
# ---------------------------------------------------------------------------

def test_train_steps_on_bpe_batches_match_jax(tmp_path, monkeypatch):
    """The same numpy weights (converted with fft_tpu_torch.convert) and
    the same BPE batches from one .tokens stream (the native loader,
    elem_size 2): three train_steps, losses and gradient norms within 1e-4
    of JAX's train_step (the first update has lr 0, so the third step sees
    an update)."""
    monkeypatch.setattr(pc, "INTERPRET", True)
    tokens = tmp_path / "corpus.tokens"
    bpe.tokenize_file(synthetic_corpus(30_000, seed=2), str(tokens),
                      vocab_size=512)
    cfg = LMConfig(
        vocab_size=512, num_layers=2, max_seq=64,
        block=SpectreConfig(embed_dim=64, num_heads=4, n_fft=64,
                            pooling_type="mean", wavelet_on_rate=0.0,
                            causal=True, causal_chunk=16, memory_size=0))
    params, model = lm_pair(cfg, seed=6)
    tcfg = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    state = train_init(model, TrainConfig(**tcfg), seed=1)
    jstate, opt = jtrain.train_init(jax.random.key(1),
                                    jax.tree.map(jnp.asarray, params),
                                    jtrain.TrainConfig(**tcfg))
    jcfg = jax_lm_config(cfg)
    step = jax.jit(lambda s, b: jtrain.train_step(s, b, model_cfg=jcfg,
                                                  optimizer=opt))
    loader = NativeCharLoader(str(tokens), 2, 64, seed=0, elem_size=2)
    for _ in range(3):
        batch = next(loader)
        assert batch.max() >= 256             # merged ids reach the model
        ours = train_step(state, batch)
        jstate, theirs = step(jstate, batch)
        for k in ("loss", "grad_norm"):
            a, b = float(ours[k]), float(theirs[k])
            assert abs(a - b) <= LOSS_TOL * abs(b), (k, a, b)
    loader.close()
