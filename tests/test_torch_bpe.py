"""The port's BPE corpora and data loaders against fft_tpu's on the CPU:
merges, token ids, the uint16 stream and its sidecar, the ``tokenize``
command, ``TokenDataset``, the native loader, and the batches ``train-lm``
feeds its step (training and held-out streams, the re-seed on resume).
Every comparison is exact: the port copies the JAX package's numpy and
C++ code."""

import contextlib
import io
import json

import numpy as np
import pytest

import fft_tpu.cli as jcli
import fft_tpu.train.bpe as jbpe
import fft_tpu.train.data as jdata
import fft_tpu.train.native_loader as jnative
from fft_tpu_torch import cli
from fft_tpu_torch.kernels.build import BUILD_DIR
from fft_tpu_torch.train import bpe, data as tdata
from fft_tpu_torch.train import native_loader

TEXT = (tdata.synthetic_corpus(20_000, seed=3)
        + " unicode: héllo wörld ☃ 12+3=15.\n")
UNICODE = ("Ω≈ç√∫˜µ≤ emoji 🙂 tabs\t\tand\nnewlines — ünïcödé wörds wörds "
           "wörds ☃☃ 北京 北京 北京\n") * 40
WEIRD = "Ω≈ç√∫˜µ≤ emoji 🙂 tabs\t\tand\nnewlines, never seen"


def _quiet(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# the tokenizer against fft_tpu.train.bpe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,vocab", [
    ("synthetic_200k", 50432), ("unicode", 1024), ("small_target", 300),
])
def test_merges_and_ids_equal_jax(name, vocab):
    text = {"synthetic_200k": lambda: tdata.synthetic_corpus(200_000),
            "unicode": lambda: UNICODE, "small_target": lambda: TEXT}[name]()
    ours = bpe.train_bpe(text, vocab)
    theirs = jbpe.train_bpe(text, vocab)
    assert ours.merges == theirs.merges and len(ours.merges) > 0
    assert ours.vocab_size == theirs.vocab_size == vocab
    for probe in (text[:5000], WEIRD, "the "):
        a, b = ours.encode(probe), theirs.encode(probe)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert ours.decode(a) == theirs.decode(b) == probe


def test_tokenize_file_is_byte_equal_to_jax(tmp_path):
    """Stream and sidecar of either package, byte for byte, and each
    package reads the other's."""
    ours = tmp_path / "ours.tokens"
    theirs = tmp_path / "theirs.tokens"
    bpe.tokenize_file(TEXT, str(ours), vocab_size=700)
    jbpe.tokenize_file(TEXT, str(theirs), vocab_size=700)
    assert ours.read_bytes() == theirs.read_bytes()
    assert bpe.vocab_sidecar(ours).read_bytes() == \
        jbpe.vocab_sidecar(theirs).read_bytes()
    assert bpe.Tokenizer.load(jbpe.vocab_sidecar(theirs)).merges == \
        jbpe.Tokenizer.load(bpe.vocab_sidecar(ours)).merges


def test_tokenize_command_prints_jax_json(tmp_path):
    text = tmp_path / "corpus.txt"
    text.write_text(tdata.synthetic_corpus(30_000, seed=7))
    outs = []
    for main, name in ((cli.main, "ours"), (jcli.main, "theirs")):
        out = tmp_path / f"{name}.tokens"
        printed = _quiet(main, ["tokenize", "--data", str(text), "--out",
                                str(out), "--vocab-size", "512"])
        rec = json.loads(printed.strip().splitlines()[-1])
        rec.pop("out")
        outs.append((rec, out.read_bytes()))
    assert outs[0] == outs[1]
    assert outs[0][0]["vocab_size"] == 512 and outs[0][0]["compression"] > 1.5


def test_tokenize_command_synthetic_default_equals_jax(tmp_path):
    recs = []
    for main, name in ((cli.main, "ours"), (jcli.main, "theirs")):
        out = tmp_path / f"{name}.tokens"
        printed = _quiet(main, ["tokenize", "--out", str(out), "--chars",
                                "20000", "--vocab-size", "600",
                                "--max-merges", "40"])
        rec = json.loads(printed.strip().splitlines()[-1])
        rec.pop("out")
        recs.append(rec)
    assert recs[0] == recs[1] and recs[0]["merges_learned"] == 40


# ---------------------------------------------------------------------------
# tests/test_bpe.py's cases on the port
# ---------------------------------------------------------------------------

def test_roundtrip_lossless():
    tok = bpe.train_bpe(TEXT, vocab_size=512)
    assert tok.decode(tok.encode(TEXT)) == TEXT
    # byte fallback: text never seen in training still roundtrips
    assert tok.decode(tok.encode(WEIRD)) == WEIRD


def test_merges_compress_and_stay_in_vocab():
    tok = bpe.train_bpe(TEXT, vocab_size=1024)
    ids = tok.encode(TEXT)
    assert len(ids) < 0.6 * len(TEXT.encode("utf-8"))
    assert len(tok.merges) > 50
    assert 0 <= ids.min() and ids.max() < tok.vocab_size


def test_training_deterministic():
    assert bpe.train_bpe(TEXT, 600).merges == bpe.train_bpe(TEXT, 600).merges


def test_small_corpus_saturates_below_target():
    tok = bpe.train_bpe("ab ab ab cd cd", vocab_size=50432)
    assert tok.vocab_size == 50432 and len(tok.merges) < 50


def test_save_load(tmp_path):
    tok = bpe.train_bpe(TEXT, vocab_size=512)
    tok.save(tmp_path / "vocab.json")
    tok2 = bpe.Tokenizer.load(tmp_path / "vocab.json")
    assert tok2.merges == tok.merges
    np.testing.assert_array_equal(tok2.encode(TEXT[:500]),
                                  tok.encode(TEXT[:500]))


@pytest.fixture(scope="module")
def token_corpus(tmp_path_factory):
    out = tmp_path_factory.mktemp("bpe") / "corpus.tokens"
    tok = bpe.tokenize_file(TEXT, str(out), vocab_size=512)
    return out, tok


@pytest.fixture(scope="module")
def text_corpus(tmp_path_factory):
    p = tmp_path_factory.mktemp("text") / "corpus.txt"
    p.write_text(tdata.synthetic_corpus(50_000, seed=11), encoding="utf-8")
    return p


def test_token_file_format(token_corpus):
    out, tok = token_corpus
    assert bpe.is_token_file(str(out)) and bpe.vocab_sidecar(out).exists()
    assert not bpe.is_token_file(None)
    assert tok.decode(np.fromfile(out, dtype="<u2")) == TEXT


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_token_dataset_equals_jax(token_corpus, seed):
    out, _ = token_corpus
    ours = tdata.TokenDataset(str(out))
    theirs = jdata.TokenDataset(str(out))
    assert ours.vocab_size == theirs.vocab_size == 512
    blob = out.read_bytes()
    a_it, b_it = ours.batches(4, 32, seed=seed), theirs.batches(4, 32,
                                                                 seed=seed)
    for _ in range(3):
        a, b = next(a_it), next(b_it)
        assert a.shape == (4, 33) and a.dtype == b.dtype == np.int32
        assert np.array_equal(a, b)
        for row in a:                       # every row is a real window
            assert row.astype("<u2").tobytes() in blob


def test_token_dataset_refuses_a_corpus_shorter_than_a_window(tmp_path):
    out = tmp_path / "short.tokens"
    bpe.tokenize_file("ab ab ab cd cd", str(out), vocab_size=300)
    with pytest.raises(AssertionError, match="shorter than one window"):
        next(tdata.TokenDataset(str(out)).batches(1, 64))


# ---------------------------------------------------------------------------
# the native loader against fft_tpu.train.native_loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("elem_size", [1, 2])
@pytest.mark.parametrize("seed", [0, 5])
def test_native_loader_equals_jax(token_corpus, text_corpus, elem_size,
                                  seed):
    path = str(token_corpus[0] if elem_size == 2 else text_corpus)
    ours = native_loader.NativeCharLoader(path, 4, 48, seed=seed,
                                          elem_size=elem_size)
    theirs = jnative.NativeCharLoader(path, 4, 48, seed=seed,
                                      elem_size=elem_size)
    try:
        for _ in range(3):
            a, b = next(ours), next(theirs)
            assert a.shape == (4, 49) and a.dtype == np.int32
            assert np.array_equal(a, b)
    finally:
        ours.close()
        theirs.close()


def test_native_loader_windows_are_real(token_corpus, text_corpus):
    out, _ = token_corpus
    loader = native_loader.NativeCharLoader(str(out), 4, 48, seed=9,
                                            elem_size=2)
    blob = out.read_bytes()
    for _ in range(3):
        for row in next(loader):
            window = row.astype("<u2").tobytes()
            i = blob.find(window)
            while i != -1 and i % 2:      # at a token-aligned offset
                i = blob.find(window, i + 1)
            assert i != -1
    loader.close()
    data = text_corpus.read_bytes()
    loader = native_loader.NativeCharLoader(str(text_corpus), 2, 64, seed=7)
    for row in next(loader):
        assert bytes(row.astype(np.uint8)) in data
    a = next(native_loader.NativeCharLoader(str(text_corpus), 2, 16, seed=6))
    b = next(native_loader.NativeCharLoader(str(text_corpus), 2, 16, seed=5))
    assert not np.array_equal(a, b)
    loader.close()


def test_native_loader_builds_its_own_library():
    """The port compiles its copy of the source into fft_tpu_torch/build/
    under a hashed name; it never loads the JAX package's csrc build."""
    path = native_loader.build()
    assert path.parent == BUILD_DIR and path.exists()
    assert path.name.startswith("libfftdata_") and path.name != \
        "libfftdata.so"
    assert native_loader.SOURCE.parent.parent == BUILD_DIR.parent
    assert path == native_loader.library_path()


def test_native_loader_refuses_bad_corpora(tmp_path):
    with pytest.raises(native_loader.NativeLoaderUnavailable):
        native_loader.NativeCharLoader(str(tmp_path / "missing"), 2, 16)
    short = tmp_path / "short.txt"
    short.write_bytes(b"abc")
    with pytest.raises(native_loader.NativeLoaderUnavailable):
        native_loader.NativeCharLoader(str(short), 2, 16)


# ---------------------------------------------------------------------------
# the CLI's data stream (repaired: the port sampled CharDataset windows
# where the JAX CLI samples through the native loader)
# ---------------------------------------------------------------------------

def _port_stream(monkeypatch, argv, n_eval):
    """The batches the port's train-lm feeds train_step, and the held-out
    batches it scores, with both stubbed (no model step runs)."""
    import fft_tpu_torch.train as ttrain

    fed, scored = [], []

    def fake_step(state, batch):
        fed.append(np.asarray(batch))
        state.step += 1
        return {"loss": 0.0, "grad_norm": 0.0, "step": state.step - 1}

    def fake_loss(model, tokens, **kw):
        scored.append(tokens.numpy().astype(np.int32))
        return 0.0 * tokens.sum()

    monkeypatch.setattr(ttrain, "train_step", fake_step)
    monkeypatch.setattr(ttrain, "lm_loss", fake_loss)
    printed = _quiet(cli.main, ["train-lm", "--device", "cpu", *argv])
    return fed, scored[:n_eval], printed


def _jax_stream(monkeypatch, argv, n_steps, n_eval):
    """The first batches of the JAX CLI's training and held-out streams, as
    its train loop would draw them (the loop itself is stubbed)."""
    got = {}

    def fake_loop(args, state, batch_sh, step_fn, batches, ckpt_writer,
                  eval_fn, eval_batches, *rest):
        got["train"] = [next(batches) for _ in range(n_steps)]
        got["eval"] = ([next(eval_batches) for _ in range(n_eval)]
                       if eval_batches is not None else [])

    monkeypatch.setattr(jcli, "_train_lm_loop", fake_loop)
    printed = _quiet(jcli.main, ["train-lm", *argv])
    return got["train"], got["eval"], printed


def _resume_at(monkeypatch, step):
    """Both CLIs resume at ``step`` from a stubbed checkpoint."""
    import fft_tpu.train.checkpoint as jck
    import fft_tpu_torch.train.checkpoint as tck
    import jax.numpy as jnp

    def port_restore(root, state, step_=None):
        state.step = step
        return state

    monkeypatch.setattr(tck, "latest_step", lambda root: step)
    monkeypatch.setattr(tck, "restore_checkpoint", port_restore)
    monkeypatch.setattr(jck, "latest_step", lambda root: step)
    monkeypatch.setattr(jck, "restore_checkpoint", lambda root, state:
                        state._replace(step=jnp.asarray(step, jnp.int32)))


@pytest.mark.parametrize("kind,start", [
    ("text", 0), ("tokens", 0), ("text", 2), ("tokens", 3), ("synthetic", 2),
])
def test_cli_stream_equals_jax(monkeypatch, tmp_path, token_corpus,
                               text_corpus, kind, start):
    """train-lm with the same argv feeds the port's step the batches the
    JAX CLI feeds its step: through the native loader (elem_size 1 for
    text, 2 for a .tokens stream) or, without --data, the synthetic
    corpus; the held-out stream at seed + 7919; on resume the stream
    re-seeded at seed + start.  Fails on the parent, whose CLI sampled
    text files through CharDataset."""
    steps = start + 3
    argv = ["--seq", "16", "--batch", "2", "--steps", str(steps),
            "--log-every", "1", "--eval-every", "1", "--seed", "4"]
    if kind == "text":
        argv += ["--data", str(text_corpus)]
    elif kind == "tokens":
        argv += ["--data", str(token_corpus[0]), "--vocab-size", "512"]
    if start:
        argv += ["--ckpt", str(tmp_path / "ck"), "--resume"]
        _resume_at(monkeypatch, start)
    fed, scored, printed = _port_stream(monkeypatch, argv, 3)
    jfed, jscored, jprinted = _jax_stream(monkeypatch, argv, 3, 3)
    assert len(fed) == len(jfed) == 3 and len(scored) == len(jscored) == 3
    for a, b in zip(fed + scored, jfed + jscored):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    assert not np.array_equal(fed[0], scored[0])
    lines = [ln for ln in printed.splitlines() if not ln.startswith("{")]
    jlines = [ln for ln in jprinted.splitlines() if not ln.startswith("{")]
    assert lines == jlines
    if kind == "text":
        assert lines[-2:] == ["using native C++ data loader"] * 2
    elif kind == "tokens":
        assert lines[-2:] == ["using native C++ data loader "
                              "(uint16 BPE tokens)"] * 2
    if start:
        assert lines[0] == f"resumed at step {start}"


@pytest.mark.parametrize("kind", ["text", "tokens"])
def test_cli_fallback_stream_equals_jax(monkeypatch, token_corpus,
                                        text_corpus, kind):
    """Where the native library will not build, both CLIs print the same
    fallback line and sample the same Python loader's windows."""
    def unavailable(*a, **kw):
        raise native_loader.NativeLoaderUnavailable("build failed: test")

    def j_unavailable(*a, **kw):
        raise jnative.NativeLoaderUnavailable("build failed: test")

    monkeypatch.setattr(native_loader, "NativeCharLoader", unavailable)
    monkeypatch.setattr(jnative, "NativeCharLoader", j_unavailable)
    argv = ["--seq", "16", "--batch", "2", "--steps", "3", "--log-every",
            "1", "--eval-every", "1", "--seed", "2"]
    argv += (["--data", str(text_corpus)] if kind == "text" else
             ["--data", str(token_corpus[0]), "--vocab-size", "512"])
    fed, scored, printed = _port_stream(monkeypatch, argv, 3)
    jfed, jscored, jprinted = _jax_stream(monkeypatch, argv, 3, 3)
    for a, b in zip(fed + scored, jfed + jscored):
        assert np.array_equal(a, b)
    want = ("native loader unavailable (build failed: test); using Python "
            "loader")
    assert [ln for ln in printed.splitlines() if not ln.startswith("{")] \
        == [want, want] == \
        [ln for ln in jprinted.splitlines() if not ln.startswith("{")]


def test_cli_tokenize_then_train(tmp_path):
    text_path = tmp_path / "corpus.txt"
    text_path.write_text(tdata.synthetic_corpus(30_000, seed=7))
    out = tmp_path / "corpus.tokens"
    _quiet(cli.main, ["tokenize", "--data", str(text_path), "--out",
                      str(out), "--vocab-size", "512"])
    metrics = tmp_path / "m.jsonl"
    printed = _quiet(cli.main, [
        "train-lm", "--device", "cpu", "--preset", "tiny", "--vocab-size",
        "512", "--data", str(out), "--steps", "2", "--batch", "2", "--seq",
        "64", "--log-every", "1", "--metrics", str(metrics)])
    assert "using native C++ data loader (uint16 BPE tokens)" in printed
    recs = [json.loads(ln) for ln in metrics.read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in recs)


def test_cli_train_rejects_oversized_vocab(token_corpus):
    out, _ = token_corpus
    # SystemExit (not assert): user-input validation must survive python -O
    with pytest.raises(SystemExit, match="exceeds model vocab"):
        cli.main(["train-lm", "--device", "cpu", "--preset", "tiny",
                  "--vocab-size", "300", "--data", str(out), "--steps", "1",
                  "--batch", "2", "--seq", "16"])
    with pytest.raises(SystemExit, match="exceeds model vocab"):
        cli.main(["generate", "--device", "cpu", "--seq", "16", "--vocab",
                  str(out), "--steps", "1"])


def test_default_bpe_corpus_is_cached_under_home(monkeypatch, tmp_path):
    """The 350M's default corpus: the JAX CLI's synthetic BPE stream and
    sidecar, byte for byte, built once under ~/.cache/fft_tpu_torch/
    (both corpora cut to 1/100 of their 2M characters here)."""
    monkeypatch.setenv("HOME", str(tmp_path))
    for mod in (tdata, jdata):
        real_corpus = mod.synthetic_corpus
        monkeypatch.setattr(mod, "synthetic_corpus",
                            lambda n, f=real_corpus: f(n // 100))
    calls = []
    real = bpe.tokenize_file

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(bpe, "tokenize_file", counted)
    printed = _quiet(cli._default_bpe_corpus, 50432)
    path = tmp_path / ".cache" / "fft_tpu_torch" / "synth_v50432.tokens"
    assert printed.startswith(f"building BPE corpus at {path}")
    assert cli._default_bpe_corpus(50432) == str(path) and len(calls) == 1
    ref = _quiet(jcli._default_bpe_corpus, 50432).split()[-2]
    assert ref == str(tmp_path / ".cache" / "fft_tpu" / "synth_v50432.tokens")
    assert path.read_bytes() == open(ref, "rb").read()
    assert bpe.vocab_sidecar(path).read_bytes() == \
        jbpe.vocab_sidecar(ref).read_bytes()
