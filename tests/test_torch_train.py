"""The port's training slice against fft_tpu's on the CPU: the backward of
the causal mix (the plain version of the fused_causal_mix_bwd kernel
against the Pallas kernel in interpret mode and against the jnp adjoint),
gradients through the three autograd Functions, a whole train step through
the weight bridge, the optimizer and its schedule against optax, the data
pipeline, dropout and the train-lm CLI.

Tolerances are max|a-b| / max|b| (tests/golden_utils.py): 1e-5 for one
fp32 kernel, 1e-4 for gradients (as tests/test_pallas_causal.py:103-120)
and for a model step, 1e-6 for the optimizer fed the same gradients."""

import contextlib
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import fft_tpu.kernels.pallas_causal as pc
import fft_tpu.train as jtrain
import fft_tpu.train.data as jdata
from fft_tpu_torch import cli
from fft_tpu_torch.config import SpectreConfig
from fft_tpu_torch.convert import from_jax_params, to_jax_params
from fft_tpu_torch.kernels import causal as kc
from fft_tpu_torch.layers.spectre import SpectreMultiHead
from fft_tpu_torch.models.lm import SpectreLM
from fft_tpu_torch.train import (
    AdamW, TrainConfig, lm_loss, make_schedule, train_init, train_step,
)
from fft_tpu_torch.train import data as tdata
from tests.golden_utils import rel_err
from tests.test_torch_convert import jax_lm_config, lm_pair, small_lm_config

KERNEL_TOL = 1e-5
GRAD_TOL = 1e-4
OPT_TOL = 1e-6


@pytest.fixture(autouse=True)
def _interpret():
    old = pc.INTERPRET
    pc.INTERPRET = True
    yield
    pc.INTERPRET = old


def _planes(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# ---------------------------------------------------------------------------
# kernel #10's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nc", [3, 8])
@pytest.mark.parametrize("cols", [4, 8])
def test_fused_causal_mix_bwd_ref_matches_jax(nc, cols):
    """Against the jnp adjoint and the Pallas backward kernel (interpret
    mode, the branch _fc_bwd takes at these shapes)."""
    rng = np.random.default_rng(10 * nc + cols)
    b, chunk, d = 1, 128, 128
    assert pc._bwd_plan(nc, chunk, d, cols, 4, False)
    arrs = _planes(rng, (b, nc * chunk, d), (b, nc, chunk + 1, nc * cols),
                   (b, nc, chunk + 1, nc * cols), (b, nc * chunk, d))
    got = kc.fused_causal_mix_bwd_ref(*map(torch.from_numpy, arrs), chunk,
                                      cols)
    jarrs = list(map(jnp.asarray, arrs))
    adjoint = pc._fused_causal_bwd(*jarrs, chunk, cols,
                                   jax.lax.Precision.HIGHEST)
    kernel = pc._fused_causal_bwd_call(*jarrs, chunk=chunk, cols=cols,
                                       fast=False, interpret=True)
    for a, r1, r2 in zip(got, adjoint, kernel):
        assert a.shape == r1.shape == r2.shape
        assert rel_err(a.numpy(), np.asarray(r1)) < KERNEL_TOL
        assert rel_err(a.numpy(), np.asarray(r2)) < KERNEL_TOL


# ---------------------------------------------------------------------------
# the three autograd Functions
# ---------------------------------------------------------------------------

def _fused_case(rng):
    b, nc, chunk, d, cols = 1, 3, 128, 128, 4
    ins = _planes(rng, (b, nc * chunk, d), (b, nc, chunk + 1, nc * cols),
                  (b, nc, chunk + 1, nc * cols))
    outs = _planes(rng, (b, nc * chunk, d))
    return (ins, outs,
            lambda *a: (kc.fused_causal_mix(*a, chunk, cols),),
            lambda *a: (pc.fused_causal_mix(*a, chunk, cols, False, True),))


def _kf_case(rng):
    n_fft, chunk, lanes = 256, 64, 128
    ins = _planes(rng, (2, n_fft // 2 + 1, lanes), (2, n_fft // 2 + 1,
                                                    lanes))
    outs = _planes(rng, (2, 4, chunk + 1, lanes), (2, 4, chunk + 1, lanes))
    return (ins, outs, lambda *a: kc.kf_spectra(*a, n_fft, chunk),
            lambda *a: pc.kf_spectra(*a, n_fft, chunk, False, True))


def _banded_case(rng):
    b, nc, chunk, d, cols = 2, 4, 16, 128, 8
    f2 = chunk + 1
    ins = _planes(rng, (b, nc, f2, d), (b, nc, f2, d),
                  (b, nc, nc, f2, cols), (b, nc, nc, f2, cols))
    outs = _planes(rng, (b, nc, chunk, d))
    return (ins, outs, lambda *a: (kc.banded_inverse(*a, chunk),),
            lambda *a: (pc.banded_inverse(*a, chunk, False, True),))


CASES = {"fused_causal_mix": _fused_case, "kf_spectra": _kf_case,
         "banded_inverse": _banded_case}


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_grads_match_jax(name):
    """d/d(inputs) of sum(out * w) through the torch Function against
    jax.grad through the JAX custom_vjp, for every input plane."""
    ins, ws, tfn, jfn = CASES[name](np.random.default_rng(len(name)))
    xs = [torch.from_numpy(a).requires_grad_() for a in ins]
    loss = sum((o * torch.from_numpy(w)).sum() for o, w in zip(tfn(*xs), ws))
    loss.backward()

    def jloss(*a):
        return sum(jnp.sum(o * w) for o, w in zip(jfn(*a), ws))

    want = jax.grad(jloss, argnums=tuple(range(len(ins))))(
        *map(jnp.asarray, ins))
    for x, w in zip(xs, want):
        assert rel_err(x.grad.numpy(), np.asarray(w)) < GRAD_TOL


@pytest.mark.parametrize("name,node", [
    ("fused_causal_mix", "_FusedCausalMixBackward"),
    ("kf_spectra", "_KfSpectraBackward"),
    ("banded_inverse", "_BandedInverseBackward"),
])
def test_outputs_carry_the_function_grad_fn(name, node):
    """The fault the Functions repair: a kernel's output written in place
    has no autograd history, so backward() dropped the gradient of every
    input.  Each public function's output now hangs off its Function."""
    ins, _, tfn, _ = CASES[name](np.random.default_rng(0))
    xs = [torch.from_numpy(a) for a in ins]
    xs[0].requires_grad_()
    for out in tfn(*xs):
        assert type(out.grad_fn).__name__ == node
    with torch.no_grad():
        assert all(o.grad_fn is None for o in tfn(*xs))


# ---------------------------------------------------------------------------
# a whole train step through the weight bridge
# ---------------------------------------------------------------------------

def _grad_tree(model, cfg):
    """The port's .grad of every parameter as a JAX-layout tree of numpy
    arrays (the frozen memory, a buffer, gets a zero gradient: JAX's is
    stop_gradient-ed to zero)."""
    sd = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
          for k, p in model.named_parameters()}
    for k, buf in model.named_buffers():
        sd[k] = torch.zeros_like(buf)
    return to_jax_params(sd, cfg)


@functools.lru_cache(maxsize=None)
def _jax_step(seed: int):
    """(cfg, numpy params, batch, JAX loss, grads, metrics, new params) of
    one JAX train_step on the small LM."""
    cfg = small_lm_config(memory_size=16)
    jcfg = jax_lm_config(cfg)
    params, _ = lm_pair(cfg, seed=seed)
    batch = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, cfg.max_seq + 1)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, params)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, bt: jtrain.lm_loss(p, jcfg, bt, deterministic=True)))(
            jparams, batch)
    state, opt = jtrain.train_init(jax.random.key(1), jparams,
                                   jtrain.TrainConfig())
    state, metrics = jax.jit(lambda s, bt: jtrain.train_step(
        s, bt, model_cfg=jcfg, optimizer=opt))(state, batch)
    return (cfg, params, batch, float(loss), jax.tree.map(np.asarray, grads),
            {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, state.params))


def test_train_step_matches_jax_through_the_bridge():
    """Loss, grad_norm and every parameter gradient of one train_step of a
    2-layer d=256 n_fft 1024 LM (the kf_fused branch in both layers),
    within 1e-4 of JAX's; the first update has lr 0, so the parameters
    come out as they went in, on both sides."""
    cfg, params, batch, jloss, jgrads, jmetrics, jnew = _jax_step(3)
    model = SpectreLM(cfg)
    model.load_state_dict(from_jax_params(params, cfg), strict=True)
    state = train_init(model, TrainConfig(), seed=1)
    metrics = train_step(state, batch)
    assert metrics["step"] == 0 and state.step == 1
    assert abs(float(metrics["loss"]) - jloss) < GRAD_TOL * abs(jloss)
    assert abs(float(metrics["loss"]) - jmetrics["loss"]) \
        < GRAD_TOL * abs(jloss)
    assert abs(float(metrics["grad_norm"]) - jmetrics["grad_norm"]) \
        < GRAD_TOL * jmetrics["grad_norm"]
    got = jax.tree_util.tree_leaves_with_path(_grad_tree(model, cfg))
    want = jax.tree.leaves(jgrads)
    assert len(got) == len(want)
    for (path, a), b in zip(got, want):
        assert a.shape == b.shape, path
        assert rel_err(a, b) < GRAD_TOL, jax.tree_util.keystr(path)
    # the mixer's inputs get gradients (the repaired fault cut them off)
    heads = model.blocks[0].mix.heads
    for p in (heads.w_v, heads.w_q, heads.gate_fc1_w, heads.modrelu_bias):
        assert float(p.grad.abs().max()) > 0
    for a, b in zip(jax.tree.leaves(to_jax_params(model.state_dict(), cfg)),
                    jax.tree.leaves(jnew)):
        assert rel_err(a, b) < OPT_TOL


# ---------------------------------------------------------------------------
# optimizer and schedule against optax
# ---------------------------------------------------------------------------

def test_optimizer_matches_optax_on_the_same_gradients():
    """5 updates from the same numpy gradients (norms above and below the
    clip, zero for the frozen memory) through the JAX package's optimizer
    and the port's; parameters within 1e-6."""
    cfg = small_lm_config(memory_size=16)
    params, model = lm_pair(cfg, seed=5)
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=8)
    opt = jtrain.make_optimizer(jtrain.TrainConfig(
        learning_rate=1e-2, warmup_steps=2, total_steps=8), params)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = opt.init(jparams)
    update = jax.jit(opt.update)
    ours = AdamW(model.parameters(), tcfg)
    rng = np.random.default_rng(6)
    names = [k for k, _ in model.named_parameters()]
    for step, scale in enumerate((1e-3, 3.0, 0.5, 1e-4, 10.0)):
        grads = {k: rng.standard_normal(p.shape).astype(np.float32) * scale
                 / np.sqrt(p.numel()) for k, p in model.named_parameters()}
        jg = to_jax_params({**{k: torch.from_numpy(g) for k, g in
                               grads.items()},
                            **{k: torch.zeros_like(b) for k, b in
                               model.named_buffers()}}, cfg)
        updates, opt_state = update(jax.tree.map(jnp.asarray, jg),
                                    opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        norm = ours.step([torch.from_numpy(grads[k]) for k in names])
        assert abs(float(norm) - float(optax.global_norm(jg))) \
            < OPT_TOL * float(norm), step
    for a, b in zip(jax.tree.leaves(to_jax_params(model.state_dict(), cfg)),
                    jax.tree.leaves(jparams)):
        assert rel_err(a, np.asarray(b)) < OPT_TOL
    assert np.array_equal(model.blocks[0].memory_fft.numpy(),
                          params["blocks"]["memory_fft"][0])


def test_schedule_matches_optax():
    """Warmup from 0, cosine down to min_lr_ratio, flat past total_steps."""
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=100,
                       total_steps=250)
    ref = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=3e-4, warmup_steps=100,
        decay_steps=250, end_value=3e-5)
    ours = make_schedule(tcfg)
    got = np.array([ours(i) for i in range(300)])
    want = np.array([float(ref(i)) for i in range(300)])
    assert got[0] == 0.0
    # optax evaluates in float32: near the start of the warmup its values
    # carry the rounding of 1 - count / warmup at the peak's scale
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=3e-4 * np.finfo(np.float32).eps)


def test_bf16_first_moment_is_queued():
    """mu_dtype="bfloat16" is ported (tests/test_torch_bf16.py holds it
    against optax): mu is stored in bf16, nu in fp32; another dtype
    raises."""
    opt = AdamW([torch.nn.Parameter(torch.zeros(2))],
                TrainConfig(mu_dtype="bfloat16"))
    assert opt.mu[0].dtype == torch.bfloat16
    assert opt.nu[0].dtype == torch.float32
    with pytest.raises(ValueError, match="mu_dtype"):
        AdamW([torch.nn.Parameter(torch.zeros(2))],
              TrainConfig(mu_dtype="float16"))


# ---------------------------------------------------------------------------
# data, dropout, CLI
# ---------------------------------------------------------------------------

def test_char_batches_equal_jax_for_the_same_seed():
    assert tdata.synthetic_corpus(20_000, seed=3) == \
        jdata.synthetic_corpus(20_000, seed=3)
    ours = tdata.CharDataset(n_chars=50_000).batches(4, 64, seed=11)
    theirs = jdata.CharDataset(n_chars=50_000).batches(4, 64, seed=11)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a.dtype == b.dtype == np.int32
        assert np.array_equal(a, b)


def test_dropout_in_train_mode_only():
    """The segmented branch's dropout (spectre.py:540-544): off in eval,
    drawn from the generator in train mode (same seed, same mask), and a
    missing generator raises."""
    cfg = SpectreConfig(embed_dim=64, num_heads=2, n_fft=256,
                        pooling_type="mean", wavelet_on_rate=0.0,
                        causal=True, causal_chunk=128, dropout_p=0.5)
    mix = SpectreMultiHead(cfg)
    mix.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn((1, 256, 64), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = mix.eval()(x)
        mix.train()
        a = mix(x, generator=torch.Generator().manual_seed(2))
        b = mix(x, generator=torch.Generator().manual_seed(2))
        c = mix(x, generator=torch.Generator().manual_seed(3))
        with pytest.raises(ValueError, match="Generator"):
            mix(x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, ref)


def test_cli_train_lm_runs_two_steps(tmp_path):
    out = tmp_path / "m.jsonl"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["train-lm", "--device", "cpu", "--seq", "256",
                         "--batch", "2",
                         "--steps", "2", "--log-every", "1",
                         "--eval-every", "1", "--metrics", str(out)]) == 0
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    assert len(lines) == 2
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    for r in recs:
        assert np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
        assert np.isfinite(r["eval_loss"])
    assert "tokens_per_sec" in recs[1]


@pytest.mark.parametrize("extra", [
    ["--bf16", "--dp", "2"], ["--dp", "2"], ["--sp", "2"], ["--tp", "2"],
    ["--pp", "2"],
])
def test_cli_train_lm_parallel_flags_need_a_process_group(extra):
    """In one process with no process group, a parallel flag names the
    group it needs and the torchrun line that launches it."""
    with pytest.raises(ValueError, match="process group of 2 processes.*"
                       "torchrun --nproc-per-node 2 -m fft_tpu_torch.cli"):
        cli.main(["train-lm", "--device", "cpu", "--seq", "256", "--steps",
                  "1", *extra])


def test_cli_train_lm_profile_writes_a_trace(tmp_path):
    """--profile DIR traces the run's third step (one after warm-up, as the
    JAX CLI's) into DIR: one Chrome trace holding the step's aten ops."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["train-lm", "--device", "cpu", "--seq", "256",
                         "--batch", "2", "--steps", "3", "--log-every", "1",
                         "--profile", str(tmp_path / "trace")]) == 0
    traces = list((tmp_path / "trace").iterdir())
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert len([ln for ln in buf.getvalue().splitlines()
                if ln.startswith("{")]) == 3


def test_lm_loss_eval_mode_has_no_graph():
    cfg = small_lm_config()
    _, model = lm_pair(cfg, seed=1)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, 64, (1, 257))).long()
    with torch.no_grad():
        loss = lm_loss(model, toks)
    assert loss.grad_fn is None and np.isfinite(float(loss))
