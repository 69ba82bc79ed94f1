"""The bf16 fast mode (compute_dtype="bfloat16") of the port against
fft_tpu's on the CPU: the plain versions of kernels #7 and #11 with bf16
activations against the Pallas kernels' fast variants in interpret mode and
against the JAX package's HIGHEST-precision references, the dispatch rules
of the wrappers on bf16 (the _bf16 instances of #7 and #11; a named refusal
where a kernel has no bf16 variant yet), a bf16 block and a narrow
350M-shaped bf16 LM against JAX's, AdamW with a bf16 first moment against
optax's, and --bf16 on both CLI commands.

Tolerances are max|a-b| / max|b| (tests/golden_utils.py): 3e-2 against the
fast Pallas kernels (their own budget against the fp32 references,
tests/test_pallas_causal.py:270, :297: bf16 MXU passes and bf16 scratch),
1e-2 against the references on the same bf16-rounded inputs and for the
bf16 block and LM (BASELINE.md's bf16 budget: the two frameworks round to
bf16 at other places)."""

import contextlib
import dataclasses
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
import fft_tpu.layers.spectre as jsp
import fft_tpu.models.lm as jlm
import fft_tpu.train as jtrain
from fft_tpu_torch import cli
from fft_tpu_torch.config import SpectreConfig
from fft_tpu_torch.convert import to_jax_params
from fft_tpu_torch.kernels import causal as kc
from fft_tpu_torch.kernels import spectral_mix as sm
from fft_tpu_torch.layers.causal_seg import BRANCH_CALLS
from fft_tpu_torch.models import lm as tlm
from fft_tpu_torch.train import AdamW, TrainConfig, lm_loss
from tests.golden_utils import rel_err
from tests.test_torch_convert import jax_lm_config, lm_pair, small_lm_config
from tests.test_torch_layers import _jax_cfg, block_pair
from tests.test_torch_long_context import narrow_350m_config

FAST_TOL = 3e-2
BF16_TOL = 1e-2


def _bf16_inputs(seed, b, nc, chunk, d, cols):
    """v and ybar rounded to bf16, K planes fp32, as numpy (bf16 arrays as
    fp32 holding bf16 values) and as torch tensors."""
    rng = np.random.default_rng(seed)
    n, f2 = nc * chunk, chunk + 1
    v, ybar = (rng.standard_normal((b, n, d)).astype(np.float32)
               for _ in range(2))
    kr, ki = (rng.standard_normal((b, nc, f2, nc * cols)).astype(np.float32)
              for _ in range(2))
    tv, tyb = (torch.from_numpy(x).bfloat16() for x in (v, ybar))
    return (tv, torch.from_numpy(kr), torch.from_numpy(ki), tyb), \
        (jnp.asarray(tv.float().numpy(), jnp.bfloat16), jnp.asarray(kr),
         jnp.asarray(ki), jnp.asarray(tyb.float().numpy(), jnp.bfloat16))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# (nc, chunk, d, cols, #11's scr_bf16): nc 16 and 32, the 350M's chunk
# counts at seq 32768 and 65536, at a small chunk and width; the bf16
# scratch at nc 32, where JAX's plan picks it at the 350M's shape
# (_bwd_plan_v3(32, 2048, 1024, 64, 2, True) == (128, True))
LONG_BF16 = [(16, 128, 128, 8, False), (32, 128, 128, 8, True)]


@pytest.mark.parametrize("nc,chunk,d,cols,scr", LONG_BF16)
def test_fused_causal_mix_ref_bf16_matches_fast_pallas_v3(nc, chunk, d, cols,
                                                          scr):
    (tv, kr, ki, _), (jv, jkr, jki, _) = _bf16_inputs(nc, 1, nc, chunk, d,
                                                      cols)
    got = kc.fused_causal_mix_ref(tv, kr, ki, chunk, cols)
    assert got.dtype == torch.bfloat16
    fast = pc._fused_causal_call_v3(jv, jkr, jki, chunk=chunk, cols=cols,
                                    fast=True, interpret=True, dblk=128)
    assert fast.dtype == jnp.bfloat16
    assert rel_err(got.float().numpy(), _np(fast)) < FAST_TOL
    ref = pc._fused_causal_ref(jv, jkr, jki, chunk, cols)
    assert ref.dtype == jnp.bfloat16
    assert rel_err(got.float().numpy(), _np(ref)) < BF16_TOL


@pytest.mark.parametrize("nc,chunk,d,cols,scr", LONG_BF16)
def test_fused_causal_mix_bwd_ref_bf16_matches_fast_pallas_v3(nc, chunk, d,
                                                              cols, scr):
    """Each output on its own, in the primal dtypes (vbar bf16, Kbar fp32)
    on both sides."""
    (tv, kr, ki, tyb), (jv, jkr, jki, jyb) = _bf16_inputs(
        nc + 1, 1, nc, chunk, d, cols)
    got = kc.fused_causal_mix_bwd_ref(tv, kr, ki, tyb, chunk, cols)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32,
                                      torch.float32]
    fast = pc._fused_causal_bwd_call_v3(jv, jkr, jki, jyb, chunk=chunk,
                                        cols=cols, fast=True, interpret=True,
                                        dblk=128, scr_bf16=scr)
    ref = pc._fused_causal_bwd(jv, jkr, jki, jyb, chunk, cols,
                               jax.lax.Precision.HIGHEST)
    for want in (fast, ref):
        assert [x.dtype for x in want] == [jnp.bfloat16, jnp.float32,
                                           jnp.float32]
    for a, f, r in zip(got, fast, ref):
        a = a.float().numpy()
        assert rel_err(a, _np(f)) < FAST_TOL
        assert rel_err(a, _np(r)) < BF16_TOL


def test_bf16_autograd_keeps_the_primal_dtypes():
    """Through the Function on the CPU: y bf16, and the cotangents of v,
    kfr and kfi in their primal dtypes (bf16, fp32, fp32), equal to the
    plain adjoint's."""
    (tv, kr, ki, tyb), _ = _bf16_inputs(3, 1, 4, 16, 16, 4)
    xs = [t.clone().requires_grad_() for t in (tv, kr, ki)]
    y = kc.fused_causal_mix(*xs, 16, 4)
    assert y.dtype == torch.bfloat16
    y.backward(tyb)
    want = kc.fused_causal_mix_bwd_ref(tv, kr, ki, tyb, 16, 4)
    for x, w in zip(xs, want):
        assert x.grad.dtype == x.dtype == w.dtype
        assert torch.equal(x.grad, w)


def test_bf16_dispatch_takes_the_bf16_instances_or_names_the_roadmap(
        monkeypatch):
    """On the card bf16 activations reach the bf16 instances of #6 and #10
    (each its FFT and its direct kernel) and of #7 and #11; none raises or
    casts to fp32; fp32 keeps its kernels."""
    bf16, f32 = torch.bfloat16, torch.float32
    for base in ("fused_causal_mix", "fused_causal_mix_bwd"):
        for dt in (bf16, f32):
            # the 350M's long chunks and the tiny LM's chunk 128
            assert kc._mix_kernel(base, 65536, 2048, 1024, 64, dt) \
                == base + "_v3"
            assert kc._mix_kernel(base, 2048, 128, 512, 32, dt) == base
        with pytest.raises(TypeError):
            kc._mix_kernel(base, 32768, 2048, 1024, 64, torch.float16)
    # a 350M prompt of 600 tokens: chunk 600, 2C = 1200 = 16 * 75 takes no
    # FFT plan, so the direct kernels take it
    assert kc._split_odd(1200) is None
    assert kc._mix_kernel("fused_causal_mix", 600, 600, 1024, 64, bf16) \
        == "fused_causal_mix_direct"
    for dt in (bf16, f32):
        assert kc._mix_kernel("fused_causal_mix_bwd", 600, 600, 1024, 64,
                              dt) == "fused_causal_mix_bwd_direct"
    # the wrappers as they run on the card (on_cpu false), up to the launch,
    # which is recorded instead: the kernel each call reaches and its
    # bf16 flag
    launched = []

    def fake_launch(counts, name, device, *args, entry=None):
        launched.append((name, args[-1]))

    for mod in (kc, sm):
        monkeypatch.setattr(mod, "on_cpu", lambda *t: False)
        monkeypatch.setattr(mod, "launch", fake_launch)
    v = torch.zeros(1, 600, 1024, dtype=bf16)
    k = torch.zeros(1, 1, 601, 64)
    vbar, kbr, kbi = kc.fused_causal_mix_bwd_direct(v, k, k, v, 600, 64)
    assert (vbar.dtype, kbr.dtype, kbi.dtype) == (bf16, f32, f32)
    kc.fused_causal_mix_direct(v, k, k, 600, 64)
    assert launched == [("fused_causal_mix_bwd_direct_bf16", 1),
                        ("fused_causal_mix_direct_bf16", 1)]
    # each FFT and long-chunk launch runs (and counts) its bf16 instance for
    # bf16 v, its fp32 one for fp32 v: the tiny LM's nc 16, chunks of 2048
    for n, chunk, d, cols, name in ((2048, 128, 512, 32, "fused_causal_mix"),
                                    (4096, 2048, 64, 8,
                                     "fused_causal_mix_v3")):
        nc = n // chunk
        k = torch.zeros(1, nc, chunk + 1, nc * cols)
        for dt, flag, suffix in ((bf16, 1, "_bf16"), (f32, 0, "")):
            launched.clear()
            v = torch.zeros(1, n, d, dtype=dt, requires_grad=True)
            y = kc.fused_causal_mix(v, k, k, chunk, cols)
            y.backward(torch.zeros_like(y))
            bwd = name.replace("mix", "mix_bwd")
            assert launched == [(name + suffix, flag), (bwd + suffix, flag)]
    # spectral_mix takes bf16 on every kernel of mix_kernel, forward and
    # (up to n_fft 2048, #2) backward; y and vbar bf16, the gate's fp32
    for n, names in ((1024, ["direct_mix_bf16", "direct_mix_bwd_bf16"]),
                     (4096, ["staged_mix_bf16"]),
                     (16384, ["twopass_mix_bf16"])):
        monkeypatch.setattr(sm, "TWOPASS_ENABLE", n == 16384)
        launched.clear()
        fh = n // 2 + 1
        xs = [torch.zeros(1, n, 128, dtype=bf16, requires_grad=True),
              torch.zeros(1, fh, 8, requires_grad=True),
              torch.zeros(1, fh, 8, requires_grad=True)]
        y = sm.spectral_mix(*xs, torch.zeros(n, 128), n)
        assert y.dtype == bf16
        if n == 1024:
            y.backward(torch.zeros_like(y))
            assert [x.grad.dtype for x in xs] == [bf16, f32, f32]
        assert launched == [(name, 1) for name in names]


# ---------------------------------------------------------------------------
# a bf16 block and a narrow 350M-shaped bf16 LM against JAX
# ---------------------------------------------------------------------------

def test_block_bf16_matches_jax_bf16_block():
    """tests/test_bf16.py's block (d=64, 4 heads, n_fft 128, memory 8) in
    bf16 on both sides, with fft_impl="auto" (tests/test_bf16.py's
    "matmul" runs the same transforms in the port):
    the output in bf16, within the bf16 budget of JAX's; and close to the
    port's own fp32 block."""
    cfg32 = SpectreConfig(embed_dim=64, num_heads=4, n_fft=128,
                          pooling_type="mean", wavelet_on_rate=0.0,
                          memory_size=8, fft_impl="auto")
    cfg16 = dataclasses.replace(cfg32, compute_dtype="bfloat16")
    params, block32 = block_pair(cfg32, seed=0)
    _, block16 = block_pair(cfg16, seed=0)
    x = np.random.default_rng(1).standard_normal((2, 128, 64)).astype(
        np.float32)
    want = jax.jit(jsp.spectre_block_apply, static_argnums=1)(
        jax.tree.map(jnp.asarray, params), _jax_cfg(cfg16), jnp.asarray(x))
    assert want.dtype == jnp.bfloat16
    with torch.no_grad():
        got = block16(torch.from_numpy(x))
        got32 = block32(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in block16.parameters())
    assert rel_err(got.float().numpy(), _np(want)) < BF16_TOL
    assert rel_err(got.float().numpy(), got32.numpy()) < BF16_TOL


def narrow_350m_bf16() -> tlm.LMConfig:
    cfg = narrow_350m_config()
    return dataclasses.replace(cfg, block=dataclasses.replace(
        cfg.block, compute_dtype="bfloat16"))


@functools.lru_cache(maxsize=None)
def _narrow_bf16_case():
    """The narrow 350M (2 layers, d=128, seq 16384, chunk 2048: the kf_seg
    branch) in bf16: JAX's logits and loss (fft_impl="auto" on both
    sides), and JAX's fp32 logits of the same weights."""
    cfg = narrow_350m_bf16()
    jcfg = jax_lm_config(cfg)
    params, model = lm_pair(cfg, seed=7)
    batch = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, cfg.max_seq + 1)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, params)
    apply = jax.jit(jlm.lm_apply, static_argnums=1)
    logits = apply(jparams, jcfg, batch[:, :-1])
    assert logits.dtype == jnp.float32
    logits32 = apply(jparams, jax_lm_config(narrow_350m_config()),
                     batch[:, :-1])
    loss = jax.jit(lambda p, bt: jtrain.lm_loss(p, jcfg, bt,
                                                deterministic=True))(
        jparams, batch)
    return (cfg, model, batch, np.asarray(logits), np.asarray(logits32),
            float(loss))


def test_narrow_350m_bf16_logits_and_loss_match_jax():
    """Logits fp32 from bf16 blocks (tests/test_bf16.py:29), the kf_seg
    branch once a layer, the loss within the bf16 budget of JAX's bf16
    model.  The logits themselves move by ~1.3e-2 between fp32 and bf16 in
    either framework (the two roundings are independent), so they are held
    to no more than twice JAX's own bf16-to-fp32 distance."""
    cfg, model, batch, ref, ref32, jloss = _narrow_bf16_case()
    BRANCH_CALLS.clear()
    got = tlm.lm_apply(model, torch.from_numpy(batch[:, :-1]).long())
    assert dict(BRANCH_CALLS) == {"kf_seg": cfg.num_layers}
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert rel_err(got.numpy(), ref) < 2 * rel_err(ref, ref32)
    with torch.no_grad():
        loss = float(lm_loss(model, torch.from_numpy(batch).long()))
    assert abs(loss - jloss) / abs(jloss) < BF16_TOL


def test_narrow_350m_bf16_trains_and_serves():
    """The bf16 model's gradients (through the rematerialized blocks) land
    on the fp32 parameters, finite; prefill builds fp32 caches from the
    prompt's hidden states and decode runs in fp32, as JAX's; the prefill's
    logits are within the bf16 budget of the scoring logits."""
    cfg, model, batch, ref, _, _ = _narrow_bf16_case()
    tokens = torch.from_numpy(batch).long()
    model.train()
    try:
        for p in model.parameters():
            p.grad = None
        lm_loss(model, tokens).backward()
    finally:
        model.eval()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert grads and all(g.dtype == torch.float32 for g in grads)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    n = 8192
    logits, caches = tlm.lm_prefill(model, tokens[:, :n])
    assert logits.dtype == torch.float32
    assert rel_err(logits.numpy(), ref[:, n - 1]) < BF16_TOL
    assert caches[0].prefix.dtype == torch.complex64
    assert caches[0].v_buf.dtype == torch.float32
    step, _ = tlm.lm_decode_step(model, tokens[:, n], n, caches)
    assert step.dtype == torch.float32
    assert rel_err(step.numpy(), ref[:, n]) < BF16_TOL


# ---------------------------------------------------------------------------
# AdamW with a bf16 first moment, the CLI
# ---------------------------------------------------------------------------

def test_adamw_bf16_first_moment_matches_optax():
    """Three updates from the same numpy gradients through optax's
    adamw(mu_dtype="bfloat16") (the JAX package's make_optimizer) and the
    port's AdamW: mu stored in bf16, nu in fp32, each parameter's update
    within 1e-2 of optax's."""
    cfg = small_lm_config(memory_size=16)
    params, model = lm_pair(cfg, seed=8)
    kw = dict(learning_rate=1e-2, warmup_steps=1, total_steps=8,
              mu_dtype="bfloat16")
    opt = jtrain.make_optimizer(jtrain.TrainConfig(**kw), params)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = opt.init(jparams)
    update = jax.jit(opt.update)
    ours = AdamW(model.parameters(), TrainConfig(**kw))
    assert {m.dtype for m in ours.mu} == {torch.bfloat16}
    assert {v.dtype for v in ours.nu} == {torch.float32}
    start = jax.tree.map(np.copy, to_jax_params(model.state_dict(), cfg))
    rng = np.random.default_rng(9)
    names = [k for k, _ in model.named_parameters()]
    for scale in (0.5, 3.0, 1e-3):
        grads = {k: rng.standard_normal(p.shape).astype(np.float32) * scale
                 / np.sqrt(p.numel()) for k, p in model.named_parameters()}
        jg = to_jax_params({**{k: torch.from_numpy(g) for k, g in
                               grads.items()},
                            **{k: torch.zeros_like(b) for k, b in
                               model.named_buffers()}}, cfg)
        updates, opt_state = update(jax.tree.map(jnp.asarray, jg),
                                    opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        ours.step([torch.from_numpy(grads[k]) for k in names])
    mus = [x for x in jax.tree.leaves(opt_state)
           if hasattr(x, "dtype") and x.dtype == jnp.bfloat16]
    assert mus, "optax kept no bf16 first moment"
    for a, b, s in zip(jax.tree.leaves(to_jax_params(model.state_dict(),
                                                     cfg)),
                       jax.tree.leaves(jparams), jax.tree.leaves(start)):
        want = np.asarray(b) - s
        if np.abs(want).max() > 0:
            assert rel_err(a - s, want) < BF16_TOL


def test_cli_bf16_runs_both_commands_on_the_cpu():
    """--bf16 parses and runs on the CPU: train-lm's losses finite, and
    generate's text."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["train-lm", "--device", "cpu", "--bf16", "--seq",
                         "256", "--batch", "2", "--steps", "2",
                         "--log-every", "1"]) == 0
        assert cli.main(["generate", "--device", "cpu", "--bf16", "--seq",
                         "256", "--steps", "3"]) == 0
    out = buf.getvalue().splitlines()
    recs = [json.loads(line) for line in out if line.startswith("{")]
    assert len(recs) == 2 and all(np.isfinite(r["loss"]) for r in recs)
    assert out[-1].startswith("the ")
