"""The port's LM slice against fft_tpu's on the CPU, through the weight
bridge: scoring logits, prefill logits and caches, teacher-forced decode.
A small LM (2 layers, d=256, 4 heads x 4 groups, n_fft 1024, chunk 128,
vocab 64) reaches every branch of the causal dispatch.  Tolerance 1e-4
relative for model outputs: two layers of fp32 FFT round trips summed in
different orders on each side."""

import functools
import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_tpu.models.lm as jlm
import fft_tpu.train as jtrain
from fft_tpu_torch import cli
from fft_tpu_torch.layers.causal_seg import BRANCH_CALLS
from fft_tpu_torch.convert import to_jax_params
from fft_tpu_torch.models import lm as tlm
from fft_tpu_torch.train import lm_loss
from tests.golden_utils import rel_err
from tests.test_torch_convert import (
    jax_lm_config, lm_pair, small_lm_config, untied_lm_config,
)

TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _pair():
    cfg = small_lm_config(memory_size=16)
    params, model = lm_pair(cfg, seed=7)
    return cfg, jax_lm_config(cfg), jax.tree.map(jnp.asarray, params), model


def _tokens(b, n, seed):
    return np.random.default_rng(seed).integers(0, 64, (b, n)).astype(
        np.int32)


@pytest.mark.parametrize("n,branch", [(1024, "kf_fused"), (256, "fused"),
                                      (200, "fft2n"), (64, "banded")])
def test_lm_apply_parity(n, branch):
    cfg, jcfg, params, model = _pair()
    toks = _tokens(2, n, n)
    ref = np.asarray(jax.jit(jlm.lm_apply, static_argnums=1)(
        params, jcfg, toks))
    BRANCH_CALLS.clear()
    got = tlm.lm_apply(model, torch.from_numpy(toks).long()).numpy()
    assert dict(BRANCH_CALLS) == {branch: cfg.num_layers}
    assert got.shape == (2, n, 64)
    assert rel_err(got, ref) < TOL


@pytest.mark.parametrize("n", [256, 64])
def test_lm_prefill_and_teacher_forced_decode_parity(n):
    """Prefill logits and every layer's cache, then 8 decode steps fed the
    same tokens on both sides (greedy tokens are not compared: argmax ties
    at random init flip on 1e-6 differences)."""
    cfg, jcfg, params, model = _pair()
    steps = 8
    toks = _tokens(2, n + steps, 100 + n)
    ref_logits, ref_caches = jax.jit(jlm.lm_prefill, static_argnums=1)(
        params, jcfg, toks[:, :n])
    logits, caches = tlm.lm_prefill(model, torch.from_numpy(toks[:, :n])
                                    .long())
    assert rel_err(logits.numpy(), np.asarray(ref_logits)) < TOL
    for i, c in enumerate(caches):
        assert c.t == int(ref_caches.t[i]) == n - 1
        pairs = ((c.prefix.real, ref_caches.prefix_re[i]),
                 (c.prefix.imag, ref_caches.prefix_im[i]),
                 (c.v_buf, ref_caches.v_buf[i]),
                 (c.q_buf, ref_caches.q_buf[i]),
                 (c.sum_q, ref_caches.sum_q[i]))
        for got, want in pairs:
            assert rel_err(got.numpy(), np.asarray(want)) < TOL

    step = jax.jit(jlm.lm_decode_step, static_argnums=1)
    for i in range(steps):
        pos = n + i
        ref_logits, ref_caches = step(params, jcfg, toks[:, pos], pos,
                                      ref_caches)
        logits, caches = tlm.lm_decode_step(
            model, torch.from_numpy(toks[:, pos]).long(), pos, caches)
        assert rel_err(logits.numpy(), np.asarray(ref_logits)) < TOL, i


def test_generate_runs_prefill_then_decode():
    cfg, _, _, model = _pair()
    prompt = torch.from_numpy(_tokens(3, 64, 1)).long()
    out = tlm.lm_generate(model, prompt, steps=5)
    assert out.shape == (3, 5) and out.dtype == torch.int64
    logits, _ = tlm.lm_prefill(model, prompt)
    assert torch.equal(out[:, 0], logits.argmax(-1))
    sampled = tlm.lm_generate(model, prompt, steps=5, temperature=1.0,
                              generator=torch.Generator().manual_seed(0))
    assert sampled.shape == (3, 5)
    with pytest.raises(ValueError):
        tlm.lm_generate(model, prompt, steps=cfg.max_seq)


def test_cli_generate_and_not_ported_flags():
    """generate runs, and --bf16 (ported: the blocks in bf16) runs too on
    the CPU, where the kernels' plain versions take it."""
    for extra in ([], ["--bf16"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(["generate", "--device", "cpu", "--seq", "256",
                             "--steps", "3", *extra]) == 0
        assert buf.getvalue().startswith("the ")


def test_cli_generate_350m_preset():
    """--preset 350m builds the full-width 24-layer model (at a short
    --seq here) and, as the JAX CLI without --vocab, feeds the prompt's
    bytes into its 50432-entry vocab."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["generate", "--device", "cpu", "--preset", "350m",
                         "--seq", "128", "--steps", "2"]) == 0
    assert buf.getvalue().startswith("the ")


@functools.lru_cache(maxsize=None)
def _untied_pair():
    cfg = untied_lm_config()
    params, model = lm_pair(cfg, seed=9)
    return cfg, jax_lm_config(cfg), jax.tree.map(jnp.asarray, params), model


def test_untied_head_logits_loss_and_gradients_match_jax():
    """tie_embeddings=False: logits, the chunked loss and every gradient
    (lm_head's and tok_emb's apart) within 1e-4 of JAX's."""
    cfg, jcfg, params, model = _untied_pair()
    toks = _tokens(2, cfg.max_seq + 1, 3)
    ref = np.asarray(jax.jit(jlm.lm_apply, static_argnums=1)(
        params, jcfg, toks[:, :-1]))
    got = tlm.lm_apply(model, torch.from_numpy(toks[:, :-1]).long()).numpy()
    assert rel_err(got, ref) < TOL
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, t: jtrain.lm_loss(p, jcfg, t, deterministic=True)))(
            params, toks)
    model.zero_grad(set_to_none=True)
    loss = lm_loss(model, torch.from_numpy(toks).long())
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) < TOL * abs(float(jloss))
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    grads.update((k, torch.zeros_like(b)) for k, b in model.named_buffers())
    got = jax.tree_util.tree_leaves_with_path(to_jax_params(grads, cfg))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jgrads))
    assert len(got) == len(want)
    for (path, a), b in zip(got, want):
        assert rel_err(a, b) < TOL, jax.tree_util.keystr(path)
    assert float(model.lm_head.grad.abs().max()) > 0
    model.zero_grad(set_to_none=True)


def test_untied_head_prefill_and_teacher_forced_decode_match_jax():
    """Prefill logits of 128 tokens, then 4 decode steps fed the same
    tokens on both sides, through the untied head: within 1e-4."""
    cfg, jcfg, params, model = _untied_pair()
    n, steps = 128, 4
    toks = _tokens(2, n + steps, 5)
    ref_logits, ref_caches = jax.jit(jlm.lm_prefill, static_argnums=1)(
        params, jcfg, toks[:, :n])
    logits, caches = tlm.lm_prefill(model,
                                    torch.from_numpy(toks[:, :n]).long())
    assert rel_err(logits.numpy(), np.asarray(ref_logits)) < TOL
    step = jax.jit(jlm.lm_decode_step, static_argnums=1)
    for i in range(steps):
        pos = n + i
        ref_logits, ref_caches = step(params, jcfg, toks[:, pos], pos,
                                      ref_caches)
        logits, caches = tlm.lm_decode_step(
            model, torch.from_numpy(toks[:, pos]).long(), pos, caches)
        assert rel_err(logits.numpy(), np.asarray(ref_logits)) < TOL, i
