"""The bf16 fast mode of the tiny LM's causal mix and of the non-causal
block's mix on the CPU: the plain versions of kernels #6, #10, #1, #2, #3
and #4 with bf16 activations against fft_tpu's fast Pallas kernels
(``fast=True``) in interpret mode and against its HIGHEST-precision
references on the same bf16-rounded inputs; a narrow tiny LM in bf16
against JAX's bf16 LM (logits, loss, a train_step's gradients); a narrow
config-1 block in bf16 with ``fft_impl="pallas"`` at n_fft 1024 and 2304
against JAX's with ``pallas_fft.INTERPRET`` on (forward and gradients);
``--bf16`` on both CLI commands of the tiny preset.

Tolerances are max|a-b| / max|b| (tests/golden_utils.py): 3e-2 against the
fast Pallas kernels (their own budget against the fp32 references: bf16
MXU passes and bf16 scratch, tests/test_torch_bf16.py), 1e-2 against the
references on the same bf16-rounded inputs and for the bf16 LM and block
(BASELINE.md's bf16 budget: the two frameworks round to bf16 at other
places)."""

import contextlib
import dataclasses
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_tpu.kernels.pallas_causal as pc
import fft_tpu.kernels.pallas_fft as pf
import fft_tpu.layers.spectre as jsp
import fft_tpu.models.lm as jlm
import fft_tpu.train as jtrain
from fft_tpu_torch import cli
from fft_tpu_torch.convert import block_from_jax_params
from fft_tpu_torch.kernels import causal as kc
from fft_tpu_torch.kernels import spectral_mix as sm
from fft_tpu_torch.layers import spectre as tsp
from fft_tpu_torch.models import lm as tlm
from fft_tpu_torch.ops import fftops
from fft_tpu_torch.train import TrainConfig, train_init, train_step
from tests.golden_utils import rel_err
from tests.test_torch_convert import jax_lm_config, lm_pair
from tests.test_torch_layers import (
    _ZERO_GRADS, _cfg, _jax_block_apply, _jax_cfg, block_pair,
)
from tests.test_torch_train import _grad_tree

FAST_TOL = 3e-2
BF16_TOL = 1e-2


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16(x: np.ndarray):
    """x rounded to bf16, as a torch tensor and as a JAX array."""
    t = torch.from_numpy(x).bfloat16()
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


# ---------------------------------------------------------------------------
# #6 and #10 (the tiny LM's causal mix)
# ---------------------------------------------------------------------------

def _causal_inputs(seed, b, nc, chunk, d, cols):
    rng = np.random.default_rng(seed)
    n, f2 = nc * chunk, chunk + 1
    (tv, jv), (tyb, jyb) = (
        _bf16(rng.standard_normal((b, n, d)).astype(np.float32))
        for _ in range(2))
    kr, ki = (rng.standard_normal((b, nc, f2, nc * cols)).astype(np.float32)
              for _ in range(2))
    return (tv, torch.from_numpy(kr), torch.from_numpy(ki), tyb), \
        (jv, jnp.asarray(kr), jnp.asarray(ki), jyb)


# (nc, chunk, d, cols): the tiny LM's chunk 128 with 16-channel gate groups
# at nc 4, and nc 1 (a prompt of one chunk)
CAUSAL = [(4, 128, 128, 8), (1, 128, 128, 8)]


@pytest.mark.parametrize("nc,chunk,d,cols", CAUSAL)
def test_fused_causal_mix_ref_bf16_matches_fast_pallas(nc, chunk, d, cols):
    (tv, kr, ki, _), (jv, jkr, jki, _) = _causal_inputs(nc, 1, nc, chunk, d,
                                                        cols)
    got = kc.fused_causal_mix_ref(tv, kr, ki, chunk, cols)
    assert got.dtype == torch.bfloat16
    fast = pc._fused_causal_call(jv, jkr, jki, chunk=chunk, cols=cols,
                                 fast=True, interpret=True)
    assert fast.dtype == jnp.bfloat16
    assert rel_err(got.float().numpy(), _np(fast)) < FAST_TOL
    ref = pc._fused_causal_ref(jv, jkr, jki, chunk, cols)
    assert rel_err(got.float().numpy(), _np(ref)) < BF16_TOL


@pytest.mark.parametrize("nc,chunk,d,cols", CAUSAL)
def test_fused_causal_mix_bwd_ref_bf16_matches_fast_pallas(nc, chunk, d,
                                                           cols):
    """Each output on its own, in the primal dtypes (vbar bf16, Kbar fp32)
    on both sides."""
    (tv, kr, ki, tyb), (jv, jkr, jki, jyb) = _causal_inputs(
        nc + 10, 1, nc, chunk, d, cols)
    got = kc.fused_causal_mix_bwd_ref(tv, kr, ki, tyb, chunk, cols)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32,
                                      torch.float32]
    fast = pc._fused_causal_bwd_call(jv, jkr, jki, jyb, chunk=chunk,
                                     cols=cols, fast=True, interpret=True)
    ref = pc._fused_causal_bwd(jv, jkr, jki, jyb, chunk, cols,
                               jax.lax.Precision.HIGHEST)
    assert [x.dtype for x in fast] == [jnp.bfloat16, jnp.float32,
                                       jnp.float32]
    for a, f, r in zip(got, fast, ref):
        a = a.float().numpy()
        assert rel_err(a, _np(f)) < FAST_TOL
        assert rel_err(a, _np(r)) < BF16_TOL


# ---------------------------------------------------------------------------
# #1-#4 (the non-causal mix)
# ---------------------------------------------------------------------------

def _mix_inputs(n, b=1, d=128, hg=8, seed=0):
    """(torch: v bf16, g_r, g_i, mem_t, ybar bf16), (JAX: v bf16, gate
    complex, memory complex, ybar bf16)."""
    rng = np.random.default_rng(seed)
    f = n // 2 + 1

    def cplx(shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    (tv, jv), (tyb, jyb) = (
        _bf16(rng.standard_normal((b, n, d)).astype(np.float32))
        for _ in range(2))
    gate, mem = cplx((b, f, hg)), cplx((f, d))
    g = torch.from_numpy(gate)
    mem_t = fftops.irfft(torch.from_numpy(mem), n, dim=0)
    return ((tv, g.real.contiguous(), g.imag.contiguous(), mem_t, tyb),
            (jv, jnp.asarray(gate), jnp.asarray(mem), jyb))


def _highest_mix(jv, gate, mem, n):
    """JAX's HIGHEST-precision composition on the same bf16 values."""
    return pf._unfused_mix(jv.astype(jnp.float32), gate, mem, n)


@pytest.mark.parametrize("n", [256, 768])
def test_direct_mix_ref_bf16_matches_fast_pallas(n):
    """#1 at a power of two and at an odd factor (768 = 256 * 3), with
    memory: JAX's _direct_mix_call(fast=True) takes the time-domain
    memory as the port does."""
    (tv, gr, gi, mem_t, _), (jv, gate, mem, _) = _mix_inputs(n, seed=n)
    got = sm.direct_mix(tv, gr, gi, mem_t, n)
    assert got.dtype == torch.bfloat16
    fast = pf._direct_mix_call(jv, jnp.real(gate), jnp.imag(gate),
                               jnp.asarray(mem_t.numpy()), n_fft=n,
                               interpret=True, fast=True)
    assert fast.dtype == jnp.bfloat16
    assert rel_err(got.float().numpy(), _np(fast)) < FAST_TOL
    assert rel_err(got.float().numpy(),
                   _np(_highest_mix(jv, gate, mem, n))) < BF16_TOL


@pytest.mark.parametrize("n", [256, 768])
def test_direct_mix_bwd_ref_bf16_matches_fast_pallas(n):
    """#2 in the primal dtypes (vbar bf16, the gate cotangent fp32), each
    output on its own; JAX's gate cotangent is the conjugate of (dL/dRe +
    i dL/dIm) (pallas_fft.py:854), so its imaginary plane is negated."""
    (tv, gr, gi, _, tyb), (jv, gate, _, jyb) = _mix_inputs(n, seed=n + 1)
    got = sm.direct_mix_bwd(tv, gr, gi, tyb, n)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32,
                                      torch.float32]
    fast = pf._direct_mix_bwd_call(jv, jnp.real(gate), jnp.imag(gate), jyb,
                                   n_fft=n, interpret=True, fast=True)
    assert fast[0].dtype == jnp.bfloat16
    vbar, gbar, _ = pf._mix_bwd(n, False, (jv.astype(jnp.float32), gate,
                                           None), jyb.astype(jnp.float32))
    gbar = np.asarray(gbar)
    for a, f, r in zip(got, fast, (vbar, gbar.real, -gbar.imag)):
        a = a.float().numpy()
        assert rel_err(a, _np(f)) < FAST_TOL
        assert rel_err(a, _np(r)) < BF16_TOL


@pytest.mark.parametrize("n,name", [(2304, "staged_mix"),
                                    (16384, "twopass_mix")])
def test_long_mix_ref_bf16_matches_fast_pallas(n, name, monkeypatch):
    """#3 at n_fft 2304 (256 * 9) and #4 at 16384 (JAX's TWOPASS_ENABLE on
    for it, as the port's flag for its own), with memory, through
    fused_spectral_mix(fast=True), which calls _fused_mix_call and
    _twopass_mix_call with fast=True."""
    monkeypatch.setattr(pf, "TWOPASS_ENABLE", True)
    monkeypatch.setattr(sm, "TWOPASS_ENABLE", True)
    assert sm.mix_kernel(n) == name
    (tv, gr, gi, mem_t, _), (jv, gate, mem, _) = _mix_inputs(n, seed=n)
    got = getattr(sm, name)(tv, gr, gi, mem_t, n)
    assert got.dtype == torch.bfloat16
    fast = pf.fused_spectral_mix(jv, gate, mem, n_fft=n, interpret=True,
                                 fast=True)
    assert fast.dtype == jnp.bfloat16
    assert rel_err(got.float().numpy(), _np(fast)) < FAST_TOL
    assert rel_err(got.float().numpy(),
                   _np(_highest_mix(jv, gate, mem, n))) < BF16_TOL


def test_spectral_mix_bf16_backward_above_2048_keeps_the_dtypes():
    """Above n_fft 2048 the backward is autograd through the composition
    (cuFFT on the card, in fp32 from the bf16 values): vbar bf16, the gate
    and mem_t cotangents fp32, equal to the fp32 VJP of the same bf16
    values rounded once."""
    n = 2304
    (tv, gr, gi, mem_t, tyb), _ = _mix_inputs(n, seed=5)
    xs = [t.clone().requires_grad_() for t in (tv, gr, gi, mem_t)]
    y = sm.spectral_mix(*xs, n)
    assert y.dtype == torch.bfloat16
    y.backward(tyb)
    assert [x.grad.dtype for x in xs] == [torch.bfloat16] + [torch.float32] * 3
    want = sm._unfused_vjp(tv.float(), gr, gi, tyb.float(), n)
    assert torch.equal(xs[0].grad, want[0].bfloat16())
    for a, w in zip((xs[1].grad, xs[2].grad), want[1:]):
        assert torch.equal(a, w)
    assert torch.equal(xs[3].grad, tyb.float().sum(0))


# ---------------------------------------------------------------------------
# a narrow tiny LM and a narrow config-1 block in bf16 against JAX
# ---------------------------------------------------------------------------

def narrow_tiny_bf16(mode: str = "bfloat16") -> tlm.LMConfig:
    """The tiny preset's shape cut narrow: 2 layers, d=128, 4 heads, n_fft
    512, chunk 128 (nc 4: the kf_fused branch, #8, #6 and #10 on the
    card), vocab 64, in ``mode``."""
    return tlm.LMConfig(
        vocab_size=64, num_layers=2, max_seq=512,
        block=dataclasses.replace(
            tlm.tiny_lm_config().block, embed_dim=128, num_heads=4,
            n_fft=512, causal_chunk=128, compute_dtype=mode))


@functools.lru_cache(maxsize=None)
def _tiny_case():
    """JAX's logits, loss and parameter gradients of the narrow tiny LM in
    bf16 (pallas_causal's INTERPRET on: its fast kernels in interpret
    mode) and in fp32, the same weights and batch."""
    params, _ = lm_pair(narrow_tiny_bf16(), seed=11)
    batch = np.random.default_rng(11).integers(
        0, 64, (2, 513)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, params)
    out = {}
    old = pc.INTERPRET
    pc.INTERPRET = True
    try:
        for mode in ("bfloat16", "float32"):
            jcfg = jax_lm_config(narrow_tiny_bf16(mode))
            logits = jax.jit(jlm.lm_apply, static_argnums=1)(
                jparams, jcfg, batch[:, :-1])
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, bt, c=jcfg: jtrain.lm_loss(p, c, bt,
                                                     deterministic=True)))(
                    jparams, batch)
            out[mode] = (np.asarray(logits), float(loss),
                         jax.tree.leaves(jax.tree.map(np.asarray, grads)))
    finally:
        pc.INTERPRET = old
    return params, batch, out


def _tiny_errs(bwd=None):
    """The port's bf16 narrow tiny LM against JAX's: (logits' rel_err, the
    loss's, {tensor: (its gradient's rel_err, JAX's own bf16-to-fp32
    rel_err of it)}), a train_step's gradients; ``bwd`` replaces
    ``fused_causal_mix_bwd`` for the run (the check's control)."""
    params, batch, out = _tiny_case()
    cfg = narrow_tiny_bf16()
    _, model = lm_pair(cfg, seed=11)
    with torch.no_grad():
        logits = tlm.lm_apply(model, torch.from_numpy(batch[:, :-1]).long())
    assert logits.dtype == torch.float32
    kept = kc.fused_causal_mix_bwd
    kc.fused_causal_mix_bwd = bwd or kept
    try:
        metrics = train_step(train_init(model, TrainConfig(), seed=1), batch)
    finally:
        kc.fused_causal_mix_bwd = kept
    jlogits, jloss, jgrads = out["bfloat16"]
    got = jax.tree_util.tree_leaves_with_path(_grad_tree(model, cfg))
    assert len(got) == len(jgrads)
    grads = {jax.tree_util.keystr(path): (rel_err(a, b), rel_err(b, b32))
             for (path, a), b, b32 in zip(got, jgrads, out["float32"][2])
             if np.abs(b).max() > 0}
    return (rel_err(logits.numpy(), jlogits),
            abs(float(metrics["loss"]) - jloss) / abs(jloss), grads)


def _drop_last_lag(*args):
    """A #10 whose Kbar misses its farthest lag (the card's control)."""
    vbar, kbr, kbi = kc.fused_causal_mix_bwd_ref(*args)
    kbr, kbi = kbr.clone(), kbi.clone()
    kbr[:, -1] = 0
    kbi[:, -1] = 0
    return vbar, kbr, kbi


def test_narrow_tiny_bf16_logits_loss_and_grads_match_jax():
    """Logits fp32 from bf16 blocks and the loss of one train_step within
    the bf16 budget of JAX's bf16 model, and each parameter gradient of
    that step within twice JAX's own distance between its bf16 and fp32
    gradients of the tensor.  Two bf16 models that round at other places
    are as far apart as either is from fp32: at this shape JAX's bf16
    logits sit 1.1e-2 from its fp32 ones and the port's 1.15e-2 from JAX's
    bf16 ones (max-wise), and the gate path's gradients move by up to 22%
    between JAX's own bf16 and fp32 runs, so each is held to its own
    tensor's distance (as the narrow 350M's logits are in
    tests/test_torch_bf16.py).  A #10 whose Kbar misses its farthest lag
    must fail the same check."""
    _, _, out = _tiny_case()
    own = rel_err(out["bfloat16"][0], out["float32"][0])
    logits, loss, grads = _tiny_errs()
    assert logits < 2 * own
    assert loss < BF16_TOL
    for name, (err, jax_own) in grads.items():
        assert err < 2 * max(jax_own, BF16_TOL / 2), name
    _, _, faulty = _tiny_errs(_drop_last_lag)
    assert any(err >= 2 * max(jax_own, BF16_TOL / 2)
               for err, jax_own in faulty.values())


def _block_cfg(n_fft, mode="bfloat16"):
    """A config-1-shaped block cut narrow (d=128, 2 heads, mean pooling,
    memory 8, no wavelet) in ``mode`` on the fused branch."""
    return dataclasses.replace(_cfg(), embed_dim=128, num_heads=2,
                               n_fft=n_fft, memory_size=8,
                               compute_dtype=mode, fft_impl="pallas")


def _drop_group(v, g_r, g_i, ybar, n_fft):
    """A #2 whose gate cotangent misses its first gate group."""
    vbar, gbr, gbi = sm.direct_mix_bwd_ref(v, g_r, g_i, ybar, n_fft)
    gbr, gbi = gbr.clone(), gbi.clone()
    gbr[..., 0] = 0
    gbi[..., 0] = 0
    return vbar, gbr, gbi


@pytest.mark.parametrize("n_fft,kernel", [(1024, "direct_mix"),
                                          (2304, "staged_mix")])
def test_block_bf16_pallas_matches_jax(n_fft, kernel, monkeypatch):
    """The block's output within 1e-2 of JAX's block with
    pallas_fft.INTERPRET set (its fused branch and fast kernels in
    interpret mode), and each parameter gradient of sum(y.float() ** 2)
    within twice JAX's own distance between its bf16 and fp32 gradients
    of the tensor (as the LM's above: at n_fft 1024 the pooler's gate
    path moves by up to 31% between JAX's bf16 and fp32 runs, and the
    port's bf16 gradients sit up to 1.4e-2 from JAX's on the LayerNorms).
    At n_fft 1024 a #2 whose gate cotangent misses a gate group must fail
    the same check."""
    cfg = _block_cfg(n_fft)
    assert tsp._mix_branch(cfg) == "fused"
    assert sm.mix_kernel(n_fft) == kernel
    monkeypatch.setattr(pf, "INTERPRET", True)
    params, _ = block_pair(cfg, seed=n_fft)
    x = np.random.default_rng(n_fft).standard_normal(
        (2, n_fft, 128)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    ref = {}
    for mode in ("bfloat16", "float32"):
        jcfg = _jax_cfg(_block_cfg(n_fft, mode))
        ref[mode] = block_from_jax_params(jax.tree.map(
            np.asarray, jax.jit(jax.grad(lambda p, c=jcfg: jnp.sum(
                jsp.spectre_block_apply(p, c, jnp.asarray(x)).astype(
                    jnp.float32) ** 2)))(jp)), cfg)
    want_y = _jax_block_apply(jp, cfg, x)

    def worst(bwd=None):
        """The largest ratio of a gradient's distance to JAX's bf16 one
        over its bound."""
        _, block = block_pair(cfg, seed=n_fft)
        kept = sm.direct_mix_bwd
        sm.direct_mix_bwd = bwd or kept
        try:
            y = block(torch.from_numpy(x))
            assert y.dtype == torch.bfloat16
            assert rel_err(y.detach().float().numpy(),
                           _np(want_y)) < BF16_TOL
            (y.float() ** 2).sum().backward()
        finally:
            sm.direct_mix_bwd = kept
        ratios = {}
        for name, p in block.named_parameters():
            # the wavelet MLP (rate 0) and the pooler's last bias (zero in
            # exact arithmetic, rounding alone on either side) have no
            # gradient to compare
            if p.grad is None or name in _ZERO_GRADS:
                continue
            b16, b32 = ref["bfloat16"][name], ref["float32"][name]
            bound = 2 * max(rel_err(b16.numpy(), b32.numpy()), BF16_TOL / 2)
            ratios[name] = rel_err(p.grad.numpy(), b16.numpy()) / bound
        return max(ratios.values())

    assert worst() < 1
    if n_fft == 1024:
        assert worst(_drop_group) >= 1


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_bf16_tiny_preset_both_commands_on_the_cpu():
    """train-lm --bf16 and generate --bf16 on the tiny preset at its full
    width (seq cut to 256) on the CPU: finite losses, the first step's
    loss (lr 0 there) within 1e-2 of the fp32 run's, as the JAX package
    holds its bf16 LM (tests/test_bf16.py), text out, no kernel
    launched."""
    kc.reset_launches()
    sm.reset_launches()
    losses = {}
    buf = io.StringIO()
    for mode in ("--bf16", None):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(["train-lm", "--device", "cpu", "--preset",
                             "tiny", "--seq", "256", "--batch", "1",
                             "--steps", "1", "--log-every", "1"]
                            + ([mode] if mode else [])) == 0
        recs = [json.loads(line) for line in buf.getvalue().splitlines()
                if line.startswith("{")]
        assert recs and all(np.isfinite(r["loss"]) for r in recs)
        losses[mode] = recs[0]["loss"]
    assert abs(losses["--bf16"] - losses[None]) < BF16_TOL * losses[None]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["generate", "--device", "cpu", "--bf16",
                         "--preset", "tiny", "--seq", "256", "--steps",
                         "2"]) == 0
    assert buf.getvalue().splitlines()[-1].startswith("the ")
    assert set(kc.LAUNCHES.values()) == set(sm.LAUNCHES.values()) == {0}
