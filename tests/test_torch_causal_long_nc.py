"""The tiny LM at long context (seq 8192: nc = 64 segments of chunk 128,
the kf_fused branch: #8 at n_fft 8192, the direct #6 forward, the direct
#10 backward on the card) against fft_tpu on the CPU: the plain adjoint of
the segmented causal mix (kernel #10's plain version) at nc 48 and 64
against jax.vjp of JAX's composition (pallas_causal._fused_causal_ref); a
2-layer LM of the tiny LM's shape (d=64, 2 heads x 4 gate groups, chunk
128, seq 8192) against JAX's logits and jax.grad in fp32; and the card's
dispatch at those shapes: the direct #10 (csrc/causal_bwd.cu) and its
bf16 instance, as the FFT #10's bin-major block no longer fits shared
memory from nc 48 on.  The same LM in bf16 at seq 2048 (nc 16; the plain
#10 is one function at every nc here) against JAX's bf16 gradients under
tests/test_torch_hybrid.py's rule, with Kbar-lag faults failing; at nc 64
the bf16 path is held on the card (chip_smoke.py phase 6c).  The CUDA
kernel itself is checked on the card (tests/test_torch_kernels.py,
chip_smoke.py) and, at small shapes, on the CPU through
tests/test_torch_emulated_kernels.py.

Tolerances are max|a-b| / max|b| (tests/golden_utils.py): 1e-5 for the
kernel's plain version (fp32 FFTs against JAX's DFT matmuls at HIGHEST),
1e-4 for logits, loss and gradients (fp32 FFT round trips summed in other
orders on each side); bf16 as in tests/test_torch_hybrid.py: each
gradient tensor in JAX's own bf16-to-fp32 distance for it."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_tpu.kernels.pallas_causal as pc
import fft_tpu.layers.spectre as jsp
import fft_tpu.models.lm as jlm
import fft_tpu.train as jtrain
from fft_tpu_torch.kernels import causal as kc
from fft_tpu_torch.layers.causal_seg import BRANCH_CALLS
from fft_tpu_torch.models import lm as tlm
from fft_tpu_torch.train import lm_loss
from tests.golden_utils import rel_err
from tests.test_torch_convert import jax_lm_config, lm_pair
from tests.test_torch_hybrid import BF16_MEDIAN, BF16_TOL, BF16_WORST
from tests.test_torch_hybrid import _bf16_grad_ratios as grad_ratios
from tests.test_torch_train import _grad_tree

KERNEL_TOL = 1e-5
MODEL_TOL = 1e-4
SEQ = 8192
# the bf16 check's length (nc 16) and seeds (weights and batch)
BF16_SEQ = 2048
BF16_SEEDS = (6,)


def _fast_jit(fn, *args):
    """jax.jit(fn)(*args) compiled at XLA's optimisation level 0, as
    tests/test_torch_dist_fft.py's FAST_COMPILE: JAX's composition unrolls
    a lag loop of nc steps, whose compile is most of the reference's time;
    the same results at these tolerances."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


@pytest.mark.parametrize("nc", [48, 64])
def test_fused_causal_mix_bwd_ref_at_long_nc_matches_jax_vjp(nc):
    """vbar and both Kbar planes of the plain adjoint at nc 48 and 64
    (chunk 128, d=64, 8 gate columns) against jax.vjp of JAX's jnp
    composition of the fused mix on the same inputs; Kbar exactly 0 for
    c < delta."""
    rng = np.random.default_rng(nc)
    b, chunk, d, cols = 1, 128, 64, 8
    f2 = chunk + 1
    v, kr, ki, ybar = (rng.standard_normal(s).astype(np.float32) for s in (
        (b, nc * chunk, d), (b, nc, f2, nc * cols), (b, nc, f2, nc * cols),
        (b, nc * chunk, d)))
    want = _fast_jit(lambda *a: jax.vjp(
        lambda *p: pc._fused_causal_ref(*p, chunk, cols), *a[:3])[1](a[3]),
        *map(jnp.asarray, (v, kr, ki, ybar)))
    got = kc.fused_causal_mix_bwd_ref(
        *map(torch.from_numpy, (v, kr, ki, ybar)), chunk, cols)
    for a, w in zip(got, want):
        assert rel_err(a.numpy(), np.asarray(w)) < KERNEL_TOL
    kbar = got[1].view(b, nc, f2, nc, cols)
    assert all(int(torch.count_nonzero(kbar[:, dl, :, :dl])) == 0
               for dl in range(nc))


def long_tiny_config(seq: int = SEQ,
                     mode: str = "float32") -> tlm.LMConfig:
    """tiny_lm_config at ``seq`` (chunk 128: nc 64 at 8192) cut to 2
    layers, d=64, 2 heads x 4 gate groups, in ``mode``."""
    cfg = tlm.tiny_lm_config(seq=seq)
    return dataclasses.replace(cfg, num_layers=2, block=dataclasses.replace(
        cfg.block, embed_dim=64, num_heads=2, compute_dtype=mode))


def _tokens(seq: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, (1, seq + 1)).astype(np.int32)


class _Fp32Cumsum:
    """jax.numpy with cumsum accumulated in fp32 and rounded once to the
    input's dtype, as torch.cumsum does on a bf16 tensor (the same bits).
    XLA's cumsum of a bf16 array on the CPU adds in bf16 along its scan."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def cumsum(a, axis=None, **kw):
        return jnp.cumsum(a.astype(jnp.float32), axis, **kw).astype(a.dtype)


def jax_lm_run(cfg: tlm.LMConfig, params, batch: np.ndarray,
               fp32_cumsum: bool = False):
    """JAX's (loss, logits, [gradient leaves]) of the LM ``cfg``: lm_apply's
    logits of lm_hidden and lm_loss's chunked cross entropy of the same
    hidden states, in one function compiled at optimisation level 0;
    ``fp32_cumsum`` traces it with _Fp32Cumsum as fft_tpu.layers.spectre's
    jnp (the chunk gates' prefix sum)."""
    jcfg = jax_lm_config(cfg)

    def loss_logits(p, bt):
        h = jlm.lm_hidden(p, jcfg, bt[:, :-1], deterministic=True)
        head = jlm.lm_head_matrix(p, jcfg)
        logits = (h @ head.astype(h.dtype)).astype(jnp.float32)
        return jtrain.loop.chunked_softmax_ce(h, head, bt[:, 1:]), logits

    kept = jsp.jnp
    jsp.jnp = _Fp32Cumsum() if fp32_cumsum else kept
    try:
        (loss, logits), grads = _fast_jit(
            jax.value_and_grad(loss_logits, has_aux=True),
            jax.tree.map(jnp.asarray, params), jnp.asarray(batch))
    finally:
        jsp.jnp = kept
    return float(loss), np.asarray(logits), \
        jax.tree.leaves(jax.tree.map(np.asarray, grads))


def port_lm_run(cfg: tlm.LMConfig, seed: int, batch: np.ndarray, bwd=None):
    """The port's (loss, fp32 logits, [gradient leaves in JAX's order]) of
    the LM ``cfg`` with lm_pair's weights of ``seed``; ``bwd`` replaces
    ``fused_causal_mix_bwd`` for the run (a fault)."""
    _, model = lm_pair(cfg, seed=seed)
    BRANCH_CALLS.clear()
    with torch.no_grad():
        logits = tlm.lm_apply(model, torch.from_numpy(batch[:, :-1]).long())
    assert dict(BRANCH_CALLS) == {"kf_fused": cfg.num_layers}
    model.train()
    kept = kc.fused_causal_mix_bwd
    kc.fused_causal_mix_bwd = bwd or kept
    try:
        loss = lm_loss(model, torch.from_numpy(batch).long())
        loss.backward()
    finally:
        kc.fused_causal_mix_bwd = kept
    return float(loss.detach()), logits.float().numpy(), \
        jax.tree.leaves(_grad_tree(model, cfg))


def test_long_tiny_lm_matches_jax_in_fp32():
    """Logits, loss and every gradient of the long tiny LM at seq 8192
    (weights and batch from seed 6) within MODEL_TOL of JAX's; kf_fused in
    every layer's forward, as JAX's (n_fft 8192 is the last its kf kernel
    takes)."""
    cfg = long_tiny_config()
    params, _ = lm_pair(cfg, seed=6)
    batch = _tokens(SEQ, 6)
    jloss, jlogits, theirs = jax_lm_run(cfg, params, batch)
    loss, logits, ours = port_lm_run(cfg, 6, batch)
    assert rel_err(logits, jlogits) < MODEL_TOL
    assert abs(loss - jloss) / abs(jloss) < MODEL_TOL
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        if np.abs(b).max() > 0:
            assert rel_err(a, b) < MODEL_TOL
        else:
            assert np.abs(a).max() == 0


def drop_lag(lag: int):
    """A #10 whose Kbar misses lag ``lag`` (a fault the bf16 rule must
    catch)."""
    def bwd(*args):
        vbar, kbr, kbi = kc.fused_causal_mix_bwd_ref(*args)
        kbr, kbi = kbr.clone(), kbi.clone()
        kbr[:, lag] = 0
        kbi[:, lag] = 0
        return vbar, kbr, kbi
    return bwd


@functools.lru_cache(maxsize=None)
def bf16_case(seed: int, seq: int = BF16_SEQ):
    """(params, batch, JAX's bf16 run with the fp32-accumulated cumsum,
    JAX's fp32 run) of the long tiny LM at ``seq``, weights and batch from
    ``seed``."""
    params, _ = lm_pair(long_tiny_config(seq, "bfloat16"), seed=seed)
    batch = _tokens(seq, seed)
    return params, batch, \
        jax_lm_run(long_tiny_config(seq, "bfloat16"), params, batch, True), \
        jax_lm_run(long_tiny_config(seq), params, batch)


def bf16_grads(ours, jax16, jax32):
    """{leaf index: (our gradient's rel_err to JAX's bf16 one, JAX's own
    bf16-to-fp32 rel_err of it)} over the leaves JAX's bf16 run moves."""
    return {i: (rel_err(a, b), rel_err(b, b32))
            for i, (a, b, b32) in enumerate(zip(ours, jax16, jax32))
            if np.abs(b).max() > 0}


def bf16_errs(seed: int, seq: int = BF16_SEQ, bwd=None):
    """The port's bf16 long tiny LM against JAX's (the fp32-accumulated
    cumsum): (logits' rel_err, JAX's own bf16-to-fp32 rel_err of them, the
    loss's relative error, bf16_grads)."""
    _, batch, (jloss, jlogits, jgrads), (_, jlogits32, jgrads32) = \
        bf16_case(seed, seq)
    loss, logits, grads = port_lm_run(long_tiny_config(seq, "bfloat16"),
                                      seed, batch, bwd)
    return (rel_err(logits, jlogits), rel_err(jlogits, jlogits32),
            abs(loss - jloss) / abs(jloss), bf16_grads(grads, jgrads,
                                                        jgrads32))


@pytest.mark.parametrize("seed", BF16_SEEDS)
def test_long_tiny_lm_bf16_grads_within_the_hybrid_rule(seed):
    """The bf16 LM at seq 2048 (nc 16, the FFT #10's range on the card and
    the same plain #10 as at nc 64 here) against JAX's bf16 LM traced with
    an fp32-accumulated cumsum (_Fp32Cumsum): logits within twice JAX's own
    bf16-to-fp32 distance, the loss within BF16_TOL, the median gradient
    tensor within BF16_MEDIAN of JAX's own distance for it and each within
    BF16_WORST (tests/test_torch_hybrid.py's rule); a #10 whose Kbar misses
    its nearest lag, or its farthest, must fail the same rule (the farthest
    is one (c, s) pair of 136: caught at seed 6, worst 4.46, and within
    bf16's scatter at seed 7, worst 1.40).

    Why that reference (tests/bf16_lm_witness.py): the chunk gates'
    descriptor is a bf16 prefix sum over every earlier chunk, which the
    gate MLP amplifies, so it grows with nc; XLA's CPU cumsum adds in bf16
    along its scan, torch's in fp32.  Against plain jitted JAX the port
    reads a median tensor of 1.22 and a worst of 3.03 (seed 6), and JAX's
    own two cumsums read about as far apart; against the fp32-accumulated
    one, the port reads as the hybrid's port does against JAX."""
    logits, own, loss, grads = bf16_errs(seed)
    assert logits < 2 * own
    assert loss < BF16_TOL
    ratios = grad_ratios(grads)
    assert np.median(ratios) < BF16_MEDIAN, np.median(ratios)
    for i, ratio in zip(grads, ratios):
        assert ratio < BF16_WORST, i
    for lag in (0, -1):
        faulty = grad_ratios(bf16_errs(seed, bwd=drop_lag(lag))[3])
        assert (np.median(faulty) >= BF16_MEDIAN
                or faulty.max() >= BF16_WORST), lag


@pytest.mark.parametrize("n,chunk,d,cols,nc", [
    (SEQ, 128, 512, 32, 64), (600, 600, 1024, 64, 1)])
def test_bf16_backward_reaches_the_direct_10s_bf16_instance(
        monkeypatch, n, chunk, d, cols, nc):
    """On the card (the wrappers with on_cpu false, the launch recorded in
    place of the library call) the tiny LM's mix at seq 8192 and a 600-token
    chunk (2C = 1200 = 16 * 75) run forward through the direct #6 and
    backward through the direct #10's bf16 instance, bf16 flag set: the FFT
    #10 has no plan there (its bin-major block stages nc segments), nothing
    is cast to fp32."""
    bf16 = torch.bfloat16
    assert kc.bwd_fft_plan(nc, chunk, d, cols) is None
    assert kc.bwd_direct_plan(nc, chunk, d, cols) is not None
    assert kc._mix_kernel("fused_causal_mix_bwd", n, chunk, d, cols, bf16) \
        == "fused_causal_mix_bwd_direct"
    launched = []

    def fake_launch(counts, name, device, *args, entry=None):
        launched.append((name, args[-1]))

    monkeypatch.setattr(kc, "on_cpu", lambda *t: False)
    monkeypatch.setattr(kc, "launch", fake_launch)
    v = torch.zeros(1, n, d, dtype=bf16, requires_grad=True)
    k = torch.zeros(1, nc, chunk + 1, nc * cols)
    y = kc.fused_causal_mix(v, k, k, chunk, cols)
    assert y.dtype == bf16
    y.backward(torch.zeros_like(y))
    assert v.grad.dtype == bf16
    assert launched == [("fused_causal_mix_direct_bf16", 1),
                        ("fused_causal_mix_bwd_direct_bf16", 1)]
