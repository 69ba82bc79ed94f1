"""The port's hybrid SPECTRE + sliding-window LM (config 5) against
fft_tpu's on the CPU: the sliding-window attention, its ring decode, the
model's logits, loss, gradients, train step and greedy generation through
the weight bridge, remat, bf16, the CLI and the presets.

Both sides run ``fft_impl="auto"`` (JAX's tests set "matmul"; the port
takes it too and runs the same transforms for both); the port's kernels
run their plain versions on CPU tensors.  Tolerances are
max|a-b| / max|b| (tests/golden_utils.py): 1e-5 for the attention, 2e-5
for decode (COMPONENTS.md 2.4), 1e-4 for model logits, losses and
gradients."""

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

import fft_tpu.config as jcfg_mod
import fft_tpu.layers.attention as jattn
import fft_tpu.models.hybrid as jhy
import fft_tpu.train as jtrain
import fft_tpu.train.loop as jloop
from fft_tpu_torch import cli
from fft_tpu_torch.config import SpectreConfig
from fft_tpu_torch.convert import (
    cache_from_jax, hybrid_from_jax_params, swa_block_from_jax_params,
    swa_cache_from_jax, swa_cache_to_jax,
)
from fft_tpu_torch.kernels import causal as kc
from fft_tpu_torch.layers import attention as tattn
from fft_tpu_torch.layers.causal_seg import BRANCH_CALLS
from fft_tpu_torch.models import hybrid as thy
from fft_tpu_torch.parallel import comm, make_mesh
from fft_tpu_torch.train import (
    TrainConfig, hybrid_loss, hybrid_train_step, train_init,
)
from tests.golden_utils import rel_err
from tests.test_torch_convert import _leaf_init
from tests.torch_parallel_worker import one_rank_group

ATTN_TOL = 1e-5
DECODE_TOL = 2e-5
MODEL_TOL = 1e-4
BF16_TOL = 1e-2
# The bf16 check's seeds (weights and batch) and its gradient rule, in
# JAX's own bf16-to-fp32 distance for each tensor (floored at BF16_TOL/2).
# Two sound bf16 runs round in different places, so a tensor's distance
# between them scatters around that own distance.  Over these seeds
# (tests/bf16_hybrid_witness.py): JAX against itself (its eager run
# against its jitted one) reads a median tensor of 0.81-0.99 and a worst
# of 1.63-1.97; the port against JAX 0.83-1.05 and 1.60-2.05 (seed 11, a
# SPECTRE LayerNorm bias); a #10 that misses its farthest lag 2.3-3.5 and
# 10-17.
BF16_SEEDS = (1, 2, 3, 11)
BF16_MEDIAN = 1.25
BF16_WORST = 2.25


def jax_hybrid_config(cfg: thy.HybridConfig) -> jhy.HybridConfig:
    """The JAX HybridConfig with the same fields as a port HybridConfig."""
    block = jcfg_mod.SpectreConfig(**dataclasses.asdict(cfg.block))
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg) if f.name != "block"}
    return jhy.HybridConfig(block=block, **fields)


def small_hybrid(mode: str = "float32", chunk: int = 128,
                 seq: int = 256) -> thy.HybridConfig:
    """2 groups of (SPECTRE + SWA), d=64, 4 heads x 4 groups (16 gate
    columns, as the tiny hybrid's), seq 256, chunk 128 (nc 2: the kf_fused
    branch, the plain #8, #6 and #10), window 64, vocab 64."""
    return thy.HybridConfig(
        vocab_size=64, num_groups=2, spectre_per_group=1,
        block=SpectreConfig(embed_dim=64, num_heads=4, n_fft=seq,
                            pooling_type="mean", wavelet_on_rate=0.0,
                            causal=True, causal_chunk=chunk,
                            compute_dtype=mode),
        attn_heads=4, attn_window=64, max_seq=seq)


def hybrid_pair(cfg: thy.HybridConfig, seed: int = 0):
    """(JAX params as numpy, port model) with the same numpy-seeded
    weights, bridged into the port."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: jhy.hybrid_init(jax.random.key(0), jax_hybrid_config(cfg)))
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: _leaf_init(path, s.shape, rng).astype(np.float32),
        shapes)
    model = thy.HybridLM(cfg)
    model.load_state_dict(hybrid_from_jax_params(params, cfg), strict=True)
    return params, model.eval()


def _tokens(cfg, seed, b=2, extra=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, cfg.max_seq + extra)).astype(np.int32)


def _port_grads(model):
    """{port name: gradient} of every parameter, zeros where none flowed
    (the wavelet MLP at rate 0; JAX's gradient there is zero)."""
    return {k: (torch.zeros_like(p) if p.grad is None else p.grad)
            for k, p in model.named_parameters()}


def _jax_grads_by_name(grads, cfg):
    """JAX's gradient tree in the port's names and layouts."""
    return hybrid_from_jax_params(jax.tree.map(np.asarray, grads), cfg)


# ---------------------------------------------------------------------------
# sliding-window attention and its ring decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 200])
def test_swa_matches_jax(n):
    """N a multiple of the window (4 blocks) and not one (200: zero-padded
    to 256)."""
    rng = np.random.default_rng(n)
    q, k, v = (rng.standard_normal((2, n, 4, 16)).astype(np.float32)
               for _ in range(3))
    want = jattn.sliding_window_attention(*map(jnp.asarray, (q, k, v)), 16)
    got = tattn.sliding_window_attention(*map(torch.from_numpy, (q, k, v)),
                                         16)
    assert got.shape == want.shape
    assert rel_err(got.numpy(), np.asarray(want)) < ATTN_TOL


def _swa_block_pair(seed=3, d=64, heads=4):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: jattn.swa_block_init(jax.random.key(0), d, heads))
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: _leaf_init(path, s.shape, rng).astype(np.float32),
        shapes)
    block = tattn.SWABlock(d, heads, 16)
    block.load_state_dict(swa_block_from_jax_params(params), strict=True)
    return params, block


def test_swa_block_and_its_ring_decode_past_the_wrap():
    """The block's forward against JAX's, then 40 decode steps (the 16-slot
    ring wraps twice) against that forward and against JAX's decode from
    the same bridged cache."""
    params, block = _swa_block_pair()
    x = np.random.default_rng(4).standard_normal((2, 40, 64)).astype(
        np.float32)
    jparams = jax.tree.map(jnp.asarray, params)
    want = np.asarray(jattn.swa_block_apply(jparams, jnp.asarray(x), 4, 16))
    with torch.no_grad():
        fwd = block(torch.from_numpy(x))
    assert rel_err(fwd.numpy(), want) < ATTN_TOL
    cache = tattn.swa_cache_init(2, 4, 16, 16, device="cpu")
    jcache = jattn.swa_cache_init(2, 4, 16, 16)
    jstep = jax.jit(lambda p, xt, c: jattn.swa_block_decode_step(p, xt, c, 4))
    for i in range(40):
        with torch.no_grad():
            y, cache = tattn.swa_block_decode_step(
                block, torch.from_numpy(x[:, i]), cache)
        jy, jcache = jstep(jparams, jnp.asarray(x[:, i]), jcache)
        assert rel_err(y.numpy(), want[:, i]) < DECODE_TOL, i
        assert rel_err(y.numpy(), np.asarray(jy)) < DECODE_TOL, i
    assert cache.t == int(jcache.t) == 39
    back = swa_cache_from_jax(swa_cache_to_jax(cache))
    assert torch.equal(back.k_buf, cache.k_buf) and back.t == cache.t
    bridged = swa_cache_from_jax(jcache)
    assert rel_err(bridged.v_buf.numpy(), cache.v_buf.numpy()) < DECODE_TOL


def test_cp_mesh_runs_the_halo_exchange_on_one_rank(tmp_path):
    """On a 1-rank gloo group the context-parallel block launches its halo
    hop, receives the sequence start's zeros and equals the block without
    a mesh bit for bit."""
    _, block = _swa_block_pair()
    x = torch.randn(2, 32, 64, generator=torch.Generator().manual_seed(4))
    with one_rank_group(tmp_path):
        mesh = make_mesh(1, 1, 1, device="cpu")
        comm.reset_calls()
        got = block(x, cp_mesh=mesh)
        assert comm.CALLS["halo"] == 1
    assert torch.equal(got, block(x))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_case(seed: int = 5):
    """(cfg, params, batch, JAX logits, loss, grads, metrics and params
    after two hybrid_train_steps) of the small hybrid."""
    cfg = small_hybrid()
    jcfg = jax_hybrid_config(cfg)
    params, _ = hybrid_pair(cfg, seed)
    batch = _tokens(cfg, seed)
    jp = jax.tree.map(jnp.asarray, params)
    logits = jax.jit(jhy.hybrid_apply, static_argnums=1)(
        jp, jcfg, batch[:, :-1])
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, bt: jloop.hybrid_loss(p, jcfg, bt, deterministic=True)))(
            jp, batch)
    tcfg = jtrain.TrainConfig(learning_rate=1e-4, warmup_steps=1,
                              total_steps=10)
    state, opt = jtrain.train_init(jax.random.key(1), jp, tcfg)
    step = jax.jit(lambda s, b: jloop.hybrid_train_step(
        s, b, model_cfg=jcfg, optimizer=opt))
    metrics = []
    for _ in range(2):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return (cfg, params, batch, np.asarray(logits), float(loss), grads,
            metrics, jax.tree.map(np.asarray, state.params))


def test_hybrid_apply_logits_match_jax():
    cfg, params, batch, logits, *_ = _jax_case()
    _, model = hybrid_pair(cfg, 5)
    BRANCH_CALLS.clear()
    got = thy.hybrid_apply(model, torch.from_numpy(batch[:, :-1]).long())
    assert dict(BRANCH_CALLS) == {"kf_fused": cfg.num_groups}
    assert got.dtype == torch.float32 and got.shape == logits.shape
    assert rel_err(got.numpy(), logits) < MODEL_TOL


def test_hybrid_loss_and_every_gradient_match_jax():
    cfg, params, batch, _, loss, grads, *_ = _jax_case()
    _, model = hybrid_pair(cfg, 5)
    got = hybrid_loss(model, torch.from_numpy(batch).long())
    got.backward()
    assert abs(float(got.detach()) - loss) / abs(loss) < MODEL_TOL
    want = _jax_grads_by_name(grads, cfg)
    port = _port_grads(model)
    assert sorted(want) == sorted(port)
    for name, g in port.items():
        if not np.abs(want[name].numpy()).max():
            assert not g.abs().max(), name
            continue
        assert rel_err(g.numpy(), want[name].numpy()) < MODEL_TOL, name


def test_hybrid_train_steps_match_jax():
    """Two steps (the first at lr 0 under the warmup), optax's clip, AdamW
    and schedule: the metrics and every parameter after them.  Adam moves
    each parameter by about lr whatever its gradient, so an element whose
    gradient is rounding noise (|g| near eps) moves by a noisy fraction of
    lr on either side: lr = 1e-4 keeps that under the tolerance while a
    wrong update (a missing or flipped one, ~lr) breaks it."""
    cfg, params, batch, *_, metrics, new_params = _jax_case()
    _, model = hybrid_pair(cfg, 5)
    state = train_init(model, TrainConfig(learning_rate=1e-4,
                                          warmup_steps=1, total_steps=10),
                       seed=1, deterministic=True)
    assert not model.training
    for want in metrics:
        got = hybrid_train_step(state, batch)
        assert got["step"] == want["step"]
        for k in ("loss", "grad_norm"):
            assert abs(float(got[k]) - want[k]) / abs(want[k]) < MODEL_TOL
    ref = hybrid_from_jax_params(new_params, cfg)
    old = hybrid_from_jax_params(params, cfg)
    moved = max(float((p.detach() - old[n]).abs().max())
                for n, p in model.named_parameters())
    assert moved > 5e-5
    for name, p in model.named_parameters():
        assert rel_err(p.detach().numpy(), ref[name].numpy()) < MODEL_TOL, \
            name


def test_hybrid_remat_equals_no_remat():
    """The loss and every gradient with each group recomputed in backward
    equal those without."""
    cfg, params, batch, *_ = _jax_case()
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        model = thy.HybridLM(c)
        model.load_state_dict(hybrid_from_jax_params(params, c))
        loss = hybrid_loss(model, torch.from_numpy(batch).long())
        loss.backward()
        out.append((float(loss.detach()), _port_grads(model)))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    for k, g in out[0][1].items():
        # JAX's remat test's limits (tests/test_hybrid.py:252): the
        # recomputed groups accumulate the shared weights' gradients in
        # another order
        np.testing.assert_allclose(out[1][1][k].numpy(), g.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_hybrid_generate_greedy_tokens_equal_jax():
    cfg = small_hybrid()
    params, model = hybrid_pair(cfg, 8)
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size,
                                               (2, 6)).astype(np.int32)
    want = jhy.hybrid_generate(jax.tree.map(jnp.asarray, params),
                               jax_hybrid_config(cfg), jnp.asarray(prompt),
                               steps=5)
    got = thy.hybrid_generate(model, torch.from_numpy(prompt).long(), 5)
    assert got.tolist() == np.asarray(want).tolist()
    with pytest.raises(ValueError, match="max_seq"):
        thy.hybrid_generate(model, torch.from_numpy(prompt).long(),
                            cfg.max_seq)


def test_hybrid_decode_step_matches_jax_and_forward_at_chunk_1():
    """At chunk 1 SPECTRE's decode equals its forward (JAX's
    tests/test_hybrid.py:123): the port's decode logits against its own
    forward and JAX's decode step, 12 tokens from empty caches, and the
    caches bridged back to JAX's."""
    cfg = small_hybrid(chunk=1, seq=16)
    jcfg = jax_hybrid_config(cfg)
    params, model = hybrid_pair(cfg, 2)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             (2, 12)).astype(np.int32)
    fwd = thy.hybrid_apply(model, torch.from_numpy(toks).long())
    caches = thy.hybrid_decode_init(model, 2)
    jp = jax.tree.map(jnp.asarray, params)
    jcaches = jhy.hybrid_decode_init(jcfg, 2)
    jstep = jax.jit(lambda p, t, i, c: jhy.hybrid_decode_step(p, jcfg, t, i,
                                                              c))
    for i in range(12):
        logits, caches = thy.hybrid_decode_step(
            model, torch.from_numpy(toks[:, i]).long(), i, caches)
        jlogits, jcaches = jstep(jp, jnp.asarray(toks[:, i]), i, jcaches)
        assert rel_err(logits.numpy(), fwd[:, i].numpy()) < MODEL_TOL, i
        assert rel_err(logits.numpy(), np.asarray(jlogits)) < MODEL_TOL, i
    sp, at = caches
    jsp, jat = jcaches
    for g in range(cfg.num_groups):
        ours = cache_from_jax(jax.tree.map(lambda a: a[g, 0], jsp._asdict()))
        assert rel_err(sp[g][0].v_buf.numpy(), ours.v_buf.numpy()) < 1e-5
        assert rel_err(at[g].k_buf.numpy(), swa_cache_from_jax(
            jax.tree.map(lambda a: a[g], jat._asdict())).k_buf.numpy()) < 1e-5


# ---------------------------------------------------------------------------
# bf16
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_hybrid_fns(mode: str):
    """JAX's jitted logits and (loss, gradients) of the small hybrid in
    ``mode``, compiled once for every seed."""
    jcfg = jax_hybrid_config(small_hybrid(mode))
    apply = jax.jit(lambda p, t: jhy.hybrid_apply(p, jcfg, t))
    loss_grad = jax.jit(jax.value_and_grad(
        lambda p, bt: jloop.hybrid_loss(p, jcfg, bt, deterministic=True)))
    return apply, loss_grad


@functools.lru_cache(maxsize=None)
def _bf16_case(seed: int):
    """JAX's logits, loss and gradients of the small hybrid in bf16 and in
    fp32, the same weights and batch."""
    params, _ = hybrid_pair(small_hybrid("bfloat16"), seed)
    batch = _tokens(small_hybrid(), seed)
    jp = jax.tree.map(jnp.asarray, params)
    out = {}
    for mode in ("bfloat16", "float32"):
        apply, loss_grad = _jax_hybrid_fns(mode)
        loss, grads = loss_grad(jp, batch)
        out[mode] = (np.asarray(apply(jp, batch[:, :-1])), float(loss),
                     _jax_grads_by_name(grads, small_hybrid(mode)))
    return params, batch, out


def _bf16_errs(seed: int, bwd=None):
    """The port's bf16 small hybrid against JAX's: (logits' rel_err, the
    loss's, {tensor: (its gradient's rel_err, JAX's own bf16-to-fp32
    rel_err of it)}); ``bwd`` replaces ``fused_causal_mix_bwd`` for the
    run (the control)."""
    params, batch, out = _bf16_case(seed)
    cfg = small_hybrid("bfloat16")
    model = thy.HybridLM(cfg)
    model.load_state_dict(hybrid_from_jax_params(params, cfg))
    logits = thy.hybrid_apply(model, torch.from_numpy(batch[:, :-1]).long())
    assert logits.dtype == torch.float32
    kept = kc.fused_causal_mix_bwd
    kc.fused_causal_mix_bwd = bwd or kept
    try:
        loss = hybrid_loss(model, torch.from_numpy(batch).long())
        loss.backward()
    finally:
        kc.fused_causal_mix_bwd = kept
    jlogits, jloss, jgrads = out["bfloat16"]
    grads = {}
    for name, g in _port_grads(model).items():
        b, b32 = jgrads[name].numpy(), out["float32"][2][name].numpy()
        if np.abs(b).max() > 0:
            grads[name] = (rel_err(g.numpy(), b), rel_err(b, b32))
    return (rel_err(logits.numpy(), jlogits),
            abs(float(loss.detach()) - jloss) / abs(jloss), grads)


def _drop_last_lag(*args):
    """A #10 whose Kbar misses its farthest lag (the card's control)."""
    vbar, kbr, kbi = kc.fused_causal_mix_bwd_ref(*args)
    kbr, kbi = kbr.clone(), kbi.clone()
    kbr[:, -1] = 0
    kbi[:, -1] = 0
    return vbar, kbr, kbi


def _bf16_grad_ratios(grads) -> np.ndarray:
    """Each tensor's distance in JAX's own (floored) distance."""
    return np.array([err / max(jax_own, BF16_TOL / 2)
                     for err, jax_own in grads.values()])


@pytest.mark.parametrize("seed", BF16_SEEDS)
def test_small_hybrid_bf16_matches_jax_within_twice_its_own_distance(seed):
    """The logits within twice JAX's own bf16-to-fp32 distance, the loss
    within the bf16 budget, the median tensor's gradient within
    BF16_MEDIAN of JAX's own distance for it and every tensor's within
    BF16_WORST; a #10 whose Kbar misses its farthest lag must fail the
    same gradient rule."""
    _, _, out = _bf16_case(seed)
    own = rel_err(out["bfloat16"][0], out["float32"][0])
    logits, loss, grads = _bf16_errs(seed)
    assert logits < 2 * own
    assert loss < BF16_TOL
    ratios = _bf16_grad_ratios(grads)
    assert np.median(ratios) < BF16_MEDIAN, np.median(ratios)
    for name, ratio in zip(grads, ratios):
        assert ratio < BF16_WORST, name
    faulty = _bf16_grad_ratios(_bf16_errs(seed, _drop_last_lag)[2])
    assert np.median(faulty) >= BF16_MEDIAN or faulty.max() >= BF16_WORST


# ---------------------------------------------------------------------------
# the CLI and the presets
# ---------------------------------------------------------------------------

def test_cli_train_hybrid_on_the_cpu(tmp_path):
    buf = io.StringIO()
    args = ["train-hybrid", "--device", "cpu", "--seq", "128", "--steps",
            "2", "--log-every", "1", "--eval-every", "1", "--ckpt",
            str(tmp_path / "ck"), "--ckpt-every", "1"]
    with contextlib.redirect_stdout(buf):
        cli.main(args)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    assert len(lines) == 2 and '"eval_loss"' in lines[0]
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["1", "2"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(args[:6] + ["3"] + args[7:] + ["--resume"])
    assert "resumed at step 2" in buf.getvalue()
    for flag in ("--sp", "--dp"):
        with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
            cli.main(["train-hybrid", "--device", "cpu", "--seq", "128",
                      flag, "2"])


def test_cli_train_hybrid_profile_writes_a_trace(tmp_path):
    """--profile DIR traces the run's third step into DIR (JAX's
    cmd_train_hybrid takes the flag and never reads it)."""
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["train-hybrid", "--device", "cpu", "--seq", "128",
                  "--steps", "3", "--profile", str(tmp_path / "trace")])
    traces = list((tmp_path / "trace").iterdir())
    assert len(traces) == 1 and traces[0].suffix == ".json"
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


@pytest.mark.parametrize("name,kw", [("hybrid_tiny_config", {}),
                                     ("hybrid_tiny_config", {"seq": 512}),
                                     ("hybrid_1b_config", {}),
                                     ("hybrid_1b_config", {"seq": 8192})])
def test_preset_fields_equal_jax(name, kw):
    ours = getattr(thy, name)(**kw)
    want = getattr(jhy, name)(**kw)
    assert dataclasses.asdict(ours) == dataclasses.asdict(want)
    assert ours.num_layers == want.num_layers


def test_tiny_hybrid_takes_the_fused_kernels_on_the_card():
    """The tiny hybrid's shape (d=256, 16 gate columns, seq 2048, chunk
    256, nc 8) has FFT plans for #8, #6 and #10; the 1B's (d=2048, 64
    columns, chunk 1024, nc 32) takes #9, #7 and #11."""
    tiny = thy.hybrid_tiny_config().block
    cols = tiny.num_heads * tiny.num_groups
    assert kc.kf_fft_plan(2048, 256, 8 * cols) is not None
    assert kc.mix_fft_plan(8, 256, 256, cols) is not None
    assert kc.bwd_fft_plan(8, 256, 256, cols) is not None
    big = thy.hybrid_1b_config().block
    cols = big.num_heads * big.num_groups
    assert not kc.fused_mix_supported(32, 1024, 2048, cols)
    assert kc.fused_mix_v3_supported(32, 1024, 2048, cols)
    assert kc.kf_seg_rfft_supported(32768, 1024, 32 * cols)
