"""The 350M model's long-context slice (BASELINE config 4) against fft_tpu on
the CPU: the plain versions of kernels #9 kf_seg_rfft, #7 the v3 fused mix
and #11 its backward against the Pallas kernels in interpret mode (as
tests/test_pallas_causal.py runs them), the 350M config field for field, and
a 350M-shaped LM at a narrow width that still takes the long path (seq
16384, chunk 2048, nc = 8, the kf_seg branch) against JAX's logits and
jax.grad, through the weight bridge; its logits at seq 32768 with nc = 16
(chunk 2048) and nc = 32 (chunk 1024: chunk 2048 at seq 65536 takes ~80 s
here), its loss and gradients at nc = 16 and 32 with chunk 512 (seq 8192,
16384), the prompt dispatch at n_fft 32768 and 65536, kernel #12's plain version
against the Pallas kernel at the windows of 32768 and 65536 (F_half
16385, 32769) and the bridge at seq 65536.  The CUDA kernels themselves are
checked on the card (tests/test_torch_kernels.py, chip_smoke.py) and, at
small shapes, on the CPU through tests/test_torch_emulated_kernels.py.

Tolerances are max|a-b| / max|b| (tests/golden_utils.py): 1e-5 for one
fp32 kernel, 2e-5 for #12's decode output (COMPONENTS.md 2.4), 1e-4 for
gradients and model outputs (fp32 FFT round trips summed in other orders
on each side)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_tpu.kernels.pallas_causal as pc
import fft_tpu.kernels.pallas_decode as pd
import fft_tpu.models.lm as jlm
import fft_tpu.train as jtrain
from fft_tpu_torch.convert import to_jax_params
from fft_tpu.ops import rfft_phasor as jax_rfft_phasor
from fft_tpu_torch.kernels import causal as kc
from fft_tpu_torch.kernels import decode as kd
from fft_tpu_torch.layers.causal_seg import BRANCH_CALLS
from fft_tpu_torch.layers.spectre import SpectreMultiHead
from fft_tpu_torch.models import lm as tlm
from fft_tpu_torch.train import lm_loss
from tests.golden_utils import rel_err
from tests.test_torch_convert import jax_lm_config, lm_pair
from tests.test_torch_train import _grad_tree

KERNEL_TOL = 1e-5
MODEL_TOL = 1e-4
DECODE_TOL = 2e-5


@pytest.fixture(autouse=True)
def _interpret():
    old = pc.INTERPRET
    pc.INTERPRET = True
    yield
    pc.INTERPRET = old


def _planes(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

def test_kf_seg_rfft_ref_matches_pallas_and_its_gradient_jax_grad():
    rng = np.random.default_rng(9)
    chunk = 128
    kt, wr, wi = _planes(rng, (2, 1024, 128), (2, 8, chunk + 1, 128),
                         (2, 8, chunk + 1, 128))
    ref = pc.kf_seg_rfft(jnp.asarray(kt), chunk, False, True)
    got = kc.kf_seg_rfft_ref(torch.from_numpy(kt), chunk)
    for a, r in zip(got, ref):
        assert rel_err(a.numpy(), np.asarray(r)) < KERNEL_TOL

    x = torch.from_numpy(kt).requires_grad_()
    kr, ki = kc.kf_seg_rfft(x, chunk)
    ((kr * torch.from_numpy(wr)).sum()
     + (ki * torch.from_numpy(wi)).sum()).backward()

    def jloss(k):
        r, i = pc.kf_seg_rfft(k, chunk, False, True)
        return jnp.sum(r * wr) + jnp.sum(i * wi)

    want = jax.grad(jloss)(jnp.asarray(kt))
    assert rel_err(x.grad.numpy(), np.asarray(want)) < MODEL_TOL


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("b,nc,chunk,d,cols", [(2, 4, 128, 256, 32),
                                               (1, 3, 128, 128, 8)])
def test_fused_causal_mix_ref_matches_pallas_v3(staged, b, nc, chunk, d,
                                                cols):
    rng = np.random.default_rng(nc * d + cols + staged)
    arrs = _planes(rng, (b, nc * chunk, d), (b, nc, chunk + 1, nc * cols),
                   (b, nc, chunk + 1, nc * cols))
    ref = pc._fused_causal_call_v3(*map(jnp.asarray, arrs), chunk=chunk,
                                   cols=cols, interpret=True, staged=staged,
                                   dblk=128)
    got = kc.fused_causal_mix_ref(*map(torch.from_numpy, arrs), chunk, cols)
    assert rel_err(got.numpy(), np.asarray(ref)) < KERNEL_TOL


@pytest.mark.parametrize("d", [128, 256])
def test_fused_causal_mix_bwd_ref_matches_pallas_v3(d):
    rng = np.random.default_rng(d)
    b, nc, chunk, cols = 1, 3, 512, 4
    arrs = _planes(rng, (b, nc * chunk, d), (b, nc, chunk + 1, nc * cols),
                   (b, nc, chunk + 1, nc * cols), (b, nc * chunk, d))
    ref = pc._fused_causal_bwd_call_v3(*map(jnp.asarray, arrs), chunk=chunk,
                                       cols=cols, interpret=True, dblk=128)
    got = kc.fused_causal_mix_bwd_ref(*map(torch.from_numpy, arrs), chunk,
                                      cols)
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        assert rel_err(a.numpy(), np.asarray(r)) < KERNEL_TOL


def test_kf_seg_rfft_wrapper_runs_the_plain_version_on_cpu():
    kt = torch.randn((1, 512, 16), generator=torch.Generator().manual_seed(0))
    kc.reset_launches()
    for got, want in zip(kc.kf_seg_rfft(kt, 64), kc.kf_seg_rfft_ref(kt, 64)):
        assert torch.equal(got, want)
    assert set(kc.LAUNCHES.values()) == {0}


def test_long_chunk_predicates():
    """At the 350M's widths (d=1024, 64 gate columns) #6 stops where its
    32-channel spectra leave shared memory; #7's port takes the power-of-
    two chunks up to 2048, kf_seg_rfft the 512 gate lanes at nc = 8, and
    the banded kernel every chunk up to 2904 (Bluestein's 4096-point
    transform at 853 and 854)."""
    assert not kc.fused_mix_supported(8, 2048, 1024, 64)
    assert kc.fused_mix_v3_supported(8, 2048, 1024, 64)
    assert kc.fused_mix_v3_supported(1, 1024, 1024, 64)
    assert not kc.fused_mix_v3_supported(1, 1500, 1024, 64)
    assert not kc.fused_mix_v3_supported(1, 4096, 1024, 64)
    assert kc.kf_seg_rfft_supported(16384, 2048, 512)
    assert not kc.kf_seg_rfft_supported(16384, 2048, 12)
    assert kc.banded_fft_plan(853)[:2] == (4096, 0)
    assert kc.banded_fft_plan(854)[:2] == (4096, 0)
    assert kc.banded_supported(1, 2905, 1024, 64)
    assert not kc.banded_supported(1, 2906, 1024, 64)


# ---------------------------------------------------------------------------
# the 350M config and its prompt-length dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [1024, 2048, 4096, 8192, 16384, 32768,
                                 65536])
def test_350m_config_matches_jax(seq):
    """Field for field, the causal chunk (the reference's choice, part of
    the model) included."""
    ours = tlm.spectre_350m_config(seq=seq)
    theirs = jlm.spectre_350m_config(seq=seq)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.block.causal_chunk == {1024: 512, 2048: 512, 4096: 512,
                                       8192: 1024}.get(seq, 2048)


def _jax_runs_a_kernel(n, d, cols, chunk_cfg) -> bool:
    """Whether fft_tpu runs a Pallas kernel (#5, #6 or #7) for the causal
    mix of a length-n call on a TPU in fp32 (causal_seg.py:126-182)."""
    chunk = min(chunk_cfg, n)
    nc = n // chunk
    return (pc.fused_mix_supported(nc, chunk, d, False, cols)
            or (d % 128 == 0 and pc.banded_supported(nc, chunk + 1)))


@pytest.mark.parametrize("n,want", [(1500, "banded"), (1024, "fused"),
                                    (8192, "kf_seg")])
def test_350m_prompt_dispatch_takes_a_kernel_where_jax_does(n, want):
    """At the 350M's own widths (d=1024, 16 heads x 4 groups, n_fft 16384,
    chunk 2048) a prompt of n tokens takes a kernel's branch wherever the
    reference runs a Pallas kernel: #5 at chunk 1500, #7's port at 1024
    (nc=1) and 8192 (kf_seg_rfft, nc=4); never the plain composition."""
    cfg = tlm.spectre_350m_config().block
    cols = cfg.num_heads * cfg.num_groups
    assert _jax_runs_a_kernel(n, cfg.embed_dim, cols, cfg.causal_chunk)
    mix = SpectreMultiHead(cfg)
    mix.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn((1, n, cfg.embed_dim),
                    generator=torch.Generator().manual_seed(1))
    BRANCH_CALLS.clear()
    with torch.no_grad():
        y = mix(x)
    assert dict(BRANCH_CALLS) == {want: 1}
    assert y.shape == x.shape and torch.isfinite(y).all()


# ---------------------------------------------------------------------------
# a 350M-shaped LM at a narrow width, seq 16384
# ---------------------------------------------------------------------------

def narrow_350m_config(seq: int = 16384, chunk=None) -> tlm.LMConfig:
    """spectre_350m_config(seq) cut to 2 layers, d=128, 2 heads x 4 groups,
    vocab 256: chunk 2048 (nc = seq / 2048) as at full size unless
    ``chunk`` is given, remat on."""
    cfg = tlm.spectre_350m_config(vocab_size=256, seq=seq)
    block = dataclasses.replace(cfg.block, embed_dim=128, num_heads=2)
    if chunk is not None:
        block = dataclasses.replace(block, causal_chunk=chunk)
    return dataclasses.replace(cfg, num_layers=2, block=block)


def test_bridge_round_trip_at_24_layers():
    """The weight bridge at the 350M's depth (24 stacked layers, 16 heads x
    4 groups; narrow here): bit-exact both ways."""
    cfg = tlm.spectre_350m_config(vocab_size=64, seq=1024)
    cfg = dataclasses.replace(
        cfg, block=dataclasses.replace(cfg.block, embed_dim=64))
    params, model = lm_pair(cfg, seed=2)
    assert len(model.blocks) == 24
    back = to_jax_params(model.state_dict(), cfg)
    flat_a, tree_a = jax.tree.flatten(params)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.shape == b.shape
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


@functools.lru_cache(maxsize=None)
def _narrow_case():
    cfg = narrow_350m_config()
    jcfg = jax_lm_config(cfg)
    params, model = lm_pair(cfg, seed=4)
    batch = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, cfg.max_seq + 1)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, params)
    logits = jax.jit(jlm.lm_apply, static_argnums=1)(jparams, jcfg,
                                                     batch[:, :-1])
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, bt: jtrain.lm_loss(p, jcfg, bt, deterministic=True)))(
            jparams, batch)
    return (cfg, model, batch, np.asarray(logits), float(loss),
            jax.tree.map(np.asarray, grads))


def test_narrow_350m_logits_match_jax():
    cfg, model, batch, ref, _, _ = _narrow_case()
    assert cfg.block.causal_chunk == 2048
    BRANCH_CALLS.clear()
    got = tlm.lm_apply(model, torch.from_numpy(batch[:, :-1]).long())
    assert dict(BRANCH_CALLS) == {"kf_seg": cfg.num_layers}
    assert got.shape == (1, 16384, 256)
    assert rel_err(got.numpy(), ref) < MODEL_TOL


def test_narrow_350m_gradients_match_jax_grad():
    """Loss and every parameter gradient through the rematerialized blocks
    (torch.utils.checkpoint, as jax.checkpoint) against jax.grad."""
    cfg, model, batch, _, jloss, jgrads = _narrow_case()
    model.train()
    try:
        for p in model.parameters():
            p.grad = None
        BRANCH_CALLS.clear()
        loss = lm_loss(model, torch.from_numpy(batch).long())
        loss.backward()
    finally:
        model.eval()
    # the forward once, and its recompute in backward
    assert dict(BRANCH_CALLS) == {"kf_seg": 2 * cfg.num_layers}
    assert abs(float(loss.detach()) - jloss) / abs(jloss) < MODEL_TOL
    ours = jax.tree.leaves(_grad_tree(model, cfg))
    theirs = jax.tree.leaves(jgrads)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        if np.abs(b).max() > 0:
            assert rel_err(a, b) < MODEL_TOL
        else:
            assert np.abs(a).max() == 0


def test_remat_replays_dropout_draws():
    """With remat, the recompute in backward draws the forward's dropout
    masks again (the generator is replayed and then left where the forward
    left it): the loss, every gradient and the generator's next draw equal
    those of the same step without remat (the gradients up to the order of
    their sums: checkpointing accumulates them in another order)."""
    cfg = narrow_350m_config()
    cfg = dataclasses.replace(
        cfg, max_seq=256,
        block=dataclasses.replace(cfg.block, n_fft=256, causal_chunk=128,
                                  dropout_p=0.3))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 257)))
    runs = []
    for remat in (True, False):
        model = tlm.SpectreLM(dataclasses.replace(cfg, remat=remat))
        model.reset_parameters(torch.Generator().manual_seed(1))
        model.train()
        gen = torch.Generator().manual_seed(2)
        loss = lm_loss(model, tokens, generator=gen)
        loss.backward()
        runs.append((float(loss.detach()),
                     [p.grad.clone() for p in model.parameters()
                      if p.grad is not None],
                     torch.rand(4, generator=gen)))
    (la, ga, ra), (lb, gb, rb) = runs
    assert la == lb and torch.equal(ra, rb)
    assert len(ga) == len(gb)
    for a, b in zip(ga, gb):
        assert rel_err(a.numpy(), b.numpy()) < 1e-6


# ---------------------------------------------------------------------------
# module 5b: seq 32768 and 65536 (nc = 16 and 32)
# ---------------------------------------------------------------------------

# (seq, chunk) of the logits: nc = 16 at the 350M's chunk, nc = 32 at
# chunk 1024 (at seq 65536 and chunk 2048 the JAX side alone takes ~50 s
# on the CPU)
LONG_CASES = [(32768, None), (32768, 1024)]
# (seq, chunk) of the gradients: nc = 16 and 32 at chunk 512.  The gate
# MLP's gradients are long sums with cancellation whose fp32 rounding
# grows with n_fft: at seq 32768 they sat at 1.01-1.05e-4 of JAX's (nc 16
# at chunk 2048, nc 32 at chunk 1024), and among the 4.2e6 gate values of
# nc 32 at chunk 1024 some lay within rounding of the modReLU kink, where
# the two frameworks take different sides (5e-4 in modrelu_bias).  The
# card holds the full-size chunk 2048 at nc 16 against this CPU path with
# the kink sides aligned (chip_smoke.py, 350m_long_parity).
LONG_GRAD_CASES = [(8192, 512), (16384, 512)]


@functools.lru_cache(maxsize=None)
def _long_pair(seq, chunk):
    cfg = narrow_350m_config(seq, chunk)
    params, model = lm_pair(cfg, seed=5)
    batch = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, cfg.max_seq + 1)).astype(np.int32)
    return cfg, jax_lm_config(cfg), jax.tree.map(jnp.asarray, params), \
        model, batch


@pytest.mark.parametrize("seq,chunk", LONG_CASES)
def test_narrow_350m_long_logits_match_jax(seq, chunk):
    """The kf_seg branch at nc = 16 and 32 (#9's and #7's plain versions)
    against JAX's logits."""
    cfg, jcfg, jparams, model, batch = _long_pair(seq, chunk)
    nc = seq // cfg.block.causal_chunk
    assert nc in (16, 32)
    ref = jax.jit(jlm.lm_apply, static_argnums=1)(jparams, jcfg,
                                                  batch[:, :-1])
    BRANCH_CALLS.clear()
    got = tlm.lm_apply(model, torch.from_numpy(batch[:, :-1]).long())
    assert dict(BRANCH_CALLS) == {"kf_seg": cfg.num_layers}
    assert rel_err(got.numpy(), np.asarray(ref)) < MODEL_TOL


@pytest.mark.parametrize("seq,chunk", LONG_GRAD_CASES)
def test_narrow_350m_long_gradients_match_jax_grad(seq, chunk):
    """Loss and every gradient at nc = 16 and 32 (#11's plain version),
    where JAX's fp32 backward is its jnp adjoint (_bwd_plan_v3 is None in
    fp32 at the 350M's nc 16 and 32), against jax.grad."""
    cfg, jcfg, jparams, model, batch = _long_pair(seq, chunk)
    assert pc._bwd_plan_v3(16, 2048, 1024, 64, 4, False) is None
    assert pc._bwd_plan_v3(32, 2048, 1024, 64, 4, False) is None
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, bt: jtrain.lm_loss(p, jcfg, bt, deterministic=True)))(
            jparams, batch)
    model.train()
    try:
        for p in model.parameters():
            p.grad = None
        loss = lm_loss(model, torch.from_numpy(batch).long())
        loss.backward()
    finally:
        model.eval()
    jloss = float(jloss)
    assert abs(float(loss.detach()) - jloss) / abs(jloss) < MODEL_TOL
    ours = jax.tree.leaves(_grad_tree(model, cfg))
    theirs = jax.tree.leaves(jax.tree.map(np.asarray, jgrads))
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        if np.abs(b).max() > 0:
            assert rel_err(a, b) < MODEL_TOL
        else:
            assert np.abs(a).max() == 0


@pytest.mark.parametrize("seq", [32768, 65536])
def test_350m_long_prefill_dispatch(seq):
    """The 350M's config at seq 32768 and 65536 gives JAX's chunk (2048);
    a prefill of half the window takes the kf_seg branch (#9, then #7) at
    nc = 8 and 16, where JAX runs its Pallas kernels (at a narrow width
    here: the branch rule does not look at d past its tiling)."""
    cfg = tlm.spectre_350m_config(seq=seq)
    assert cfg.block.causal_chunk == 2048
    assert _jax_runs_a_kernel(seq // 2, 1024, 64, 2048)
    block = narrow_350m_config(seq).block
    mix = SpectreMultiHead(block)
    mix.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn((1, seq // 2, block.embed_dim),
                    generator=torch.Generator().manual_seed(1))
    BRANCH_CALLS.clear()
    with torch.no_grad():
        y = mix(x)
    assert dict(BRANCH_CALLS) == {"kf_seg": 1}
    assert y.shape == x.shape and torch.isfinite(y).all()


@pytest.mark.parametrize("n", [32768, 65536])
@pytest.mark.parametrize("evict", [0, 1])
def test_fused_decode_mix_ref_at_long_windows(n, evict):
    """#12's plain version against the Pallas kernel at the windows of the
    350M at seq 32768 and 65536 (F_half 16385, 32769), at the last ring
    slot and output position, where the phases k j and k pos pass 2^29:
    prefix and y, each on its own."""
    b, h, hd, groups = 1, 2, 8, 2
    j, pos = n - 1, n - 2
    f = n // 2 + 1
    rng = np.random.default_rng(n + evict)
    pre_r, pre_i = (rng.standard_normal((b, h, f, hd)).astype(np.float32)
                    for _ in range(2))
    g_r, g_i = (rng.standard_normal((b, h, groups, f)).astype(np.float32)
                for _ in range(2))
    v_t = rng.standard_normal((b, h, hd)).astype(np.float32)
    v_buf = rng.standard_normal((b, h, n, hd)).astype(np.float32)
    prefix = torch.complex(torch.from_numpy(pre_r), torch.from_numpy(pre_i))
    y = kd.fused_decode_mix_ref(
        prefix, torch.complex(torch.from_numpy(g_r), torch.from_numpy(g_i)),
        torch.from_numpy(v_t), torch.from_numpy(v_buf), evict, j, pos)
    delta = (v_t - evict * v_buf[..., j, :])[..., None, :]
    ph = jax_rfft_phasor(n, j)
    k = jnp.arange(f, dtype=jnp.float32)
    phase = (2.0 * np.pi / n) * k * jnp.float32(pos)
    coef = jnp.full((f,), 2.0).at[0].set(1.0).at[-1].set(1.0)
    w_r = (coef * jnp.cos(phase) / n)[None, :]
    w_i = (-coef * jnp.sin(phase) / n)[None, :]
    want_r, want_i, want_y = pd.fused_decode_mix(
        jnp.asarray(pre_r), jnp.asarray(pre_i),
        jnp.asarray(np.swapaxes(g_r, -1, -2)),
        jnp.asarray(np.swapaxes(g_i, -1, -2)), jnp.asarray(delta),
        jnp.real(ph)[None, :], jnp.imag(ph)[None, :], w_r, w_i,
        interpret=True)
    assert kd.decode_supported(hd, groups)
    assert rel_err(prefix.real.numpy(), np.asarray(want_r)) < KERNEL_TOL
    assert rel_err(prefix.imag.numpy(), np.asarray(want_i)) < KERNEL_TOL
    # y sums 32769 terms of both signs in another order on each side: the
    # decode budget (COMPONENTS.md 2.4)
    assert rel_err(y.numpy(), np.asarray(want_y)[:, :, 0]) < DECODE_TOL


def test_bridge_round_trip_at_seq_65536():
    """The weight bridge with the 350M's position table at seq 65536
    (65536 x d; narrow here), the same parameters in fp32 and bf16 mode:
    bit-exact both ways."""
    cfg = tlm.spectre_350m_config(vocab_size=64, seq=65536)
    cfg = dataclasses.replace(cfg, num_layers=2, block=dataclasses.replace(
        cfg.block, embed_dim=64, compute_dtype="bfloat16"))
    params, model = lm_pair(cfg, seed=6)
    assert model.pos_emb.shape == (65536, 64)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    back = to_jax_params(model.state_dict(), cfg)
    flat_a, tree_a = jax.tree.flatten(params)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.shape == b.shape
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
