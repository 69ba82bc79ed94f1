"""The port's decode path against fft_tpu's on the CPU: kernel #12's plain
version against the Pallas kernel in interpret mode, both decode branches
past the window's wrap, the goldens under ``reference_compat``, the
``window`` and ``consistent`` descriptors, the causal chunk gates of the
DCT and attention poolers and LMs built on them, ``lm_prefill_split``, the
cache bridge, and the non-causal multihead's dispatch.

Both sides get the same numpy-seeded weights through the weight bridge and
the same state through the cache bridge.  Tolerances (max|a-b| / max|b|):
1e-5 for the kernel's plain version and the gates, 2e-5 for decode outputs
(COMPONENTS.md 2.4), 1e-4 for LM logits (layers of fp32 FFT round trips
in other orders)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_tpu.decode.cache as jdc
import fft_tpu.kernels.pallas_decode as pd
import fft_tpu.kernels.pallas_fft as pf
import fft_tpu.layers.spectre as jsp
import fft_tpu.models.lm as jlm
from fft_tpu.kernels.matfft import plan_factors
from fft_tpu.ops import rfft_phasor as jax_rfft_phasor
from fft_tpu_torch.config import SpectreConfig
from fft_tpu_torch.convert import cache_from_jax, cache_to_jax
from fft_tpu_torch.decode import cache as tdc
from fft_tpu_torch.kernels import decode as kd
from fft_tpu_torch.kernels import spectral_mix as sm
from fft_tpu_torch.layers import spectre as tsp
from fft_tpu_torch.models import lm as tlm
from tests.golden_utils import load, map_head_params, rel_err
from tests.test_torch_convert import jax_lm_config, lm_pair
from tests.test_torch_layers import (
    _jax_cfg, _port_mix, _single_head_mix, block_pair,
)

TOL_KERNEL = 1e-5
TOL_DECODE = 2e-5
TOL_LM = 1e-4


@pytest.fixture(params=[True, False], ids=["fused", "plain"])
def port_fused(request):
    """The port's decode branch: kernels.decode.ENABLE on or off."""
    old = kd.ENABLE
    kd.ENABLE = request.param
    yield request.param
    kd.ENABLE = old


def _jax_cache(cache: tdc.PrefixFFTCache):
    return jdc.PrefixFFTCache(**{k: jnp.asarray(v)
                                 for k, v in cache_to_jax(cache).items()})


# ---------------------------------------------------------------------------
# Kernel #12's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd,groups", [(64, 4), (8, 2)])
@pytest.mark.parametrize("evict", [0, 1])
@pytest.mark.parametrize("where", ["start", "middle", "end"])
def test_fused_decode_mix_ref_matches_pallas_kernel(hd, groups, evict,
                                                    where):
    """prefix and y, each on its own, at ring slots and output positions
    near 0, n/2 and n-1."""
    b, h, n = 2, 2, 64
    j, pos = {"start": (0, 1), "middle": (n // 2, n // 2 - 1),
              "end": (n - 1, n - 2)}[where]
    f = n // 2 + 1
    rng = np.random.default_rng(hd + 10 * evict + j)
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

    # the JAX package's fused branch (decode/cache.py:222-259) forms these
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
    assert rel_err(prefix.real.numpy(), np.asarray(want_r)) < TOL_KERNEL
    assert rel_err(prefix.imag.numpy(), np.asarray(want_i)) < TOL_KERNEL
    assert rel_err(y.numpy(), np.asarray(want_y)[:, :, 0]) < TOL_KERNEL


# ---------------------------------------------------------------------------
# Block decode past the window's wrap: both branches on both sides
# ---------------------------------------------------------------------------

_WRAP_CFG = dict(embed_dim=128, num_heads=2, n_fft=64, pooling_type="mean",
                 wavelet_on_rate=0.0, memory_size=8)
_WRAP_STEPS = 70


@functools.lru_cache(maxsize=None)
def _jax_block_trajectory(fused: bool):
    """tests/test_pallas_decode.py's run: prefill 64 tokens, then 70 steps
    each fed the previous output, with the JAX package's fused (Pallas
    kernel, interpreted) or plain branch."""
    cfg = SpectreConfig(**_WRAP_CFG)
    params, _ = block_pair(cfg, seed=3)
    jcfg = _jax_cfg(cfg)
    params = jax.tree.map(jnp.asarray, params)
    x = _wrap_prompt()
    old = (pd.INTERPRET, pd.ENABLE)
    try:
        pd.INTERPRET, pd.ENABLE = fused, fused
        step = jax.jit(lambda p, xt, c: jdc.spectre_block_decode_step(
            p, jcfg, xt, c))
        cache = jdc.spectre_block_prefill(
            params, jcfg, jnp.asarray(x),
            jdc.cache_init(2, cfg.num_heads, cfg.n_fft, cfg.head_dim))
        xt, outs = jnp.asarray(x[:, -1]), []
        for _ in range(_WRAP_STEPS):
            xt, cache = step(params, xt, cache)
            outs.append(np.asarray(xt))
    finally:
        pd.INTERPRET, pd.ENABLE = old
    return np.stack(outs), jax.tree.map(np.asarray, cache)


def _wrap_prompt():
    return np.random.default_rng(4).standard_normal((2, 64, 128)).astype(
        np.float32)


@pytest.mark.parametrize("jax_fused", [True, False],
                         ids=["jax_fused", "jax_plain"])
def test_block_decode_past_the_wrap_matches_jax(port_fused, jax_fused):
    """Eviction runs from step 1 on: the outputs, the final prefix and the
    query sum."""
    cfg = SpectreConfig(**_WRAP_CFG)
    _, block = block_pair(cfg, seed=3)
    x = torch.from_numpy(_wrap_prompt())
    before = kd.LAUNCHES["fused_decode_mix"]
    with torch.no_grad():
        cache = tdc.spectre_block_prefill(
            block, x, tdc.cache_init(2, cfg.num_heads, cfg.n_fft,
                                     cfg.head_dim))
        xt, outs = x[:, -1], []
        for _ in range(_WRAP_STEPS):
            xt, cache = tdc.spectre_block_decode_step(block, xt, cache)
            outs.append(xt.numpy())
    # on the CPU the fused branch runs the plain version: no launch
    assert kd.LAUNCHES["fused_decode_mix"] == before
    want, want_cache = _jax_block_trajectory(jax_fused)
    assert cache.t == int(want_cache.t) == 64 + _WRAP_STEPS - 1
    assert rel_err(np.stack(outs), want) < TOL_DECODE
    assert rel_err(cache.prefix.real.numpy(), want_cache.prefix_re) < \
        TOL_DECODE
    assert rel_err(cache.prefix.imag.numpy(), want_cache.prefix_im) < \
        TOL_DECODE
    assert rel_err(cache.sum_q.numpy(), want_cache.sum_q) < TOL_DECODE


# ---------------------------------------------------------------------------
# The original's goldens (reference_compat)
# ---------------------------------------------------------------------------

def test_decode_golden_parity_reference_compat(port_fused):
    """tests/test_decode.py's golden decode loop: the Nyquist sign, the
    frozen query sum and the original's interpolation; reference_compat
    takes the plain branch whatever ENABLE says."""
    g = load("decode")
    cfg = SpectreConfig(embed_dim=16, num_heads=1, n_fft=32,
                        pooling_type="mean", wavelet_on_rate=0.0,
                        interp_reference_compat=True)
    head = map_head_params(g, cfg.head_config())
    mix = _port_mix(_single_head_mix(
        jax.tree.map(lambda a: np.asarray(a)[None], head), 16), cfg)
    prompt = g["prompt"]
    w_q, w_v = np.asarray(head["w_q"]["w"]), np.asarray(head["w_v"]["w"])
    cache = tdc.cache_prefill(
        tdc.cache_init(1, 1, 32, 16),
        torch.from_numpy(prompt @ w_q)[None, None],
        torch.from_numpy(prompt @ w_v)[None, None])
    with torch.no_grad():
        for i in range(g["extra"].shape[0]):
            y, cache = tdc.spectre_multihead_decode_step(
                mix, torch.from_numpy(g["extra"][i])[None], cache,
                reference_compat=True)
            assert rel_err(y[0].numpy(), g["outs"][i]) < TOL_DECODE, i
            assert rel_err(cache.prefix[0, 0].numpy(),
                           g["cache_fft"][i]) < TOL_DECODE, i


def test_pruned_irfft_reference_compat_sign():
    """pruned_irfft_single at an even and an odd position, both modes,
    against JAX's (the modes differ at odd positions only)."""
    rng = np.random.default_rng(0)
    x = torch.complex(*(torch.from_numpy(
        rng.standard_normal((17, 3)).astype(np.float32)) for _ in range(2)))
    from fft_tpu.ops import pruned_irfft_single as jax_pruned
    from fft_tpu_torch.ops import pruned_irfft_single
    for pos in (4, 7):
        for compat in (False, True):
            got = pruned_irfft_single(x, 32, pos, reference_compat=compat)
            want = jax_pruned(jnp.asarray(x.numpy()), 32, pos,
                              reference_compat=compat)
            assert rel_err(got.numpy(), np.asarray(want)) < TOL_KERNEL


# ---------------------------------------------------------------------------
# The window and consistent descriptors
# ---------------------------------------------------------------------------

def _desc_cfg(pooling, descriptor="window", **kw):
    base = dict(embed_dim=32, num_heads=4, n_fft=16, pooling_type=pooling,
                wavelet_on_rate=0.0, decode_descriptor=descriptor,
                memory_size=0, fft_impl="auto")
    base.update(kw)
    return SpectreConfig(**base)


def _mix_prefill(mix, x):
    """Prefill of the multihead's projections (no LayerNorm)."""
    b, n, d = x.shape
    h, hd = mix.cfg.num_heads, mix.cfg.head_dim
    xh = x.reshape(b, n, h, hd)
    q = tsp._heads_linear(xh, mix.heads.w_q).transpose(1, 2)
    v = tsp._heads_linear(xh, mix.heads.w_v).transpose(1, 2)
    return tdc.cache_prefill(tdc.cache_init(b, h, mix.cfg.n_fft, hd), q, v)


@pytest.mark.parametrize("pooling", ["attention", "dct"])
def test_window_descriptor_decode_equals_forward(port_fused, pooling):
    """tests/test_decode.py:108 for the port: with the window descriptor
    each decoded token equals the forward on its window's last position,
    for the attention and the DCT pooler (rolled weights, past the wrap)."""
    cfg = _desc_cfg(pooling)
    _, block = block_pair(cfg, seed=11)
    mix, n = block.mix, cfg.n_fft
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (2, n + 5, 32)).astype(np.float32) * 0.5)
    with torch.no_grad():
        cache = _mix_prefill(mix, x[:, :n])
        for i in range(5):
            y, cache = tdc.spectre_multihead_decode_step(mix, x[:, n + i],
                                                         cache)
            fwd = mix(x[:, i + 1:n + i + 1])
            assert rel_err(y.numpy(), fwd[:, -1].numpy()) < 5e-5, i


@pytest.mark.parametrize("pooling,descriptor", [
    ("attention", "window"), ("dct", "window"), ("mean", "window"),
    ("mean", "consistent")])
def test_descriptors_match_jax_step_by_step(port_fused, pooling,
                                            descriptor):
    """From a 5-token prefill (zeros in the unfilled slots) through the
    window's wrap at t = 16: each step's descriptor against JAX's
    _decode_descriptor and its output against JAX's step."""
    cfg = _desc_cfg(pooling, descriptor)
    params, block = block_pair(cfg, seed=13)
    mix, jcfg = block.mix, _jax_cfg(cfg)
    jmix = jax.tree.map(jnp.asarray, params["mix"])
    x = np.random.default_rng(14).standard_normal((2, 20, 32)).astype(
        np.float32)
    with torch.no_grad():
        cache = _mix_prefill(mix, torch.from_numpy(x[:, :5]))
        jcache = _jax_cache(cache)
        step = jax.jit(lambda p, xt, c: jdc.spectre_multihead_decode_step(
            p, jcfg, xt, c))
        for i in range(5, 20):
            y, cache = tdc.spectre_multihead_decode_step(
                mix, torch.from_numpy(x[:, i]), cache)
            want, jcache = step(jmix, jnp.asarray(x[:, i]), jcache)
            assert rel_err(y.numpy(), np.asarray(want)) < TOL_DECODE, i
            descr = tdc._decode_descriptor(mix.heads, cache)
            jdescr = jdc._decode_descriptor(jmix["heads"], jcfg.head_config(),
                                            jcache)
            assert rel_err(descr.numpy(), np.asarray(jdescr)) < TOL_DECODE, i


@pytest.mark.parametrize("impl", ["jnp", "matmul"])
def test_decode_step_with_each_fft_impl_matches_jax(impl):
    """A decode step built with JAX's other fft_impl values, from a
    5-token prefill through the wrap, against JAX's step with the same
    value (both on the plain branch: JAX fuses only under "pallas" and
    "auto", decode/cache.py:214-216).  1e-5 for "jnp"; for "matmul" 1e-5
    or twice JAX's own "matmul"-to-"jnp" distance, where larger."""
    cfg = _desc_cfg("mean", fft_impl=impl)
    params, block = block_pair(cfg, seed=15)
    mix = block.mix
    jmix = jax.tree.map(jnp.asarray, params["mix"])
    steps = [jax.jit(lambda p, xt, cache, c=c:
                     jdc.spectre_multihead_decode_step(p, c, xt, cache))
             for c in (_jax_cfg(cfg), _jax_cfg(_desc_cfg("mean",
                                                         fft_impl="jnp")))]
    x = np.random.default_rng(16).standard_normal((2, 20, 32)).astype(
        np.float32)
    with torch.no_grad():
        cache = _mix_prefill(mix, torch.from_numpy(x[:, :5]))
        jcaches = [_jax_cache(cache)] * 2
        for i in range(5, 20):
            y, cache = tdc.spectre_multihead_decode_step(
                mix, torch.from_numpy(x[:, i]), cache)
            outs = []
            for k, step in enumerate(steps):
                out, jcaches[k] = step(jmix, jnp.asarray(x[:, i]),
                                       jcaches[k])
                outs.append(np.asarray(out))
            tol = max(TOL_KERNEL, 2 * rel_err(outs[0], outs[1]))
            assert rel_err(y.numpy(), outs[0]) < tol, i


@pytest.mark.parametrize("impl,launches", [
    ("auto", 1), ("pallas", 1), ("jnp", 0), ("matmul", 0)])
def test_decode_kernel_launches_only_where_jax_fuses(impl, launches,
                                                     monkeypatch):
    """#12 launches once a step under "auto" and "pallas" and never under
    "jnp" or "matmul", counted by the wrapper as on the card (its launch
    replaced by a counter: the kernel is CUDA only)."""
    monkeypatch.setattr(kd, "on_cpu", lambda *t: False)
    monkeypatch.setattr(kd, "launch", lambda counts, name, *a, **k:
                        counts.__setitem__(name, counts[name] + 1))
    kd.reset_launches()
    cfg = _desc_cfg("mean", fft_impl=impl)
    _, block = block_pair(cfg, seed=17)
    with torch.no_grad():
        x = torch.zeros(1, 6, 32)
        cache = _mix_prefill(block.mix, x[:, :5])
        tdc.spectre_multihead_decode_step(block.mix, x[:, 5], cache)
    assert kd.LAUNCHES["fused_decode_mix"] == launches
    kd.reset_launches()


# ---------------------------------------------------------------------------
# Causal chunk gates of the DCT and attention poolers, and LMs on them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pooling", ["dct", "attention", "mean"])
@pytest.mark.parametrize("n,chunk", [(50, 64), (50, 16), (62, 4)])
def test_causal_chunk_gates_match_jax(pooling, n, chunk):
    """nc = 1, 4 and 16 chunks, each with n < nc * chunk (a padded tail)."""
    cfg = _desc_cfg(pooling, causal=True, n_fft=64, causal_chunk=chunk,
                    embed_dim=64, num_heads=2)
    params, block = block_pair(cfg, seed=n + chunk)
    nc = -(-n // chunk)
    hcfg = cfg.head_config()
    q = np.random.default_rng(chunk).standard_normal((2, n, 2, 32)).astype(
        np.float32)
    with torch.no_grad():
        got = tsp.causal_chunk_gates(block.mix.heads, hcfg,
                                     torch.from_numpy(q), nc, chunk)
    jhcfg = _jax_cfg(cfg).head_config()
    want = jax.jit(jax.vmap(
        lambda hp, qh: jsp.causal_chunk_gates(hp, jhcfg, qh, nc, chunk),
        in_axes=(0, 2), out_axes=2))(
            jax.tree.map(jnp.asarray, params["mix"]["heads"]),
            jnp.asarray(q))
    assert got.shape == (2, nc, 2, cfg.num_groups, cfg.f_half)
    assert rel_err(got.numpy(), np.asarray(want)) < TOL_KERNEL


def _pooler_lm_config(pooling: str) -> tlm.LMConfig:
    return tlm.LMConfig(
        vocab_size=64, num_layers=2, max_seq=128,
        block=SpectreConfig(
            embed_dim=128, num_heads=2, n_fft=128, pooling_type=pooling,
            wavelet_on_rate=0.0, causal=True, causal_chunk=16,
            memory_size=8, decode_descriptor="window"))


@pytest.mark.parametrize("pooling", ["dct", "attention"])
def test_causal_pooler_lm_and_window_decode_match_jax(port_fused, pooling):
    """A 2-layer causal LM with the DCT or attention pooler: lm_apply, then
    a 64-token prefill and 8 teacher-forced decode steps with the window
    descriptor."""
    cfg = _pooler_lm_config(pooling)
    params, model = lm_pair(cfg, seed=21)
    jcfg = jax_lm_config(cfg)
    params = jax.tree.map(jnp.asarray, params)
    toks = np.random.default_rng(22).integers(0, 64, (2, 128)).astype(
        np.int32)
    got = tlm.lm_apply(model, torch.from_numpy(toks).long()).numpy()
    want = jax.jit(jlm.lm_apply, static_argnums=1)(params, jcfg, toks)
    assert rel_err(got, np.asarray(want)) < TOL_LM

    n = 64
    logits, caches = tlm.lm_prefill(model, torch.from_numpy(toks[:, :n])
                                    .long())
    ref_logits, ref_caches = jax.jit(jlm.lm_prefill, static_argnums=1)(
        params, jcfg, toks[:, :n])
    assert rel_err(logits.numpy(), np.asarray(ref_logits)) < TOL_LM
    step = jax.jit(jlm.lm_decode_step, static_argnums=1)
    for i in range(8):
        pos = n + i
        ref_logits, ref_caches = step(params, jcfg, toks[:, pos], pos,
                                      ref_caches)
        logits, caches = tlm.lm_decode_step(
            model, torch.from_numpy(toks[:, pos]).long(), pos, caches)
        assert rel_err(logits.numpy(), np.asarray(ref_logits)) < TOL_LM, i


# ---------------------------------------------------------------------------
# lm_prefill_split, the cache bridge, eviction drift
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _split_lm():
    cfg = tlm.LMConfig(
        vocab_size=64, num_layers=3, max_seq=128,
        block=SpectreConfig(embed_dim=32, num_heads=4, n_fft=128,
                            pooling_type="mean", wavelet_on_rate=0.0,
                            causal=True, causal_chunk=16))
    params, model = lm_pair(cfg, seed=5)
    toks = np.random.default_rng(6).integers(0, 64, (2, 100)).astype(
        np.int32)
    return cfg, jax.tree.map(jnp.asarray, params), model, toks


def test_lm_prefill_split_matches_lm_prefill_and_jax():
    cfg, params, model, toks = _split_lm()
    t = torch.from_numpy(toks).long()
    logits_a, caches_a = tlm.lm_prefill(model, t)
    logits_b, caches_b = tlm.lm_prefill_split(model, t)
    assert torch.equal(logits_a, logits_b)
    for a, b in zip(caches_a, caches_b):
        assert a.t == b.t
        for name in ("prefix", "v_buf", "q_buf", "sum_q"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
    ref_logits, ref_caches = jlm.lm_prefill_split(params, jax_lm_config(cfg),
                                                  toks)
    assert rel_err(logits_b.numpy(), np.asarray(ref_logits)) < TOL_LM
    mine = cache_to_jax(caches_b)
    for name in mine:
        assert rel_err(mine[name], np.asarray(getattr(ref_caches, name))) \
            < TOL_LM, name


def test_cache_bridge_round_trip_is_bit_exact():
    """JAX's stacked caches -> the port's list -> back, and one layer's."""
    cfg, params, _, toks = _split_lm()
    _, caches = jax.jit(jlm.lm_prefill, static_argnums=1)(
        params, jax_lm_config(cfg), toks)
    ours = cache_from_jax(caches)
    assert len(ours) == cfg.num_layers
    assert ours[0].prefix.dtype == torch.complex64 and ours[0].t == 99
    back = cache_to_jax(ours)
    one = cache_to_jax(cache_from_jax(jax.tree.map(lambda a: a[1], caches)))
    for name in jdc.PrefixFFTCache._fields:
        want = np.asarray(getattr(caches, name))
        assert back[name].dtype == want.dtype and np.array_equal(
            back[name], want), name
        assert np.array_equal(one[name], want[1]), name


def test_eviction_drift_bounded(port_fused):
    """tests/test_decode.py:132 for the port, 200 steps past the window:
    the running spectrum stays the exact rFFT of the ring buffer, through
    cache_decode_step or through the kernel's plain version."""
    n, d = 16, 4
    tokens = np.random.default_rng(0).standard_normal((n + 200, d)).astype(
        np.float32)
    first = torch.from_numpy(tokens[:n])[None, None]
    cache = tdc.cache_prefill(tdc.cache_init(1, 1, n, d), first, first)
    gate = torch.ones((1, 1, 1, n // 2 + 1), dtype=torch.complex64)
    for i in range(n, n + 200):
        tok = torch.from_numpy(tokens[i])[None, None]
        if port_fused:
            t, j, evict = tdc._step_slot(cache)
            kd.fused_decode_mix(cache.prefix, gate, tok, cache.v_buf, evict,
                                j, j)
            cache.v_buf[..., j, :] = tok
            tdc._append_query(cache, tok, t, j, evict, False)
        else:
            cache = tdc.cache_decode_step(cache, tok, tok)
    t = n + 200 - 1
    window = np.stack([tokens[t - ((t - s) % n)] for s in range(n)])
    assert rel_err(cache.prefix[0, 0].numpy(),
                   np.fft.rfft(window, axis=0)) < 1e-4
    assert torch.equal(cache.v_buf[0, 0], torch.from_numpy(window))


# ---------------------------------------------------------------------------
# The non-causal multihead's dispatch (fft_impl="pallas")
# ---------------------------------------------------------------------------

def _jax_branch(n_fft: int, d: int) -> str:
    """fft_tpu/layers/spectre.py:433-449 on the card, with
    pf.TWOPASS_ENABLE as it is set."""
    if pf.pallas_mix_supported(n_fft) and d % 128 == 0:
        return "fused"
    if n_fft >= 16384 and d % 128 == 0 and plan_factors(n_fft) is not None:
        return "wide"
    return "per_head"


def _twopass_flags(monkeypatch, on: bool) -> None:
    """The reference's TWOPASS_ENABLE and the port's, both set to ``on``."""
    monkeypatch.setattr(pf, "TWOPASS_ENABLE", on)
    monkeypatch.setattr(sm, "TWOPASS_ENABLE", on)


def test_reference_dispatch_predicates_are_the_references(monkeypatch):
    """With both TWOPASS_ENABLE flags off, then both on."""
    sizes = list(range(4, 600)) + [1000, 1024, 2304, 4096, 4352, 6000, 7936,
                                   8192, 8194, 16384, 16386, 3 * 8192,
                                   17 * 1024, 32768, 65536, 131072,
                                   2 * 257 * 64, 2 * 131 * 128]
    for on in (False, True):
        _twopass_flags(monkeypatch, on)
        for n in sizes:
            assert (sm.mix_kernel(n) is not None) == \
                pf.pallas_mix_supported(n), (n, on)
            assert tsp._reference_plan_exists(n) == \
                (plan_factors(n) is not None), n


@pytest.mark.parametrize("n_fft,d,heads", [(1024, 512, 8), (1024, 96, 3),
                                           (16384, 256, 2), (4352, 256, 2),
                                           (32768, 128, 2)])
def test_multihead_dispatch_matches_jax_rule(n_fft, d, heads, monkeypatch):
    """With both TWOPASS_ENABLE flags off, then both on."""
    cfg = SpectreConfig(embed_dim=d, num_heads=heads, n_fft=n_fft,
                        pooling_type="mean", wavelet_on_rate=0.0,
                        memory_size=0, fft_impl="pallas")
    mix = tsp.SpectreMultiHead(cfg)
    mix.reset_parameters(torch.Generator().manual_seed(0))
    for on in (False, True):
        _twopass_flags(monkeypatch, on)
        tsp.MIX_BRANCH_CALLS.clear()
        with torch.no_grad():
            mix.eval()(torch.zeros(1, 16, d))
        assert dict(tsp.MIX_BRANCH_CALLS) == {_jax_branch(n_fft, d): 1}, on


def test_wide_branch_block_matches_jax():
    """The n_fft 16384 block with fft_impl="pallas": JAX's d-wide matmul
    composition against the port's (cuFFT on the card; the plain FFT
    here), memory and all."""
    cfg = SpectreConfig(embed_dim=128, num_heads=2, n_fft=16384,
                        pooling_type="mean", wavelet_on_rate=0.0,
                        memory_size=8, fft_impl="pallas")
    params, block = block_pair(cfg, seed=9)
    x = np.random.default_rng(10).standard_normal((1, 96, 128)).astype(
        np.float32)
    tsp.MIX_BRANCH_CALLS.clear()
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    assert dict(tsp.MIX_BRANCH_CALLS) == {"wide": 1}
    want = jax.jit(jsp.spectre_block_apply, static_argnums=1)(
        jax.tree.map(jnp.asarray, params), _jax_cfg(cfg), jnp.asarray(x))
    assert rel_err(got, np.asarray(want)) < TOL_KERNEL

