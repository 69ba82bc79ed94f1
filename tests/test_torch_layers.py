"""The non-causal SPECTRE head, multihead and block of fft_tpu_torch against
fft_tpu on the CPU: the same numpy-seeded weights (through the block
bridge) and inputs through both, the Pallas kernels in interpret mode as
tests/test_pallas_mix.py runs them; and against the original's goldens in
tests/golden/ with the bound of tests/test_layers_golden.py.  Forward
parity within 1e-5, gradients against jax.grad within 1e-4 (max|a-b| /
max|b|, fp32 on both sides)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_tpu.kernels.pallas_fft as pf
import fft_tpu.layers.spectre as jsp
from fft_tpu.config import SpectreConfig as JaxSpectreConfig
from fft_tpu_torch import bench, cli
from fft_tpu_torch.config import SpectreConfig
from fft_tpu_torch.convert import block_from_jax_params, block_to_jax_params
from fft_tpu_torch.kernels import spectral_mix as sm
from fft_tpu_torch.layers import attention as tattn
from fft_tpu_torch.layers import spectre as tsp
from fft_tpu_torch.layers.causal_seg import BRANCH_CALLS
from fft_tpu_torch.models import hybrid as thy
from fft_tpu_torch.models import lm as tlm
from fft_tpu_torch.models import vit as tvit
from fft_tpu_torch.parallel import comm, dist_fft, make_mesh
from fft_tpu_torch.utils import prof
from tests.golden_utils import (
    load, map_block_params, map_head_params, map_multihead_params, rel_err,
)
from tests.test_torch_convert import _leaf_init
from tests.torch_parallel_worker import one_rank_group

TOL = 1e-5
GRAD_TOL = 1e-4
# the attention pooler's softmax is invariant to its scorer's output bias
_ZERO_GRADS = {"mix.heads.pool_fc2_b"}


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = pf.INTERPRET
    pf.INTERPRET = True
    yield
    pf.INTERPRET = old


def _jax_cfg(cfg: SpectreConfig) -> JaxSpectreConfig:
    return JaxSpectreConfig(**dataclasses.asdict(cfg))


def block_pair(cfg: SpectreConfig, seed: int = 0):
    """(JAX block params as numpy, port block in eval mode) holding the
    same numpy-seeded weights, bridged by block_from_jax_params."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: jsp.spectre_block_init(jax.random.key(0), _jax_cfg(cfg)))
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: _leaf_init(path, s.shape, rng).astype(np.float32),
        shapes)
    block = tsp.SpectreBlock(cfg)
    block.load_state_dict(block_from_jax_params(params, cfg), strict=True)
    return params, block.eval()


def _cfg(**kw) -> SpectreConfig:
    base = dict(embed_dim=128, num_heads=2, n_fft=64, pooling_type="mean",
                wavelet_on_rate=0.0, memory_size=8, fft_impl="pallas")
    base.update(kw)
    return SpectreConfig(**base)


def _x(n, d=128, seed=1):
    return np.random.default_rng(seed).standard_normal((2, n, d)).astype(
        np.float32)


def _jax_block_apply(params, cfg, x):
    return np.asarray(jax.jit(jsp.spectre_block_apply, static_argnums=1)(
        params, _jax_cfg(cfg), jnp.asarray(x)))


def _jax_grads(params, cfg, x):
    """jax.grad of sum(block(x)^2), bridged into the port's names."""
    jcfg = _jax_cfg(cfg)
    grads = jax.jit(jax.grad(
        lambda p: jnp.sum(jsp.spectre_block_apply(p, jcfg, jnp.asarray(x))
                          ** 2)))(params)
    return block_from_jax_params(jax.tree.map(np.asarray, grads), cfg)


def _check_grads(params, block, cfg, x, tol=GRAD_TOL):
    """Every parameter gradient of sum(block(x)^2) against jax.grad (within
    ``tol``); the JAX gradient tree goes through the same bridge.  A
    parameter the port's graph does not reach (the wavelet MLP at rate 0)
    must have a zero JAX gradient."""
    ref = _jax_grads(params, cfg, x)
    block.zero_grad(set_to_none=True)
    (block(torch.from_numpy(x)) ** 2).sum().backward()
    scale = max(float(r.abs().max()) for r in ref.values())
    for name, p in block.named_parameters():
        if p.grad is None:
            assert float(ref[name].abs().max()) == 0.0, name
        elif name in _ZERO_GRADS:
            # zero in exact arithmetic: both sides hold rounding only
            assert max(float(p.grad.abs().max()),
                       float(ref[name].abs().max())) < tol * scale
        else:
            assert rel_err(p.grad.numpy(), ref[name].numpy()) < tol, name


@pytest.mark.parametrize("n", [64, 50])
def test_block_forward_and_grads_match_pallas_path(n):
    """The BASELINE config-1 path at a small size: fused all-heads mix
    (fft_impl="pallas"), mean pooling, memory of 8 bins; n=50 runs the
    zero-padded short sequence."""
    cfg = _cfg()
    params, block = block_pair(cfg, seed=n)
    x = _x(n)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    assert rel_err(got, _jax_block_apply(params, cfg, x)) < TOL
    _check_grads(params, block, cfg, x)


_VARIANTS = {
    "dct": dict(pooling_type="dct"),
    "attention_fullmem": dict(pooling_type="attention", memory_size=1),
    "toeplitz_interp_compat": dict(use_toeplitz=True,
                                   interp_reference_compat=True,
                                   fft_impl="auto"),
    "wavelet_on": dict(pooling_type="dct", wavelet_on_rate=1.0),
    "wavelet_ref_compat": dict(wavelet_on_rate=1.0,
                               wavelet_reference_compat=True,
                               fft_impl="auto"),
    "per_head_mem16": dict(fft_impl="auto", memory_size=16),
    "spectre_defaults": dict(pooling_type="dct", wavelet_on_rate=0.1,
                             memory_size=0, fft_impl="auto"),
}


@pytest.mark.parametrize("name", sorted(_VARIANTS))
def test_block_variants_match_jax(name):
    """Each pooler, the Toeplitz gate, the original's interpolation, the
    wavelet branch (always on; at the default rate 0.1 it is off outside
    training, as JAX's deterministic=True) and the per-head branch."""
    cfg = _cfg(**_VARIANTS[name])
    params, block = block_pair(cfg, seed=len(name))
    n = 64 if cfg.wavelet_reference_compat else 50
    x = _x(n, seed=2)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    assert rel_err(got, _jax_block_apply(params, cfg, x)) < TOL
    _check_grads(params, block, cfg, x)


@pytest.mark.parametrize("impl", ["jnp", "matmul"])
@pytest.mark.parametrize("causal", [False, True], ids=["noncausal",
                                                      "causal"])
def test_block_fft_impl_matches_jax(impl, causal):
    """A block built with JAX's other fft_impl values, forward and every
    gradient against JAX's block with the same value.  The port runs
    torch.fft for both (the per-head branch; the causal one on the plain
    composition, as JAX's, which runs no kernel under them).  "jnp": 1e-5
    on the output and on each gradient; "matmul" (JAX's MXU DFT matmuls):
    1e-5, or twice JAX's own "matmul"-to-"jnp" distance on the same inputs
    where that is larger."""
    extra = dict(causal=True, causal_chunk=16, memory_size=0) if causal \
        else {}
    cfg = _cfg(fft_impl=impl, **extra)
    params, block = block_pair(cfg, seed=21)
    x = _x(64, seed=22)
    want = _jax_block_apply(params, cfg, x)
    tol = grad_tol = TOL
    if impl == "matmul":
        jnp_cfg = dataclasses.replace(cfg, fft_impl="jnp")
        tol = max(tol, 2 * rel_err(want, _jax_block_apply(params, jnp_cfg,
                                                          x)))
        ref, ref_jnp = (_jax_grads(params, c, x) for c in (cfg, jnp_cfg))
        grad_tol = max([grad_tol] + [2 * rel_err(ref[k].numpy(),
                                                 ref_jnp[k].numpy())
                                     for k in ref
                                     if float(ref_jnp[k].abs().max()) > 0])
    tsp.MIX_BRANCH_CALLS.clear()
    BRANCH_CALLS.clear()
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    assert rel_err(got, want) < tol
    if causal:
        assert dict(BRANCH_CALLS) == {"composition": 1}
    else:
        assert dict(tsp.MIX_BRANCH_CALLS) == {"per_head": 1}
    _check_grads(params, block, cfg, x, grad_tol)


def test_fft_impl_outside_jax_values_raises():
    with pytest.raises(ValueError, match="fft_impl"):
        tsp.SpectreBlock(_cfg(fft_impl="cufft"))


@pytest.mark.parametrize("impl", ["auto", "pallas"])
@pytest.mark.parametrize("batched", [False, True])
def test_multihead_pos_phase_matches_jax(impl, batched):
    cfg = _cfg(fft_impl=impl)
    params, block = block_pair(cfg, seed=3)
    x = _x(64, seed=4)
    rng = np.random.default_rng(5)
    shape = (2, cfg.f_half) if batched else (cfg.f_half,)
    ph = np.exp(1j * rng.uniform(-np.pi, np.pi, shape)).astype(np.complex64)
    ref = np.asarray(jsp.spectre_multihead_apply(
        params["mix"], _jax_cfg(cfg), jnp.asarray(x),
        pos_phase=jnp.asarray(ph)))
    with torch.no_grad():
        got = block.mix(torch.from_numpy(x),
                        pos_phase=torch.from_numpy(ph)).numpy()
    assert rel_err(got, ref) < TOL


def test_training_mode_randomness_comes_from_the_generator():
    """Dropout and the wavelet on-mask draw only under .train(), from the
    generator: same seed, same output; eval mode is the JAX default
    (deterministic: no dropout, wavelet at rate < 1 off)."""
    cfg = _cfg(dropout_p=0.3, wavelet_on_rate=0.5)
    params, block = block_pair(cfg, seed=6)
    x = torch.from_numpy(_x(64, seed=7))
    with torch.no_grad():
        ref = block(x).numpy()
        block.train()
        a = block(x, generator=torch.Generator().manual_seed(1))
        b = block(x, generator=torch.Generator().manual_seed(1))
        c = block(x, generator=torch.Generator().manual_seed(2))
        with pytest.raises(ValueError, match="Generator"):
            block(x)
    assert rel_err(ref, _jax_block_apply(params, cfg, x.numpy())) < TOL
    assert torch.equal(a, b) and not torch.equal(a, c)


# ---------------------------------------------------------------------------
# The original's goldens (tests/golden/, mapped by tests/golden_utils.py)
# ---------------------------------------------------------------------------

def _neutral_block_tree(mix_tree, d):
    """A block tree around a multihead tree; its LayerNorms and MLP are
    never run by these tests."""
    ln = {"scale": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)}
    fc = {"w": np.zeros((d, 4 * d), np.float32),
          "b": np.zeros(4 * d, np.float32)}
    fc2 = {"w": np.zeros((4 * d, d), np.float32),
           "b": np.zeros(d, np.float32)}
    return {"ln1": ln, "ln2": ln, "mix": mix_tree,
            "mlp": {"fc1": fc, "fc2": fc2}}


def _port_mix(mix_tree, cfg: SpectreConfig):
    block = tsp.SpectreBlock(cfg)
    tree = jax.tree.map(np.asarray,
                        _neutral_block_tree(mix_tree, cfg.embed_dim))
    block.load_state_dict(block_from_jax_params(tree, cfg), strict=True)
    return block.mix.eval()


def _single_head_mix(head, d):
    """A multihead tree around one head's (stacked) tree; its output
    projection and wavelet MLP are never run by these tests."""
    fc = {"w": np.zeros((d, d), np.float32), "b": np.zeros(d, np.float32)}
    return {"heads": head, "out_proj": {"w": np.eye(d, dtype=np.float32)},
            "wavelet": {"fc1": fc, "fc2": fc}}


@pytest.mark.parametrize("tag,pooling", [
    ("mean_96", "mean"), ("mean_128", "mean"), ("attn_96", "attention"),
])
def test_head_golden(tag, pooling):
    g = load(f"head_{tag}")
    cfg = SpectreConfig(embed_dim=16, num_heads=1, n_fft=128,
                        pooling_type=pooling, wavelet_on_rate=0.0,
                        interp_reference_compat=True)
    hcfg = cfg.head_config()
    head = jax.tree.map(lambda a: np.asarray(a)[None],
                        map_head_params(g, hcfg))
    mix = _port_mix(_single_head_mix(head, 16), cfg)
    x = torch.from_numpy(g["x"])[:, :, None]
    mem = torch.from_numpy(g["memory"])[:, None]
    with torch.no_grad():
        out, q_pool = tsp.spectre_head_apply(mix.heads, mix.heads.cfg, x,
                                             memory_fft=mem)
        out_nomem, _ = tsp.spectre_head_apply(mix.heads, mix.heads.cfg, x)
    assert rel_err(q_pool[:, 0].numpy(), g["q_pool"]) < TOL
    assert rel_err(out[:, :, 0].numpy(), g["out"]) < TOL
    assert rel_err(out_nomem[:, :, 0].numpy(), g["out_nomem"]) < TOL


def test_head_golden_pos_phase():
    g = load("head_posphase")
    cfg = SpectreConfig(embed_dim=16, num_heads=1, n_fft=64,
                        pooling_type="mean", wavelet_on_rate=0.0,
                        interp_reference_compat=True)
    head = jax.tree.map(lambda a: np.asarray(a)[None],
                        map_head_params(g, cfg.head_config()))
    mix = _port_mix(_single_head_mix(head, 16), cfg)
    with torch.no_grad():
        out, _ = tsp.spectre_head_apply(
            mix.heads, mix.heads.cfg, torch.from_numpy(g["x"])[:, :, None],
            pos_phase=torch.from_numpy(g["pos_phase"])[None])
    assert rel_err(out[:, :, 0].numpy(), g["out"]) < TOL


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_multihead_golden_no_wavelet(impl):
    g = load("multihead_nowave")
    cfg = SpectreConfig(embed_dim=64, num_heads=4, n_fft=128,
                        pooling_type="mean", wavelet_on_rate=0.0,
                        fft_impl=impl, interp_reference_compat=True)
    mix = _port_mix(map_multihead_params(g, cfg), cfg)
    x = torch.from_numpy(g["x"])
    with torch.no_grad():
        out = mix(x, memory_fft=torch.from_numpy(g["memory"])).numpy()
        out_nomem = mix(x).numpy()
    assert rel_err(out, g["out"]) < TOL
    assert rel_err(out_nomem, g["out_nomem"]) < TOL


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_multihead_golden_wavelet_always_on(impl):
    g = load("multihead_wave")
    cfg = SpectreConfig(embed_dim=64, num_heads=4, n_fft=64,
                        pooling_type="mean", wavelet_on_rate=1.0,
                        wavelet_reference_compat=True, fft_impl=impl,
                        interp_reference_compat=True)
    mix = _port_mix(map_multihead_params(g, cfg), cfg)
    with torch.no_grad():
        out = mix(torch.from_numpy(g["x"])).numpy()
    assert rel_err(out, g["out"]) < TOL


@pytest.mark.parametrize("impl", ["auto", "pallas"])
@pytest.mark.parametrize("tag,mem_size", [
    ("nomem", 0), ("fullmem", 1), ("truncmem", 16),
])
def test_block_golden(tag, mem_size, impl):
    g = load(f"block_{tag}")
    cfg = SpectreConfig(embed_dim=64, num_heads=4, n_fft=128,
                        pooling_type="mean", wavelet_on_rate=0.0,
                        memory_size=mem_size, fft_impl=impl,
                        interp_reference_compat=True)
    block = tsp.SpectreBlock(cfg)
    block.load_state_dict(block_from_jax_params(
        jax.tree.map(np.asarray, map_block_params(g, cfg)), cfg),
        strict=True)
    with torch.no_grad():
        out = block.eval()(torch.from_numpy(g["x"])).numpy()
    assert rel_err(out, g["out"]) < TOL


# ---------------------------------------------------------------------------
# The block bridge, the device rule and the bench
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(pooling_type="attention", use_toeplitz=True, memory_size=16),
    dict(pooling_type="dct", memory_size=0),
])
def test_block_bridge_round_trip_is_bit_exact(kw):
    cfg = _cfg(**kw)
    params = jax.tree.map(np.asarray, jsp.spectre_block_init(
        jax.random.key(3), _jax_cfg(cfg)))
    block = tsp.SpectreBlock(cfg)
    block.load_state_dict(block_from_jax_params(params, cfg), strict=True)
    back = block_to_jax_params(block.state_dict(), cfg)
    flat_a, tree_a = jax.tree.flatten(params)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def test_port_block_init_matches_jax_init_distributions():
    """spectre_block_init draws each leaf from the JAX init's distribution
    (pooler, Toeplitz kernel and memory included): same mean and spread
    within five standard errors."""
    cfg = _cfg(pooling_type="attention", use_toeplitz=True, memory_size=1,
               embed_dim=256, num_heads=4)
    block = tsp.spectre_block_init(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    tree = block_to_jax_params(block.state_dict(), cfg)
    ref = jsp.spectre_block_init(jax.random.key(0), _jax_cfg(cfg))
    assert jax.tree.structure(tree) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(ref)):
        b = np.asarray(b)
        assert a.shape == b.shape
        se = b.std() / np.sqrt(b.size)
        assert abs(a.mean() - b.mean()) < 5 * se + 1e-6
        assert abs(a.std() - b.std()) < 5 * se / np.sqrt(2) + 1e-6


@pytest.mark.parametrize("entry", [
    "lm_init", "spectre_block_init", "spectre_multihead_init", "bench",
    "cli_generate", "cli_train_lm", "hybrid_init", "vit_init", "swa_init",
    "swa_block_init", "swa_cache_init", "cli_train_hybrid", "cli_train_vit",
    "cli_bench_mix", "profile_trace", "measure_chip_constants"])
def test_entry_points_default_to_the_card(entry, monkeypatch, tmp_path):
    """Without a card, an entry point not asked for the CPU fails at once
    instead of running there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = torch.Generator().manual_seed(0)
    calls = {
        "lm_init": lambda: tlm.lm_init(tlm.tiny_lm_config(seq=256), g),
        "spectre_block_init": lambda: tsp.spectre_block_init(_cfg(), g),
        "spectre_multihead_init":
            lambda: tsp.spectre_multihead_init(_cfg(), g),
        "bench": lambda: bench.run(steps=1, batch=1, seq=64),
        "cli_generate": lambda: cli.main(["generate", "--seq", "256"]),
        "cli_train_lm": lambda: cli.main(["train-lm", "--seq", "256"]),
        "hybrid_init": lambda: thy.hybrid_init(thy.hybrid_tiny_config(), g),
        "vit_init": lambda: tvit.vit_init(tvit.vit_s_config(), g),
        "swa_init": lambda: tattn.swa_init(64, g),
        "swa_block_init": lambda: tattn.swa_block_init(64, 4, 16, g),
        "swa_cache_init": lambda: tattn.swa_cache_init(1, 4, 16, 16),
        "cli_train_hybrid": lambda: cli.main(
            ["train-hybrid", "--seq", "256"]),
        "cli_train_vit": lambda: cli.main(["train-vit", "--layers", "1"]),
        "cli_bench_mix": lambda: cli.main(["bench-mix", "--seqs", "64"]),
        "profile_trace": lambda: prof.profile_trace(tmp_path).__enter__(),
        "measure_chip_constants": prof.measure_chip_constants,
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_bench_runs_on_the_cpu_when_asked():
    sm.reset_launches()
    out = bench.run(steps=2, batch=1, seq=64, device="cpu")
    assert out["device"] == "cpu" and np.isfinite(out["value"])
    assert out["value"] > 0 and len(out["step_ms_all"]) == 2
    assert set(sm.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("entry", ["block", "multihead_strided", "head"])
def test_sequence_parallel_arguments_run_on_one_rank(entry, tmp_path):
    """The sp_mesh arguments on a 1-rank gloo group: the block (against
    JAX's), the multihead in the strided layout and the head, each through
    the distributed four-step FFT, against the same module without a
    mesh."""
    cfg = _cfg()
    params, block = block_pair(cfg)
    x = torch.from_numpy(_x(64, seed=5))
    with one_rank_group(tmp_path), torch.no_grad():
        mesh = make_mesh(1, 1, 1, device="cpu")
        comm.reset_calls()
        if entry == "block":
            got = tsp.spectre_block_apply(block, x, sp_mesh=mesh)
            want = _jax_block_apply(params, cfg, x.numpy())
        elif entry == "multihead_strided":
            n1 = dist_fft.sp_plan_strided(64, 1)
            got = dist_fft.sp_stride_permute(tsp.spectre_multihead_apply(
                block.mix, dist_fft.sp_stride_permute(x, n1, 64 // n1),
                sp_mesh=mesh, sp_layout="strided"), n1, 64 // n1,
                inverse=True)
            want = tsp.spectre_multihead_apply(block.mix, x)
        else:
            heads = block.mix.heads
            xh = x.reshape(2, 64, 2, 64)
            got, q_pool = tsp.spectre_head_apply(heads, heads.cfg, xh,
                                                 sp_mesh=mesh)
            want, q_want = tsp.spectre_head_apply(heads, heads.cfg, xh)
            assert rel_err(q_pool, q_want) < TOL
        assert comm.CALLS["all_to_all"] == (2 if entry == "multihead_strided"
                                            else 4)
    assert rel_err(got, want) < TOL


def test_bench_profile_needs_the_card():
    with pytest.raises(ValueError, match="card"):
        bench.run(steps=1, batch=1, seq=64, device="cpu", profile_steps=1)
