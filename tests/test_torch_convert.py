"""fft_tpu_torch against fft_tpu: the config mirror, the weight bridge and
the port's import hygiene (no JAX, no nvcc at import)."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import fft_tpu.config as jcfg
import fft_tpu.models.lm as jlm
from fft_tpu_torch import config as tcfg
from fft_tpu_torch.convert import from_jax_params, to_jax_params
from fft_tpu_torch.models import lm as tlm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_lm_config(cfg: tlm.LMConfig) -> jlm.LMConfig:
    """The JAX LMConfig with the same fields as a port LMConfig."""
    block = jcfg.SpectreConfig(**dataclasses.asdict(cfg.block))
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg) if f.name != "block"}
    return jlm.LMConfig(block=block, **fields)


def _leaf_init(path, shape, rng):
    """numpy draw for one JAX parameter leaf, scaled like its init but
    without its constants (so the modReLU bias and the LayerNorms are
    exercised too)."""
    name = path[-1].key
    if name == "w":                                  # (..., fan_in, fan_out)
        return rng.uniform(-1, 1, shape) / np.sqrt(shape[-2])
    if name == "scale":
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if name == "modrelu_bias":
        return -0.1 + 0.1 * rng.standard_normal(shape)
    if name in ("tok_emb", "pos_emb", "lm_head"):
        return 0.02 * rng.standard_normal(shape)
    if name == "memory_fft":
        return rng.standard_normal(shape) / np.sqrt(2.0 * shape[-1])
    return 0.05 * rng.standard_normal(shape)      # biases


def lm_pair(cfg: tlm.LMConfig, seed: int = 0):
    """(JAX params as numpy, port model) holding the same numpy-seeded
    weights: the JAX tree's structure, each leaf drawn by _leaf_init, then
    bridged into the port."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: jlm.lm_init(jax.random.key(0), jax_lm_config(cfg)))
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: _leaf_init(path, s.shape, rng).astype(np.float32),
        shapes)
    model = tlm.SpectreLM(cfg)
    model.load_state_dict(from_jax_params(params, cfg), strict=True)
    return params, model.eval()


def small_lm_config(memory_size: int = 0) -> tlm.LMConfig:
    """2 layers, d=256, 4 heads, n_fft 1024, chunk 128, vocab 64: nc*cols =
    8*16 = 128 gate lanes at the full window, so every branch is
    reachable."""
    return tlm.LMConfig(
        vocab_size=64, num_layers=2, max_seq=1024,
        block=tcfg.SpectreConfig(
            embed_dim=256, num_heads=4, n_fft=1024, pooling_type="mean",
            wavelet_on_rate=0.0, causal=True, causal_chunk=128,
            memory_size=memory_size))


@pytest.mark.parametrize("cls", ["SpectreConfig", "SpectreHeadConfig"])
def test_config_fields_and_defaults_match(cls):
    ours = dataclasses.fields(getattr(tcfg, cls))
    theirs = dataclasses.fields(getattr(jcfg, cls))
    assert [(f.name, f.default) for f in ours] == \
        [(f.name, f.default) for f in theirs]


@pytest.mark.parametrize("kw", [
    dict(embed_dim=512, num_heads=8, n_fft=2048, memory_size=0),
    dict(embed_dim=256, num_heads=4, n_fft=1024, memory_size=1),
    dict(embed_dim=96, num_heads=3, n_fft=100, memory_size=7,
         num_buckets=3, num_groups=2),
])
def test_config_derived_sizes_match(kw):
    ours, theirs = tcfg.SpectreConfig(**kw), jcfg.SpectreConfig(**kw)
    for name in ("head_dim", "f_half", "memory_freq_bins"):
        assert getattr(ours, name) == getattr(theirs, name), name
    oh, th = ours.head_config(), theirs.head_config()
    assert dataclasses.asdict(oh) == dataclasses.asdict(th)
    for name in ("f_half", "buckets", "d_group"):
        assert getattr(oh, name) == getattr(th, name), name


def test_tiny_lm_config_matches():
    ours, theirs = tlm.tiny_lm_config(), jlm.tiny_lm_config()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("memory_size", [0, 16])
def test_bridge_round_trip_is_bit_exact(memory_size):
    cfg = small_lm_config(memory_size)
    params, model = lm_pair(cfg, seed=memory_size)
    back = to_jax_params(model.state_dict(), cfg)
    flat_a, tree_a = jax.tree.flatten(params)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def untied_lm_config() -> tlm.LMConfig:
    """2 layers, d=128, 2 heads, n_fft 256, chunk 64, memory of 8 bins,
    vocab 64 and its own LM head (tie_embeddings=False)."""
    return tlm.LMConfig(
        vocab_size=64, num_layers=2, max_seq=256, tie_embeddings=False,
        block=tcfg.SpectreConfig(
            embed_dim=128, num_heads=2, n_fft=256, pooling_type="mean",
            wavelet_on_rate=0.0, causal=True, causal_chunk=64,
            memory_size=8))


def test_untied_head_bridges_bit_exact_with_jax_init_distributions():
    """The untied head's (d, vocab) lm_head leaf crosses the bridge both
    ways bit for bit, and lm_init draws it as JAX's (emb_init_std)."""
    cfg = untied_lm_config()
    params, model = lm_pair(cfg, seed=4)
    assert tuple(model.lm_head.shape) == (128, 64)
    assert torch.equal(model.lm_head, torch.from_numpy(params["lm_head"]))
    back = to_jax_params(model.state_dict(), cfg)
    flat_a, tree_a = jax.tree.flatten(params)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    drawn = tlm.lm_init(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = np.asarray(jax.jit(jlm.lm_init, static_argnums=1)(
        jax.random.key(0), jax_lm_config(cfg))["lm_head"])
    got = drawn.lm_head.detach().numpy()
    se = ref.std() / np.sqrt(ref.size)
    assert abs(got.mean() - ref.mean()) < 5 * se + 1e-6
    assert abs(got.std() - ref.std()) < 5 * se / np.sqrt(2) + 1e-6
    # a tied model draws what it drew before: the head comes last
    tied = tlm.lm_init(dataclasses.replace(cfg, tie_embeddings=True),
                       torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(tied.tok_emb, drawn.tok_emb)
    assert "lm_head" not in dict(tied.named_parameters())


def test_port_init_matches_jax_init_distributions():
    """lm_init draws from the same distributions as the JAX init: the trees
    bridge with the same structure and shapes, and every leaf has the same
    mean and spread (the two RNGs give different numbers)."""
    cfg = small_lm_config(memory_size=16)
    model = tlm.lm_init(cfg, torch.Generator().manual_seed(0), "cpu")
    tree = to_jax_params(model.state_dict(), cfg)
    ref = jlm.lm_init(jax.random.key(0), jax_lm_config(cfg))
    assert jax.tree.structure(tree) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(ref)):
        b = np.asarray(b)
        assert a.shape == b.shape
        # five standard errors of the sample mean and of the sample spread
        se = b.std() / np.sqrt(b.size)
        assert abs(a.mean() - b.mean()) < 5 * se + 1e-6
        assert abs(a.std() - b.std()) < 5 * se / np.sqrt(2) + 1e-6


def _run_isolated(code: str, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_never_imports_jax():
    code = ("import sys; import fft_tpu_torch, fft_tpu_torch.kernels.causal, "
            "fft_tpu_torch.kernels.spectral_mix, fft_tpu_torch.kernels.decode, "
            "fft_tpu_torch.bench, "
            "fft_tpu_torch.cli, fft_tpu_torch.convert, fft_tpu_torch.models, "
            "fft_tpu_torch.decode, fft_tpu_torch.layers, "
            "fft_tpu_torch.models.vit, fft_tpu_torch.models.hybrid, "
            "fft_tpu_torch.layers.attention, fft_tpu_torch.train.images, "
            "fft_tpu_torch.train.bpe, fft_tpu_torch.train.checkpoint, "
            "fft_tpu_torch.train.data, fft_tpu_torch.train.native_loader, "
            "fft_tpu_torch.train.supervisor, fft_tpu_torch.utils.prof, "
            "fft_tpu_torch.kernels.probe, fft_tpu_torch.parallel, "
            "fft_tpu_torch.parallel.comm, fft_tpu_torch.parallel.mesh, "
            "fft_tpu_torch.parallel.multihost, "
            "fft_tpu_torch.parallel.dist_fft, "
            "fft_tpu_torch.parallel.pipeline, tests.torch_parallel_worker; "
            "bad = sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'fft_tpu.'))"
            " or m == 'fft_tpu'); print(bad); sys.exit(1 if bad else 0)")
    proc = _run_isolated(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_kernel_module_imports_without_nvcc():
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent",
               CUDA_PATH="/nonexistent")
    code = ("import fft_tpu_torch.kernels.causal as kc, "
            "fft_tpu_torch.kernels.spectral_mix as sm, "
            "fft_tpu_torch.kernels.decode as kd, "
            "fft_tpu_torch.kernels.probe as kp, "
            "fft_tpu_torch.kernels.build as kb, "
            "fft_tpu_torch.train.native_loader as nl; "
            "assert kb._LIB is None and nl._LIB is None; print('ok')")
    proc = _run_isolated(code, env)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr
