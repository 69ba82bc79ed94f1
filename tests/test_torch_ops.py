"""fft_tpu_torch ops and causal layers against fft_tpu on the CPU: the same
numpy-seeded inputs through both, parity at 1e-5 relative (max|a-b| /
max|b|, fp32 on both sides; the two sum in different orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_tpu.layers.spectre as jsp
import fft_tpu.ops as jops
import fft_tpu.ops.interp as jinterp
from fft_tpu.ops import fftops as jfft
from fft_tpu_torch import config as tcfg
from fft_tpu_torch import ops as tops
from fft_tpu_torch.layers import spectre as tsp
from fft_tpu_torch.ops import fftops as tfft
from fft_tpu_torch.ops import interp as tinterp
from fft_tpu_torch.models import lm as tlm
from tests.golden_utils import rel_err
from tests.test_torch_convert import lm_pair

TOL = 1e-5


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def test_modrelu_parity():
    rng = np.random.default_rng(0)
    z = _cplx(rng, (3, 4, 65))
    z[0, 0, :5] = 1e-5                       # |z| ~ eps: smooth denominator
    bias = (0.3 * rng.standard_normal((4, 65)) - 0.1).astype(np.float32)
    ref = np.asarray(jops.modrelu(jnp.asarray(z), jnp.asarray(bias)))
    got = tops.modrelu(torch.from_numpy(z), torch.from_numpy(bias)).numpy()
    assert rel_err(got, ref) < TOL


@pytest.mark.parametrize("k,size", [(4, 9), (22, 513), (32, 1025)])
def test_interp_complex_1d_parity(k, size):
    rng = np.random.default_rng(k)
    x = _cplx(rng, (2, 3, k))
    ref = np.asarray(jops.interp_complex_1d(jnp.asarray(x), size))
    got = tops.interp_complex_1d(torch.from_numpy(x), size).numpy()
    assert rel_err(got, ref) < TOL
    assert np.array_equal(tinterp._interp_matrix_np(k, size),
                          jinterp._interp_matrix_np(k, size, "cubic"))


@pytest.mark.parametrize("n,pos", [(64, 0), (64, 31), (64, 63), (63, 10)])
def test_pruned_irfft_single_parity(n, pos):
    rng = np.random.default_rng(pos)
    x = _cplx(rng, (2, 3, n // 2 + 1, 8))
    ref = np.asarray(jops.pruned_irfft_single(jnp.asarray(x), n, pos))
    got = tops.pruned_irfft_single(torch.from_numpy(x), n, pos).numpy()
    assert rel_err(got, ref) < TOL


def test_rfft_phasor_and_mean_pool_parity():
    ref = np.asarray(jops.rfft_phasor(2048, 777))
    got = tops.rfft_phasor(2048, 777).numpy()
    assert rel_err(got, ref) < TOL
    x = np.random.default_rng(1).standard_normal((2, 50, 16)).astype(
        np.float32)
    assert rel_err(tops.mean_pool(torch.from_numpy(x)).numpy(),
                   np.asarray(jops.mean_pool(jnp.asarray(x)))) < TOL


@pytest.mark.parametrize("n", [64, 63])
def test_irfft_drops_imag_at_dc_and_nyquist(n):
    """A gate spectrum that is not Hermitian at DC/Nyquist: the port's
    irfft agrees with the JAX one (which drops those imaginary parts)."""
    rng = np.random.default_rng(n)
    x = _cplx(rng, (n // 2 + 1, 5))
    ref = np.asarray(jfft.irfft(jnp.asarray(x), n, axis=-2, impl="jnp"))
    got = tfft.irfft(torch.from_numpy(x), n, dim=-2).numpy()
    assert rel_err(got, ref) < TOL
    x[0].imag += 3.0
    if n % 2 == 0:
        x[-1].imag += 3.0
    got2 = tfft.irfft(torch.from_numpy(x), n, dim=-2).numpy()
    assert rel_err(got2, ref) < TOL


def _block_cfg(n_fft, chunk, memory_size=0, causal_impl="segmented",
               embed_dim=64, num_heads=4):
    return tlm.LMConfig(
        vocab_size=8, num_layers=1, max_seq=n_fft,
        block=tcfg.SpectreConfig(
            embed_dim=embed_dim, num_heads=num_heads, n_fft=n_fft,
            pooling_type="mean",
            wavelet_on_rate=0.0, causal=True, causal_chunk=chunk,
            memory_size=memory_size, causal_impl=causal_impl))


def _jax_block(cfg, seed=0):
    """(JAX block params, JAX SpectreConfig, port block) with equal
    weights, via a 1-layer LM through the bridge."""
    params, model = lm_pair(cfg, seed)
    jblock = jax.tree.map(lambda a: jnp.asarray(a[0]), params["blocks"])
    jc = jsp.SpectreConfig(**dataclasses.asdict(cfg.block))
    return jblock, jc, model.blocks[0]


def test_spectre_gate_parity():
    cfg = _block_cfg(256, 128)
    jblock, jc, block = _jax_block(cfg)
    hcfg_j = jc.head_config()
    rng = np.random.default_rng(2)
    descr = rng.standard_normal((3, cfg.block.num_heads, 16)).astype(
        np.float32)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda hp, dh: jsp.spectre_gate(hp, hcfg_j, dh),
        in_axes=(0, 1), out_axes=1))(jblock["mix"]["heads"], descr))
    with torch.no_grad():
        got = tsp.spectre_gate(block.mix.heads, block.mix.heads.cfg,
                               torch.from_numpy(descr)).numpy()
    assert got.shape == ref.shape == (3, 4, 4, 129)
    assert rel_err(got, ref) < TOL


@pytest.mark.parametrize("n,chunk", [(64, 16), (50, 16), (256, 128)])
def test_causal_chunk_gates_parity(n, chunk):
    cfg = _block_cfg(256, chunk)
    jblock, jc, block = _jax_block(cfg, seed=1)
    nc = -(-n // chunk)
    q = np.random.default_rng(3).standard_normal(
        (2, n, cfg.block.num_heads, 16)).astype(np.float32)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda hp, qh: jsp.causal_chunk_gates(hp, jc.head_config(), qh, nc,
                                              chunk),
        in_axes=(0, 2), out_axes=2))(jblock["mix"]["heads"], q))
    with torch.no_grad():
        got = tsp.causal_chunk_gates(block.mix.heads, block.mix.heads.cfg,
                                     torch.from_numpy(q), nc, chunk).numpy()
    assert rel_err(got, ref) < TOL


# (n_fft, chunk, n, causal_impl, memory, d, branch the port takes)
_BLOCK_CASES = [
    (256, 128, 256, "segmented", 0, 64, "kf_fused"),
    (512, 128, 256, "segmented", 16, 64, "fused"),
    (256, 16, 64, "segmented", 1, 64, "banded"),
    (256, 16, 64, "segmented", 0, 48, "composition"),   # d % 32 != 0
    (256, 128, 200, "segmented", 16, 64, "fft2n"),
    (256, 16, 64, "fft2n", 0, 64, "fft2n"),
]


@pytest.mark.parametrize("n_fft,chunk,n,impl,mem,d,branch", _BLOCK_CASES)
def test_causal_block_parity(n_fft, chunk, n, impl, mem, d, branch):
    """The causal multihead mixer and the whole block (with the additive
    spectral memory) against JAX, through every branch of the dispatch."""
    from fft_tpu_torch.layers.causal_seg import BRANCH_CALLS
    cfg = _block_cfg(n_fft, chunk, mem, impl, embed_dim=d,
                     num_heads=4 if d == 64 else 2)
    jblock, jc, block = _jax_block(cfg, seed=4)
    x = np.random.default_rng(5).standard_normal((2, n, d)).astype(
        np.float32)
    ref_mix = np.asarray(jax.jit(jsp.spectre_multihead_apply,
                                 static_argnums=1)(jblock["mix"], jc, x))
    ref_blk = np.asarray(jax.jit(jsp.spectre_block_apply,
                                 static_argnums=1)(jblock, jc, x))
    BRANCH_CALLS.clear()
    with torch.no_grad():
        got_mix = block.mix(torch.from_numpy(x)).numpy()
        got_blk = block(torch.from_numpy(x)).numpy()
    assert set(BRANCH_CALLS) == {branch}
    assert rel_err(got_mix, ref_mix) < TOL
    assert rel_err(got_blk, ref_blk) < TOL


# ---------------------------------------------------------------------------
# The non-causal block's ops: DCT, poolers, Toeplitz conv, ref-compat
# interpolation, Haar pyramid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [50, 128])
def test_dct2_and_dct_pool_parity(n):
    from fft_tpu.ops.dct import dct_pool_weights as jweights
    x = np.random.default_rng(n).standard_normal((2, n, 16)).astype(
        np.float32)
    for norm in (None, "ortho"):
        ref = np.asarray(jops.dct2(jnp.asarray(x), norm=norm))
        assert rel_err(tops.dct2(torch.from_numpy(x), norm=norm).numpy(),
                       ref) < TOL
    ref = np.asarray(jops.dct_pool(jnp.asarray(x)))
    assert rel_err(tops.dct_pool(torch.from_numpy(x)).numpy(), ref) < TOL
    assert np.array_equal(tops.dct_pool_weights(n).numpy(),
                          np.asarray(jweights(n)))


def test_attention_pool_parity():
    rng = np.random.default_rng(4)
    d, hidden = 16, 256
    x = rng.standard_normal((2, 12, d)).astype(np.float32)
    p = {"w1": rng.standard_normal((d, hidden)) / 4,
         "b1": 0.1 * rng.standard_normal(hidden),
         "w2": rng.standard_normal((hidden, 1)) / 16,
         "b2": 0.1 * rng.standard_normal(1)}
    p = {k: a.astype(np.float32) for k, a in p.items()}
    ref = np.asarray(jops.attention_pool(
        {k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x)))
    t = {k: torch.from_numpy(a) for k, a in p.items()}
    got = tops.attention_pool(torch.from_numpy(x), t["w1"].T, t["b1"],
                              t["w2"].T, t["b2"]).numpy()
    assert rel_err(got, ref) < TOL


@pytest.mark.parametrize("length,klen", [(9, 9), (22, 9), (5, 3)])
def test_complex_circular_conv1d_parity(length, klen):
    rng = np.random.default_rng(length)
    x, k = _cplx(rng, (2, 3, length)), _cplx(rng, (klen,))
    ref = np.asarray(jops.complex_circular_conv1d(jnp.asarray(x),
                                                  jnp.asarray(k)))
    got = tops.complex_circular_conv1d(torch.from_numpy(x),
                                       torch.from_numpy(k)).numpy()
    assert rel_err(got, ref) < TOL


@pytest.mark.parametrize("groups,size", [(4, 65), (1, 33), (3, 129)])
def test_interp_ref_compat_parity(groups, size):
    x = _cplx(np.random.default_rng(groups), (2, groups, 8))
    ref = np.asarray(jinterp.interp_complex_1d_ref_compat(jnp.asarray(x),
                                                          size))
    got = tops.interp_complex_1d_ref_compat(torch.from_numpy(x),
                                            size).numpy()
    assert rel_err(got, ref) < TOL


@pytest.mark.parametrize("length", [64, 197])
@pytest.mark.parametrize("compat", [False, True])
def test_haar_pyramid_parity(length, compat):
    """Every coefficient of the pyramid and the reconstruction, at a
    power-of-two and an odd length (ViT's 197).  The original's pyramid
    (reference_compat) cannot reconstruct an odd length, in JAX or here."""
    x = np.random.default_rng(length).standard_normal(
        (2, 3, length)).astype(np.float32)
    ref_c, ref_l = jops.haar_decompose(jnp.asarray(x),
                                       reference_compat=compat)
    got_c, got_l = tops.haar_decompose(torch.from_numpy(x),
                                       reference_compat=compat)
    assert got_l == ref_l and len(got_c) == len(ref_c)
    for a, r in zip(got_c, ref_c):
        assert a.shape == r.shape and rel_err(a.numpy(), np.asarray(r)) < TOL
    if compat and length % 2:
        return
    ref = np.asarray(jops.haar_reconstruct(ref_c, ref_l))
    got = tops.haar_reconstruct(got_c, got_l).numpy()
    assert rel_err(got, ref) < TOL
    if not compat:
        assert rel_err(got, x) < TOL            # perfect reconstruction
