"""The causal kernels' plain PyTorch versions against the JAX Pallas kernels
(run in interpret mode on the CPU, as tests/test_pallas_causal.py runs
them), the CPU routing of the wrappers, and the prompt-length dispatch at
the tiny LM's own widths.  The CUDA kernels themselves are checked on the
card by tests/test_torch_kernels.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_tpu.kernels.pallas_causal as pc
from fft_tpu_torch.kernels import causal as kc
from fft_tpu_torch.layers.causal_seg import BRANCH_CALLS
from fft_tpu_torch.layers.spectre import SpectreMultiHead
from fft_tpu_torch.models.lm import spectre_350m_config, tiny_lm_config
from tests.golden_utils import rel_err

TOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret():
    old = pc.INTERPRET
    pc.INTERPRET = True
    yield
    pc.INTERPRET = old


def _planes(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("b,nc,chunk,d,cols", [
    (2, 4, 16, 128, 8),
    (1, 1, 4, 128, 32),           # the 4-token prompt: one chunk of 4
])
def test_banded_inverse_ref_matches_pallas(b, nc, chunk, d, cols):
    rng = np.random.default_rng(chunk)
    f2 = chunk + 1
    arrs = _planes(rng, (b, nc, f2, d), (b, nc, f2, d),
                   (b, nc, nc, f2, cols), (b, nc, nc, f2, cols))
    ref = np.asarray(pc.banded_inverse(*map(jnp.asarray, arrs), chunk,
                                       False, True))
    got = kc.banded_inverse_ref(*map(torch.from_numpy, arrs), chunk).numpy()
    assert rel_err(got, ref) < TOL


def test_fused_causal_mix_ref_matches_pallas():
    rng = np.random.default_rng(3)
    b, nc, chunk, d, cols = 1, 2, 128, 128, 8
    assert pc.fused_mix_supported(nc, chunk, d, False, cols)
    arrs = _planes(rng, (b, nc * chunk, d), (b, nc, chunk + 1, nc * cols),
                   (b, nc, chunk + 1, nc * cols))
    ref = np.asarray(pc.fused_causal_mix(*map(jnp.asarray, arrs), chunk,
                                         cols, False, True))
    got = kc.fused_causal_mix_ref(*map(torch.from_numpy, arrs), chunk,
                                  cols).numpy()
    assert rel_err(got, ref) < TOL


def test_kf_spectra_ref_matches_pallas():
    rng = np.random.default_rng(7)
    n_fft, chunk, lanes = 256, 64, 128
    arrs = _planes(rng, (2, n_fft // 2 + 1, lanes), (2, n_fft // 2 + 1,
                                                     lanes))
    rr, ri = pc.kf_spectra(*map(jnp.asarray, arrs), n_fft, chunk, False,
                           True)
    gr, gi = kc.kf_spectra_ref(*map(torch.from_numpy, arrs), n_fft, chunk)
    assert rel_err(gr.numpy(), np.asarray(rr)) < TOL
    assert rel_err(gi.numpy(), np.asarray(ri)) < TOL


def test_wrappers_run_the_plain_version_on_cpu_tensors():
    rng = np.random.default_rng(11)
    b, nc, chunk, d, cols = 1, 2, 128, 64, 4
    v, kr, ki = map(torch.from_numpy, _planes(
        rng, (b, nc * chunk, d), (b, nc, chunk + 1, nc * cols),
        (b, nc, chunk + 1, nc * cols)))
    gr, gi = map(torch.from_numpy, _planes(rng, (b, 129, 32), (b, 129, 32)))
    kc.reset_launches()
    assert torch.equal(kc.fused_causal_mix(v, kr, ki, chunk, cols),
                       kc.fused_causal_mix_ref(v, kr, ki, chunk, cols))
    for got, want in zip(kc.kf_spectra(gr, gi, 256, 64),
                         kc.kf_spectra_ref(gr, gi, 256, 64)):
        assert torch.equal(got, want)
    vf = kc.segment_spectra(v, chunk)
    k5 = kr.reshape(b, nc, chunk + 1, nc, cols).permute(0, 3, 1, 2, 4)
    args = (vf.real, vf.imag, k5, k5 * 0.5)
    assert torch.equal(kc.banded_inverse(*args, chunk),
                       kc.banded_inverse_ref(*args, chunk))
    assert set(kc.LAUNCHES.values()) == {0}      # no kernel ran


def test_wrappers_raise_off_cpu_and_cuda():
    """A tensor that is neither on the CPU nor on a CUDA device reaches no
    plain version: the call raises."""
    g = torch.empty((1, 129, 32), device="meta")
    with pytest.raises(ValueError):
        kc.kf_spectra(g, g, 256, 64)


def _jax_branch(n: int, d: int, cols: int, n_fft: int, chunk_cfg: int):
    """The branch fft_tpu takes on a TPU (fft_impl="auto", fp32) for a
    causal multihead call of length n: causal_seg.py:116-182 and
    spectre.py:512-513."""
    chunk = min(chunk_cfg, n)
    if n % chunk:
        return "fft2n"
    nc = n // chunk
    use_kf = (pc.kf_spectra_supported(n_fft, chunk) and n == n_fft
              and (nc * cols) % 128 == 0
              and (n_fft != 2048 or nc * cols >= 256))
    fused = pc.fused_mix_supported(nc, chunk, d, False, cols)
    if fused and use_kf:
        return "kf_fused"
    if fused:
        return "fused"
    if d % 128 == 0 and pc.banded_supported(nc, chunk + 1):
        return "banded"
    return "composition"


@pytest.mark.parametrize("n", [4, 200, 256, 2048])
def test_dispatch_matches_tpu_at_tiny_lm_widths(n):
    """d=512, 8 heads x 4 groups, n_fft 2048, chunk 128, B=1: each prompt
    length takes the branch the JAX predicates pick on a TPU."""
    cfg = tiny_lm_config().block
    want = _jax_branch(n, cfg.embed_dim, cfg.num_heads * cfg.num_groups,
                       cfg.n_fft, cfg.causal_chunk)
    assert want == {4: "banded", 200: "fft2n", 256: "fused",
                    2048: "kf_fused"}[n]
    mix = SpectreMultiHead(cfg)
    mix.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn((1, n, cfg.embed_dim),
                    generator=torch.Generator().manual_seed(1))
    BRANCH_CALLS.clear()
    with torch.no_grad():
        y = mix(x)
    assert dict(BRANCH_CALLS) == {want: 1}
    assert y.shape == x.shape and torch.isfinite(y).all()


def test_predicates_hold_the_shared_memory_bounds():
    """The chunk and window limits follow from the 227 KB a Hopper block
    may use (the JAX package's VMEM models do not apply): banded_inverse's
    32-channel tile to chunk 853, its 8-channel tile to 2904; #6 only with
    the 32-channel tile."""
    assert kc._banded_lanes(853, 512) == 32
    assert kc._banded_lanes(854, 512) == 8
    assert kc.banded_supported(1, 2905, 512, 32)
    assert not kc.banded_supported(1, 2906, 512, 32)
    assert kc.fused_mix_supported(16, 128, 512, 32)
    assert kc.fused_mix_supported(1, 853, 512, 32)
    assert not kc.fused_mix_supported(1, 854, 512, 32)
    assert not kc.fused_mix_supported(1, 64, 512, 32)
    assert kc.kf_spectra_supported(2048, 128, 512)
    assert not kc.kf_spectra_supported(2048, 128, 16)
    assert not kc.kf_spectra_supported(32768, 128, 512)


def test_shape_choice_between_the_fft_and_direct_kernels():
    """Inside #6's, #8's and #10's ranges the wrappers pick a kernel by shape:
    the FFT kernels (causal_fft.cu) at every shape of the tiny LM's paths
    (n_fft 2048, C 128, nc 1..16, d 512, 32 gate columns), the direct ones
    (causal.cu, causal_bwd.cu) where 2C has an odd factor past 31.  The
    350M's long chunks stay on #7 and #11."""
    blk = tiny_lm_config().block
    d, cols = blk.embed_dim, blk.num_heads * blk.num_groups
    n_fft, chunk = blk.n_fft, blk.causal_chunk
    assert kc.kf_spectra_kernel(n_fft, chunk, n_fft // chunk * cols) == \
        "kf_spectra"
    for nc in range(1, n_fft // chunk + 1):
        assert kc._mix_kernel("fused_causal_mix", nc * chunk, chunk, d,
                              cols) == "fused_causal_mix"
        assert kc._mix_kernel("fused_causal_mix_bwd", nc * chunk, chunk, d,
                              cols) == "fused_causal_mix_bwd"
    big = spectre_350m_config(seq=16384).block
    d, cols = big.embed_dim, big.num_heads * big.num_groups
    for n in (16384, 8192, 2048):
        assert kc._mix_kernel("fused_causal_mix", n, 2048, d, cols) == \
            "fused_causal_mix_v3"
        assert kc._mix_kernel("fused_causal_mix_bwd", n, 2048, d, cols) == \
            "fused_causal_mix_bwd_v3"
    assert kc._mix_kernel("fused_causal_mix", 3 * 129, 129, 512, 32) == \
        "fused_causal_mix_direct"
    assert kc._mix_kernel("fused_causal_mix_bwd", 3 * 129, 129, 512, 32) == \
        "fused_causal_mix_bwd_direct"
    assert kc.kf_spectra_kernel(4 * 129, 129, 64) == "kf_spectra_direct"
    with pytest.raises(ValueError):
        kc.kf_spectra_kernel(32768, 128, 512)
