"""The CUDA kernels of fft_tpu_torch against their plain PyTorch versions,
on the card, at the tiny LM's, BASELINE config 1's and the 350M's shapes
(#8 and #6 through the FFT kernels of causal_fft.cu and the direct ones of
causal.cu, the long-chunk kernels #9, #7 and #11 (also at nc 16 and 32,
and #7's and #11's bf16 instances), #5 past chunk 853, the decode kernel
#12 at both LMs' decode shapes and at the 350M's windows of 32768 and
65536, the non-causal mix past n_fft 2048: #3 at 2304-8192 and #4 at
16384-65536, the bf16 instances of #6, #10, #1-#4, and the bf16 calls
that must raise).  Imports no
JAX, so it runs on a machine without it:

    FFT_TPU_REAL=1 python -m pytest tests/test_torch_kernels.py -q

(FFT_TPU_REAL=1 keeps tests/conftest.py from forcing JAX onto the CPU.)
Where there is no CUDA device every test here skips."""

import pytest
import torch

from fft_tpu_torch.kernels import causal as kc
from fft_tpu_torch.kernels import decode as kd
from fft_tpu_torch.kernels import spectral_mix as sm

# max|a-b| / max|b|, as tests/golden_utils.py: direct fp32 DFTs against
# cuFFT, both accumulating in fp32 in different orders
TOL = 2e-5

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _randn(g, dev, *shape):
    return torch.randn(shape, generator=g).to(dev)


def _mix_inputs_at(dev, b, nc, chunk, d, cols, seed):
    g = torch.Generator().manual_seed(seed)
    return (_randn(g, dev, b, nc * chunk, d),
            _randn(g, dev, b, nc, chunk + 1, nc * cols),
            _randn(g, dev, b, nc, chunk + 1, nc * cols))


@pytest.mark.parametrize("nc", [8, 16])
def test_fused_causal_mix_kernel(dev, nc):
    """The tiny LM's shapes go to the FFT kernel (causal_fft.cu), never to
    the direct one."""
    b, chunk, d, cols = 4, 128, 512, 32
    v, kr, ki = _mix_inputs_at(dev, b, nc, chunk, d, cols, nc)
    before = dict(kc.LAUNCHES)
    got = kc.fused_causal_mix(v, kr, ki, chunk, cols)
    torch.cuda.synchronize()
    assert kc.LAUNCHES["fused_causal_mix"] == before["fused_causal_mix"] + 1
    assert (kc.LAUNCHES["fused_causal_mix_direct"]
            == before["fused_causal_mix_direct"])
    assert _rel(got, kc.fused_causal_mix_ref(v, kr, ki, chunk, cols)) < TOL


# (b, nc, chunk, d, cols): the tiny LM's prompts of 128 and 384 tokens and
# its training batch; an odd factor in 2C (C = 384); gate groups narrower
# than the channel tile (cols 64 at d 256) and of one channel; nc 32, whose
# spectra take the 2-pair tile
MIX_FFT_CASES = [(4, 1, 128, 512, 32), (4, 3, 128, 512, 32),
                 (8, 16, 128, 512, 32), (2, 3, 384, 256, 64),
                 (2, 4, 128, 256, 256), (2, 32, 128, 512, 32)]


@pytest.mark.parametrize("b,nc,chunk,d,cols", MIX_FFT_CASES)
def test_fused_causal_mix_fft_kernel_shapes(dev, b, nc, chunk, d, cols):
    assert kc.mix_fft_plan(nc, chunk, d, cols) is not None
    v, kr, ki = _mix_inputs_at(dev, b, nc, chunk, d, cols, nc * chunk + d)
    before = dict(kc.LAUNCHES)
    got = kc.fused_causal_mix(v, kr, ki, chunk, cols)
    torch.cuda.synchronize()
    assert kc.LAUNCHES["fused_causal_mix"] == before["fused_causal_mix"] + 1
    assert (kc.LAUNCHES["fused_causal_mix_direct"]
            == before["fused_causal_mix_direct"])
    assert _rel(got, kc.fused_causal_mix_ref(v, kr, ki, chunk, cols)) < TOL


@pytest.mark.parametrize("nc", [8, 16])
def test_direct_kernels_at_the_tiny_lm_shapes(dev, nc):
    """The direct-DFT kernels (causal.cu), called on their own at the
    shapes the FFT kernels take on the main path, agree with the plain
    versions too."""
    b, chunk, d, cols = 4, 128, 512, 32
    v, kr, ki = _mix_inputs_at(dev, b, nc, chunk, d, cols, 40 + nc)
    g = torch.Generator().manual_seed(nc)
    gr = _randn(g, dev, b, 1025, nc * cols)
    gi = _randn(g, dev, b, 1025, nc * cols)
    before = dict(kc.LAUNCHES)
    y = kc.fused_causal_mix_direct(v, kr, ki, chunk, cols)
    kf = kc.kf_spectra_direct(gr, gi, 2048, chunk)
    torch.cuda.synchronize()
    assert (kc.LAUNCHES["fused_causal_mix_direct"]
            == before["fused_causal_mix_direct"] + 1)
    assert kc.LAUNCHES["kf_spectra_direct"] == before["kf_spectra_direct"] + 1
    assert kc.LAUNCHES["fused_causal_mix"] == before["fused_causal_mix"]
    assert _rel(y, kc.fused_causal_mix_ref(v, kr, ki, chunk, cols)) < TOL
    for a, w in zip(kf, kc.kf_spectra_ref(gr, gi, 2048, chunk)):
        assert _rel(a, w.contiguous()) < TOL


def test_direct_kernels_take_what_the_fft_kernels_do_not(dev):
    """2C = 258 has the odd factor 129: the wrappers' shape choice sends
    #6 and #8 to the direct kernels there."""
    b, nc, chunk, d, cols = 2, 3, 129, 512, 32
    v, kr, ki = _mix_inputs_at(dev, b, nc, chunk, d, cols, 7)
    g = torch.Generator().manual_seed(7)
    n_fft, lanes = 4 * chunk, 64
    gr = _randn(g, dev, b, n_fft // 2 + 1, lanes)
    gi = _randn(g, dev, b, n_fft // 2 + 1, lanes)
    before = dict(kc.LAUNCHES)
    y = kc.fused_causal_mix(v, kr, ki, chunk, cols)
    kf = kc.kf_spectra(gr, gi, n_fft, chunk)
    torch.cuda.synchronize()
    assert (kc.LAUNCHES["fused_causal_mix_direct"]
            == before["fused_causal_mix_direct"] + 1)
    assert kc.LAUNCHES["kf_spectra_direct"] == before["kf_spectra_direct"] + 1
    assert kc.LAUNCHES["fused_causal_mix"] == before["fused_causal_mix"]
    assert kc.LAUNCHES["kf_spectra"] == before["kf_spectra"]
    assert _rel(y, kc.fused_causal_mix_ref(v, kr, ki, chunk, cols)) < TOL
    for a, w in zip(kf, kc.kf_spectra_ref(gr, gi, n_fft, chunk)):
        assert _rel(a, w.contiguous()) < TOL


@pytest.mark.parametrize("chunk", [4, 100])
def test_banded_inverse_kernel(dev, chunk):
    g = torch.Generator().manual_seed(chunk)
    b, nc, d, cols = 4, 1, 512, 32
    f2 = chunk + 1
    args = [_randn(g, dev, b, nc, f2, d), _randn(g, dev, b, nc, f2, d),
            _randn(g, dev, b, nc, nc, f2, cols),
            _randn(g, dev, b, nc, nc, f2, cols)]
    got = kc.banded_inverse(*args, chunk)
    torch.cuda.synchronize()
    assert _rel(got, kc.banded_inverse_ref(*args, chunk)) < TOL


def test_banded_inverse_kernel_several_chunks(dev):
    g = torch.Generator().manual_seed(5)
    b, nc, chunk, d, cols = 2, 5, 64, 256, 16
    f2 = chunk + 1
    args = [_randn(g, dev, b, nc, f2, d), _randn(g, dev, b, nc, f2, d),
            _randn(g, dev, b, nc, nc, f2, cols),
            _randn(g, dev, b, nc, nc, f2, cols)]
    got = kc.banded_inverse(*args, chunk)
    torch.cuda.synchronize()
    assert _rel(got, kc.banded_inverse_ref(*args, chunk)) < TOL


# (b, n_fft, chunk, lanes): the tiny LM's scoring and training batches;
# odd factors in n_fft (1152 = 128 * 9, 768 = 256 * 3) and in 2C (C = 384),
# nc = 3 (2C does not divide n_fft); n_fft 8192 on the 2-pair tile and
# 16384 on the 1-pair tile
KF_CASES = [(4, 2048, 128, 512), (8, 2048, 128, 512), (2, 1152, 384, 96),
            (2, 768, 256, 96), (1, 8192, 128, 2048), (1, 16384, 128, 4096)]


@pytest.mark.parametrize("b,n_fft,chunk,lanes", KF_CASES)
def test_kf_spectra_kernel(dev, b, n_fft, chunk, lanes):
    """The FFT kernel (causal_fft.cu) takes every one of these shapes."""
    assert kc.kf_spectra_kernel(n_fft, chunk, lanes) == "kf_spectra"
    g = torch.Generator().manual_seed(n_fft + b)
    gr = _randn(g, dev, b, n_fft // 2 + 1, lanes)
    gi = _randn(g, dev, b, n_fft // 2 + 1, lanes)
    before = dict(kc.LAUNCHES)
    got = kc.kf_spectra(gr, gi, n_fft, chunk)
    torch.cuda.synchronize()
    assert kc.LAUNCHES["kf_spectra"] == before["kf_spectra"] + 1
    assert kc.LAUNCHES["kf_spectra_direct"] == before["kf_spectra_direct"]
    want = kc.kf_spectra_ref(gr, gi, n_fft, chunk)
    for a, w in zip(got, want):
        assert _rel(a, w.contiguous()) < TOL


@pytest.mark.parametrize("nc,d,cols", [(8, 512, 32), (16, 512, 32),
                                        (3, 256, 4), (2, 256, 64)])
def test_fused_causal_mix_bwd_kernel(dev, nc, d, cols):
    """The tiny LM's shapes (16-channel gate groups), and groups wider than
    a warp (64 channels) and narrower (4 channels)."""
    g = torch.Generator().manual_seed(100 + nc)
    b, chunk = 2, 128
    v = _randn(g, dev, b, nc * chunk, d)
    kr = _randn(g, dev, b, nc, chunk + 1, nc * cols)
    ki = _randn(g, dev, b, nc, chunk + 1, nc * cols)
    ybar = _randn(g, dev, b, nc * chunk, d)
    before = dict(kc.LAUNCHES)
    got = kc.fused_causal_mix_bwd(v, kr, ki, ybar, chunk, cols)
    torch.cuda.synchronize()
    assert (kc.LAUNCHES["fused_causal_mix_bwd"]
            == before["fused_causal_mix_bwd"] + 1)
    assert (kc.LAUNCHES["fused_causal_mix_bwd_direct"]
            == before["fused_causal_mix_bwd_direct"])
    want = kc.fused_causal_mix_bwd_ref(v, kr, ki, ybar, chunk, cols)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        assert _rel(a, w) < TOL
    _assert_kbar_zero_past_c(got[1], b, nc, chunk, cols)


def _assert_kbar_zero_past_c(kbar, b, nc, chunk, cols):
    kbar = kbar.reshape(b, nc, chunk + 1, nc, cols)      # (B, dl, F2, c, G)
    for dl in range(nc):
        assert int(torch.count_nonzero(kbar[:, dl, :, :dl])) == 0


# (b, nc, chunk, d, cols): the tiny LM's training batch at nc 16, its
# 128-token prompt (nc 1); 2C = 768 = 256 * 3; nc 3 with 1-channel groups;
# 8-channel groups at d 384, whose bin-major blocks take 32 groups and then
# 16
BWD_FFT_CASES = [(8, 16, 128, 512, 32), (4, 1, 128, 512, 32),
                 (2, 3, 384, 256, 64), (2, 3, 128, 64, 64),
                 (1, 4, 128, 384, 48)]


@pytest.mark.parametrize("b,nc,chunk,d,cols", BWD_FFT_CASES)
def test_fused_causal_mix_bwd_fft_kernel_shapes(dev, b, nc, chunk, d, cols):
    """#10's FFT kernel (causal_fft.cu) at these shapes, each output on its
    own, Kbar exactly 0 where c < delta, and the direct kernel not
    launched."""
    assert kc.bwd_fft_plan(nc, chunk, d, cols) is not None
    v, kr, ki = _mix_inputs_at(dev, b, nc, chunk, d, cols, nc * chunk + d)
    ybar = _randn(torch.Generator().manual_seed(chunk), dev, b, nc * chunk,
                  d)
    before = dict(kc.LAUNCHES)
    got = kc.fused_causal_mix_bwd(v, kr, ki, ybar, chunk, cols)
    torch.cuda.synchronize()
    assert (kc.LAUNCHES["fused_causal_mix_bwd"]
            == before["fused_causal_mix_bwd"] + 1)
    assert (kc.LAUNCHES["fused_causal_mix_bwd_direct"]
            == before["fused_causal_mix_bwd_direct"])
    for a, w in zip(got, kc.fused_causal_mix_bwd_ref(v, kr, ki, ybar, chunk,
                                                    cols)):
        assert _rel(a, w) < TOL
    _assert_kbar_zero_past_c(got[1], b, nc, chunk, cols)


@pytest.mark.parametrize("nc", [8, 16])
def test_fused_causal_mix_bwd_direct_kernel(dev, nc):
    """The direct-DFT #10 (causal_bwd.cu), called on its own at the tiny
    LM's training shapes, which the FFT kernel takes on the main path."""
    b, chunk, d, cols = 4, 128, 512, 32
    v, kr, ki = _mix_inputs_at(dev, b, nc, chunk, d, cols, 60 + nc)
    ybar = _randn(torch.Generator().manual_seed(nc), dev, b, nc * chunk, d)
    before = dict(kc.LAUNCHES)
    got = kc.fused_causal_mix_bwd_direct(v, kr, ki, ybar, chunk, cols)
    torch.cuda.synchronize()
    assert (kc.LAUNCHES["fused_causal_mix_bwd_direct"]
            == before["fused_causal_mix_bwd_direct"] + 1)
    assert (kc.LAUNCHES["fused_causal_mix_bwd"]
            == before["fused_causal_mix_bwd"])
    for a, w in zip(got, kc.fused_causal_mix_bwd_ref(v, kr, ki, ybar, chunk,
                                                    cols)):
        assert _rel(a, w) < TOL


@pytest.mark.parametrize("nc,d,cols,dtype", [
    (48, 512, 32, torch.float32), (64, 512, 32, torch.float32),
    (64, 512, 32, torch.bfloat16), (3, 1088, 1, torch.bfloat16)])
def test_fused_causal_mix_bwd_direct_at_long_nc(dev, nc, d, cols, dtype):
    """The tiny LM's backward from seq 6144 on (nc 48, 64), where the FFT
    #10 has no plan, and a gate group of 1088 channels (wider than a
    block: three slices): the wrapper takes the direct #10 (its bf16
    instance for bf16 v and ybar), each output against the plain version,
    Kbar exactly 0 where c < delta."""
    b, chunk = 1, 128
    assert kc.bwd_fft_plan(nc, chunk, d, cols) is None
    v, kr, ki = _mix_inputs_at(dev, b, nc, chunk, d, cols, nc)
    ybar = _randn(torch.Generator().manual_seed(nc + 1), dev, b, nc * chunk,
                  d)
    v, ybar = v.to(dtype), ybar.to(dtype)
    name = "fused_causal_mix_bwd_direct" + (
        "_bf16" if dtype == torch.bfloat16 else "")
    before = dict(kc.LAUNCHES)
    got = kc.fused_causal_mix_bwd(v, kr, ki, ybar, chunk, cols)
    torch.cuda.synchronize()
    assert kc.LAUNCHES[name] == before[name] + 1
    want = kc.fused_causal_mix_bwd_ref(v, kr, ki, ybar, chunk, cols)
    tol = (BF16_TOL if dtype == torch.bfloat16 else TOL, TOL, TOL)
    for a, w, t in zip(got, want, tol):
        assert a.dtype == w.dtype
        assert _rel(a.float(), w.float()) < t
    _assert_kbar_zero_past_c(got[1], b, nc, chunk, cols)


def test_fused_causal_mix_bwd_direct_takes_chunk_129(dev):
    """2C = 258 has the odd factor 129: the wrapper sends #10 to the direct
    kernel there."""
    b, nc, chunk, d, cols = 2, 3, 129, 512, 32
    v, kr, ki = _mix_inputs_at(dev, b, nc, chunk, d, cols, 8)
    ybar = _randn(torch.Generator().manual_seed(9), dev, b, nc * chunk, d)
    before = dict(kc.LAUNCHES)
    got = kc.fused_causal_mix_bwd(v, kr, ki, ybar, chunk, cols)
    torch.cuda.synchronize()
    assert (kc.LAUNCHES["fused_causal_mix_bwd_direct"]
            == before["fused_causal_mix_bwd_direct"] + 1)
    assert (kc.LAUNCHES["fused_causal_mix_bwd"]
            == before["fused_causal_mix_bwd"])
    for a, w in zip(got, kc.fused_causal_mix_bwd_ref(v, kr, ki, ybar, chunk,
                                                    cols)):
        assert _rel(a, w) < TOL


# (b, nc, chunk, d, cols): the 350M's layer at seq 16384 and its 8192- and
# 1024-token prompts; nc 16 at chunk 2048 (seq 32768: a check for longer
# contexts, not a shape of the 350M's paths); small shapes that #6 does not
# take (d not a multiple of 32) with 8- and 1-channel gate groups, and one
# 136-channel group (several channels a thread of the bin-major sums)
LONG_CASES = [(1, 8, 2048, 1024, 64), (1, 4, 2048, 1024, 64),
              (1, 1, 1024, 1024, 64), (1, 16, 2048, 1024, 64),
              (2, 3, 256, 40, 5), (1, 2, 128, 48, 48), (1, 3, 256, 136, 1)]


def _long_inputs(dev, b, nc, chunk, d, cols):
    g = torch.Generator().manual_seed(nc * chunk + d + cols)
    n, f2 = nc * chunk, chunk + 1
    assert not kc.fused_mix_supported(nc, chunk, d, cols)
    assert kc.fused_mix_v3_supported(nc, chunk, d, cols)
    return (_randn(g, dev, b, n, d), _randn(g, dev, b, nc, f2, nc * cols),
            _randn(g, dev, b, nc, f2, nc * cols), _randn(g, dev, b, n, d))


@pytest.mark.parametrize("b,nc,chunk,d,cols", LONG_CASES)
def test_fused_causal_mix_v3_kernel(dev, b, nc, chunk, d, cols):
    v, kr, ki, _ = _long_inputs(dev, b, nc, chunk, d, cols)
    before = kc.LAUNCHES["fused_causal_mix_v3"]
    got = kc.fused_causal_mix(v, kr, ki, chunk, cols)
    torch.cuda.synchronize()
    assert kc.LAUNCHES["fused_causal_mix_v3"] == before + 1
    assert _rel(got, kc.fused_causal_mix_ref(v, kr, ki, chunk, cols)) < TOL


@pytest.mark.parametrize("b,nc,chunk,d,cols", LONG_CASES)
def test_fused_causal_mix_bwd_v3_kernel(dev, b, nc, chunk, d, cols):
    """Each output on its own; Kbar exactly 0 where c < delta."""
    v, kr, ki, ybar = _long_inputs(dev, b, nc, chunk, d, cols)
    before = kc.LAUNCHES["fused_causal_mix_bwd_v3"]
    got = kc.fused_causal_mix_bwd(v, kr, ki, ybar, chunk, cols)
    torch.cuda.synchronize()
    assert kc.LAUNCHES["fused_causal_mix_bwd_v3"] == before + 1
    want = kc.fused_causal_mix_bwd_ref(v, kr, ki, ybar, chunk, cols)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        assert _rel(a, w) < TOL
    kbar = got[1].reshape(b, nc, chunk + 1, nc, cols)
    for dl in range(nc):
        assert int(torch.count_nonzero(kbar[:, dl, :, :dl])) == 0


@pytest.mark.parametrize("plan", [(4, 4, 256), (4, 4, 128), (4, 4, 512),
                                  (4, 2, 256), (4, 8, 256), (2, 4, 256),
                                  (1, 4, 64)])
def test_fused_causal_mix_bwd_every_tile_plan(dev, plan):
    """Each plan (channel pairs and windows a transform block, threads a
    bin-major block) of #10's FFT kernel that chip_smoke.py's sweep times,
    at a small shape."""
    b, nc, chunk, d, cols = 2, 5, 128, 64, 4
    v, kr, ki = _mix_inputs_at(dev, b, nc, chunk, d, cols, 3)
    ybar = _randn(torch.Generator().manual_seed(4), dev, b, nc * chunk, d)
    got = kc._launch_bwd("fused_causal_mix_bwd", v, kr, ki, ybar, chunk,
                         cols, plan)
    torch.cuda.synchronize()
    for a, w in zip(got, kc.fused_causal_mix_bwd_ref(v, kr, ki, ybar, chunk,
                                                    cols)):
        assert _rel(a, w) < TOL


@pytest.mark.parametrize("threads", [32, 256, 384, 512])
def test_kf_seg_rfft_every_block_size(dev, threads):
    """#9 at the threads a block chip_smoke.py's sweep times (and 32), at
    chunk 2048 with more items than blocks."""
    g = torch.Generator().manual_seed(threads)
    kt = _randn(g, dev, 2, 16384, 512)
    got = kc._kf_seg_rfft(kt, 2048, threads)
    torch.cuda.synchronize()
    for a, w in zip(got, kc.kf_seg_rfft_ref(kt, 2048)):
        assert _rel(a, w.contiguous()) < TOL


@pytest.mark.parametrize("plan", [(1, 64), (1, 256), (1, 512), (2, 256),
                                  (2, 512), (4, 256), (4, 512)])
def test_long_kernels_every_tile_plan(dev, plan):
    """Each transform tile plan (channel pairs, threads a block) of #7 and
    #11 that chip_smoke.py's sweep times, at a small shape."""
    b, nc, chunk, d, cols = 2, 3, 256, 40, 5
    v, kr, ki, ybar = _long_inputs(dev, b, nc, chunk, d, cols)
    y = kc._launch_mix("fused_causal_mix_v3", v, kr, ki, chunk, cols, plan)
    got = kc._launch_bwd("fused_causal_mix_bwd_v3", v, kr, ki, ybar, chunk,
                         cols, plan)
    torch.cuda.synchronize()
    assert _rel(y, kc.fused_causal_mix_ref(v, kr, ki, chunk, cols)) < TOL
    for a, w in zip(got, kc.fused_causal_mix_bwd_ref(v, kr, ki, ybar, chunk,
                                                    cols)):
        assert _rel(a, w) < TOL


@pytest.mark.parametrize("b,n,chunk,lanes", [(1, 16384, 2048, 512),
                                             (2, 8192, 2048, 256),
                                             (1, 1024, 128, 64),
                                             (2, 4096, 1024, 8),
                                             (1, 64, 2, 16)])
def test_kf_seg_rfft_kernel(dev, b, n, chunk, lanes):
    g = torch.Generator().manual_seed(n + lanes)
    kt = _randn(g, dev, b, n, lanes)
    before = kc.LAUNCHES["kf_seg_rfft"]
    got = kc.kf_seg_rfft(kt, chunk)
    torch.cuda.synchronize()
    assert kc.LAUNCHES["kf_seg_rfft"] == before + 1
    for a, w in zip(got, kc.kf_seg_rfft_ref(kt, chunk)):
        assert _rel(a, w.contiguous()) < TOL


@pytest.mark.parametrize("chunk", [854, 1024, 1500, 2048, 1499, 2047, 2904])
def test_banded_inverse_kernel_long_chunks(dev, chunk):
    """The chunks past the first design's 32-lane tile (853): the 350M's
    prompts shorter than 2048, through 2C = P O (1024, 2048) or Bluestein
    (M = 4096, 8192, 16384)."""
    g = torch.Generator().manual_seed(chunk)
    b, nc, d, cols = 1, 1, 1024, 64
    f2 = chunk + 1
    assert kc.banded_fft_plan(chunk)[:2] == {
        854: (4096, 0), 1024: (2048, 1), 1500: (8192, 0), 2048: (4096, 1),
        1499: (8192, 0), 2047: (8192, 0), 2904: (16384, 0)}[chunk]
    args = [_randn(g, dev, b, nc, f2, d), _randn(g, dev, b, nc, f2, d),
            _randn(g, dev, b, nc, nc, f2, cols),
            _randn(g, dev, b, nc, nc, f2, cols)]
    got = kc.banded_inverse(*args, chunk)
    torch.cuda.synchronize()
    assert _rel(got, kc.banded_inverse_ref(*args, chunk)) < TOL


@pytest.mark.parametrize("chunk,d", [(4, 512), (100, 512), (1024, 1024),
                                     (1536, 1024), (1500, 1024)])
def test_banded_inverse_every_plan(dev, chunk, d):
    """#5's kernel at every tile plan that fits a block (channel pairs,
    threads) against the plain version: 2C a power of two, with an odd
    factor, Bluestein."""
    g = torch.Generator().manual_seed(chunk)
    b, nc, cols = (4, 1, 32) if d == 512 else (1, 1, 64)
    f2 = chunk + 1
    args = [_randn(g, dev, b, nc, f2, d), _randn(g, dev, b, nc, f2, d),
            _randn(g, dev, b, nc, nc, f2, cols),
            _randn(g, dev, b, nc, nc, f2, cols)]
    want = kc.banded_inverse_ref(*args, chunk)
    length, o, *_ = kc.banded_fft_plan(chunk)
    for np_ in (1, 2, 4):
        for threads in (128, 256, 512):
            if ((o > 1 and threads > 256) or kc._banded_fft_smem(
                    chunk, length, o, np_) > kc.SMEM_MAX):
                continue
            got = kc._banded_inverse(*args, chunk, (np_, threads))
            torch.cuda.synchronize()
            assert _rel(got, want) < TOL, (np_, threads)


def test_banded_inverse_without_gradients_skips_the_function(dev):
    """Under no_grad, and for inputs that require no gradient, #5 launches
    once through its wrapper alone, with the Function path's result; a
    shape, dtype or layout the kernel does not take raises naming it."""
    g = torch.Generator().manual_seed(3)
    b, nc, chunk, d, cols = 1, 2, 1500, 64, 8
    f2 = chunk + 1
    args = [_randn(g, dev, b, nc, f2, d), _randn(g, dev, b, nc, f2, d),
            _randn(g, dev, b, nc, nc, f2, cols),
            _randn(g, dev, b, nc, nc, f2, cols)]
    before = kc.LAUNCHES["banded_inverse"]
    with torch.no_grad():
        fast = kc.banded_inverse(*args, chunk)
    xs = [a.clone().requires_grad_() for a in args]
    slow = kc.banded_inverse(*xs, chunk)
    torch.cuda.synchronize()
    assert kc.LAUNCHES["banded_inverse"] == before + 2
    assert fast.grad_fn is None and slow.grad_fn is not None
    assert torch.equal(fast, slow.detach())
    with pytest.raises(ValueError, match="banded_inverse"):
        kc.banded_inverse(*args, 2905)
    with pytest.raises(TypeError):
        kc.banded_inverse(args[0].double(), *args[1:], chunk)
    with pytest.raises(ValueError, match="contiguous"):
        kc.banded_inverse(args[0].transpose(2, 3).contiguous().transpose(
            2, 3), *args[1:], chunk)
    with pytest.raises(ValueError):
        kc.banded_inverse(args[0].cpu(), *args[1:], chunk)


def test_long_chunk_backward_through_each_wrapper(dev):
    """backward() on the card through kf_seg_rfft, fused_causal_mix at a
    chunk only #7 takes (its backward is #11) and banded_inverse at a long
    chunk: every input's gradient equals the CPU's."""
    g = torch.Generator().manual_seed(19)
    b, nc, chunk, d, cols = 1, 2, 1024, 64, 8
    f2 = chunk + 1
    cases = [
        ("kf_seg_rfft", lambda kt: kc.kf_seg_rfft(kt, chunk),
         [(b, nc * chunk, nc * cols)], [(b, nc, f2, nc * cols)] * 2),
        ("fused_causal_mix",
         lambda v, kr, ki: kc.fused_causal_mix(v, kr, ki, chunk, cols),
         [(b, nc * chunk, d), (b, nc, f2, nc * cols), (b, nc, f2, nc * cols)],
         [(b, nc * chunk, d)]),
        ("banded_inverse", lambda *a: kc.banded_inverse(*a, chunk),
         [(b, nc, f2, d)] * 2 + [(b, nc, nc, f2, cols)] * 2,
         [(b, nc, chunk, d)]),
    ]
    for name, fn, in_shapes, out_shapes in cases:
        inputs = [torch.randn(s, generator=g) for s in in_shapes]
        weights = [torch.randn(s, generator=g) for s in out_shapes]
        bwd_before = kc.LAUNCHES["fused_causal_mix_bwd_v3"]
        got = _grads_on(dev, fn, inputs, weights)
        torch.cuda.synchronize()
        if name == "fused_causal_mix":
            assert kc.LAUNCHES["fused_causal_mix_bwd_v3"] == bwd_before + 1
        want = _grads_on("cpu", fn, inputs, weights)
        for a, w in zip(got, want):
            assert a is not None and a.device.type == "cuda", name
            assert _rel(a.cpu(), w) < 1e-4, name


def _grads_on(device, fn, inputs, weights):
    xs = [x.to(device).requires_grad_() for x in inputs]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * w.to(device)).sum() for o, w in zip(outs, weights))
    loss.backward()
    return [x.grad for x in xs]


def test_backward_through_each_wrapper(dev):
    """backward() through the three Functions on the card reaches a
    gradient for every input, equal to the CPU's (plain versions)."""
    g = torch.Generator().manual_seed(9)
    b, nc, chunk, d, cols = 2, 4, 128, 256, 16
    f2 = chunk + 1
    cases = [
        ("fused_causal_mix",
         lambda v, kr, ki: kc.fused_causal_mix(v, kr, ki, chunk, cols),
         [(b, nc * chunk, d), (b, nc, f2, nc * cols), (b, nc, f2, nc * cols)],
         [(b, nc * chunk, d)]),
        ("kf_spectra",
         lambda gr, gi: kc.kf_spectra(gr, gi, nc * chunk, chunk),
         [(b, nc * chunk // 2 + 1, 64)] * 2, [(b, nc, f2, 64)] * 2),
        ("banded_inverse",
         lambda *a: kc.banded_inverse(*a, chunk),
         [(b, nc, f2, d)] * 2 + [(b, nc, nc, f2, cols)] * 2,
         [(b, nc, chunk, d)]),
    ]
    for name, fn, in_shapes, out_shapes in cases:
        inputs = [torch.randn(s, generator=g) for s in in_shapes]
        weights = [torch.randn(s, generator=g) for s in out_shapes]
        bwd_before = kc.LAUNCHES["fused_causal_mix_bwd"]
        got = _grads_on(dev, fn, inputs, weights)
        torch.cuda.synchronize()
        if name == "fused_causal_mix":
            assert kc.LAUNCHES["fused_causal_mix_bwd"] == bwd_before + 1
        want = _grads_on("cpu", fn, inputs, weights)
        for a, w in zip(got, want):
            assert a is not None and a.device.type == "cuda", name
            assert _rel(a.cpu(), w) < 1e-4, name


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    v = torch.zeros((1, 256, 64), dtype=torch.float64, device=dev)
    k = torch.zeros((1, 2, 129, 8), device=dev)
    with pytest.raises(TypeError):
        kc.fused_causal_mix(v, k, k, 128, 4)
    v32 = torch.zeros((1, 64, 256), device=dev).transpose(1, 2)
    with pytest.raises(ValueError):
        kc.fused_causal_mix(v32, k, k, 128, 4)
    with pytest.raises(ValueError):           # mixed devices
        kc.fused_causal_mix(v32.contiguous(), k.cpu(), k, 128, 4)
    gr = torch.zeros((1, 8193, 512), device=dev)
    with pytest.raises(ValueError):           # past the shared memory
        kc.kf_spectra(gr, gr, 16384, 1024)


# n_fft, d_g: config 1's 1024 with 16-channel groups; groups of 8 and 64
# channels (a CTA holds whole groups, clusters of 2 and 8 CTAs do); the
# odd factor 3 (768, 1536), n = 2 mod 4 (254 = 2 * 127, a direct DFT);
# one-channel groups, groups of 3 and 6 channels (d = 384) and one group
# of all 512 channels (the second launch)
MIX_CASES = ([(n, dg) for n in (64, 256, 1024, 2048) for dg in (8, 16, 64)]
             + [(768, 16), (1536, 16), (254, 16), (1024, 1), (1536, 3),
                (254, 6), (768, 512)])


def _mix_inputs(dev, n_fft, d_g, seed, b=2, d=None):
    d = d or (384 if d_g % 3 == 0 else 512)
    g = torch.Generator().manual_seed(seed)
    cols, fh = d // d_g, n_fft // 2 + 1
    return (_randn(g, dev, b, n_fft, d), _randn(g, dev, b, fh, cols),
            _randn(g, dev, b, fh, cols), _randn(g, dev, n_fft, d),
            _randn(g, dev, b, n_fft, d))


@pytest.mark.parametrize("n_fft,d_g", MIX_CASES)
def test_direct_mix_kernel(dev, n_fft, d_g):
    v, gr, gi, mem_t, _ = _mix_inputs(dev, n_fft, d_g, n_fft + d_g)
    for m in (mem_t, None):
        before = sm.LAUNCHES["direct_mix"]
        got = sm.direct_mix(v, gr, gi, m, n_fft)
        torch.cuda.synchronize()
        assert sm.LAUNCHES["direct_mix"] == before + 1
        assert _rel(got, sm.direct_mix_ref(v, gr, gi, m, n_fft)) < TOL


@pytest.mark.parametrize("n_fft,d_g", MIX_CASES)
def test_direct_mix_bwd_kernel(dev, n_fft, d_g):
    v, gr, gi, _, ybar = _mix_inputs(dev, n_fft, d_g, 7 * n_fft + d_g)
    before = sm.LAUNCHES["direct_mix_bwd"]
    got = sm.direct_mix_bwd(v, gr, gi, ybar, n_fft)
    torch.cuda.synchronize()
    assert sm.LAUNCHES["direct_mix_bwd"] == before + 1
    want = sm.direct_mix_bwd_ref(v, gr, gi, ybar, n_fft)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        assert _rel(a, w) < TOL


def test_direct_mix_bwd_is_one_launch_at_config1(dev):
    """#2 at config 1 (B=8, n_fft 1024, d=512, 16-channel groups) is one
    CUDA kernel launch (torch.profiler's device events), no group-sum
    kernel, and repeats bit for bit."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    v, gr, gi, _, ybar = _mix_inputs(dev, 1024, 16, 5, b=8)
    first = sm.direct_mix_bwd(v, gr, gi, ybar, 1024)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = sm.direct_mix_bwd(v, gr, gi, ybar, 1024)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "mix_bwd_kernel" in kernels[0], kernels
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_spectral_mix_backward_on_card(dev):
    """backward() through the spectral_mix Function on the card runs
    direct_mix_bwd and gives every input the CPU's gradient."""
    n_fft = 1024
    inputs = [t.cpu() for t in _mix_inputs(dev, n_fft, 16, 3)[:4]]
    w = torch.randn((2, n_fft, 512),
                    generator=torch.Generator().manual_seed(4))
    before = sm.LAUNCHES["direct_mix_bwd"]
    got = _grads_on(dev, lambda *a: sm.spectral_mix(*a, n_fft), inputs, [w])
    torch.cuda.synchronize()
    assert sm.LAUNCHES["direct_mix_bwd"] == before + 1
    want = _grads_on("cpu", lambda *a: sm.spectral_mix(*a, n_fft), inputs,
                     [w])
    for a, b in zip(got, want):
        assert a is not None and a.device.type == "cuda"
        assert _rel(a.cpu(), b) < 1e-4


def test_direct_mix_refuses_what_the_kernels_do_not_take(dev):
    for n_fft, match in ((4096, "#3 .*range"), (16384, "#4 .*range"),
                         (1000, "unsupported")):
        v, gr, gi, _, _ = _mix_inputs(dev, n_fft, 16, 0, b=1, d=64)
        with pytest.raises(ValueError, match=match):
            sm.direct_mix(v, gr, gi, None, n_fft)


# (b, n_fft, d, cols): config 1's block at 4096 (B=2) and 8192 (B=1), odd
# factors 9, 17 and 31
STAGED_CASES = [(2, 4096, 512, 32), (1, 8192, 512, 32), (1, 2304, 512, 32),
                (1, 4352, 128, 32), (1, 7936, 512, 32)]


@pytest.mark.parametrize("b,n_fft,d,cols", STAGED_CASES)
def test_staged_mix_kernel(dev, b, n_fft, d, cols):
    v, gr, gi, mem_t, _ = _mix_inputs(dev, n_fft, d // cols, n_fft, b=b, d=d)
    for m in (mem_t, None):
        before = sm.LAUNCHES["staged_mix"]
        got = sm.staged_mix(v, gr, gi, m, n_fft)
        torch.cuda.synchronize()
        assert sm.LAUNCHES["staged_mix"] == before + 1
        assert _rel(got, sm.staged_mix_ref(v, gr, gi, m, n_fft)) < TOL


@pytest.mark.parametrize("m", range(9, 33))
def test_staged_mix_kernel_every_length(dev, m):
    """Every n_fft = 256 m the layer sends #3 (each odd factor's instance
    of the kernel), at d=128 with 4-channel gate groups."""
    n_fft = 256 * m
    v, gr, gi, mem_t, _ = _mix_inputs(dev, n_fft, 4, m, b=1, d=128)
    got = sm.staged_mix(v, gr, gi, mem_t, n_fft)
    torch.cuda.synchronize()
    assert _rel(got, sm.staged_mix_ref(v, gr, gi, mem_t, n_fft)) < TOL


@pytest.mark.parametrize("n_fft", [16384, 32768, 65536])
def test_twopass_mix_kernel(dev, n_fft):
    v, gr, gi, mem_t, _ = _mix_inputs(dev, n_fft, 16, n_fft, b=1, d=512)
    for m in (mem_t, None):
        before = sm.LAUNCHES["twopass_mix"]
        got = sm.twopass_mix(v, gr, gi, m, n_fft)
        torch.cuda.synchronize()
        assert sm.LAUNCHES["twopass_mix"] == before + 1
        assert _rel(got, sm.twopass_mix_ref(v, gr, gi, m, n_fft)) < TOL


# (wrapper, B, n_fft, (cs, np, threads)): every instance of the kernel that
# #3 and #4 share (csrc/mix_fft.cuh), beside the plans the wrappers pick
PLAN_CASES = [("twopass_mix", 1, 16384, (cs, np_, 256))
              for cs, np_ in sm.LONG_INSTANCES["twopass_mix"]
              if sm.long_plan_fits(16384, (cs, np_, 256))]
PLAN_CASES += [("staged_mix", 2, 4096, (cs, np_, 512))
               for cs, np_ in sm.LONG_INSTANCES["staged_mix"]]
PLAN_CASES += [("staged_mix", 1, 2304, (1, np_, 128)) for np_ in (1, 2)]


@pytest.mark.parametrize("name,b,n_fft,plan", PLAN_CASES)
def test_long_mix_kernel_plans(dev, name, b, n_fft, plan):
    v, gr, gi, mem_t, _ = _mix_inputs(dev, n_fft, 16, n_fft + plan[0], b=b,
                                      d=128)
    got = sm._launch_long(name, v, gr, gi, mem_t, n_fft, plan)
    torch.cuda.synchronize()
    assert _rel(got, sm.twopass_mix_ref(v, gr, gi, mem_t, n_fft)) < TOL


def test_twopass_mix_allocates_no_scratch(dev):
    """One call of #4 at n_fft 65536 raises the peak of allocated device
    memory by y's bytes and no more (a small slack): the spectrum stays in
    the cluster's shared memory."""
    n_fft = 65536
    v, gr, gi, mem_t, _ = _mix_inputs(dev, n_fft, 16, 7, b=1, d=512)
    sm.twopass_mix(v, gr, gi, mem_t, n_fft)      # the twiddle tables
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    y = sm.twopass_mix(v, gr, gi, mem_t, n_fft)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated(dev) - before
    assert y.numel() * 4 <= grown <= y.numel() * 4 + (1 << 20)


def test_staged_and_twopass_refuse_what_their_kernels_do_not_take(dev):
    v, gr, gi, _, _ = _mix_inputs(dev, 4096, 16, 0, b=1, d=96)
    with pytest.raises(ValueError, match="#3 .*unsupported"):
        sm.staged_mix(v, gr, gi, None, 4096)
    v, gr, gi, _, _ = _mix_inputs(dev, 8192, 16, 0, b=1, d=128)
    with pytest.raises(ValueError, match="#4 .*#3"):
        sm.twopass_mix(v, gr, gi, None, 8192)
    with pytest.raises(ValueError, match="contiguous"):
        sm.staged_mix(v.transpose(1, 2).contiguous().transpose(1, 2), gr,
                      gi, None, 8192)


def test_spectral_mix_backward_on_card_past_2048(dev):
    """backward() through the spectral_mix Function at n_fft 4096 on the
    card: #3 forward, autograd through unfused_mix (cuFFT) backward, never
    #2; every input's gradient equals the CPU's."""
    n_fft = 4096
    inputs = [t.cpu() for t in _mix_inputs(dev, n_fft, 16, 5, b=1)[:4]]
    w = torch.randn((1, n_fft, 512),
                    generator=torch.Generator().manual_seed(6))
    before = dict(sm.LAUNCHES)
    got = _grads_on(dev, lambda *a: sm.spectral_mix(*a, n_fft), inputs, [w])
    torch.cuda.synchronize()
    assert sm.LAUNCHES["staged_mix"] == before["staged_mix"] + 1
    assert sm.LAUNCHES["direct_mix_bwd"] == before["direct_mix_bwd"]
    want = _grads_on("cpu", lambda *a: sm.spectral_mix(*a, n_fft), inputs,
                     [w])
    for a, b in zip(got, want):
        assert a is not None and a.device.type == "cuda"
        assert _rel(a.cpu(), b) < 1e-4


# (B, H, n, hd, G): the tiny LM's decode at batch 4 and the 350M's at 1
DECODE_CASES = [(4, 8, 2048, 64, 4), (1, 16, 16384, 64, 4)]


@pytest.mark.parametrize("b,h,n,hd,groups", DECODE_CASES)
@pytest.mark.parametrize("evict", [0, 1])
def test_fused_decode_mix_kernel(dev, b, h, n, hd, groups, evict):
    """In place: the kernel's updated prefix and y against the plain
    version's from the same state, at the last ring slot and position."""
    g = torch.Generator().manual_seed(n + evict)
    f = n // 2 + 1
    prefix = torch.complex(_randn(g, dev, b, h, f, hd),
                           _randn(g, dev, b, h, f, hd))
    gate = torch.complex(_randn(g, dev, b, h, groups, f),
                         _randn(g, dev, b, h, groups, f))
    v_t, v_buf = _randn(g, dev, b, h, hd), _randn(g, dev, b, h, n, hd)
    want_prefix = prefix.clone()
    before = kd.LAUNCHES["fused_decode_mix"]
    got = kd.fused_decode_mix(prefix, gate, v_t, v_buf, evict, n - 1, n - 1)
    torch.cuda.synchronize()
    assert kd.LAUNCHES["fused_decode_mix"] == before + 1
    want = kd.fused_decode_mix_ref(want_prefix, gate, v_t, v_buf, evict,
                                   n - 1, n - 1)
    assert _rel(prefix, want_prefix) < TOL
    assert _rel(got, want) < TOL


# ---------------------------------------------------------------------------
# the 350M at seq 32768 and 65536, and bf16 (module 5b and the fast mode)
# ---------------------------------------------------------------------------

# bf16 against the plain version on the same bf16 inputs: only the
# output's rounding to bf16 differs (the fp32 Kbar within TOL)
BF16_TOL = 1e-2


@pytest.mark.parametrize("nc", [16, 32])
def test_long_kernels_at_nc_16_and_32(dev, nc):
    """#7 and #11 (fp32) at the 350M's layer at seq 32768 and 65536."""
    b, chunk, d, cols = 1, 2048, 1024, 64
    v, kr, ki, ybar = _long_inputs(dev, b, nc, chunk, d, cols)
    got = kc.fused_causal_mix(v, kr, ki, chunk, cols)
    assert _rel(got, kc.fused_causal_mix_ref(v, kr, ki, chunk, cols)) < TOL
    got = kc.fused_causal_mix_bwd(v, kr, ki, ybar, chunk, cols)
    want = kc.fused_causal_mix_bwd_ref(v, kr, ki, ybar, chunk, cols)
    for a, w in zip(got, want):
        assert _rel(a, w) < TOL


@pytest.mark.parametrize("b,nc,chunk,d,cols", [
    (1, 16, 2048, 1024, 64), (1, 32, 2048, 1024, 64), (2, 3, 256, 40, 5)])
def test_long_kernels_bf16_instances(dev, b, nc, chunk, d, cols):
    """#7's and #11's bf16 instances: bf16 v and ybar in, y and vbar bf16
    and Kbar fp32 out, each against the plain version on the same inputs;
    launched under their own names."""
    v, kr, ki, ybar = _long_inputs(dev, b, nc, chunk, d, cols)
    v, ybar = v.bfloat16(), ybar.bfloat16()
    before = dict(kc.LAUNCHES)
    y = kc.fused_causal_mix(v, kr, ki, chunk, cols)
    got = kc.fused_causal_mix_bwd(v, kr, ki, ybar, chunk, cols)
    torch.cuda.synchronize()
    for name in ("fused_causal_mix_v3_bf16", "fused_causal_mix_bwd_v3_bf16"):
        assert kc.LAUNCHES[name] == before[name] + 1
    for name in ("fused_causal_mix_v3", "fused_causal_mix_bwd_v3"):
        assert kc.LAUNCHES[name] == before[name]
    want = kc.fused_causal_mix_ref(v, kr, ki, chunk, cols)
    assert y.dtype == torch.bfloat16
    assert _rel(y.float(), want.float()) < BF16_TOL
    want = kc.fused_causal_mix_bwd_ref(v, kr, ki, ybar, chunk, cols)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32,
                                      torch.float32]
    assert _rel(got[0].float(), want[0].float()) < BF16_TOL
    assert _rel(got[1], want[1]) < TOL and _rel(got[2], want[2]) < TOL


def test_bf16_refuses_kernels_without_a_bf16_variant(dev):
    """Every causal kernel has a bf16 instance now: a bf16 backward that
    reaches the direct #10 (a 600-token chunk, whose 2C = 1200 takes no FFT
    plan), through the wrapper and by name, runs its bf16 instance (vbar
    bf16, Kbar fp32, each against the plain version), never its fp32
    one, and raises nothing."""
    v, kr, ki = _mix_inputs_at(dev, 1, 1, 600, 1024, 64, 0)
    # a ybar of its own: with ybar = v, Kbar's one lag is real and its
    # imaginary plane rounding noise on both sides
    vb = v.bfloat16()
    yb = _randn(torch.Generator().manual_seed(1), dev, 1, 600,
                1024).bfloat16()
    want = kc.fused_causal_mix_bwd_ref(vb, kr, ki, yb, 600, 64)
    for fn in (kc.fused_causal_mix_bwd, kc.fused_causal_mix_bwd_direct):
        before = dict(kc.LAUNCHES)
        got = fn(vb, kr, ki, yb, 600, 64)
        _bf16_check(got, want, ("fused_causal_mix_bwd_direct_bf16",),
                    before)


def _bf16_check(got, want, names, before):
    """Each output against the plain version's (bf16 ones within BF16_TOL,
    fp32 ones within TOL), the dtypes equal, each of ``names`` launched
    once and its fp32 instance never."""
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert a.dtype == w.dtype
        tol = BF16_TOL if a.dtype == torch.bfloat16 else TOL
        assert _rel(a.float(), w.float()) < tol
    launches = {**kc.LAUNCHES, **sm.LAUNCHES}
    for name in names:
        assert launches[name] == before[name] + 1, name
        fp32 = name.removesuffix("_bf16")
        assert launches[fp32] == before[fp32], fp32


@pytest.mark.parametrize("b,nc,chunk,d,cols", [
    (4, 16, 128, 512, 32), (1, 1, 512, 1024, 64), (2, 3, 128, 64, 8)])
def test_tiny_causal_kernels_bf16_instances(dev, b, nc, chunk, d, cols):
    """#6's and #10's FFT kernels in bf16 (the tiny LM's shape, a 350M
    prompt of 512 tokens, a narrow one): bf16 v and ybar in, y and vbar
    bf16 and Kbar fp32 out."""
    v, kr, ki = _mix_inputs_at(dev, b, nc, chunk, d, cols, chunk + nc)
    v = v.bfloat16()
    ybar = torch.randn(v.shape, generator=torch.Generator().manual_seed(
        nc)).to(dev).bfloat16()
    before = {**kc.LAUNCHES, **sm.LAUNCHES}
    got = (kc.fused_causal_mix(v, kr, ki, chunk, cols),
           *kc.fused_causal_mix_bwd(v, kr, ki, ybar, chunk, cols))
    want = (kc.fused_causal_mix_ref(v, kr, ki, chunk, cols),
            *kc.fused_causal_mix_bwd_ref(v, kr, ki, ybar, chunk, cols))
    _bf16_check(got, want, ("fused_causal_mix_bf16",
                            "fused_causal_mix_bwd_bf16"), before)


@pytest.mark.parametrize("nc,chunk", [(1, 600), (2, 129)])
def test_direct_causal_mix_bf16_instance(dev, nc, chunk):
    """The direct #6 in bf16 (a 350M prompt of 600 tokens, and nc 2 at
    chunk 129)."""
    v, kr, ki = _mix_inputs_at(dev, 1, nc, chunk, 1024, 64, chunk)
    v = v.bfloat16()
    assert kc._mix_kernel("fused_causal_mix", nc * chunk, chunk, 1024, 64,
                          torch.bfloat16) == "fused_causal_mix_direct"
    before = {**kc.LAUNCHES, **sm.LAUNCHES}
    got = kc.fused_causal_mix(v, kr, ki, chunk, 64)
    _bf16_check((got,), (kc.fused_causal_mix_ref(v, kr, ki, chunk, 64),),
                ("fused_causal_mix_direct_bf16",), before)


@pytest.mark.parametrize("b,n,mem", [(8, 1024, True), (2, 768, False),
                                     (2, 200, True)])
def test_direct_mix_bf16_instances(dev, b, n, mem):
    """#1 and #2 in bf16: config 1's shape, an odd factor (768 = 256 * 3)
    and a direct DFT (200); y and vbar bf16, the gate cotangent fp32."""
    g = torch.Generator().manual_seed(n)
    d, cols, fh = 512, 32, n // 2 + 1
    v, ybar = (_randn(g, dev, b, n, d).bfloat16() for _ in range(2))
    gr, gi = _randn(g, dev, b, fh, cols), _randn(g, dev, b, fh, cols)
    mem_t = _randn(g, dev, n, d) if mem else None
    before = {**kc.LAUNCHES, **sm.LAUNCHES}
    got = (sm.direct_mix(v, gr, gi, mem_t, n),
           *sm.direct_mix_bwd(v, gr, gi, ybar, n))
    want = (sm.direct_mix_ref(v, gr, gi, mem_t, n),
            *sm.direct_mix_bwd_ref(v, gr, gi, ybar, n))
    _bf16_check(got, want, ("direct_mix_bf16", "direct_mix_bwd_bf16"),
                before)


@pytest.mark.parametrize("name,b,n", [
    ("staged_mix", 2, 4096), ("staged_mix", 1, 8192),
    ("staged_mix", 1, 2304), ("twopass_mix", 1, 16384),
    ("twopass_mix", 1, 65536)])
def test_long_mix_bf16_instances(dev, name, b, n):
    """#3 and #4 in bf16 at their plans' lengths (and 2304, an odd
    factor), with memory."""
    g = torch.Generator().manual_seed(n)
    d, cols, fh = 512, 32, n // 2 + 1
    v = _randn(g, dev, b, n, d).bfloat16()
    gr, gi = _randn(g, dev, b, fh, cols), _randn(g, dev, b, fh, cols)
    mem_t = _randn(g, dev, n, d)
    before = {**kc.LAUNCHES, **sm.LAUNCHES}
    got = getattr(sm, name)(v, gr, gi, mem_t, n)
    _bf16_check((got,), (sm.direct_mix_ref(v, gr, gi, mem_t, n),),
                (name + "_bf16",), before)


def test_bf16_refuses_rows_off_alignment(dev):
    """The bf16 instances move whole rows of channel pairs: a bf16 v that
    does not start on 16 bytes is refused with a clear error."""
    g = torch.Generator().manual_seed(1)
    v = _randn(g, dev, 1, 1024 * 512 + 1).bfloat16()[:, 1:].view(
        1, 1024, 512)
    gr = _randn(g, dev, 1, 513, 32)
    with pytest.raises(ValueError, match="16-byte"):
        sm.direct_mix(v, gr, gr, None, 1024)


@pytest.mark.parametrize("n", [32768, 65536])
@pytest.mark.parametrize("evict", [0, 1])
def test_fused_decode_mix_kernel_at_long_windows(dev, n, evict):
    """#12 at the 350M's decode windows of seq 32768 and 65536 (F_half
    16385, 32769), at the last ring slot and position; the decode budget
    (2e-5, COMPONENTS.md 2.4) for y, a sum of F_half terms."""
    b, h, hd, groups = 1, 16, 64, 4
    g = torch.Generator().manual_seed(n + evict)
    f = n // 2 + 1
    prefix = torch.complex(_randn(g, dev, b, h, f, hd),
                           _randn(g, dev, b, h, f, hd))
    gate = torch.complex(_randn(g, dev, b, h, groups, f),
                         _randn(g, dev, b, h, groups, f))
    v_t, v_buf = _randn(g, dev, b, h, hd), _randn(g, dev, b, h, n, hd)
    want_prefix = prefix.clone()
    got = kd.fused_decode_mix(prefix, gate, v_t, v_buf, evict, n - 1, n - 2)
    want = kd.fused_decode_mix_ref(want_prefix, gate, v_t, v_buf, evict,
                                   n - 1, n - 2)
    torch.cuda.synchronize()
    assert _rel(prefix, want_prefix) < TOL
    assert _rel(got, want) < 2e-5
