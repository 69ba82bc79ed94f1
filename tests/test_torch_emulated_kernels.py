"""The spectral-mix CUDA kernels (fft_tpu_torch/csrc/spectral_mix.cu) run
on the CPU through tests/cuda_emulation.py, against their plain PyTorch
versions: the kernels' index arithmetic, shared-memory layout and barriers
at small shapes, on a machine without nvcc or a card.  Same bound as on
the card (max|a-b| / max|b| < 2e-5: radix-2 FFTs against pocketfft, both
fp32).  Skips where there is no host C++ compiler."""

import pytest
import torch

from fft_tpu_torch.kernels import build as kb
from fft_tpu_torch.kernels import spectral_mix as sm
from fft_tpu_torch.kernels.common import twiddles_np
from tests import cuda_emulation

TOL = 2e-5


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if cuda_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++)")
    lib = cuda_emulation.build(kb.CSRC_DIR / "spectral_mix.cu",
                               tmp_path_factory.mktemp("emu"))
    for name in ("fft_direct_mix", "fft_direct_mix_bwd"):
        argtypes, restype = kb._SIGNATURES[name]
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = restype
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


# (n_fft, d, cols, memory): 2- to 64-channel groups, tiles holding whole
# groups and groups spanning tiles (the second, group-sum launch)
CASES = [(8, 32, 16, True), (64, 32, 4, False), (64, 32, 2, True),
         (256, 64, 8, True), (256, 64, 1, False), (1024, 32, 2, True),
         (2048, 16, 1, True), (2048, 32, 16, False)]


@pytest.mark.parametrize("n,d,cols,mem", CASES)
def test_emulated_kernels_match_plain_versions(lib, n, d, cols, mem):
    assert sm.direct_supported(n, d, cols)
    g = torch.Generator().manual_seed(n + d + cols)
    b, fh = 2, n // 2 + 1
    v, ybar = (torch.randn(b, n, d, generator=g) for _ in range(2))
    gr, gi = (torch.randn(b, fh, cols, generator=g) for _ in range(2))
    mem_t = torch.randn(n, d, generator=g) if mem else None
    tw = torch.from_numpy(twiddles_np(n))
    ct = sm._tile(n)

    y = torch.empty_like(v)
    assert lib.fft_direct_mix(_ptr(v), _ptr(gr), _ptr(gi), _ptr(mem_t),
                              _ptr(tw), _ptr(y), b, n, d, cols, ct,
                              None) == 0
    assert _rel(y, sm.direct_mix_ref(v, gr, gi, mem_t, n)) < TOL

    unit = min(d // cols, ct // 2)
    out = [torch.empty_like(v), torch.empty_like(gr), torch.empty_like(gi)]
    parts = ([torch.empty(b, fh, d // unit) for _ in range(2)]
             if unit < d // cols else [None, None])
    assert lib.fft_direct_mix_bwd(
        _ptr(v), _ptr(ybar), _ptr(gr), _ptr(gi), _ptr(tw),
        *(_ptr(t) for t in out), *(_ptr(p) for p in parts), b, n, d, cols,
        ct // 2, None) == 0
    for got, want in zip(out, sm.direct_mix_bwd_ref(v, gr, gi, ybar, n)):
        assert _rel(got, want) < TOL


def test_plain_adjoint_is_autograd_of_the_plain_forward():
    """direct_mix_bwd_ref, written out, equals autograd through
    direct_mix_ref (with the memory constant)."""
    n, d, cols = 64, 32, 4
    g = torch.Generator().manual_seed(1)
    v = torch.randn(2, n, d, generator=g, requires_grad=True)
    gr = torch.randn(2, n // 2 + 1, cols, generator=g, requires_grad=True)
    gi = torch.randn(2, n // 2 + 1, cols, generator=g, requires_grad=True)
    ybar = torch.randn(2, n, d, generator=g)
    sm.direct_mix_ref(v, gr, gi, torch.randn(n, d, generator=g),
                      n).backward(ybar)
    want = sm.direct_mix_bwd_ref(v.detach(), gr.detach(), gi.detach(), ybar,
                                 n)
    for t, w in zip((v, gr, gi), want):
        assert _rel(t.grad, w) < 1e-5
