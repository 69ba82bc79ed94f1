"""fft_tpu_torch.kernels.spectral_mix on the CPU (the kernels' plain
versions) against fft_tpu's Pallas spectral-mix kernels, run in interpret
mode as tests/test_pallas_mix.py runs them: the same numpy-seeded inputs
through both, max|a-b| / max|b| within 1e-5 (fp32 on both sides; dense DFT
matmuls there, FFTs here, summing in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_tpu.kernels.pallas_fft as pf
from fft_tpu_torch.kernels import spectral_mix as sm
from fft_tpu_torch.ops import fftops
from tests.golden_utils import rel_err

TOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = pf.INTERPRET
    pf.INTERPRET = True
    yield
    pf.INTERPRET = old


def _inputs(n, b=2, d=128, hg=8, seed=0):
    """v (B, N, d), compact gate (B, F, hg) complex, memory (F, d) complex,
    ybar (B, N, d), all numpy."""
    rng = np.random.default_rng(seed)
    f = n // 2 + 1

    def cplx(shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    v = rng.standard_normal((b, n, d)).astype(np.float32)
    return (v, cplx((b, f, hg)), cplx((f, d)),
            rng.standard_normal((b, n, d)).astype(np.float32))


def _planes(gate):
    g = torch.from_numpy(gate)
    return g.real.contiguous(), g.imag.contiguous()


@pytest.mark.parametrize("n", [64, 512, 2048])
@pytest.mark.parametrize("with_mem", [False, True])
def test_direct_mix_ref_matches_pallas(n, with_mem):
    v, gate, mem, _ = _inputs(n, seed=n)
    mem = mem if with_mem else None
    ref = np.asarray(pf.fused_spectral_mix(
        jnp.asarray(v), jnp.asarray(gate),
        None if mem is None else jnp.asarray(mem), n_fft=n))
    mem_t = (None if mem is None
             else fftops.irfft(torch.from_numpy(mem), n, dim=0))
    got = sm.direct_mix(torch.from_numpy(v), *_planes(gate), mem_t, n)
    assert rel_err(got.numpy(), ref) < TOL


@pytest.mark.parametrize("n", [64, 128])
def test_direct_mix_bwd_ref_matches_pallas(n):
    """Against pf._mix_bwd in both of JAX's modes (the fused adjoint kernel
    and jax.vjp of the composition) and against _direct_mix_bwd_call with
    two channel blocks (dblk=128).  JAX's gate cotangent is the conjugate of
    (dL/dRe + i dL/dIm) (pallas_fft.py:854): only real planes compare."""
    v, gate, _, ybar = _inputs(n, d=256, hg=8, seed=7)
    got = sm.direct_mix_bwd(torch.from_numpy(v), *_planes(gate),
                            torch.from_numpy(ybar), n)
    args = (jnp.asarray(v), jnp.asarray(gate), None)
    for fast in (True, False):
        vbar, gbar, _ = pf._mix_bwd(n, fast, args, jnp.asarray(ybar))
        gbar = np.asarray(gbar)
        for a, r in zip(got, (np.asarray(vbar), gbar.real, -gbar.imag)):
            assert rel_err(a.numpy(), r) < TOL
    ref = pf._direct_mix_bwd_call(
        jnp.asarray(v), jnp.real(args[1]), jnp.imag(args[1]),
        jnp.asarray(ybar), n_fft=n, interpret=True, dblk=128)
    for a, r in zip(got, ref):
        assert rel_err(a.numpy(), np.asarray(r)) < TOL


@pytest.mark.parametrize("hg", [8, 128])
def test_unfused_mix_matches_jax(hg):
    n = 256
    v, gate, mem, _ = _inputs(n, hg=hg, seed=hg)
    ref = np.asarray(pf._unfused_mix(jnp.asarray(v), jnp.asarray(gate),
                                     jnp.asarray(mem), n))
    got = sm.unfused_mix(torch.from_numpy(v), torch.from_numpy(gate),
                         torch.from_numpy(mem), n)
    assert rel_err(got.numpy(), ref) < TOL


def test_direct_mix_equals_unfused_with_memory_in_the_spectrum():
    """Memory as the kernel's time-domain constant irfft(mem) == memory
    added to the spectrum before the inverse (pallas_fft.py:736-750)."""
    n = 128
    v, gate, mem, _ = _inputs(n, seed=3)
    mem_t = fftops.irfft(torch.from_numpy(mem), n, dim=0)
    a = sm.direct_mix(torch.from_numpy(v), *_planes(gate), mem_t, n)
    b = sm.unfused_mix(torch.from_numpy(v), torch.from_numpy(gate),
                       torch.from_numpy(mem), n)
    assert rel_err(a.numpy(), b.numpy()) < TOL


def test_spectral_mix_grads_match_jax_grad():
    """backward() through the Function (CPU: direct_mix_bwd_ref) against
    jax.grad of pf.spectral_mix, both taking the gate as real planes; the
    time-domain memory's gradient is ybar summed over the batch."""
    n = 64
    v, gate, mem, w = _inputs(n, seed=11)
    gr, gi = np.real(gate).copy(), np.imag(gate).copy()

    def loss_jax(v_, gr_, gi_):
        y = pf.spectral_mix(v_, jax.lax.complex(gr_, gi_), jnp.asarray(mem),
                            n, False)
        return jnp.sum(y * w)

    ref = jax.grad(loss_jax, argnums=(0, 1, 2))(
        jnp.asarray(v), jnp.asarray(gr), jnp.asarray(gi))
    ts = [torch.from_numpy(a).requires_grad_() for a in (v, gr, gi)]
    mem_t = fftops.irfft(torch.from_numpy(mem), n, dim=0).requires_grad_()
    y = sm.spectral_mix(*ts, mem_t, n)
    assert y.grad_fn is not None
    (y * torch.from_numpy(w)).sum().backward()
    for t, r in zip(ts, ref):
        assert rel_err(t.grad.numpy(), np.asarray(r)) < 1e-4
    assert torch.allclose(mem_t.grad, torch.from_numpy(w).sum(0))


def test_cpu_tensors_take_the_plain_versions():
    n = 64
    v, gate, _, ybar = _inputs(n, seed=5)
    sm.reset_launches()
    sm.direct_mix(torch.from_numpy(v), *_planes(gate), None, n)
    sm.direct_mix_bwd(torch.from_numpy(v), *_planes(gate),
                      torch.from_numpy(ybar), n)
    for fn in (sm.staged_mix, sm.twopass_mix):
        fn(torch.from_numpy(v), *_planes(gate), None, n)
    assert set(sm.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("n_fft,d,cols,ok", [
    (1024, 512, 32, True),      # BASELINE config 1: 16-channel groups
    (2048, 512, 32, True),      # two backward tiles per group
    (8, 64, 16, True),
    (64, 512, 8, True),         # 64-channel groups
    (1000, 512, 32, False),     # not a power of two
    (1024, 512, 512, False),    # one-channel groups
    (1024, 96, 32, False),      # 3-channel groups
    (1024, 40, 4, False),       # d not a whole number of tiles
    (2304, 512, 32, True),      # kernel #3 from m = 9 ...
    (4096, 512, 32, True),
    (4352, 128, 32, True),      # ... at the prime m = 17 ...
    (7936, 512, 512, True),     # ... with one-channel groups ...
    (8192, 512, 32, True),      # ... to m = 32
    (5000, 512, 32, False),     # not 256 m
    (4096, 96, 32, False),      # d not a multiple of 128
    (16384, 512, 32, True),     # kernel #4
    (65536, 128, 8, True),
    (131072, 512, 32, False),   # past #4's sizes
    (16384, 64, 32, False),     # d not a multiple of 128
])
def test_support_predicate(n_fft, d, cols, ok, monkeypatch):
    """The predicate of the kernel whose range holds n_fft, with
    ``TWOPASS_ENABLE`` on so that #4's sizes reach their kernel."""
    monkeypatch.setattr(sm, "TWOPASS_ENABLE", True)
    assert sm.mix_supported(n_fft, d, cols) is ok


@pytest.mark.parametrize("name,n_fft,d,match", [
    ("direct_mix", 1000, 512, "#1 .*unsupported"),
    ("direct_mix", 2304, 512, "#3 .*range"),
    ("direct_mix", 4096, 512, "#3 .*range"),
    ("direct_mix", 16384, 512, "#4 .*range"),
    ("staged_mix", 5000, 512, "#3 .*unsupported"),
    ("staged_mix", 4096, 96, "#3 .*unsupported"),
    ("twopass_mix", 8192, 512, "#4 .*#3 .*range"),
    ("twopass_mix", 20000, 512, "#4 .*unsupported"),
])
def test_unsupported_sizes_raise_naming_their_roadmap_item(name, n_fft, d,
                                                           match):
    """Each wrapper refuses what its kernel does not take, naming the
    kernel and why: another kernel's range or a shape it refuses."""
    with pytest.raises(ValueError, match=match):
        sm._require(name, n_fft, d, 32)


@pytest.mark.parametrize("name,n_fft", [
    ("direct_mix", 1024), ("staged_mix", 2304), ("staged_mix", 3072),
    ("staged_mix", 4096), ("staged_mix", 8192), ("twopass_mix", 16384),
    ("twopass_mix", 65536)])
def test_each_kernel_takes_its_range(name, n_fft, monkeypatch):
    monkeypatch.setattr(sm, "TWOPASS_ENABLE", True)
    assert sm.mix_kernel(n_fft) == name
    sm._require(name, n_fft, 512, 32)


@pytest.mark.parametrize("n_fft", [16384, 32768, 65536])
def test_twopass_sizes_follow_the_flag(n_fft, monkeypatch):
    """With ``TWOPASS_ENABLE`` off (its default) no mix kernel runs at #4's
    sizes: the layer takes its wide branch, and ``spectral_mix`` refuses
    them rather than run #4 or a plain version."""
    assert sm.TWOPASS_ENABLE is False
    assert sm.mix_kernel(n_fft) is None
    assert not sm.mix_supported(n_fft, 512, 32)
    v = torch.zeros(1, n_fft, 128)
    g = torch.zeros(1, n_fft // 2 + 1, 32)
    with pytest.raises(ValueError, match="TWOPASS_ENABLE=False"):
        sm.spectral_mix(v, g, g, None, n_fft)
    monkeypatch.setattr(sm, "TWOPASS_ENABLE", True)
    assert sm.mix_kernel(n_fft) == "twopass_mix"
