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
    (1000, 512, 32, False),     # not fused: 1000 / 2 is no multiple of 128
    (1024, 512, 512, True),     # one-channel groups
    (1024, 96, 32, True),       # 3-channel groups (clusters of 3 CTAs)
    (1024, 40, 4, True),        # 10-channel groups (clusters of 5 CTAs)
    (1024, 36, 4, False),       # d not a whole number of 8-channel CTAs
    (10, 128, 8, True),         # n = 2 mod 4 (a direct DFT)
    (254, 128, 128, True),      # 2 * 127
    (768, 768, 128, True),      # 256 * 3, 6-channel groups
    (1536, 512, 1, True),       # 512 * 3, one 512-channel group
    (1792, 512, 32, True),      # 256 * 7
    (2050, 512, 32, False),     # past #1's range, and not 256 m
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


@pytest.mark.parametrize("d,cols", [(128, 8), (128, 128), (384, 128),
                                    (768, 128)])
def test_direct_kernels_take_every_length_jax_fuses(d, cols):
    """Every n_fft up to 2048 on which JAX's fused mix runs its direct
    kernel (pf.pallas_mix_supported and pf._direct_supported: the even n_fft
    from 8 to 256 and 256 m) is one that #1 and #2 take, with gate groups of
    16, 1, 3 and 6 channels; no other n_fft up to 2048 is."""
    for n in range(1, 2049):
        fused = pf.pallas_mix_supported(n) and pf._direct_supported(n)
        assert sm.direct_supported(n, d, cols) is fused, n
        assert (sm.mix_kernel(n) == "direct_mix") is fused, n


@pytest.mark.parametrize("n", [10, 66, 254, 768, 1536])
def test_direct_kernels_match_pallas_at_every_split(n):
    """The plain #1 (with the time-domain memory) and #2 against
    _direct_mix_call and _direct_mix_bwd_call in interpret mode at lengths
    with no power-of-two split (n = 2 mod 4, odd factors 33 and 127) and
    with odd factors 3 (768 = 256 * 3, 1536 = 512 * 3), d=128 and 8-channel
    gate groups."""
    v, gate, mem, ybar = _inputs(n, d=128, hg=16, seed=n + 1)
    mem_t = fftops.irfft(torch.from_numpy(mem), n, dim=0)
    gr, gi = _planes(gate)
    ref = pf._direct_mix_call(jnp.asarray(v), jnp.asarray(gr.numpy()),
                              jnp.asarray(gi.numpy()),
                              jnp.asarray(mem_t.numpy()), n_fft=n,
                              interpret=True)
    got = sm.direct_mix(torch.from_numpy(v), gr, gi, mem_t, n)
    assert rel_err(got.numpy(), np.asarray(ref)) < TOL
    ref = pf._direct_mix_bwd_call(jnp.asarray(v), jnp.asarray(gr.numpy()),
                                  jnp.asarray(gi.numpy()), jnp.asarray(ybar),
                                  n_fft=n, interpret=True)
    got = sm.direct_mix_bwd(torch.from_numpy(v), gr, gi,
                            torch.from_numpy(ybar), n)
    for a, r in zip(got, ref):
        assert rel_err(a.numpy(), np.asarray(r)) < TOL


def test_block_at_n_fft_768_matches_jax_pallas_path():
    """A 2-head d=128 block with memory 8 at n_fft = L = 768 (256 * 3),
    fft_impl="pallas": both take the fused branch (JAX's #1 in interpret
    mode; the port's direct_mix and direct_mix_bwd, here their plain
    versions), forward and every gradient against JAX's."""
    from tests.test_torch_layers import (
        _cfg, _check_grads, _jax_block_apply, block_pair,
    )
    from fft_tpu_torch.layers import spectre as tsp

    cfg = _cfg(n_fft=768)
    params, block = block_pair(cfg, seed=50)
    x = np.random.default_rng(51).standard_normal((1, 768, 128)).astype(
        np.float32)
    tsp.MIX_BRANCH_CALLS.clear()
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    assert dict(tsp.MIX_BRANCH_CALLS) == {"fused": 1}
    assert rel_err(got, _jax_block_apply(params, cfg, x)) < TOL
    _check_grads(params, block, cfg, x)


def test_config1_backward_is_one_launch_without_scratch():
    """At config 1 (d=512, 32 gate columns: 16-channel groups) and the other
    layer shapes whose groups a cluster of up to 8 CTAs holds whole, #2's
    wrapper asks for no scratch (so its C entry makes one launch); groups
    wider than 8 CTAs' channels take the scratch and the second launch."""
    np_ = sm.bwd_plan(1024)[0]
    assert sm.bwd_cluster(16, np_) * 2 * np_ % 16 == 0
    for n, d, cols in ((1024, 512, 32), (2048, 512, 32), (256, 384, 128),
                       (768, 768, 128), (1024, 512, 512)):
        np_ = sm.bwd_plan(n)[0]
        assert sm.bwd_cluster(d // cols, np_) <= sm.BWD_CLUSTER_MAX
        assert sm.bwd_parts(2, n, d, cols, np_, "cpu") is None, (n, d, cols)
    parts = sm.bwd_parts(2, 1024, 512, 1, 4, "cpu")
    assert parts is not None and parts.shape == (2, 513, 64, 2, 2)
