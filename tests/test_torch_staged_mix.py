"""The non-causal mix past n_fft 2048 on the CPU: the plain versions of
kernels #3 (``staged_mix``) and #4 (``twopass_mix``) against fft_tpu's
``_fused_mix_call`` and ``_twopass_mix_call`` run in interpret mode, as
tests/test_pallas_mix.py runs them (#4 with ``TWOPASS_ENABLE`` patched
on), and a ``fft_impl="pallas"`` block at n_fft 4096 against JAX's, forward
and every gradient.  The same numpy-seeded inputs go through both sides;
max|a-b| / max|b| within 1e-5 in fp32 (dense DFT matmuls there, FFTs here,
summing in different orders), 1e-4 for gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_tpu.kernels.pallas_fft as pf
from fft_tpu_torch.kernels import spectral_mix as sm
from fft_tpu_torch.layers import spectre as tsp
from fft_tpu_torch.ops import fftops
from tests.golden_utils import rel_err
from tests.test_torch_layers import (
    _cfg, _check_grads, _jax_block_apply, block_pair,
)

TOL = 1e-5
GRAD_TOL = 1e-4


def _inputs(n, b=1, d=128, hg=32, seed=0):
    """v (B, N, d), compact gate (B, F, hg) complex, memory (F, d) complex,
    all numpy."""
    rng = np.random.default_rng(seed)
    f = n // 2 + 1

    def cplx(shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    return (rng.standard_normal((b, n, d)).astype(np.float32),
            cplx((b, f, hg)), cplx((f, d)))


def _port(fn, v, gate, mem, n):
    g = torch.from_numpy(gate)
    mem_t = (None if mem is None
             else fftops.irfft(torch.from_numpy(mem), n, dim=0))
    return fn(torch.from_numpy(v), g.real.contiguous(), g.imag.contiguous(),
              mem_t, n).numpy()


def _pallas(v, gate, mem, n):
    return np.asarray(pf.fused_spectral_mix(
        jnp.asarray(v), jnp.asarray(gate),
        None if mem is None else jnp.asarray(mem), n_fft=n, interpret=True))


@pytest.mark.parametrize("n", [2304, 4096, 4352])
@pytest.mark.parametrize("with_mem", [False, True])
def test_staged_mix_ref_matches_pallas(n, with_mem):
    """n_fft 256 m at m = 9, 16 and 17 (a prime): JAX's staged kernel #3."""
    assert sm.mix_kernel(n) == "staged_mix" and not pf._direct_supported(n)
    v, gate, mem = _inputs(n, seed=n)
    mem = mem if with_mem else None
    got = _port(sm.staged_mix, v, gate, mem, n)
    assert rel_err(got, _pallas(v, gate, mem, n)) < TOL


@pytest.mark.parametrize("with_mem", [False, True])
def test_twopass_mix_ref_matches_pallas(with_mem, monkeypatch):
    """n_fft 16384: JAX's two-pass kernel #4, reached only with its
    TWOPASS_ENABLE on (memory added outside the kernel there)."""
    monkeypatch.setattr(pf, "TWOPASS_ENABLE", True)
    n = 16384
    v, gate, mem = _inputs(n, seed=1)
    mem = mem if with_mem else None
    got = _port(sm.twopass_mix, v, gate, mem, n)
    assert rel_err(got, _pallas(v, gate, mem, n)) < TOL


def test_twopass_flag_mirrors_the_reference_default():
    assert sm.TWOPASS_ENABLE is False and pf.TWOPASS_ENABLE is False


@pytest.mark.parametrize("n,kernel", [(8, "direct_mix"),
                                      (2048, "direct_mix"),
                                      (2304, "staged_mix"),
                                      (8192, "staged_mix"),
                                      (16384, "twopass_mix"),
                                      (65536, "twopass_mix")])
def test_spectral_mix_forward_takes_the_kernel_of_its_range(n, kernel,
                                                            monkeypatch):
    """The Function's forward calls the wrapper of n_fft's range (on the CPU
    its plain version), and no other; #4's sizes with ``TWOPASS_ENABLE``
    on, as the layer sends them."""
    monkeypatch.setattr(sm, "TWOPASS_ENABLE", True)
    called = []
    for name in ("direct_mix", "staged_mix", "twopass_mix"):
        wrapper = getattr(sm, name)
        monkeypatch.setitem(sm._FORWARD, name,
                            lambda *a, _n=name, _w=wrapper: (
                                called.append(_n), _w(*a))[1])
    v, gate, _ = _inputs(n, d=128, hg=8, seed=2)
    g = torch.from_numpy(gate)
    y = sm.spectral_mix(torch.from_numpy(v), g.real.contiguous(),
                        g.imag.contiguous(), None, n)
    assert called == [kernel] and y.shape == (1, n, 128)


def test_backward_above_2048_is_autograd_through_unfused_mix(monkeypatch):
    """At n_fft 2304 the Function's backward is the adjoint of unfused_mix
    (JAX's _mix_bwd: jax.vjp of _unfused_mix), never #2 or its plain
    version: against jax.grad of pf.spectral_mix, whose forward is #3 in
    interpret mode, with the gate as real planes."""
    def refuse(*_):
        raise AssertionError("#2 called above n_fft 2048")

    monkeypatch.setattr(sm, "direct_mix_bwd", refuse)
    monkeypatch.setattr(sm, "direct_mix_bwd_ref", refuse)
    monkeypatch.setattr(pf, "INTERPRET", True)
    n = 2304
    v, gate, mem = _inputs(n, seed=11)
    w = np.random.default_rng(12).standard_normal(v.shape).astype(np.float32)
    gr, gi = np.real(gate).copy(), np.imag(gate).copy()

    def loss_jax(v_, gr_, gi_):
        y = pf.spectral_mix(v_, jax.lax.complex(gr_, gi_), jnp.asarray(mem),
                            n, False)
        return jnp.sum(y * w)

    ref = jax.grad(loss_jax, argnums=(0, 1, 2))(
        jnp.asarray(v), jnp.asarray(gr), jnp.asarray(gi))
    ts = [torch.from_numpy(a).requires_grad_() for a in (v, gr, gi)]
    mem_t = fftops.irfft(torch.from_numpy(mem), n, dim=0).requires_grad_()
    (sm.spectral_mix(*ts, mem_t, n) * torch.from_numpy(w)).sum().backward()
    for t, r in zip(ts, ref):
        assert rel_err(t.grad.numpy(), np.asarray(r)) < GRAD_TOL
    assert torch.allclose(mem_t.grad, torch.from_numpy(w).sum(0))


def test_block_at_n_fft_4096_matches_jax_pallas_path(monkeypatch):
    """A 2-head d=128 block with memory 8 at n_fft = L = 4096,
    fft_impl="pallas": JAX runs #3 (interpret mode) forward and jax.vjp of
    the composition backward; the port's fused branch runs staged_mix's
    plain version forward and autograd through unfused_mix backward."""
    monkeypatch.setattr(pf, "INTERPRET", True)
    cfg = _cfg(n_fft=4096)
    params, block = block_pair(cfg, seed=40)
    x = np.random.default_rng(41).standard_normal((1, 4096, 128)).astype(
        np.float32)
    tsp.MIX_BRANCH_CALLS.clear()
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    assert dict(tsp.MIX_BRANCH_CALLS) == {"fused": 1}
    assert rel_err(got, _jax_block_apply(params, cfg, x)) < TOL
    _check_grads(params, block, cfg, x)
