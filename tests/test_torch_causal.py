"""The causal kernels' plain PyTorch versions against the JAX Pallas kernels
(run in interpret mode on the CPU, as tests/test_pallas_causal.py runs
them), the CPU routing of the wrappers, the prompt-length dispatch at
the tiny LM's own widths, and a numpy model of #5's FFT kernel (both
transform paths with the host's tables) with the branch choice its
predicates keep.  The CUDA kernels themselves are checked on the card by
tests/test_torch_kernels.py and chip_smoke.py (and on the CPU by
tests/test_torch_emulated_kernels.py)."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_tpu.kernels.pallas_causal as pc
from fft_tpu_torch.kernels import causal as kc
from fft_tpu_torch.kernels.common import twiddles_np
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


@pytest.mark.parametrize("b,nc,chunk,d,cols", [
    (1, 2, 128, 128, 8),
    (1, 1, 600, 64, 8),           # the 350M's 600-token prompt's chunk
    (1, 2, 129, 64, 8),
])
def test_fused_causal_mix_ref_matches_pallas(b, nc, chunk, d, cols):
    """fused_causal_mix_ref against the JAX function the reference runs at
    the shape: its fused Pallas kernel in interpret mode where
    pc.fused_mix_supported holds (chunk 128), else the jnp composition of
    fft_tpu/layers/causal_seg.py (2C = 1200 and 258 take no Pallas plan),
    both sides fed the K spectra of one gate (its length-N irfft, then
    rfft_2C of each segment, by each package's own layer code)."""
    rng = np.random.default_rng(3 + (chunk != 128) * chunk)
    n = nc * chunk
    if chunk == 128:
        assert pc.fused_mix_supported(nc, chunk, d, False, cols)
        arrs = _planes(rng, (b, n, d), (b, nc, chunk + 1, nc * cols),
                       (b, nc, chunk + 1, nc * cols))
        ref = np.asarray(pc.fused_causal_mix(*map(jnp.asarray, arrs), chunk,
                                             cols, False, True))
        got = kc.fused_causal_mix_ref(*map(torch.from_numpy, arrs), chunk,
                                      cols).numpy()
        assert rel_err(got, ref) < TOL
        return
    from fft_tpu.config import SpectreHeadConfig as JaxHeadConfig
    from fft_tpu.layers.causal_seg import segmented_causal_mix
    from fft_tpu_torch.layers.causal_seg import _segment_rfft
    from fft_tpu_torch.ops import fftops

    assert not pc.fused_mix_supported(nc, chunk, d, False, cols)
    v = _planes(rng, (b, n, d))[0]
    f = n // 2 + 1
    gate = (rng.standard_normal((b, nc, cols, f))
            + 1j * rng.standard_normal((b, nc, cols, f))).astype(np.complex64)
    ref = np.asarray(segmented_causal_mix(
        jnp.asarray(v), jnp.asarray(gate),
        JaxHeadConfig(embed_dim=d, n_fft=n, fft_impl="auto"), chunk))
    g_l = torch.from_numpy(gate).permute(0, 3, 1, 2).reshape(b, f, nc * cols)
    kf = _segment_rfft(fftops.irfft(g_l, n, dim=-2), n, chunk)
    got = kc.fused_causal_mix_ref(torch.from_numpy(v), kf.real.contiguous(),
                                  kf.imag.contiguous(), chunk, cols).numpy()
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
    """The chunk and window limits of the Hopper kernels (the JAX package's
    VMEM models do not apply): banded_inverse takes chunks to 2904, 853 and
    854 both through Bluestein's 4096-point transform; #6 to chunk 853."""
    assert kc.banded_transform(853) == (4096, 0)
    assert kc.banded_transform(854) == (4096, 0)
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


# ---------------------------------------------------------------------------
# banded_inverse's FFT kernel (csrc/causal.cu): a numpy model of its two
# paths, the branch dispatch kept from the parent's predicates, the wrapper
# ---------------------------------------------------------------------------

def _bit_reversed(m: int) -> np.ndarray:
    bits = m.bit_length() - 1
    return np.array([int(format(i, f"0{bits}b")[::-1], 2) if bits else 0
                     for i in range(m)])


def _packed_spectra(vfr, vfi, kfr, kfi, chunk):
    """The banded sum and the kernel's pair packing in numpy: Z (B, nc,
    2C, d/2) with Z[k] = A_a[k] + i A_b[k] for k <= C (Im dropped at DC and
    Nyquist) and conj(A_a[2C-k]) + i conj(A_b[2C-k]) above."""
    b, nc, f2, d = vfr.shape
    cols = kfr.shape[-1]
    v = (vfr + 1j * vfi).astype(np.complex128)
    k = np.repeat((kfr + 1j * kfi).astype(np.complex128), d // cols, -1)
    acc = np.zeros_like(v)
    for c in range(nc):
        for j in range(c + 1):
            acc[:, c] += k[:, c, j] * v[:, c - j]
    acc[:, :, 0].imag = 0.0
    acc[:, :, chunk].imag = 0.0
    a, bb = acc[..., 0::2], acc[..., 1::2]
    z = np.zeros((b, nc, 2 * chunk, d // 2), dtype=np.complex128)
    z[:, :, :f2] = a + 1j * bb
    z[:, :, f2:] = (np.conj(a) + 1j * np.conj(bb))[:, :, 1:chunk][:, :, ::-1]
    return z


def _model_banded(vfr, vfi, kfr, kfi, chunk):
    """banded_fft_kernel's inverse of the packed spectra, path by path, with
    the port's fp32 host tables: 2C = P O as the odd pass (twiddle on the
    output) then the P-point pass; else Bluestein with the chirp, M and
    spectrum of ``kc.bluestein_np`` (spectrum in bit-reversed row order).
    Returns y (B, nc, C, d)."""
    n = 2 * chunk
    z = _packed_spectra(vfr, vfi, kfr, kfi, chunk)
    length, o = kc.banded_transform(chunk)
    if o:
        assert length * o == n and length >= 4 and o % 2 == 1 and o <= 31
        tw = twiddles_np(n).astype(np.float64)
        root = tw[:, 0] + 1j * tw[:, 1]                  # e^{2 pi i m / n}
        zs = z.reshape(*z.shape[:2], o, length, -1)      # [k1, k2]
        k1, t1 = np.arange(o)[:, None], np.arange(o)[None, :]
        dft_o = root[(k1 * t1 % o) * length]             # e^{2 pi i k1 t1/O}
        xp = np.einsum("bckqp,kt->bctqp", zs, dft_o)     # [t1, k2]
        xp *= root[(np.arange(o)[:, None] * np.arange(length)[None, :])
                   % n][None, None, :, :, None]
        y = length * np.fft.ifft(xp, axis=3)             # [t1, t2]
        y = y.transpose(0, 1, 3, 2, 4).reshape(z.shape) / n   # t1 + O t2
    else:
        assert length >= 3 * chunk - 1 and length & (length - 1) == 0
        chirp, spec = (t[..., 0] + 1j * t[..., 1].astype(np.float64)
                       for t in kc.bluestein_np(chunk))
        a = np.zeros((*z.shape[:2], length, z.shape[-1]), np.complex128)
        a[:, :, :n] = z * chirp[:, None]
        rows = _bit_reversed(length)
        g = length * np.fft.ifft(a, axis=2)[:, :, rows]  # sign +1, rows
        g *= spec[:, None]
        nat = np.empty_like(g)
        nat[:, :, rows] = g
        y = np.fft.fft(nat, axis=2)[:, :, :n] * chirp[:, None]
    y = y[:, :, chunk:]
    out = np.empty((*y.shape[:3], 2 * y.shape[-1]))
    out[..., 0::2], out[..., 1::2] = y.real, y.imag
    return out


@pytest.mark.parametrize("chunk,nc", [(4, 1), (7, 2), (100, 3), (853, 1),
                                      (854, 1), (1499, 1), (1500, 1),
                                      (2047, 1), (2904, 1)])
def test_banded_fft_model_matches_pallas(chunk, nc):
    """Both paths of banded_fft_kernel's plan (2C = P O at 4 and 100; every
    other chunk through Bluestein at M = 64, 4096, 8192 and 16384), modelled
    in numpy with the host's tables, against JAX's banded_inverse in
    interpret mode and the plain version, within 1e-5."""
    rng = np.random.default_rng(chunk)
    b, d, cols = 1, 128, 8
    f2 = chunk + 1
    arrs = _planes(rng, (b, nc, f2, d), (b, nc, f2, d),
                   (b, nc, nc, f2, cols), (b, nc, nc, f2, cols))
    want = np.asarray(pc.banded_inverse(*map(jnp.asarray, arrs), chunk,
                                        False, True))
    got = _model_banded(*arrs, chunk)
    assert rel_err(got, want) < TOL
    ref = kc.banded_inverse_ref(*map(torch.from_numpy, arrs), chunk).numpy()
    assert rel_err(got, ref) < TOL


def test_bluestein_tables_are_exact_where_they_can_be():
    """The chirp's phase comes from m^2 mod 2n in integers: at n near 4096
    a float square would lose it.  w[0] = 1 exactly, |w| = 1, and the chirp
    repeats with period n (n even)."""
    for chunk in (854, 2047, 2904):
        chirp, spec = kc.bluestein_np(chunk)
        n, m = 2 * chunk, np.arange(2 * chunk, dtype=np.int64)
        w = np.exp(1j * np.pi * ((m * m) % (2 * n)) / n)
        assert np.abs(chirp[:, 0] + 1j * chirp[:, 1] - w).max() < 1e-7
        assert tuple(chirp[0]) == (1.0, 0.0)
        assert spec.shape == (kc.banded_transform(chunk)[0], 2)
        assert spec.dtype == np.float32


def _model_segment_bluestein(z, chunk, m_len, half):
    """segment_fft_kernel's Bluestein path in numpy with the host's fp32
    tables at cyclic length ``m_len``: the FFT of the 2C-point window z
    (complex; its first C rows zero where ``half``) as n conj(w y) of the
    sign +1 chirp-z transform y of conj(z) w, the half-zero window shifted
    down by C rows and its spectrum times (-1)^f."""
    n = 2 * chunk
    chirp, spec = (t[..., 0] + 1j * t[..., 1].astype(np.float64)
                   for t in kc.bluestein_np(chunk, m_len))
    t0 = chunk if half else 0
    a = np.zeros(m_len, np.complex128)
    a[:n - t0] = np.conj(z[t0:]) * chirp[:n - t0]
    rows = _bit_reversed(m_len)
    g = m_len * np.fft.ifft(a)[rows] * spec
    nat = np.empty_like(g)
    nat[rows] = g
    y = np.fft.fft(nat)[:n] * chirp
    sign = (-1.0) ** np.arange(n) if half else 1.0
    return n * np.conj(y) * sign


@pytest.mark.parametrize("chunk", [129, 600, 853])
def test_segment_bluestein_model_matches_fft(chunk):
    """The segment transforms' lengths (``segment_transform``: #5's M >=
    3C - 1 for the half-zero windows, M >= 4C - 1 for full ones) and
    tables, modelled in numpy, against numpy's FFT of both kinds of window
    within 1e-5; a full window at the half-zero windows' M (too short
    where it is below 4C - 1, as at 129 and 600) fails."""
    rng = np.random.default_rng(chunk)
    length, full, o = kc.segment_transform(chunk)
    assert o == 0 and length == kc.banded_transform(chunk)[0]
    assert length >= 3 * chunk - 1 and full >= 4 * chunk - 1
    z = rng.standard_normal(2 * chunk) + 1j * rng.standard_normal(2 * chunk)
    want = np.fft.fft(z)
    assert rel_err(_model_segment_bluestein(z, chunk, full, False),
                   want) < TOL
    zh = z.copy()
    zh[:chunk] = 0
    assert rel_err(_model_segment_bluestein(zh, chunk, length, True),
                   np.fft.fft(zh)) < TOL
    if length < 4 * chunk - 1:
        assert rel_err(_model_segment_bluestein(z, chunk, length, False),
                       want) > TOL


def test_segment_plan_and_tables():
    """segment_fft_kernel's transform and threads at the 350M's prompts
    (its tile is 4 pairs): 512 (256 with an odd factor); its tables cached
    per (chunk, device), Bluestein's shared with #5's at the half-zero
    windows' M."""
    cpu = torch.device("cpu")
    assert kc.segment_transform(600) == (2048, 4096, 0)
    assert kc.segment_transform(853) == (4096, 4096, 0)
    assert kc.segment_transform(640) == (256, 256, 5)
    assert kc.segment_transform(512) == (1024, 1024, 1)
    assert kc.segment_fft_threads(1, 600) == 512
    assert kc.segment_fft_threads(2, 853) == 512
    assert kc.segment_fft_threads(1, 640) == 256
    assert kc.segment_fft_threads(1, 128) == 128
    assert kc._segment_rows(2, 853) == 4096
    assert kc._segment_rows(1, 600) == 2048
    assert kc._segment_rows(2, 600) == 4096
    tables = kc._segment_tables(600, cpu)
    assert tables is kc._segment_tables(600, cpu)
    banded = kc._banded_tables(600, cpu)
    assert tables[0] is banded[0] and tables[1] is banded[2]
    assert tables[3] is banded[3]
    assert [tuple(t.shape) for t in tables] == [
        (1200, 2), (1200, 2), (2048, 2), (2048, 2), (4096, 2), (4096, 2)]


def _parent_banded_supported(nc, f2, d, cols):
    """banded_supported as the parent tree computed it: a 32-channel tile
    of one chunk's summed spectrum plus the 2C twiddles in 227 KB (chunk <=
    853, d % 32), else an 8-channel tile (chunk <= 2904, d % 8)."""
    chunk = f2 - 1
    smem = 232448

    def tile(lanes):
        return 2 * chunk * 8 + 2 * (chunk + 1) * lanes * 4

    if tile(32) <= smem:
        lanes = 32 if d % 32 == 0 else None
    else:
        lanes = 8 if d % 8 == 0 and tile(8) <= smem else None
    return nc >= 1 and chunk >= 1 and d % cols == 0 and lanes is not None


def _parent_fused_mix_supported(nc, chunk, d, cols):
    """fused_mix_supported as the parent tree computed it."""
    d_g = d // cols if cols else 0
    return (chunk >= 128 and _parent_banded_supported(nc, chunk + 1, d, cols)
            and chunk <= 853 and d % 32 == 0
            and d_g >= 1 and (32 % d_g == 0 or d_g % 32 == 0))


@pytest.mark.parametrize("chunk", [4, 127, 128, 129, 700, 853, 854, 1024,
                                   1500, 2048, 2904, 2905])
def test_dispatch_keeps_the_parents_branches(chunk, monkeypatch):
    """Over (nc, d, cols) at each chunk, 853/854 at d = 512 and 1024
    included, banded_supported and the branch segmented_causal_mix takes
    are what the parent's predicates gave (hard-coded above; the kf and v3
    predicates this change leaves alone).  The kernels are stubbed: only
    the branch is under test."""
    from fft_tpu_torch.layers import causal_seg

    def zeros_like_y(v, *a):
        return torch.zeros_like(v)

    monkeypatch.setattr(kc, "fused_causal_mix", zeros_like_y)
    monkeypatch.setattr(kc, "banded_inverse",
                        lambda vr, *a: torch.zeros(vr.shape[0], vr.shape[1],
                                                   vr.shape[2] - 1,
                                                   vr.shape[3]))
    monkeypatch.setattr(kc, "kf_seg_rfft", lambda kt, c: (None, None))
    for nc in (1, 2, 3):
        for d, cols in ((512, 32), (1024, 64), (64, 8), (40, 5), (16, 16)):
            n = nc * chunk
            want_banded = _parent_banded_supported(nc, chunk + 1, d, cols)
            assert kc.banded_supported(nc, chunk + 1, d, cols) == want_banded
            fused = (_parent_fused_mix_supported(nc, chunk, d, cols)
                     or kc.fused_mix_v3_supported(nc, chunk, d, cols))
            if fused and n >= kc.KF_SEG_MIN_N and kc.kf_seg_rfft_supported(
                    n, chunk, nc * cols):
                want = "kf_seg"
            elif fused:
                want = "fused"
            else:
                want = "banded" if want_banded else "composition"
            if n * d > 3_000_000 and want == "composition":
                continue                   # the plain composition is slow
            # n_fft = 2n: long enough for the segments, never the kf branch
            v = torch.zeros(1, n, d)
            gate = torch.zeros(1, nc, cols, n + 1, dtype=torch.complex64)
            BRANCH_CALLS.clear()
            causal_seg.segmented_causal_mix(
                v, gate, SimpleNamespace(n_fft=2 * n, fft_impl="auto"),
                chunk)
            assert dict(BRANCH_CALLS) == {want: 1}, (nc, chunk, d, cols)


def test_banded_inverse_skips_the_function_without_gradients():
    """Without a gradient to take (grad mode off, or no input requiring
    one) banded_inverse runs its wrapper without the Function and returns
    what the Function path returns; inputs that require a gradient still
    go through it and get the plain version's VJP."""
    rng = np.random.default_rng(5)
    b, nc, chunk, d, cols = 1, 2, 12, 16, 4
    f2 = chunk + 1
    arrs = [torch.from_numpy(a) for a in _planes(
        rng, (b, nc, f2, d), (b, nc, f2, d), (b, nc, nc, f2, cols),
        (b, nc, nc, f2, cols))]
    with torch.no_grad():
        fast = kc.banded_inverse(*arrs, chunk)
    assert fast.grad_fn is None
    plain = kc.banded_inverse(*arrs, chunk)
    assert plain.grad_fn is None
    xs = [a.clone().requires_grad_() for a in arrs]
    y = kc.banded_inverse(*xs, chunk)
    assert type(y.grad_fn).__name__ == "_BandedInverseBackward"
    assert torch.equal(y.detach(), fast) and torch.equal(plain, fast)
    w = torch.from_numpy(_planes(rng, (b, nc, chunk, d))[0])
    (y * w).sum().backward()
    ys = [a.clone().requires_grad_() for a in arrs]
    (kc.banded_inverse_ref(*ys, chunk) * w).sum().backward()
    for x, r in zip(xs, ys):
        assert torch.allclose(x.grad, r.grad, rtol=0, atol=0)


def test_banded_tables_are_cached_per_chunk_and_device():
    """The tables are built once for each (chunk, device): the 2C-point
    roots, the stage twiddles of the plan's transform and, for
    Bluestein, its chirp and spectrum."""
    cpu = torch.device("cpu")
    for chunk, n_tables in ((1024, 2), (1500, 4)):
        tables = kc._banded_tables(chunk, cpu)
        assert tables is kc._banded_tables(chunk, cpu)
        length, o = kc.banded_transform(chunk)
        assert tuple(tables[0].shape) == (2 * chunk, 2)
        assert tuple(tables[1].shape) == (length, 2)
        if o == 0:
            assert tuple(tables[2].shape) == (2 * chunk, 2)
            assert tuple(tables[3].shape) == (length, 2)
        assert len({id(t) for t in tables}) == n_tables
