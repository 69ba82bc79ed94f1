"""CUDA kernels of fft_tpu_torch/csrc run on the CPU through
tests/cuda_emulation.py, against their plain PyTorch versions: the kernels'
index arithmetic, shared-memory layout and barriers at small shapes, on a
machine without nvcc or a card.  spectral_mix.cu (#1, #2), staged_mix.cu
(#3, at every length), twopass_mix.cu (#4, clusters of 1-8 CTAs at small
n_fft and the wrapper's plan at 16384; a copy whose step across the
cluster reads one CTA alone must fail),
causal_long.cu (#9, #7, #11, at chunks up to 2048; #7's and #11's bf16
instances at nc 3 and 16), causal.cu's
banded_inverse (#5: both transform paths, every tile plan, both K layouts
through the direct #6) and the direct #6 (segment_fft.cuh's segment FFTs:
P O passes, Bluestein for half-zero and full windows; a copy that sizes
full windows' Bluestein for 3C - 1 must fail), causal_bwd.cu's direct #10
(fp32 and bf16, lag tiles of 2 to 4 segments), decode.cu (#12), and
probe.cu (the FMA chain of utils/prof.py's measured constants, no TPU
kernel).  Same bound as on the
card (max|a-b| / max|b| < 2e-5: FFTs or direct DFTs against pocketfft, all
fp32), and for the bf16 instances 1e-2 on the bf16 outputs (their one
rounding to bf16 against the plain version's) and 2e-5 on the fp32 Kbar.
Skips where there is no host C++ compiler."""

import ctypes
import functools

import pytest
import torch

from fft_tpu_torch.kernels import build as kb
from fft_tpu_torch.kernels import causal as kc
from fft_tpu_torch.kernels import decode as kd
from fft_tpu_torch.kernels import probe
from fft_tpu_torch.kernels import spectral_mix as sm
from fft_tpu_torch.kernels.common import stage_twiddles_np, twiddles_np
from tests import cuda_emulation

TOL = 2e-5
BF16_TOL = 1e-2


def _emulated(tmp_path_factory, source, names):
    if cuda_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++)")
    lib = cuda_emulation.build(kb.CSRC_DIR / source,
                               tmp_path_factory.mktemp("emu"))
    for name in names:
        argtypes, restype = kb._SIGNATURES[name]
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = restype
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _emulated(tmp_path_factory, "spectral_mix.cu",
                     ("fft_direct_mix", "fft_direct_mix_bwd"))


@pytest.fixture(scope="module")
def long_lib(tmp_path_factory):
    return _emulated(tmp_path_factory, "causal_long.cu",
                     ("fft_kf_seg_rfft", "fft_fused_causal_mix_v3",
                      "fft_fused_causal_mix_bwd_v3"))


@pytest.fixture(scope="module")
def causal_lib(tmp_path_factory):
    return _emulated(tmp_path_factory, "causal.cu",
                     ("fft_banded_inverse", "fft_fused_causal_mix_direct"))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _rel(a, b) -> float:
    if a.dtype == torch.bfloat16:
        a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def _bf16(v) -> int:
    """The C entries' bf16 flag for activations v."""
    return int(v.dtype == torch.bfloat16)


def _emulated_direct(lib, v, gr, gi, mem_t, n, plan):
    """y from #1's C entry with ``plan`` (cs, np, threads) and the split and
    twiddles ``sm._launch_direct`` passes on the card; y starts as NaN."""
    b, _, d = v.shape
    cs, np_, threads = plan
    o = sm.direct_split(n, cs)
    y = torch.full_like(v, float("nan"))
    assert lib.fft_direct_mix(
        _ptr(v), _ptr(gr), _ptr(gi), _ptr(mem_t),
        _ptr(torch.from_numpy(twiddles_np(n))),
        _ptr(torch.from_numpy(stage_twiddles_np(n // (cs * o)))), _ptr(y),
        b, n, d, gr.shape[-1], o, cs, np_, threads, _bf16(v), None) == 0
    return y


def _emulated_bwd(lib, v, gr, gi, ybar, n, plan):
    """(vbar, gbar_r, gbar_i) from #2's C entry with ``plan`` (np, threads),
    the cluster and scratch ``sm._launch_bwd`` passes on the card; the
    outputs start as NaN."""
    b, _, d = v.shape
    cols = gr.shape[-1]
    np_, threads = plan
    o = sm.direct_split(n)
    parts = sm.bwd_parts(b, n, d, cols, np_, "cpu")
    out = [torch.full_like(t, float("nan")) for t in (v, gr, gi)]
    assert lib.fft_direct_mix_bwd(
        _ptr(v), _ptr(ybar), _ptr(gr), _ptr(gi),
        _ptr(torch.from_numpy(twiddles_np(n))),
        _ptr(torch.from_numpy(stage_twiddles_np(n // o))),
        *(_ptr(t) for t in out), _ptr(parts), b, n, d, cols, o, np_, threads,
        sm.bwd_cluster(d // cols, np_), _bf16(v), None) == 0
    return out


def _check_direct_pair(lib, b, n, d, cols, mem, fwd_plan, bwd_plan):
    """#1 and #2 at one shape against their plain versions."""
    assert sm.direct_supported(n, d, cols)
    g = torch.Generator().manual_seed(n + d + cols)
    fh = n // 2 + 1
    v, ybar = (torch.randn(b, n, d, generator=g) for _ in range(2))
    gr, gi = (torch.randn(b, fh, cols, generator=g) for _ in range(2))
    mem_t = torch.randn(n, d, generator=g) if mem else None
    y = _emulated_direct(lib, v, gr, gi, mem_t, n, fwd_plan)
    assert _rel(y, sm.direct_mix_ref(v, gr, gi, mem_t, n)) < TOL
    got = _emulated_bwd(lib, v, gr, gi, ybar, n, bwd_plan)
    for a, want in zip(got, sm.direct_mix_bwd_ref(v, gr, gi, ybar, n)):
        assert _rel(a, want) < TOL


# (n_fft, d, cols, memory): 1- to 64-channel groups, CTAs holding whole
# groups, clusters of 2 to 8 CTAs holding them, and groups wider than any
# cluster (their parts summed by the second launch), with the wrappers'
# plans
CASES = [(8, 32, 16, True), (64, 32, 4, False), (64, 32, 2, True),
         (256, 64, 8, True), (256, 64, 1, False), (1024, 32, 2, True),
         (2048, 16, 1, True), (2048, 32, 16, False)]


@pytest.mark.parametrize("n,d,cols,mem", CASES)
def test_emulated_kernels_match_plain_versions(lib, n, d, cols, mem):
    _check_direct_pair(lib, 2, n, d, cols, mem, sm.direct_plan(n),
                       sm.bwd_plan(n))


# (n_fft, d, cols, memory, #1's plan, #2's plan) at the lengths with no
# power-of-two split: n = 2 mod 4 (10, 66 = 2 * 33, 254 = 2 * 127: one
# direct DFT), odd factors past 31 (132 = 4 * 33) and past 7 with P >= 4
# (36 = 4 * 9), the templated odd factors 3 (12, 768, 1536) and 5 (40);
# gate groups of 1, 3 and 6 channels (clusters of 3 CTAs) and 5 (5 CTAs);
# both instances' channel pairs a CTA, #1 with a cluster of 2 at 512;
# groups that no cluster of up to 8 CTAs holds whole (9 channels, 128),
# their parts summed by the second launch
ODD_CASES = [(10, 8, 8, True, (1, 4, 64), (4, 64)),
             (66, 24, 8, False, (1, 2, 64), (4, 64)),
             (254, 24, 4, True, (1, 4, 128), (2, 64)),
             (132, 16, 16, True, (1, 4, 64), (2, 64)),
             (36, 40, 8, False, (1, 2, 32), (4, 32)),
             (12, 8, 8, True, (1, 4, 32), (2, 32)),
             (40, 24, 4, True, (1, 2, 64), (2, 64)),
             (768, 24, 8, True, (1, 4, 128), (4, 128)),
             (1536, 24, 4, False, (1, 4, 256), (4, 256)),
             (512, 48, 8, True, (2, 4, 64), (2, 64)),
             (16, 72, 8, True, (2, 4, 32), (4, 32)),
             (66, 128, 1, False, (1, 4, 64), (4, 64))]


def test_emulated_bwd_with_a_channel_dropped_fails(tmp_path_factory):
    """A copy of spectral_mix.cu whose #2 gate sums skip each group's
    first channel disagrees with the plain version in the gate cotangent
    alone (vbar stays right), in a cluster of 2 CTAs and in one CTA: the
    checks above see the group sum."""
    if cuda_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++)")
    src = (kb.CSRC_DIR / "spectral_mix.cu").read_text()
    good = "for (int ch = lo; ch < hi; ++ch) {"
    assert src.count(good) == 1
    out = tmp_path_factory.mktemp("broken_mix_bwd")
    (out / "spectral_mix.cu").write_text(src.replace(
        good, "for (int ch = lo + 1; ch < hi; ++ch) {"))
    for name in ("mix_fft.cuh", "fft_common.cuh"):
        (out / name).write_text((kb.CSRC_DIR / name).read_text())
    lib = cuda_emulation.build(out / "spectral_mix.cu", out)
    argtypes, restype = kb._SIGNATURES["fft_direct_mix_bwd"]
    lib.fft_direct_mix_bwd.argtypes = argtypes
    lib.fft_direct_mix_bwd.restype = restype
    for n, d, cols in ((64, 16, 1), (64, 16, 4)):
        g = torch.Generator().manual_seed(n + cols)
        v, ybar = (torch.randn(1, n, d, generator=g) for _ in range(2))
        gr, gi = (torch.randn(1, n // 2 + 1, cols, generator=g)
                  for _ in range(2))
        got = _emulated_bwd(lib, v, gr, gi, ybar, n, (4, 64))
        want = sm.direct_mix_bwd_ref(v, gr, gi, ybar, n)
        assert _rel(got[0], want[0]) < TOL
        assert _rel(got[1], want[1]) > TOL and _rel(got[2], want[2]) > TOL


@pytest.mark.parametrize("n,d,cols,mem,fwd_plan,bwd_plan", ODD_CASES)
def test_emulated_direct_mix_every_split(lib, n, d, cols, mem, fwd_plan,
                                         bwd_plan):
    _check_direct_pair(lib, 1, n, d, cols, mem, fwd_plan, bwd_plan)


@pytest.fixture(scope="module")
def staged_lib(tmp_path_factory):
    return _emulated(tmp_path_factory, "staged_mix.cu", ("fft_staged_mix",))


@pytest.fixture(scope="module")
def twopass_lib(tmp_path_factory):
    return _emulated(tmp_path_factory, "twopass_mix.cu", ("fft_twopass_mix",))


def _mix_args(b, n, d, cols, mem, seed):
    g = torch.Generator().manual_seed(seed)
    fh = n // 2 + 1
    return (_randn(g, b, n, d), _randn(g, b, fh, cols), _randn(g, b, fh, cols),
            _randn(g, n, d) if mem else None)


def _emulated_long_mix(fn, v, gr, gi, mem_t, n, plan):
    """y from the C entry of #3 or #4 (``fn``) with ``plan`` (cs, np,
    threads), the per-stage twiddles of its P = n / (cs O) points, as
    ``sm._launch_long`` passes them on the card; y starts as NaN."""
    b, _, d = v.shape
    cs, np_, threads = plan
    odd = n // (n & -n)
    y = torch.full_like(v, float("nan"))
    assert fn(_ptr(v), _ptr(gr), _ptr(gi), _ptr(mem_t),
              _ptr(torch.from_numpy(twiddles_np(n))),
              _ptr(torch.from_numpy(stage_twiddles_np(n // (cs * odd)))),
              _ptr(y), b, n, d, gr.shape[-1], cs, np_, threads, _bf16(v),
              None) == 0
    return y


# (b, n_fft, cols, memory) of #3 with the wrapper's plan on 8 channels:
# odd factors 9 (n = 256 * 9), 17 and 31 (primes) and 1 (4096, one CTA a
# tile; 8192, a cluster of two), gate groups of 1, 2 and 4 channels
STAGED_CASES = [(2, 2304, 4, True), (1, 4352, 2, False), (1, 7936, 4, True),
                (1, 4096, 1, True), (1, 8192, 2, True)]


@pytest.mark.parametrize("b,n,cols,mem", STAGED_CASES)
def test_emulated_staged_mix(staged_lib, b, n, cols, mem):
    d = 8
    v, gr, gi, mem_t = _mix_args(b, n, d, cols, mem, n + cols)
    y = _emulated_long_mix(staged_lib.fft_staged_mix, v, gr, gi, mem_t, n,
                           sm.staged_plan(n))
    assert _rel(y, sm.staged_mix_ref(v, gr, gi, mem_t, n)) < TOL


@pytest.mark.parametrize("m", range(9, 33))
def test_emulated_staged_mix_every_length(staged_lib, m):
    """Every n_fft = 256 m the layer sends #3, so every odd factor's
    odd_pass (O = 1, 3, ..., 31), with the wrapper's plan, on one or two
    tiles without memory."""
    n, d, cols = 256 * m, 8, 2
    v, gr, gi, _ = _mix_args(1, n, d, cols, False, m)
    y = _emulated_long_mix(staged_lib.fft_staged_mix, v, gr, gi, None, n,
                           sm.staged_plan(n))
    assert _rel(y, sm.staged_mix_ref(v, gr, gi, None, n)) < TOL


def test_emulated_twopass_mix(twopass_lib):
    """#4 at n_fft 16384 with the wrapper's plan, on one tile, with memory
    and 2-channel gate groups."""
    b, n, d, cols = 1, 16384, 8, 4
    v, gr, gi, mem_t = _mix_args(b, n, d, cols, True, 5)
    y = _emulated_long_mix(twopass_lib.fft_twopass_mix, v, gr, gi, mem_t, n,
                           sm.TWOPASS_PLAN[n])
    assert _rel(y, sm.twopass_mix_ref(v, gr, gi, mem_t, n)) < TOL


# (b, n_fft, d, cols, memory, (cs, np, threads)): #4's kernel at P = n / cs
# of 64-256 points a CTA with clusters of 1, 2, 4, 8 and 16 CTAs, two and
# four channel pairs a CTA, gate groups of 1, 2, 3 and 4 channels, several
# clusters and batch rows; P = 512 and 8192, whose last three stages take
# one pass; gate groups of 16 and 32 channels, which a CTA's pairs share
# (their gates staged in shared memory)
CLUSTER_CASES = [(1, 128, 4, 2, True, (1, 2, 64)),
                 (2, 256, 8, 4, False, (2, 2, 64)),
                 (1, 512, 8, 2, True, (2, 4, 64)),
                 (1, 512, 12, 4, True, (4, 2, 32)),
                 (1, 1024, 16, 16, False, (4, 4, 128)),
                 (2, 1024, 24, 8, True, (8, 2, 64)),
                 (1, 2048, 16, 4, True, (8, 4, 64)),
                 (1, 4096, 8, 2, True, (16, 4, 64)),
                 (2, 1024, 12, 6, False, (4, 2, 64)),
                 (1, 512, 4, 2, True, (1, 2, 64)),
                 (1, 16384, 4, 1, True, (2, 2, 256)),
                 (1, 1024, 32, 2, True, (8, 4, 64)),
                 (2, 2048, 32, 1, False, (16, 4, 32))]


@pytest.mark.parametrize("b,n,d,cols,mem,plan", CLUSTER_CASES)
def test_emulated_twopass_mix_clusters(twopass_lib, b, n, d, cols, mem,
                                       plan):
    v, gr, gi, mem_t = _mix_args(b, n, d, cols, mem, n + d + cols)
    y = _emulated_long_mix(twopass_lib.fft_twopass_mix, v, gr, gi, mem_t, n,
                           plan)
    assert _rel(y, sm.twopass_mix_ref(v, gr, gi, mem_t, n)) < TOL


def test_emulated_twopass_reading_its_own_rank_fails(tmp_path_factory):
    """A copy of mix_fft.cuh whose cross-CTA step reads and writes its own
    CTA's shared memory in place of every rank's disagrees with the plain
    version wherever a cluster has more than one CTA (and only there): the
    checks above see the step across the cluster."""
    if cuda_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++)")
    src = (kb.CSRC_DIR / "mix_fft.cuh").read_text()
    good = "return cg::this_cluster().map_shared_rank(z, q);"
    assert src.count(good) == 1
    out = tmp_path_factory.mktemp("broken_cluster")
    (out / "mix_fft.cuh").write_text(src.replace(
        good, "return cg::this_cluster().map_shared_rank(\n"
        "        z, cg::this_cluster().block_rank());"))
    for name in ("twopass_mix.cu", "fft_common.cuh"):
        (out / name).write_text((kb.CSRC_DIR / name).read_text())
    lib = cuda_emulation.build(out / "twopass_mix.cu", out)
    argtypes, restype = kb._SIGNATURES["fft_twopass_mix"]
    lib.fft_twopass_mix.argtypes = argtypes
    lib.fft_twopass_mix.restype = restype
    n, d, cols = 512, 8, 2
    v, gr, gi, mem_t = _mix_args(1, n, d, cols, True, 3)
    want = sm.twopass_mix_ref(v, gr, gi, mem_t, n)
    for plan, broken in (((1, 2, 32), False), ((4, 2, 32), True),
                         ((16, 4, 32), True)):
        y = _emulated_long_mix(lib.fft_twopass_mix, v, gr, gi, mem_t, n,
                               plan)
        assert (_rel(y, want) > TOL) == broken


def test_mix_ablation_cuts_apply():
    """fft_tpu_torch.kernels.mix_ablation's copies of mix_fft.cuh (#3 and
    #4 through twopass_mix.cu, #1 through spectral_mix.cu) and of #2's
    kernel each take out exactly the parts they name: every cut finds its
    text once, and the whole kernel is the source as it is."""
    from fft_tpu_torch.kernels import mix_ablation as ma
    for kernel, (_, _, cuts, variants, _) in ma._KERNELS.items():
        whole = ma._sources("whole", kernel)
        for name, text in whole.items():
            assert text == (kb.CSRC_DIR / name).read_text()
        for cut, edits in cuts.items():
            for old, _ in edits:
                assert sum(t.count(old) for t in whole.values()) == 1, (
                    kernel, cut, old)
        for variant in variants[1:]:
            texts = ma._sources(variant, kernel)
            assert texts != whole
            for cut in variant[2:].split("_no"):
                for old, new in cuts[cut]:
                    assert old not in "".join(texts.values())
                    assert new in "".join(texts.values())


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


def _randn(g, *shape):
    return torch.randn(shape, generator=g)


def _tw(chunk):
    return torch.from_numpy(twiddles_np(2 * chunk))


# (b, n, chunk, lanes, threads, sms): #9 at chunks 2 to 2048 (2: a copy
# and one radix-2 stage; 4: the first pass alone; 2048: the 16-element
# register passes) with more items than blocks, so a block walks several
# and loads the next one's rows during this one's passes
KF_SEG_CASES = [(2, 64, 16, 16, 256, 1), (1, 24, 8, 8, 64, 1),
                (1, 4096, 2048, 8, 512, 1), (2, 512, 128, 16, 128, 1),
                (1, 16, 4, 8, 32, 1), (1, 8, 2, 16, 32, 1),
                (1, 1024, 256, 8, 256, 2), (1, 4096, 1024, 16, 384, 1)]


@pytest.mark.parametrize("b,n,chunk,lanes,threads,sms", KF_SEG_CASES)
def test_emulated_kf_seg_rfft(long_lib, b, n, chunk, lanes, threads, sms):
    assert kc.kf_seg_rfft_supported(n, chunk, lanes)
    g = torch.Generator().manual_seed(n + lanes)
    kt = _randn(g, b, n, lanes)
    kfr = torch.full((b, n // chunk, chunk + 1, lanes), float("nan"))
    kfi = torch.full_like(kfr, float("nan"))
    assert long_lib.fft_kf_seg_rfft(_ptr(kt), _ptr(_tw(chunk)), _ptr(kfr),
                                    _ptr(kfi), b, n, chunk, lanes, threads,
                                    sms, None) == 0
    want = kc.kf_seg_rfft_ref(kt, chunk)
    assert _rel(kfr, want[0]) < TOL and _rel(kfi, want[1]) < TOL
    assert torch.equal(kfi[:, :, 0], torch.zeros_like(kfi[:, :, 0]))


# (b, nc, chunk, d, cols, np, threads): gate groups of 8, 1 (a channel
# pair spans two groups) and 16 channels; one 8-channel group at chunk
# 2048; nc 16 (two 8-output tiles, ten 4 x 4 Kbar tiles); a 32-channel
# group filling a bin row and 4-channel groups 8 to a row; a 64-channel
# group, two channels a thread; each transform tile plan (np channel pairs,
# threads a block) passed explicitly (at chunk 2048 the 4-pair tile takes
# an SM, and its blocks loop over the segments)
LONG_CASES = [(2, 3, 16, 16, 2, 2, 512), (1, 2, 8, 32, 4, 4, 256),
              (1, 3, 4, 16, 16, 1, 64), (1, 2, 2048, 8, 1, 4, 512),
              (1, 16, 8, 16, 4, 2, 96), (1, 3, 16, 32, 1, 4, 128),
              (1, 2, 16, 32, 8, 2, 256), (1, 2, 8, 64, 1, 4, 512)]


def _long_inputs(b, nc, chunk, d, cols):
    g = torch.Generator().manual_seed(nc * chunk + d + cols)
    n, f2 = nc * chunk, chunk + 1
    return (_randn(g, b, n, d), _randn(g, b, nc, f2, nc * cols),
            _randn(g, b, nc, f2, nc * cols), _randn(g, b, n, d))


def _emulated_mix_v3(lib, v, kr, ki, chunk, cols, np_, threads):
    b, n, d = v.shape
    nc = n // chunk
    scratch = [torch.full((b, nc, chunk + 1, d), float("nan"))
               for _ in range(2)]
    y = torch.empty_like(v)
    assert lib.fft_fused_causal_mix_v3(
        _ptr(v), _ptr(kr), _ptr(ki), _ptr(_tw(chunk)),
        *(_ptr(t) for t in scratch), _ptr(y), b, nc, chunk, d, cols, np_,
        threads, int(v.dtype == torch.bfloat16), None) == 0
    return y


def _emulated_bwd_v3(lib, v, kr, ki, ybar, chunk, cols, np_, threads):
    b, n, d = v.shape
    nc = n // chunk
    scratch = [torch.full((b, nc, chunk + 1, d), float("nan"))
               for _ in range(4)]
    out = [torch.empty_like(v), torch.full_like(kr, float("nan")),
           torch.full_like(ki, float("nan"))]
    assert lib.fft_fused_causal_mix_bwd_v3(
        _ptr(v), _ptr(kr), _ptr(ki), _ptr(ybar), _ptr(_tw(chunk)),
        *(_ptr(t) for t in scratch), *(_ptr(t) for t in out), b, nc, chunk,
        d, cols, np_, threads, int(v.dtype == torch.bfloat16), None) == 0
    return out


@pytest.mark.parametrize("b,nc,chunk,d,cols,np_,threads", LONG_CASES)
def test_emulated_fused_causal_mix_v3(long_lib, b, nc, chunk, d, cols, np_,
                                      threads):
    v, kr, ki, _ = _long_inputs(b, nc, chunk, d, cols)
    y = _emulated_mix_v3(long_lib, v, kr, ki, chunk, cols, np_, threads)
    assert _rel(y, kc.fused_causal_mix_ref(v, kr, ki, chunk, cols)) < TOL


@pytest.mark.parametrize("b,nc,chunk,d,cols,np_,threads", LONG_CASES)
def test_emulated_fused_causal_mix_bwd_v3(long_lib, b, nc, chunk, d, cols,
                                          np_, threads):
    """Each output on its own, and Kbar exactly 0 where c < delta."""
    v, kr, ki, ybar = _long_inputs(b, nc, chunk, d, cols)
    out = _emulated_bwd_v3(long_lib, v, kr, ki, ybar, chunk, cols, np_,
                           threads)
    want = kc.fused_causal_mix_bwd_ref(v, kr, ki, ybar, chunk, cols)
    for got, w in zip(out, want):
        assert _rel(got, w) < TOL
    kbar = out[1].reshape(b, nc, chunk + 1, nc, cols)     # (B, dl, F2, c, G)
    for dl in range(nc):
        assert torch.equal(kbar[:, dl, :, :dl],
                           torch.zeros_like(kbar[:, dl, :, :dl]))


# (b, nc, chunk, d, cols, np, threads) of the bf16 instances: nc 3 (B=2,
# one-channel groups: a pair spans two) and nc 16 (two 8-output tiles, ten
# 4 x 4 Kbar tiles), each with a tile plan of its own
LONG_BF16_CASES = [(2, 3, 16, 16, 16, 2, 512), (1, 3, 32, 32, 4, 4, 128),
                   (1, 16, 8, 16, 4, 2, 96), (1, 16, 16, 32, 2, 1, 64)]


@pytest.mark.parametrize("b,nc,chunk,d,cols,np_,threads", LONG_BF16_CASES)
def test_emulated_fused_causal_mix_v3_bf16(long_lib, b, nc, chunk, d, cols,
                                           np_, threads):
    """#7's bf16 instance: bf16 v in, bf16 y out, against the plain
    version on the same bf16 inputs."""
    v, kr, ki, _ = _long_inputs(b, nc, chunk, d, cols)
    v = v.bfloat16()
    y = _emulated_mix_v3(long_lib, v, kr, ki, chunk, cols, np_, threads)
    want = kc.fused_causal_mix_ref(v, kr, ki, chunk, cols)
    assert y.dtype == want.dtype == torch.bfloat16
    assert _rel(y.float(), want.float()) < BF16_TOL


@pytest.mark.parametrize("b,nc,chunk,d,cols,np_,threads", LONG_BF16_CASES)
def test_emulated_fused_causal_mix_bwd_v3_bf16(long_lib, b, nc, chunk, d,
                                               cols, np_, threads):
    """#11's bf16 instance: bf16 v and ybar in, vbar bf16 and Kbar fp32
    out (the primal dtypes), each against the plain version on the same
    bf16 inputs; Kbar, summed in fp32 from the same values, within the
    fp32 bound and exactly 0 where c < delta."""
    v, kr, ki, ybar = _long_inputs(b, nc, chunk, d, cols)
    v, ybar = v.bfloat16(), ybar.bfloat16()
    out = _emulated_bwd_v3(long_lib, v, kr, ki, ybar, chunk, cols, np_,
                           threads)
    want = kc.fused_causal_mix_bwd_ref(v, kr, ki, ybar, chunk, cols)
    assert [t.dtype for t in out] == [t.dtype for t in want] == [
        torch.bfloat16, torch.float32, torch.float32]
    assert _rel(out[0].float(), want[0].float()) < BF16_TOL
    assert _rel(out[1], want[1]) < TOL and _rel(out[2], want[2]) < TOL
    kbar = out[1].reshape(b, nc, chunk + 1, nc, cols)     # (B, dl, F2, c, G)
    for dl in range(nc):
        assert torch.equal(kbar[:, dl, :, :dl],
                           torch.zeros_like(kbar[:, dl, :, :dl]))


def test_emulated_long_bf16_refuses_rows_out_of_alignment(long_lib):
    """The bf16 instances copy a window's rows whole (16 bytes at 4 channel
    pairs): a v or ybar that starts off that alignment is refused with
    cudaErrorInvalidValue (1), never copied; the fp32 instance takes it."""
    b, nc, chunk, d, cols = 1, 3, 16, 32, 4
    v, kr, ki, ybar = _long_inputs(b, nc, chunk, d, cols)
    scratch = [torch.empty((b, nc, chunk + 1, d)) for _ in range(4)]
    for bf16, want in ((1, 1), (0, 0)):
        dt = torch.bfloat16 if bf16 else torch.float32
        buf = torch.zeros(b * nc * chunk * d + 4, dtype=dt)
        off = buf[2:2 + v.numel()].view(v.shape)        # 4 or 8 bytes in
        off.copy_(v)
        out = torch.empty_like(off)
        args = (_ptr(kr), _ptr(ki), _ptr(_tw(chunk)))
        assert long_lib.fft_fused_causal_mix_v3(
            _ptr(off), *args, *(_ptr(t) for t in scratch[:2]), _ptr(out), b,
            nc, chunk, d, cols, 4, 128, bf16, None) == want
        assert long_lib.fft_fused_causal_mix_bwd_v3(
            _ptr(off), _ptr(kr), _ptr(ki), _ptr(off), _ptr(_tw(chunk)),
            *(_ptr(t) for t in scratch), _ptr(out), _ptr(torch.empty_like(
                kr)), _ptr(torch.empty_like(ki)), b, nc, chunk, d, cols, 4,
            128, bf16, None) == want


def test_emulated_kbar_with_a_channel_dropped_fails(tmp_path_factory):
    """A copy of causal_long.cu whose Kbar group sums skip each group's
    first channel disagrees with the plain version (and only in Kbar): the
    check above sees it."""
    if cuda_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++)")
    src = (kb.CSRC_DIR / "causal_long.cu").read_text()
    good = "for (int e = 0; e < span; ++e) {"
    assert src.count(good) == 1
    out = tmp_path_factory.mktemp("broken_long")
    broken = out / "causal_long.cu"
    broken.write_text(src.replace(good, "for (int e = 1; e < span; ++e) {"))
    for header in ("causal_common.cuh", "fft_common.cuh"):
        (out / header).write_text((kb.CSRC_DIR / header).read_text())
    lib = cuda_emulation.build(broken, out)
    argtypes, restype = kb._SIGNATURES["fft_fused_causal_mix_bwd_v3"]
    lib.fft_fused_causal_mix_bwd_v3.argtypes = argtypes
    lib.fft_fused_causal_mix_bwd_v3.restype = restype
    b, nc, chunk, d, cols = 1, 3, 16, 32, 8
    v, kr, ki, ybar = _long_inputs(b, nc, chunk, d, cols)
    got = _emulated_bwd_v3(lib, v, kr, ki, ybar, chunk, cols, 2, 128)
    want = kc.fused_causal_mix_bwd_ref(v, kr, ki, ybar, chunk, cols)
    assert _rel(got[0], want[0]) < TOL
    assert _rel(got[1], want[1]) > TOL and _rel(got[2], want[2]) > TOL


def _emulated_banded(lib, args, chunk, plan=None):
    """y from #5's C entry with the wrapper's transform, tables and
    parameter block, and ``plan`` (np, threads; ``kc.banded_fft_plan``'s
    unless given, threads capped at 128 for the emulation's speed); y
    starts as NaN."""
    b, nc, _, d = args[0].shape
    _, _, np_, threads = kc.banded_fft_plan(chunk)
    params = kc._banded_params(b, nc, chunk, d, args[2].shape[-1],
                               torch.device("cpu"),
                               plan or (np_, min(threads, 128)))
    y = torch.full((b, nc, chunk, d), float("nan"))
    assert lib.fft_banded_inverse(*(_ptr(t) for t in args), _ptr(y),
                                  ctypes.addressof(params), None) == 0
    return y


def _banded_args(b, nc, chunk, d, cols):
    g = torch.Generator().manual_seed(chunk + d)
    f2 = chunk + 1
    return [_randn(g, b, nc, f2, d), _randn(g, b, nc, f2, d),
            _randn(g, b, nc, nc, f2, cols), _randn(g, b, nc, nc, f2, cols)]


# (b, nc, chunk, d, cols): chunks past the first design's 32-channel tile
# (853; the 350M's prompts whose length is no multiple of 128) and a small
# chunk at nc = 3, now Bluestein at M = 8192 and 4096 and 2C = 4 * 5
BANDED_CASES = [(1, 1, 1500, 8, 1), (1, 2, 900, 16, 2), (2, 3, 10, 8, 2)]


@pytest.mark.parametrize("b,nc,chunk,d,cols", BANDED_CASES)
def test_emulated_banded_inverse_narrow_tile(causal_lib, b, nc, chunk, d,
                                             cols):
    if chunk > 853:          # the range's 8-channel part; the kernel takes
        assert kc.banded_supported(nc, chunk + 1, d, cols)   # d % 8 anywhere
    assert kc.banded_transform(chunk) == {1500: (8192, 0), 900: (4096, 0),
                                          10: (4, 5)}[chunk]
    args = _banded_args(b, nc, chunk, d, cols)
    y = _emulated_banded(causal_lib, args, chunk)
    assert _rel(y, kc.banded_inverse_ref(*args, chunk)) < TOL


# (b, nc, chunk, d, cols, plan): both paths at every tile of channel pairs,
# at nc = 3 too:
# 2C = 2^11 (the 350M's 1024-token prompt), 2C = 1024 * 3, 2C = 8 * 25;
# Bluestein at a prime chunk (M = 4096), at 1500 (M = 8192), at chunk 1, 3
# and 37 (M = 64, 64, 128) and at M = 16384 (2904)
BANDED_PLAN_CASES = [
    (1, 1, 1024, 16, 2, (4, 128)), (1, 1, 1024, 8, 1, (2, 64)),
    (1, 1, 1536, 8, 2, (1, 64)), (2, 3, 100, 16, 4, (4, 96)),
    (1, 1, 1201, 8, 1, (2, 128)), (1, 1, 1500, 16, 4, (2, 64)),
    (2, 3, 37, 8, 2, (1, 32)), (1, 3, 1, 8, 1, (4, 32)),
    (1, 2, 3, 8, 8, (2, 32)), (1, 1, 2904, 8, 1, (1, 128)),
]


@pytest.mark.parametrize("b,nc,chunk,d,cols,plan", BANDED_PLAN_CASES)
def test_emulated_banded_fft_plans(causal_lib, b, nc, chunk, d, cols, plan):
    args = _banded_args(b, nc, chunk, d, cols)
    y = _emulated_banded(causal_lib, args, chunk, plan)
    assert _rel(y, kc.banded_inverse_ref(*args, chunk)) < TOL


def _direct_mix_inputs(b, nc, chunk, d, cols, seed):
    g = torch.Generator().manual_seed(seed)
    f2 = chunk + 1
    v = _randn(g, b, nc * chunk, d)
    kr, ki = (_randn(g, b, nc, f2, nc * cols) for _ in range(2))
    return v, kr, ki


def _emulated_direct_mix(lib, v, kr, ki, chunk, cols, seg=None):
    """(y, vfr, vfi) from the direct #6's C entry with the wrapper's tables
    and parameter blocks (threads capped at 128 for the emulation's speed;
    ``seg``: another SegmentParams block); y and the scratch start as
    NaN."""
    b, n, d = v.shape
    nc, f2 = n // chunk, chunk + 1
    cpu = torch.device("cpu")
    _, _, np_, threads = kc.banded_fft_plan(chunk)
    params = kc._banded_params(b, nc, chunk, d, cols, cpu,
                               (np_, min(threads, 128)))
    if seg is None:
        seg = kc._segment_params(b, nc, chunk, d, cpu,
                                 min(kc.segment_fft_threads(nc, chunk), 128))
    y = torch.full_like(v, float("nan"))
    vfr, vfi = (torch.full((b, nc, f2, d), float("nan")) for _ in range(2))
    assert lib.fft_fused_causal_mix_direct(
        _ptr(v), _ptr(kr), _ptr(ki), _ptr(vfr), _ptr(vfi), _ptr(y),
        ctypes.addressof(params), ctypes.addressof(seg), _bf16(v),
        None) == 0
    return y, vfr, vfi


def _spectra_exact_where_real(vfi, chunk) -> bool:
    """Im of the segment spectra exactly 0 at DC and Nyquist."""
    return bool((vfi[:, :, 0] == 0).all() and (vfi[:, :, chunk] == 0).all())


# (b, nc, chunk, d, cols): the direct #6, segment FFTs then #5's body on
# the producer layout: 2C = 2^8; Bluestein at a 600-token prompt (a zero
# first half, M = 2048), at 853 with a full window (M = 4096) and at 129
# (M = 512 and 1024); 2C = 1280 = 256 * 5
DIRECT_MIX_CASES = [(2, 2, 128, 32, 2), (1, 1, 600, 64, 4),
                    (1, 2, 853, 32, 8), (2, 2, 640, 32, 2),
                    (1, 3, 129, 32, 4)]


@pytest.mark.parametrize("b,nc,chunk,d,cols", DIRECT_MIX_CASES)
def test_emulated_direct_mix_runs_the_banded_body(causal_lib, b, nc, chunk,
                                                  d, cols):
    """y against the plain version, and the first launch's scratch
    against the windows' rfft_2C (Im exactly 0 at DC and Nyquist)."""
    v, kr, ki = _direct_mix_inputs(b, nc, chunk, d, cols, chunk)
    y, vfr, vfi = _emulated_direct_mix(causal_lib, v, kr, ki, chunk, cols)
    assert _rel(y, kc.fused_causal_mix_ref(v, kr, ki, chunk, cols)) < TOL
    vf = kc.segment_spectra(v, chunk)
    assert _rel(vfr, vf.real) < TOL and _rel(vfi, vf.imag) < TOL
    assert _spectra_exact_where_real(vfi, chunk)


def test_emulated_segment_fft_refuses_what_it_does_not_take(causal_lib):
    """The direct #6's C entry returns cudaErrorInvalidValue (1) for a
    segment transform whose Bluestein length misses 3C - 1 (half-zero
    windows) or 4C - 1 (full ones), a P O split that does not make 2C, a
    width its tile of 4 pairs does not divide, threads past the odd path's
    256 or no multiple of 32, or a shape other than #5's block's, and for
    a #5 tile other than 4 pairs; y is not written."""
    cpu = torch.device("cpu")
    for chunk, nc, d, fields, tile in (
            (600, 1, 32, {10: 1024}, 4), (600, 2, 32, {11: 2048}, 4),
            (640, 1, 32, {10: 128, 11: 128}, 4), (640, 1, 32, {13: 48}, 4),
            (640, 1, 12, {}, 4), (640, 1, 32, {13: 512}, 4),
            (600, 1, 32, {6: 2}, 4), (600, 1, 32, {}, 2)):
        v, kr, ki = _direct_mix_inputs(1, nc, chunk, d, 2, 0)
        seg = kc._segment_params(1, nc, chunk, d, cpu, 128)
        for i, x in fields.items():
            seg[i] = x
        params = kc._banded_params(1, nc, chunk, d, 2, cpu, (tile, 128))
        y = torch.full_like(v, float("nan"))
        vfr, vfi = (torch.empty(1, nc, chunk + 1, d) for _ in range(2))
        assert causal_lib.fft_fused_causal_mix_direct(
            _ptr(v), _ptr(kr), _ptr(ki), _ptr(vfr), _ptr(vfi), _ptr(y),
            ctypes.addressof(params), ctypes.addressof(seg), 0, None) == 1
        assert torch.isnan(y).all()


def test_emulated_full_window_bluestein_sized_for_3c_fails(
        tmp_path_factory):
    """A copy of segment_fft.cuh that takes Bluestein's M >= 3C - 1 (the
    half-zero windows' length and tables) for full windows too, as its
    check allows, must fail against the plain version at C = 600, nc = 2
    (M = 2048 where the lags of a full window need 4096): the cyclic
    convolution wraps the lags past M - 2C onto the positive ones."""
    if cuda_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++)")
    src = (kb.CSRC_DIR / "segment_fft.cuh").read_text()
    good = "a.len_full >= 4 * a.chunk - 1"
    assert src.count(good) == 1
    out = tmp_path_factory.mktemp("broken_segment")
    (out / "segment_fft.cuh").write_text(
        src.replace(good, "a.len_full >= 3 * a.chunk - 1"))
    for name in ("causal.cu", "causal_common.cuh", "fft_common.cuh",
                 "mix_fft.cuh"):
        (out / name).write_text((kb.CSRC_DIR / name).read_text())
    lib = cuda_emulation.build(out / "causal.cu", out)
    argtypes, restype = kb._SIGNATURES["fft_fused_causal_mix_direct"]
    lib.fft_fused_causal_mix_direct.argtypes = argtypes
    lib.fft_fused_causal_mix_direct.restype = restype
    b, nc, chunk, d, cols = 1, 2, 600, 32, 2
    cpu = torch.device("cpu")
    length, full, _ = kc.segment_transform(chunk)
    assert (length, full) == (2048, 4096)
    seg = kc._segment_params(b, nc, chunk, d, cpu, 128)
    short = kc._segment_tables(chunk, cpu)
    seg[4], seg[5], seg[11] = short[2].data_ptr(), short[3].data_ptr(), \
        length
    v, kr, ki = _direct_mix_inputs(b, nc, chunk, d, cols, 1)
    y, vfr, _ = _emulated_direct_mix(lib, v, kr, ki, chunk, cols, seg)
    vf = kc.segment_spectra(v, chunk)
    assert _rel(vfr[:, :1], vf.real[:, :1]) < TOL      # the half-zero one
    assert _rel(vfr[:, 1:], vf.real[:, 1:]) > TOL
    assert _rel(y, kc.fused_causal_mix_ref(v, kr, ki, chunk, cols)) > TOL


@pytest.fixture(scope="module")
def bwd_direct_lib(tmp_path_factory):
    return _emulated(tmp_path_factory, "causal_bwd.cu",
                     ("fft_fused_causal_mix_bwd_direct",))


# (b, nc, chunk, d, cols, tile, bf16): the direct #10 at the 350M's 600-
# token chunk (Bluestein: M = 2048) and at 129 (M = 512); nc 9 at C = 8
# (2C = 16) over lag tiles of 4 segments, three tile rows; C = 17 (2C = 34,
# Bluestein at M = 64) over tiles of 2; the bf16 instance at C = 12 (2C =
# 24 = 8 * 3), five segments in tiles of 2.  Gate groups wider than a
# block (walked in slices) are held on the card
# (tests/test_torch_kernels.py): 512-thread blocks are slow to emulate
DIRECT_BWD_CASES = [(1, 2, 600, 32, 2, None, False),
                    (1, 3, 129, 32, 4, None, False),
                    (1, 9, 8, 32, 4, 4, False),
                    (1, 3, 17, 32, 2, 2, False),
                    (1, 5, 12, 32, 4, 2, True)]


def _direct_bwd_inputs(b, nc, chunk, d, cols, bf16=False):
    v, kr, ki = _direct_mix_inputs(b, nc, chunk, d, cols, chunk + 2)
    ybar = _randn(torch.Generator().manual_seed(chunk + 3), b, nc * chunk, d)
    if bf16:
        v, ybar = v.bfloat16(), ybar.bfloat16()
    return v, kr, ki, ybar


def _emulated_direct_bwd(lib, v, kr, ki, ybar, chunk, tile):
    """(vbar, Kbar's planes, A's planes) from the direct #10's C entry with
    the wrapper's parameter blocks (threads capped at 128 for the
    emulation's speed) and ``kc._lag_plan``'s lag tile of at most ``tile``
    segments; outputs and scratch start as NaN."""
    b, n, d = v.shape
    nc, f2, cols = n // chunk, chunk + 1, kr.shape[-1] // (n // chunk)
    cpu = torch.device("cpu")
    seg = kc._segment_params(b, nc, chunk, d, cpu,
                             min(kc.segment_fft_threads(nc, chunk), 128))
    inv = kc._banded_params(b, nc, chunk, d, cols, cpu)
    inv[12] = min(inv[12], 128)                   # threads
    vfr, vfi, rr, ri = (torch.full((b, nc, f2, d), float("nan"))
                        for _ in range(4))
    vbar = torch.full_like(v, float("nan"))
    kbr, kbi = (torch.full_like(kr, float("nan")) for _ in range(2))
    assert lib.fft_fused_causal_mix_bwd_direct(
        _ptr(v), _ptr(kr), _ptr(ki), _ptr(ybar), _ptr(vfr), _ptr(vfi),
        _ptr(rr), _ptr(ri), _ptr(vbar), _ptr(kbr), _ptr(kbi),
        ctypes.addressof(seg), ctypes.addressof(inv),
        *kc._lag_plan(nc, d, cols, tile), _bf16(v), None) == 0
    return vbar, kbr, kbi, rr, ri


@pytest.mark.parametrize("b,nc,chunk,d,cols,tile,bf16", DIRECT_BWD_CASES)
def test_emulated_direct_mix_bwd(bwd_direct_lib, b, nc, chunk, d, cols,
                                 tile, bf16):
    """The direct #10 (causal_bwd.cu: the segment FFTs of v and ybar, the
    lag tiles' Kbar and Vbar, one inverse FFT a chunk) against the plain
    adjoint, vbar and each Kbar plane within TOL (a bf16 vbar within
    ``_bf16_like``), Kbar exactly 0 for c < delta; launch 2's A (scratch)
    is rfft_2C([0 | ybar_s]) times coef_f / 2C with Im exactly 0 at DC and
    Nyquist."""
    v, kr, ki, ybar = _direct_bwd_inputs(b, nc, chunk, d, cols, bf16)
    f2 = chunk + 1
    vbar, kbr, kbi, rr, ri = _emulated_direct_bwd(bwd_direct_lib, v, kr,
                                                  ki, ybar, chunk, tile)
    want = kc.fused_causal_mix_bwd_ref(v, kr, ki, ybar, chunk, cols)
    assert _bf16_like(vbar, want[0])
    assert _rel(kbr, want[1]) < TOL and _rel(kbi, want[2]) < TOL
    kbar = kbr.view(b, nc, f2, nc, cols)
    assert all(int(torch.count_nonzero(kbar[:, dl, :, :dl])) == 0
               for dl in range(nc))
    ys = ybar.float().reshape(b, nc, chunk, d)
    a = torch.fft.rfft(torch.cat([torch.zeros_like(ys), ys], 2), dim=2)
    coef = torch.full((f2, 1), 2.0 / (2 * chunk))
    coef[0] = coef[-1] = 1.0 / (2 * chunk)
    assert _rel(rr, a.real * coef) < TOL
    assert _rel(ri[:, :, 1:chunk], (a.imag * coef)[:, :, 1:chunk]) < TOL
    assert _spectra_exact_where_real(ri, chunk)


def test_emulated_banded_refuses_what_it_does_not_take(causal_lib):
    """The C entry returns cudaErrorInvalidValue (1) for a transform that
    does not cover 2C, an M below 3C - 1, a tile not dividing d or not 1, 2
    or 4 pairs, threads past the odd path's 256 or no multiple of 32, or a
    block past 227 KB; nothing is written."""
    cpu = torch.device("cpu")
    for chunk, length, o, np_, threads in (
            (100, 8, 5, 1, 32), (100, 256, 0, 1, 32), (100, 8, 25, 3, 32),
            (100, 8, 25, 4, 512), (100, 8, 25, 1, 48),
            (2904, 16384, 0, 2, 128)):
        args = _banded_args(1, 1, chunk, 8, 1)
        params = kc._banded_params(1, 1, chunk, 8, 1, cpu)
        params[9:13] = [length, o, np_, threads]
        y = torch.full((1, 1, chunk, 8), float("nan"))
        assert causal_lib.fft_banded_inverse(
            *(_ptr(t) for t in args), _ptr(y), ctypes.addressof(params),
            None) == 1
        assert torch.isnan(y).all()


def test_emulated_banded_keeping_im_at_dc_and_nyquist_fails(
        tmp_path_factory):
    """A copy of causal.cu whose packing keeps Im at DC and Nyquist (irfft
    drops it) must fail against the plain version: random spectra have
    nonzero Im there, so the parity checks see the drop."""
    src = (kb.CSRC_DIR / "causal.cu").read_text()
    good = "        xa.y = 0.f;\n        xb.y = 0.f;\n"
    assert src.count(good) == 1
    out = tmp_path_factory.mktemp("broken_banded")
    broken = out / "causal.cu"
    broken.write_text(src.replace(good, ""))
    for header in ("causal_common.cuh", "fft_common.cuh", "mix_fft.cuh",
                   "segment_fft.cuh"):
        (out / header).write_text((kb.CSRC_DIR / header).read_text())
    lib = cuda_emulation.build(broken, out)
    argtypes, restype = kb._SIGNATURES["fft_banded_inverse"]
    lib.fft_banded_inverse.argtypes = argtypes
    lib.fft_banded_inverse.restype = restype
    for chunk in (16, 13):                   # 2C = 2^5; Bluestein
        args = _banded_args(1, 1, chunk, 8, 2)
        y = _emulated_banded(lib, args, chunk)
        assert _rel(y, kc.banded_inverse_ref(*args, chunk)) > TOL


@pytest.fixture(scope="module")
def decode_lib(tmp_path_factory):
    return _emulated(tmp_path_factory, "decode.cu", ("fft_fused_decode_mix",))


def _decode_inputs(b, h, n, hd, groups, seed):
    g = torch.Generator().manual_seed(seed)
    f = n // 2 + 1
    prefix = torch.complex(_randn(g, b, h, f, hd), _randn(g, b, h, f, hd))
    gate = torch.complex(_randn(g, b, h, groups, f),
                         _randn(g, b, h, groups, f))
    return prefix, gate, _randn(g, b, h, hd), _randn(g, b, h, n, hd)


def _emulated_decode(lib, prefix, gate, v_t, v_buf, evict, j, pos):
    """prefix updated in place, y: the C entry as the wrapper calls it."""
    b, h, f, hd = prefix.shape
    n = v_buf.shape[-2]
    partial = torch.empty(b, h, -(-f // kd._TILE), hd)
    y = torch.empty(b, h, hd)
    assert lib.fft_fused_decode_mix(
        _ptr(torch.view_as_real(prefix)), _ptr(torch.view_as_real(gate)),
        _ptr(v_t), _ptr(v_buf), _ptr(partial), _ptr(y), b * h, n, hd,
        gate.shape[-2], evict, j, pos, kd._TILE, kd._rows(hd), None) == 0
    return y


# (b, h, n, hd, groups, evict, j, pos): F below one tile (n=16, F=9) and
# above (n=256, F=129: three tiles, the last of one row); hd 64 / G 4 (the
# LMs' heads) and hd 8 / G 2; the 350M's n=16384 at its last slot, where
# the angle's float32 roundings show
DECODE_CASES = [(2, 2, 16, 8, 2, 0, 5, 5), (1, 2, 16, 64, 4, 1, 0, 15),
                (2, 1, 256, 64, 4, 1, 128, 255), (1, 2, 256, 8, 2, 0, 255, 3),
                (1, 1, 16384, 8, 2, 1, 16383, 16383)]


@functools.lru_cache(maxsize=None)
def _decode_case(b, h, n, hd, groups, evict, j, pos):
    """The inputs of a case and the plain version's prefix and y, shared by
    the checks of decode.cu and of its broken copy (clone before use: the
    kernel updates the prefix in place)."""
    prefix, gate, v_t, v_buf = _decode_inputs(b, h, n, hd, groups, n + hd)
    want_prefix = prefix.clone()
    want = kd.fused_decode_mix_ref(want_prefix, gate, v_t, v_buf, evict, j,
                                   pos)
    return (prefix, gate, v_t, v_buf), want_prefix, want


@pytest.mark.parametrize("b,h,n,hd,groups,evict,j,pos", DECODE_CASES)
def test_emulated_fused_decode_mix(decode_lib, b, h, n, hd, groups, evict,
                                   j, pos):
    """The prefix and y each on its own against the plain version."""
    assert kd.decode_supported(hd, groups)
    (prefix, gate, v_t, v_buf), want_prefix, want = _decode_case(
        b, h, n, hd, groups, evict, j, pos)
    prefix = prefix.clone()
    y = _emulated_decode(decode_lib, prefix, gate, v_t, v_buf, evict, j, pos)
    assert _rel(prefix, want_prefix) < TOL
    assert _rel(y, want) < TOL


def test_emulated_decode_with_the_phase_rounded_another_way_fails(
        tmp_path_factory):
    """A copy of decode.cu that forms the angle as w * (k * j), one
    rounding fewer than the plain version's (w * k) * j, disagrees with it
    at n = 16384: the check above sees a phase error of a few ulps."""
    if cuda_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++)")
    src = (kb.CSRC_DIR / "decode.cu").read_text()
    good = "const float a = (w_ins * k) * (float)j;"
    assert good in src
    out = tmp_path_factory.mktemp("broken")
    broken = out / "decode.cu"
    broken.write_text(src.replace(good,
                                  "const float a = w_ins * (k * (float)j);"))
    lib = cuda_emulation.build(broken, out)
    argtypes, restype = kb._SIGNATURES["fft_fused_decode_mix"]
    lib.fft_fused_decode_mix.argtypes = argtypes
    lib.fft_fused_decode_mix.restype = restype
    case = DECODE_CASES[-1]
    (prefix, gate, v_t, v_buf), want_prefix, _ = _decode_case(*case)
    prefix = prefix.clone()
    _emulated_decode(lib, prefix, gate, v_t, v_buf, *case[-3:])
    assert _rel(prefix, want_prefix) > TOL


@pytest.fixture(scope="module")
def fft_lib(tmp_path_factory):
    return _emulated(tmp_path_factory, "causal_fft.cu",
                     ("fft_kf_spectra", "fft_fused_causal_mix",
                      "fft_fused_causal_mix_bwd"))


def _emulated_kf(lib, g_r, g_i, n_fft, chunk, np_, gs):
    b, _, lanes = g_r.shape
    kfr = torch.empty(b, n_fft // chunk, chunk + 1, lanes)
    kfi = torch.empty_like(kfr)
    assert lib.fft_kf_spectra(
        _ptr(g_r), _ptr(g_i), _ptr(torch.from_numpy(twiddles_np(n_fft))),
        _ptr(_tw(chunk)), _ptr(kfr), _ptr(kfi), b, n_fft, chunk, lanes, np_,
        gs, None) == 0
    return kfr, kfi


# (b, n_fft, chunk, lanes, np, gs): the tiny LM's n_fft 2048 / C 128 (nc
# 16) on the plan's 4-pair tile, 16 segments a pass and 5 (a partial last
# pass); nc 3 with odd factors in both lengths (1152 = 128 * 9, 2C = 768 =
# 256 * 3: 2C does not divide n_fft); C = 384 with n_fft = 512 * 3; 2- and
# 1-pair tiles
KF_FFT_CASES = [(1, 2048, 128, 16, 4, 16), (2, 2048, 128, 8, 4, 5),
                (1, 1152, 384, 8, 4, 2), (1, 1536, 384, 8, 2, 3),
                (2, 256, 64, 4, 1, 4)]


@pytest.mark.parametrize("b,n_fft,chunk,lanes,np_,gs", KF_FFT_CASES)
def test_emulated_kf_spectra_fft(fft_lib, b, n_fft, chunk, lanes, np_, gs):
    assert kc.kf_fft_plan(n_fft, chunk, 32 * lanes) is not None
    g = torch.Generator().manual_seed(n_fft + lanes + gs)
    g_r, g_i = (_randn(g, b, n_fft // 2 + 1, lanes) for _ in range(2))
    got = _emulated_kf(fft_lib, g_r, g_i, n_fft, chunk, np_, gs)
    want = kc.kf_spectra_ref(g_r, g_i, n_fft, chunk)
    assert _rel(got[0], want[0]) < TOL and _rel(got[1], want[1]) < TOL


def _emulated_mix(lib, v, kr, ki, chunk, cols, np_, gs):
    b, n, d = v.shape
    y = torch.empty_like(v)
    assert lib.fft_fused_causal_mix(
        _ptr(v), _ptr(kr), _ptr(ki), _ptr(_tw(chunk)), _ptr(y), b,
        n // chunk, chunk, d, cols, np_, gs, _bf16(v), None) == 0
    return y


# (b, nc, chunk, d, cols, np, gs): the tiny LM's C 128 at nc 16 (one
# 16-channel gate group) on the plan's tile, and nc 1 and 3; C = 384 (2C =
# 256 * 3); gate groups of 4 channels (cols 64 at d 256: a tile touches 2)
# and of 1 (a channel pair spans 2); 2- and 1-pair tiles, a partial last
# forward pass
MIX_FFT_CASES = [(1, 16, 128, 16, 1, 4, 4), (2, 1, 128, 16, 1, 4, 1),
                 (1, 3, 128, 32, 4, 4, 3), (1, 2, 384, 16, 2, 4, 2),
                 (1, 2, 128, 256, 64, 4, 2), (1, 3, 128, 16, 16, 2, 2),
                 (1, 5, 64, 8, 2, 1, 2)]


@pytest.mark.parametrize("b,nc,chunk,d,cols,np_,gs", MIX_FFT_CASES)
def test_emulated_fused_causal_mix_fft(fft_lib, b, nc, chunk, d, cols, np_,
                                       gs):
    v, kr, ki, _ = _long_inputs(b, nc, chunk, d, cols)
    got = _emulated_mix(fft_lib, v, kr, ki, chunk, cols, np_, gs)
    assert _rel(got, kc.fused_causal_mix_ref(v, kr, ki, chunk, cols)) < TOL


def test_emulated_fft_kernels_with_the_untangle_flipped_fail(
        tmp_path_factory):
    """A copy of causal_fft.cu whose untangle (fft_common.cuh's) takes B[k]
    with the wrong sign of its real part disagrees with the plain versions:
    the checks above see it."""
    if cuda_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++)")
    src = (kb.CSRC_DIR / "fft_common.cuh").read_text()
    good = "b = make_float2(0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));"
    assert src.count(good) == 1
    out = tmp_path_factory.mktemp("broken_fft")
    (out / "fft_common.cuh").write_text(src.replace(
        good, "b = make_float2(-0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));"))
    for name in ("causal_fft.cu", "causal_common.cuh"):
        (out / name).write_text((kb.CSRC_DIR / name).read_text())
    broken = out / "causal_fft.cu"
    lib = cuda_emulation.build(broken, out)
    for name in ("fft_kf_spectra", "fft_fused_causal_mix"):
        argtypes, restype = kb._SIGNATURES[name]
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = restype
    g = torch.Generator().manual_seed(3)
    g_r, g_i = (_randn(g, 1, 129, 8) for _ in range(2))
    got = _emulated_kf(lib, g_r, g_i, 256, 64, 4, 4)
    want = kc.kf_spectra_ref(g_r, g_i, 256, 64)
    assert _rel(got[0], want[0]) > TOL
    v, kr, ki, _ = _long_inputs(1, 2, 64, 8, 2)
    got = _emulated_mix(lib, v, kr, ki, 64, 2, 4, 2)
    assert _rel(got, kc.fused_causal_mix_ref(v, kr, ki, 64, 2)) > TOL


def _emulated_bwd_fft(lib, v, kr, ki, ybar, chunk, cols, np_, gs, bt):
    b, n, d = v.shape
    nc = n // chunk
    scratch = [torch.full((b, nc, chunk + 1, d, 2), float("nan"))
               for _ in range(2)]
    out = [torch.empty_like(v), torch.full_like(kr, float("nan")),
           torch.full_like(ki, float("nan"))]
    assert lib.fft_fused_causal_mix_bwd(
        _ptr(v), _ptr(kr), _ptr(ki), _ptr(ybar), _ptr(_tw(chunk)),
        *(_ptr(t) for t in scratch), *(_ptr(t) for t in out), b, nc, chunk,
        d, cols, np_, gs, bt, _bf16(v), None) == 0
    return out


# (b, nc, chunk, d, cols, np, gs, bt) of #10's FFT kernels: the tiny LM's
# C 128 at nc 16 (one 16-channel gate group), nc 1 and 3; 2C = 384 = 128 *
# 3; gate groups of 1, 2, 4, 8, 16 and 32 channels; 32-channel groups at d
# 288, whose bin-major tiles hold 8 groups and then 1; a small chunk with a
# partial last transform block (nc 5, 2 windows a block); each tile plan
# and bin-major block size passed explicitly, several bins a bin-major
# block where its groups are narrow
BWD_FFT_CASES = [(1, 16, 128, 16, 1, 4, 4, 256), (2, 1, 128, 16, 2, 4, 1, 64),
                 (1, 3, 128, 32, 32, 4, 3, 128), (1, 2, 192, 16, 4, 2, 2, 256),
                 (1, 3, 64, 64, 2, 1, 2, 512), (1, 2, 16, 288, 9, 4, 2, 256),
                 (1, 5, 8, 8, 4, 4, 2, 96)]


@pytest.mark.parametrize("b,nc,chunk,d,cols,np_,gs,bt", BWD_FFT_CASES)
def test_emulated_fused_causal_mix_bwd_fft(fft_lib, b, nc, chunk, d, cols,
                                           np_, gs, bt):
    """Each output on its own, and Kbar exactly 0 where c < delta."""
    v, kr, ki, ybar = _long_inputs(b, nc, chunk, d, cols)
    out = _emulated_bwd_fft(fft_lib, v, kr, ki, ybar, chunk, cols, np_, gs,
                            bt)
    want = kc.fused_causal_mix_bwd_ref(v, kr, ki, ybar, chunk, cols)
    for got, w in zip(out, want):
        assert _rel(got, w) < TOL
    kbar = out[1].reshape(b, nc, chunk + 1, nc, cols)     # (B, dl, F2, c, G)
    for dl in range(nc):
        assert torch.equal(kbar[:, dl, :, :dl],
                           torch.zeros_like(kbar[:, dl, :, :dl]))


def test_emulated_fft_bwd_with_a_channel_dropped_fails(tmp_path_factory):
    """A copy of causal_fft.cu whose #10 Kbar group sums skip each group's
    first channel disagrees with the plain version (and only in Kbar): the
    check above sees it."""
    if cuda_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++)")
    src = (kb.CSRC_DIR / "causal_fft.cu").read_text()
    good = "int j = 0;\n#pragma unroll 4"
    assert src.count(good) == 1
    out = tmp_path_factory.mktemp("broken_bwd")
    broken = out / "causal_fft.cu"
    broken.write_text(src.replace(good, "int j = 1;\n#pragma unroll 4"))
    for header in ("causal_common.cuh", "fft_common.cuh"):
        (out / header).write_text((kb.CSRC_DIR / header).read_text())
    lib = cuda_emulation.build(broken, out)
    argtypes, restype = kb._SIGNATURES["fft_fused_causal_mix_bwd"]
    lib.fft_fused_causal_mix_bwd.argtypes = argtypes
    lib.fft_fused_causal_mix_bwd.restype = restype
    b, nc, chunk, d, cols = 1, 3, 16, 32, 4
    v, kr, ki, ybar = _long_inputs(b, nc, chunk, d, cols)
    got = _emulated_bwd_fft(lib, v, kr, ki, ybar, chunk, cols, 4, 2, 256)
    want = kc.fused_causal_mix_bwd_ref(v, kr, ki, ybar, chunk, cols)
    assert _rel(got[0], want[0]) < TOL
    assert _rel(got[1], want[1]) > TOL and _rel(got[2], want[2]) > TOL


# ---------------------------------------------------------------------------
# the bf16 instances of #6, #10, #1-#4 (ROADMAP item 3b)
# ---------------------------------------------------------------------------

def _bf16_like(got, want) -> bool:
    """A bf16 output held to its plain version on the same bf16 inputs:
    within BF16_TOL max-wise, and equal to it element for element but for
    at most 1% of the elements (the kernel rounds its fp32 result to
    nearest even as the plain version's .to(torch.bfloat16) does; the two
    fp32 results, summed in other orders, straddle a rounding midpoint
    rarely).  fp32 outputs within TOL."""
    assert got.dtype == want.dtype
    if got.dtype != torch.bfloat16:
        return _rel(got, want) < TOL
    differ = float((got != want).float().mean())
    return _rel(got, want) < BF16_TOL and differ <= 1e-2


# (b, nc, chunk, d, cols, np, gs) of #6's FFT kernel in bf16: the tiny
# LM's chunk at nc 16 on the plan's tile, nc 3 (a partial last pass), and
# a 1-pair tile (a 4-byte row)
MIX_FFT_BF16 = [(1, 16, 128, 16, 1, 4, 4), (1, 3, 128, 32, 4, 4, 3),
                (1, 5, 64, 8, 2, 1, 2)]


@pytest.mark.parametrize("b,nc,chunk,d,cols,np_,gs", MIX_FFT_BF16)
def test_emulated_fused_causal_mix_fft_bf16(fft_lib, b, nc, chunk, d, cols,
                                            np_, gs):
    v, kr, ki, _ = _long_inputs(b, nc, chunk, d, cols)
    v = v.bfloat16()
    got = _emulated_mix(fft_lib, v, kr, ki, chunk, cols, np_, gs)
    assert _bf16_like(got, kc.fused_causal_mix_ref(v, kr, ki, chunk, cols))


# (b, nc, chunk, d, cols, np, gs, bt) of #10's FFT kernels in bf16: the
# tiny LM's chunk at nc 16, nc 3 with 2-channel groups on a 1-pair tile
BWD_FFT_BF16 = [(1, 16, 128, 16, 1, 4, 4, 256), (1, 3, 64, 64, 2, 1, 2, 512)]


@pytest.mark.parametrize("b,nc,chunk,d,cols,np_,gs,bt", BWD_FFT_BF16)
def test_emulated_fused_causal_mix_bwd_fft_bf16(fft_lib, b, nc, chunk, d,
                                                cols, np_, gs, bt):
    """vbar bf16, Kbar fp32 (within TOL: summed in fp32 from the same
    values)."""
    v, kr, ki, ybar = _long_inputs(b, nc, chunk, d, cols)
    v, ybar = v.bfloat16(), ybar.bfloat16()
    out = _emulated_bwd_fft(fft_lib, v, kr, ki, ybar, chunk, cols, np_, gs,
                            bt)
    want = kc.fused_causal_mix_bwd_ref(v, kr, ki, ybar, chunk, cols)
    assert [t.dtype for t in out] == [torch.bfloat16, torch.float32,
                                      torch.float32]
    for got, w in zip(out, want):
        assert _bf16_like(got, w)


@pytest.mark.parametrize("b,nc,chunk,d,cols", [(2, 2, 128, 32, 2),
                                               (1, 3, 129, 32, 4),
                                               (1, 1, 600, 64, 4)])
def test_emulated_direct_mix_bf16_runs_the_banded_body(causal_lib, b, nc,
                                                       chunk, d, cols):
    """The direct #6's bf16 instance: segment_fft_kernel widening bf16 v
    (its fp32 spectra within TOL of the windows' rfft_2C), banded_fft_kernel
    rounding y on its store."""
    v, kr, ki = _direct_mix_inputs(b, nc, chunk, d, cols, chunk + 1)
    v = v.bfloat16()
    y, vfr, vfi = _emulated_direct_mix(causal_lib, v, kr, ki, chunk, cols)
    assert _bf16_like(y, kc.fused_causal_mix_ref(v, kr, ki, chunk, cols))
    vf = kc.segment_spectra(v, chunk)
    assert _rel(vfr, vf.real) < TOL and _rel(vfi, vf.imag) < TOL


# (b, n_fft, d, cols, memory) of #1 and #2 in bf16 with the wrappers'
# plans (their bf16 instances: cs 1, np 4): a power of two, an odd factor
# (768 = 256 * 3) and a direct DFT (n = 2 mod 4), gate groups of 1, 2 and 16
# channels (#2's clusters of 1 and 2 CTAs, and a group wider than its
# cluster through the second launch)
DIRECT_BF16 = [(2, 64, 16, 8, True), (1, 768, 32, 2, False),
               (1, 200, 8, 8, True), (1, 256, 64, 2, True)]


@pytest.mark.parametrize("b,n,d,cols,mem", DIRECT_BF16)
def test_emulated_direct_mix_bf16(lib, b, n, d, cols, mem):
    g = torch.Generator().manual_seed(n + d)
    fh = n // 2 + 1
    v, ybar = (_randn(g, b, n, d).bfloat16() for _ in range(2))
    gr, gi = (_randn(g, b, fh, cols) for _ in range(2))
    mem_t = _randn(g, n, d) if mem else None
    y = _emulated_direct(lib, v, gr, gi, mem_t, n, sm.direct_plan(n))
    assert _bf16_like(y, sm.direct_mix_ref(v, gr, gi, mem_t, n))
    got = _emulated_bwd(lib, v, gr, gi, ybar, n, sm.bwd_plan(n))
    want = sm.direct_mix_bwd_ref(v, gr, gi, ybar, n)
    for a, w in zip(got, want):
        assert _bf16_like(a, w)


@pytest.mark.parametrize("name,b,n,cols", [
    ("staged_mix", 2, 2304, 4), ("staged_mix", 1, 4096, 1),
    ("twopass_mix", 1, 16384, 4)])
def test_emulated_long_mix_bf16(staged_lib, twopass_lib, name, b, n, cols):
    """#3 (an odd factor, 1 CTA of 2 pairs; 4096, a cluster of 2 CTAs of 4
    pairs) and #4 (a cluster of 8) in bf16 with the wrappers' plans, with
    memory."""
    d = 8
    v, gr, gi, mem_t = _mix_args(b, n, d, cols, True, n + 1)
    v = v.bfloat16()
    if name == "staged_mix":
        fn, plan = staged_lib.fft_staged_mix, sm.staged_plan(n)
    else:
        fn, plan = twopass_lib.fft_twopass_mix, sm.TWOPASS_PLAN[n]
    y = _emulated_long_mix(fn, v, gr, gi, mem_t, n, plan)
    assert _bf16_like(y, sm.direct_mix_ref(v, gr, gi, mem_t, n))


def test_emulated_bf16_store_truncating_fails(tmp_path_factory):
    """A copy of fft_common.cuh whose bf16 store truncates instead of
    rounding to nearest even: #6's bf16 instance then disagrees with its
    plain version (the checks above see the rounding), while its fp32
    instance does not."""
    if cuda_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler (g++)")
    src = (kb.CSRC_DIR / "fft_common.cuh").read_text()
    good = "    return __floats2bfloat162_rn(a, b);"
    assert src.count(good) == 1
    out = tmp_path_factory.mktemp("broken_bf16")
    (out / "fft_common.cuh").write_text(src.replace(good, (
        "    unsigned ua, ub;\n"
        "    std::memcpy(&ua, &a, 4);\n"
        "    std::memcpy(&ub, &b, 4);\n"
        "    return __nv_bfloat162{__nv_bfloat16{(unsigned short)(ua >> 16)},\n"
        "                          __nv_bfloat16{(unsigned short)(ub >> 16)}};"
    )))
    for name in ("causal_fft.cu", "causal_common.cuh"):
        (out / name).write_text((kb.CSRC_DIR / name).read_text())
    lib = cuda_emulation.build(out / "causal_fft.cu", out)
    argtypes, restype = kb._SIGNATURES["fft_fused_causal_mix"]
    lib.fft_fused_causal_mix.argtypes = argtypes
    lib.fft_fused_causal_mix.restype = restype
    v, kr, ki, _ = _long_inputs(1, 3, 64, 8, 2)
    want = kc.fused_causal_mix_ref(v, kr, ki, 64, 2)
    assert _bf16_like(_emulated_mix(lib, v, kr, ki, 64, 2, 4, 2), want)
    vb = v.bfloat16()
    got = _emulated_mix(lib, vb, kr, ki, 64, 2, 4, 2)
    assert not _bf16_like(got, kc.fused_causal_mix_ref(vb, kr, ki, 64, 2))


@pytest.fixture(scope="module")
def probe_lib(tmp_path_factory):
    return _emulated(tmp_path_factory, "probe.cu", ("fft_fma_chain",))


@pytest.mark.parametrize("n,depth,blocks,threads", [
    (1000, 16, 2, 64), (4099, 37, 3, 128), (64, 0, 1, 32)])
def test_emulated_fma_chain(probe_lib, n, depth, blocks, threads):
    """csrc/probe.cu, the measuring probe of measure_chip_constants (no
    TPU kernel): every element's chain of ``depth`` fused multiply-adds,
    over a grid-stride loop of fewer threads than elements, against the
    plain version's multiply and add a step (one rounding apart a step:
    2e-5 over these depths)."""
    x = torch.rand(n, generator=torch.Generator().manual_seed(n)) + 0.5
    want = probe.fma_chain_ref(x.clone(), depth)
    assert probe_lib.fft_fma_chain(_ptr(x), n, depth, blocks, threads,
                                   None) == 0
    assert _rel(x, want) < TOL
    assert depth == 0 or not torch.equal(x, torch.rand(
        n, generator=torch.Generator().manual_seed(n)) + 0.5)
