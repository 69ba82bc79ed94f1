"""SPECTRE layers (mirror of ``fft_tpu/layers/spectre.py``).

Heads are stacked on a leading axis of their parameters (the JAX package
``vmap``s them) and run together as batched einsums.  Ported:

- the gate (Toeplitz anchor smoothing, cubic or ``interp_reference_compat``
  interpolation, modReLU) and the mean, DCT and attention poolers;
- the non-causal head (``spectre_head_apply``) and multihead: the fused
  all-heads branch (``fft_impl="pallas"``, the spectral-mix kernels of
  ``fft_tpu_torch.kernels.spectral_mix``) and the per-head branch
  (``fft_impl`` "auto", "jnp" or "matmul": ``torch.fft``, cuFFT on the
  card; see ``ops/fftops.py``);
- the wavelet refinement, its wavelet path detached;
- the causal head, chunk gates (all three poolers, as the decode
  descriptors see them) and segmented multihead branch;
- the block with its frozen additive spectral memory.

The non-causal multihead picks its branch by the JAX package's rule
(``_mix_branch``, counted in ``MIX_BRANCH_CALLS``).

Randomness comes from an explicit ``torch.Generator``: dropout on the mixed
values and the wavelet's on-mask draw only under ``module.train()``, which
takes the place of the JAX package's ``deterministic=False``.  The
``sp_mesh`` arguments run sequence parallelism and ``tp_mesh`` head
parallelism over the axes of a ``parallel.mesh.Mesh`` (the JAX package's
GSPMD shardings become explicit collectives, ``parallel/comm.py``).

``compute_dtype="bfloat16"`` follows the JAX package's casts: the block
casts its input to bf16 (spectre.py:632), linear layers cast their fp32
parameters down and LayerNorms compute in fp32 (``layers/common.py``), the
gate MLP's raw output is fp32 (:87), so gates and spectra are fp32, and
each mix returns its input's dtype (:249, :329, :477, :539).  The
parameters stay fp32.  The JAX package's ``precision_for`` (matfft.py
:39-48) only picks the TPU's MXU passes and has no counterpart here: the
transforms run in fp32 (``torch.fft`` takes no bf16, so ``fftops``
upcasts) and the kernels compute in fp32 whatever their input.  On the
card every mix kernel the layers reach has a bf16 instance that reads and
writes the activations in bf16 (#1-#4 on the fused branch, #6, #7, #10 and
#11 on the causal one); the direct #10 alone has none and raises, naming
its ROADMAP line.
"""

from __future__ import annotations

import collections
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fft_tpu_torch.config import SpectreConfig, SpectreHeadConfig
from fft_tpu_torch.kernels import spectral_mix as spectral_mix_kernels
from fft_tpu_torch.kernels.spectral_mix import spectral_mix, unfused_mix
from fft_tpu_torch.layers.causal_seg import (
    BRANCH_CALLS, segmented_causal_mix, sp_segmented_causal_mix,
)
from fft_tpu_torch.layers.common import (
    DTYPES, LayerNorm, Linear, gelu_exact, layernorm_apply, linear_init,
)
from fft_tpu_torch.ops import (
    attention_pool, complex_circular_conv1d, dct_pool, dct_pool_weights,
    fftops, haar_decompose, haar_reconstruct, interp_complex_1d,
    interp_complex_1d_ref_compat, mean_pool, modrelu,
)
from fft_tpu_torch.parallel import comm
from fft_tpu_torch.parallel.dist_fft import (
    sp_spectral_mix, sp_spectral_mix_strided,
)
from fft_tpu_torch.utils.device import resolve_device
from fft_tpu_torch.utils.prof import forward_span


# hidden width of the attention pooler's scorer (spectre.py:159-172)
_POOL_HIDDEN = 256


def _check_head_config(cfg: SpectreHeadConfig) -> None:
    if cfg.compute_dtype not in DTYPES:
        raise ValueError(f"compute_dtype={cfg.compute_dtype!r}: one of "
                         f"{sorted(DTYPES)}")
    if cfg.fft_impl not in fftops.IMPLS:
        raise ValueError(f"fft_impl={cfg.fft_impl!r}: one of "
                         f"{fftops.IMPLS}")


class SpectreHeads(nn.Module):
    """The per-head parameters of one multihead mixer, stacked over heads.

    Linear weights are (H, fan_out, fan_in); ``modrelu_bias`` is (H, G,
    F_half).  The attention pooler adds its scorer ``pool_fc1_*`` (hd ->
    256) and ``pool_fc2_*`` (256 -> 1); the Toeplitz gate adds
    ``toeplitz_kernel``, a real (H, 2, 2 bw + 1) [re; im] pair."""

    def __init__(self, cfg: SpectreHeadConfig, num_heads: int):
        super().__init__()
        _check_head_config(cfg)
        h, hd, g = num_heads, cfg.embed_dim, cfg.num_groups
        n_raw = cfg.buckets * g * 2
        self.cfg = cfg
        self.w_q = nn.Parameter(torch.empty(h, hd, hd))
        self.w_v = nn.Parameter(torch.empty(h, hd, hd))
        self.gate_fc1_w = nn.Parameter(torch.empty(h, cfg.d_gate, hd))
        self.gate_fc1_b = nn.Parameter(torch.empty(h, cfg.d_gate))
        self.gate_fc2_w = nn.Parameter(torch.empty(h, n_raw, cfg.d_gate))
        self.gate_fc2_b = nn.Parameter(torch.empty(h, n_raw))
        self.q_norm_w = nn.Parameter(torch.empty(h, hd))
        self.q_norm_b = nn.Parameter(torch.empty(h, hd))
        self.modrelu_bias = nn.Parameter(torch.empty(h, g, cfg.f_half))
        if cfg.pooling_type == "attention":
            self.pool_fc1_w = nn.Parameter(torch.empty(h, _POOL_HIDDEN, hd))
            self.pool_fc1_b = nn.Parameter(torch.empty(h, _POOL_HIDDEN))
            self.pool_fc2_w = nn.Parameter(torch.empty(h, 1, _POOL_HIDDEN))
            self.pool_fc2_b = nn.Parameter(torch.empty(h, 1))
        if cfg.use_toeplitz:
            self.toeplitz_kernel = nn.Parameter(
                torch.empty(h, 2, 2 * cfg.toeplitz_bw + 1))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        h, _, hd = self.w_q.shape
        d_gate, n_raw = self.cfg.d_gate, self.gate_fc2_b.shape[-1]
        self.w_q.copy_(linear_init(hd, hd, generator, False, (h,))[0])
        self.w_v.copy_(linear_init(hd, hd, generator, False, (h,))[0])
        w, b = linear_init(hd, d_gate, generator, True, (h,))
        self.gate_fc1_w.copy_(w)
        self.gate_fc1_b.copy_(b)
        w, b = linear_init(d_gate, n_raw, generator, True, (h,))
        self.gate_fc2_w.copy_(w)
        self.gate_fc2_b.copy_(b)
        self.q_norm_w.fill_(1.0)
        self.q_norm_b.zero_()
        # -0.1 = near-identity gate
        self.modrelu_bias.fill_(-0.1)
        if self.cfg.pooling_type == "attention":
            w, b = linear_init(hd, _POOL_HIDDEN, generator, True, (h,))
            self.pool_fc1_w.copy_(w)
            self.pool_fc1_b.copy_(b)
            w, b = linear_init(_POOL_HIDDEN, 1, generator, True, (h,))
            self.pool_fc2_w.copy_(w)
            self.pool_fc2_b.copy_(b)
        if self.cfg.use_toeplitz:
            # complex randn / sqrt(klen): each plane N(0, 1 / (2 klen))
            klen = self.toeplitz_kernel.shape[-1]
            self.toeplitz_kernel.copy_(
                torch.randn(self.toeplitz_kernel.shape, generator=generator)
                / math.sqrt(2.0 * klen))


def dropout(y: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout as the JAX package writes it: keep each value with
    probability 1 - p and scale the kept ones by 1 / (1 - p).  The mask
    comes from ``generator`` (on y's device); the two frameworks' random
    bits differ, so only the distribution matches JAX's."""
    if generator is None:
        raise ValueError("dropout in training mode draws from an explicit "
                         "torch.Generator: pass generator=")
    keep = 1.0 - p
    mask = torch.rand(y.shape, generator=generator, device=y.device) < keep
    return torch.where(mask, y / keep, torch.zeros_like(y))


def _heads_linear(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-head linear: x (..., H, i), w (H, o, i) -> (..., H, o), the
    parameters cast to x's dtype."""
    y = torch.einsum("...hi,hoi->...ho", x, w.to(x.dtype))
    return y if b is None else y + b.to(x.dtype)


def spectre_gate(heads: SpectreHeads, cfg: SpectreHeadConfig,
                 descriptor: torch.Tensor) -> torch.Tensor:
    """Content-adaptive complex gate from a pooled descriptor (..., H, hd)
    -> (..., H, G, F_half) complex64: the gate MLP's anchors, smoothed by
    the Toeplitz kernel when ``use_toeplitz``, interpolated to F_half bins,
    then modReLU."""
    h = gelu_exact(_heads_linear(descriptor, heads.gate_fc1_w,
                                 heads.gate_fc1_b))
    raw = _heads_linear(h, heads.gate_fc2_w, heads.gate_fc2_b).float()
    raw = raw.reshape(*raw.shape[:-1], cfg.num_groups, cfg.buckets, 2)
    anchor = torch.complex(raw[..., 0], raw[..., 1])        # (..., H, G, Bk)
    if cfg.use_toeplitz:
        tk = heads.toeplitz_kernel                           # (H, 2, klen)
        kernel = torch.complex(tk[:, 0], tk[:, 1])[:, None]  # (H, 1, klen)
        anchor = anchor + complex_circular_conv1d(anchor, kernel)
    if cfg.interp_reference_compat:
        gate = interp_complex_1d_ref_compat(anchor, cfg.f_half)
    else:
        gate = interp_complex_1d(anchor, cfg.f_half)
    return modrelu(gate, heads.modrelu_bias)


def _pool_descriptor(heads: SpectreHeads, cfg: SpectreHeadConfig,
                     q: torch.Tensor, sp_mesh=None,
                     sp_layout: str = "contiguous") -> torch.Tensor:
    """The configured pooler over the sequence, then the query LayerNorm:
    q (B, N, H, hd) -> (B, H, hd).  Under ``sp_mesh`` q is this rank's
    shard of the whole window and the pooler's sums run over all ranks
    (``comm.all_reduce``; the softmax's max through ``all_reduce_max``)."""
    b, n, h, hd = q.shape
    if sp_mesh is None:
        if cfg.pooling_type == "attention":
            pooled = attention_pool(q.transpose(1, 2), heads.pool_fc1_w,
                                    heads.pool_fc1_b, heads.pool_fc2_w,
                                    heads.pool_fc2_b)
        elif cfg.pooling_type == "dct":
            pooled = dct_pool(q.reshape(b, n, h * hd)).reshape(b, h, hd)
        else:
            pooled = mean_pool(q.transpose(1, 2))
        return layernorm_apply(pooled, heads.q_norm_w, heads.q_norm_b)
    if cfg.pooling_type not in ("mean", "attention") and \
            sp_layout == "strided":
        # not a bare assert: survives python -O.  The strided layout hands
        # each shard one residue class of the sequence; DCT pooling reads
        # positions in order
        raise ValueError(
            f"pooling_type={cfg.pooling_type!r} is order-sensitive; "
            "the strided SP layout needs an order-invariant pooler "
            "(mean or attention) — use sp_layout='contiguous'")
    s = sp_mesh.size("seq")
    if cfg.pooling_type == "attention":
        sc = _heads_linear(gelu_exact(_heads_linear(
            q, heads.pool_fc1_w, heads.pool_fc1_b)), heads.pool_fc2_w,
            heads.pool_fc2_b)                                # (B, n, H, 1)
        e = torch.exp(sc - comm.all_reduce_max(sc.amax(dim=1, keepdim=True),
                                               sp_mesh, "seq"))
        pooled = (comm.all_reduce((q * e).sum(dim=1), sp_mesh, "seq")
                  / comm.all_reduce(e.sum(dim=1), sp_mesh, "seq"))
    elif cfg.pooling_type == "dct":
        w = dct_pool_weights(n * s, device=q.device)[
            sp_mesh.rank("seq") * n:][:n].to(q.dtype)
        pooled = comm.all_reduce((q * w[:, None, None]).sum(dim=1), sp_mesh,
                                 "seq")
    else:
        pooled = comm.all_reduce(q.sum(dim=1), sp_mesh, "seq") / (n * s)
    return layernorm_apply(pooled, heads.q_norm_w, heads.q_norm_b)


def _with_pos_phase(gate: torch.Tensor,
                    pos_phase: Optional[torch.Tensor]) -> torch.Tensor:
    """gate (B, H, G, F) times an absolute-position phase (B, F) or (F,)."""
    if pos_phase is None:
        return gate
    if pos_phase.dim() == 2:
        return gate * pos_phase[:, None, None, :]
    return gate * pos_phase


def _compact_gate(gate: torch.Tensor) -> torch.Tensor:
    """(B, H, G, F) -> (B, F, H * G): one column per (head, group), so
    channel ch = h * hd + j reads column ch // d_group."""
    b, h, g, f = gate.shape
    return gate.permute(0, 3, 1, 2).reshape(b, f, h * g)


def causal_chunk_gates(heads: SpectreHeads, cfg: SpectreHeadConfig,
                       q: torch.Tensor, n_chunks: int,
                       causal_chunk: int, sp_mesh=None) -> torch.Tensor:
    """Per-chunk gates from causal cumulative descriptors: the configured
    pooler over tokens up to and including each chunk's first position,
    zero-padded to the n_fft window, which is what decode's descriptor sees
    at that step (``sum_q / N`` for mean, the ``"window"`` pooler for DCT
    and attention), so causal_chunk=1 reproduces decode.  Every pooler is a
    chunk-cumulative prefix sum:

    - mean: the prefix sum of q, divided by n_fft;
    - dct: the prefix sum of q weighted by ``dct_pool_weights`` (the DCT
      pooler is linear);
    - attention: the softmax over the padded window is the prefix sum of
      exp(score) q over the prefix sum of exp(score) plus (n_fft - tokens)
      exp(score(0)) for the zero slots.

    q: (B, N, H, hd) -> (B, nc, H, G, F_half) complex.

    Under ``sp_mesh`` q holds this rank's n_chunks whole chunks of the
    sequence: the prefix sums start from the earlier ranks' totals (an
    all-gather over ``seq``), positions are global, and the attention
    pooler's max is over all ranks."""
    with forward_span("spectre.gates"):
        b, n = q.shape[:2]
        pad_n = n_chunks * causal_chunk
        rank = 0 if sp_mesh is None else sp_mesh.rank("seq")
        pos0 = rank * pad_n                   # the first token's position

        def chunk_cum(x):
            """(B, n, ...) -> (B, nc, ...): the sum over tokens [0, c C]."""
            if pad_n > n:
                x = torch.cat(
                    [x, x.new_zeros((b, pad_n - n) + x.shape[2:])], dim=1)
            sums = x.reshape(b, n_chunks, causal_chunk,
                             *x.shape[2:]).sum(dim=2)
            excl = torch.cumsum(sums, dim=1) - sums
            if sp_mesh is not None:           # the earlier ranks' totals
                totals = comm.all_gather(sums.sum(dim=1, keepdim=True),
                                         sp_mesh, "seq", 1)
                excl = excl + totals[:, :rank].sum(dim=1, keepdim=True)
            return excl + x[:, ::causal_chunk]

        if cfg.pooling_type == "dct":
            wbar = dct_pool_weights(cfg.n_fft, device=q.device)[
                pos0:pos0 + n].to(q.dtype)
            descr = chunk_cum(q * wbar[:, None, None])
        elif cfg.pooling_type == "attention":
            s = _heads_linear(gelu_exact(_heads_linear(
                q, heads.pool_fc1_w, heads.pool_fc1_b)), heads.pool_fc2_w,
                heads.pool_fc2_b)                            # (B, n, H, 1)
            s0 = _heads_linear(gelu_exact(heads.pool_fc1_b.to(q.dtype)),
                               heads.pool_fc2_w, heads.pool_fc2_b)   # (H, 1)
            smax = s.amax(dim=1, keepdim=True)               # (B, 1, H, 1)
            if sp_mesh is not None:
                smax = comm.all_reduce_max(smax, sp_mesh, "seq")
            m = torch.maximum(smax, s0)
            es = torch.exp(s - m)
            starts = (torch.arange(n_chunks, device=q.device) * causal_chunk
                      + pos0)
            n_pad = (cfg.n_fft - (starts + 1)).to(q.dtype)
            denom = (chunk_cum(es)
                     + n_pad[None, :, None, None] * torch.exp(s0 - m))
            descr = chunk_cum(q * es) / denom
        else:
            descr = chunk_cum(q) / cfg.n_fft
        descr = layernorm_apply(descr, heads.q_norm_w, heads.q_norm_b)
        return spectre_gate(heads, cfg, descr)


def spectre_head_apply_causal(
    heads: SpectreHeads,
    cfg: SpectreHeadConfig,
    x: torch.Tensor,                      # (B, N, H, hd) tokens per head
    *,
    causal_chunk: int = 128,
    causal_impl: str = "fft2n",
    memory_fft: Optional[torch.Tensor] = None,   # (F_half, H, hd) complex
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
):
    """Causal spectral gating of every head: chunk c's kernel irfft(gate_c)
    is applied as a linear convolution over the past, through 2N-point FFTs
    (or the segmented algorithm when the chunks tile N).  Requires
    N <= n_fft.  With ``deterministic`` false and dropout_p > 0 the mixed
    values go through dropout drawn from ``generator`` (spectre.py:252-255).
    Returns (mixed (B, N, H, hd), q_pool (B, H, hd))."""
    b, n, h, hd = x.shape
    if n > cfg.n_fft:
        raise ValueError(f"sequence {n} exceeds n_fft {cfg.n_fft}")
    causal_chunk = min(causal_chunk, n)
    n_chunks = -(-n // causal_chunk)

    q = _heads_linear(x, heads.w_q)
    v = _heads_linear(x, heads.w_v)
    gate = causal_chunk_gates(heads, cfg, q, n_chunks, causal_chunk)

    if causal_impl == "segmented" and n % causal_chunk == 0:
        y = segmented_causal_mix(
            v.reshape(b, n, h * hd),
            gate.reshape(b, n_chunks, h * cfg.num_groups, cfg.f_half),
            cfg, causal_chunk).reshape(b, n, h, hd)
    else:
        BRANCH_CALLS["fft2n"] += 1
        n2 = 2 * cfg.n_fft
        k_time = fftops.irfft(gate, cfg.n_fft, dim=-1)      # (B,nc,H,G,N)
        gate2 = fftops.rfft(k_time, n2, dim=-1)             # (B,nc,H,G,F2)
        gate2 = gate2.transpose(-1, -2).repeat_interleave(
            cfg.d_group, dim=-1)                             # (B,nc,H,F2,hd)
        vf = fftops.rfft(v, n2, dim=1).permute(0, 2, 1, 3)  # (B,H,F2,hd)
        ys = [fftops.irfft(gate2[:, c] * vf, n2, dim=-2)[
                  :, :, c * causal_chunk:(c + 1) * causal_chunk]
              for c in range(n_chunks)]
        y = torch.cat(ys, dim=2)[:, :, :n].permute(0, 2, 1, 3)

    if memory_fft is not None:
        y = y + fftops.irfft(memory_fft, cfg.n_fft, dim=0)[:n]
    y = y.to(x.dtype)
    q_pool = layernorm_apply(q.sum(dim=1) / cfg.n_fft, heads.q_norm_w,
                             heads.q_norm_b)
    if not deterministic and cfg.dropout_p > 0.0:
        y = dropout(y, cfg.dropout_p, generator)
    return y, q_pool


def spectre_head_apply(
    heads: SpectreHeads,
    cfg: SpectreHeadConfig,
    x: torch.Tensor,                      # (B, N, H, hd) tokens per head
    *,
    pos_phase: Optional[torch.Tensor] = None,    # (B, F_half) or (F_half,)
    memory_fft: Optional[torch.Tensor] = None,   # (F_half, H, hd) complex
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    sp_mesh=None,
    sp_layout: str = "contiguous",
):
    """Full-sequence (non-causal) spectral gating of every head
    (spectre.py:479-557): y = irfft(gate * rfft(v) [+ memory], n_fft)[:N]
    through ``torch.fft`` (``unfused_mix``).  Requires N <= n_fft.  With
    ``deterministic`` false and dropout_p > 0 the output goes through
    dropout drawn from ``generator``.  Returns (mixed (B, N, H, hd), q_pool
    (B, H, hd)).

    With ``sp_mesh`` x is this rank's shard of the whole window (n_fft
    positions over the ``seq`` ranks), contiguous or, with
    ``sp_layout="strided"``, in the strided layout
    (``parallel.dist_fft.sp_stride_permute``), and the mix is the
    distributed four-step FFT (``sp_spectral_mix`` or
    ``sp_spectral_mix_strided``); the pooler's sums run over all ranks."""
    b, n, h, hd = x.shape
    if sp_mesh is None and n > cfg.n_fft:
        raise ValueError(f"sequence {n} exceeds n_fft {cfg.n_fft}")
    if sp_layout not in ("contiguous", "strided"):
        raise ValueError(f"sp_layout={sp_layout!r}: 'contiguous' or "
                         "'strided'")
    q = _heads_linear(x, heads.w_q)
    v = _heads_linear(x, heads.w_v)
    q_pool = _pool_descriptor(heads, cfg, q, sp_mesh, sp_layout)
    gate = _with_pos_phase(spectre_gate(heads, cfg, q_pool), pos_phase)
    mem = None if memory_fft is None else memory_fft.reshape(cfg.f_half,
                                                             h * hd)
    if sp_mesh is None:
        out = unfused_mix(v.reshape(b, n, h * hd), _compact_gate(gate), mem,
                          cfg.n_fft)[:, :n]
    else:
        mix = (sp_spectral_mix_strided if sp_layout == "strided"
               else sp_spectral_mix)
        gate_bc = _compact_gate(gate).repeat_interleave(cfg.d_group, dim=-1)
        out = mix(v.reshape(b, n, h * hd), gate_bc, mem, n_fft=cfg.n_fft,
                  mesh=sp_mesh)
    out = out.reshape(b, n, h, hd).to(x.dtype)
    if not deterministic and cfg.dropout_p > 0.0:
        out = dropout(out, cfg.dropout_p, generator)
    return out, q_pool


class WaveletRefinement(nn.Module):
    """The wavelet branch's gate MLP, Linear-SiLU-Linear-Sigmoid from the
    pooled descriptor (d -> d -> d)."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.fc1 = Linear(embed_dim, embed_dim)
        self.fc2 = Linear(embed_dim, embed_dim)


def wavelet_refinement_apply(
    wavelet: WaveletRefinement,
    v: torch.Tensor,                      # (B, N, d) mixed tokens
    q_pool: torch.Tensor,                 # (B, d) pooled descriptor
    on_rate: float,
    *,
    generator: Optional[torch.Generator] = None,
    training: bool = False,
    reference_compat: bool = False,
    sp_mesh=None,
    tp_mesh=None,
) -> torch.Tensor:
    """Gated straight-through wavelet residual (spectre.py:819-887):
    v + stop_grad(haar_reconstruct(haar_decompose(v))) * gate * mask.  The
    gate MLP trains; the wavelet path is detached.  The mask is per batch
    row: always on for on_rate >= 1; else, in training, drawn with
    probability on_rate from ``generator``, and off outside training.

    Under ``tp_mesh`` v and q_pool hold this rank's heads' channels: the
    gate is computed from the gathered descriptor and sliced (the pyramid
    runs per channel).  Under ``sp_mesh`` v is this rank's contiguous shard
    of the sequence: the detached pyramid runs on the gathered sequence."""
    if on_rate <= 0.0 or (on_rate < 1.0 and not training):
        return v
    dl = v.shape[-1]
    if tp_mesh is not None:
        q_pool = comm.gather_from(q_pool, tp_mesh, "model", -1)
    gate = torch.sigmoid(wavelet.fc2(F.silu(wavelet.fc1(q_pool))))[:, None]
    if tp_mesh is not None:
        r = tp_mesh.rank("model")
        gate = comm.copy_to(gate, tp_mesh, "model")[..., r * dl:(r + 1) * dl]
    with torch.no_grad():
        vd = v.detach()
        if sp_mesh is not None:
            vd = comm.gather_tensor(vd, sp_mesh, "seq", -2)
        coeffs, lengths = haar_decompose(vd.transpose(-1, -2),
                                         reference_compat=reference_compat)
        v_ref = haar_reconstruct(coeffs, lengths).transpose(-1, -2)
        if sp_mesh is not None:
            n = v.shape[-2]
            v_ref = v_ref[..., sp_mesh.rank("seq") * n:, :][..., :n, :]
    if on_rate >= 1.0:
        return v + v_ref * gate
    if generator is None:
        raise ValueError("the wavelet branch in training mode draws its "
                         "on-mask from an explicit torch.Generator: pass "
                         "generator=")
    mask = torch.rand((v.shape[0], 1, 1), generator=generator,
                      device=v.device) < on_rate
    return v + v_ref * gate * mask.to(v.dtype)


def _local_heads(x: torch.Tensor, heads: SpectreHeads, num_heads: int,
                 tp_mesh) -> torch.Tensor:
    """x (B, N, d) -> (B, N, H_l, hd): every head, or under ``tp_mesh``
    this rank's run of H_l = H / model heads (the parameters ``heads``
    holds), x entering through ``comm.copy_to``."""
    b, n, d = x.shape
    xh = x.reshape(b, n, num_heads, d // num_heads)
    if tp_mesh is None:
        return xh
    hl = heads.w_q.shape[0]
    r = tp_mesh.rank("model")
    xh = comm.copy_to(x, tp_mesh, "model").reshape(xh.shape)
    return xh[:, :, r * hl:(r + 1) * hl]


def _local_channels(t: Optional[torch.Tensor], dl: int,
                    tp_mesh) -> Optional[torch.Tensor]:
    """This rank's channels (..., dl) of a (..., d) tensor under
    ``tp_mesh``."""
    if t is None or tp_mesh is None:
        return t
    r = tp_mesh.rank("model")
    return t[..., r * dl:(r + 1) * dl]


def _out_proj(linear: nn.Module, y: torch.Tensor, tp_mesh) -> torch.Tensor:
    """The output projection; under ``tp_mesh`` its weight holds this
    rank's input channels and the partial products are summed over
    ``model`` (``comm.reduce_from``)."""
    y = linear(y)
    return y if tp_mesh is None else comm.reduce_from(y, tp_mesh, "model")


# "fused" | "wide" | "per_head" | "sp": the branch each non-causal
# multihead call took (_mix_branch; "sp" under sp_mesh)
MIX_BRANCH_CALLS = collections.Counter()


def _reference_plan_exists(n: int) -> bool:
    """The reference's ``matfft.plan_factors(n) is not None``
    (matfft.py:51-108): n even, n >= 4, and n / 2 has no prime factor
    left above 128 once 2, 3, 5, 7, 11 and 13 are divided out."""
    if n < 4 or n % 2:
        return False
    m = n // 2
    for p in (2, 3, 5, 7, 11, 13):
        while m % p == 0:
            m //= p
    return m <= 128


def _mix_branch(cfg: SpectreConfig) -> str:
    """The reference's dispatch of the non-causal multihead
    (fft_tpu/layers/spectre.py:433-449): with ``fft_impl="pallas"`` and d a
    multiple of 128, the spectral-mix kernels where they take n_fft
    ("fused": ``spectral_mix.mix_kernel`` picks #1/#2 up to 2048, #3 at
    2304-8192, #4 at 16384-65536 with ``TWOPASS_ENABLE`` on), else the d-wide composition at
    n_fft >= 16384 ("wide": cuFFT on the card); the per-head branch
    otherwise."""
    d = cfg.embed_dim
    if cfg.fft_impl != "pallas" or d % 128:
        return "per_head"
    if spectral_mix_kernels.mix_kernel(cfg.n_fft) is not None:
        return "fused"
    if cfg.n_fft >= 16384 and _reference_plan_exists(cfg.n_fft):
        return "wide"
    return "per_head"


class SpectreMultiHead(nn.Module):
    """Multi-head SPECTRE mixer, causal or not (``cfg.causal``)."""

    def __init__(self, cfg: SpectreConfig):
        super().__init__()
        if cfg.causal and cfg.wavelet_on_rate != 0.0:
            raise ValueError("the wavelet branch is non-causal; set "
                             "wavelet_on_rate=0 for causal models")
        self.cfg = cfg
        self.heads = SpectreHeads(cfg.head_config(), cfg.num_heads)
        self.out_proj = Linear(cfg.embed_dim, cfg.embed_dim, bias=False)
        self.wavelet = WaveletRefinement(cfg.embed_dim)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        d = self.cfg.embed_dim
        self.heads.reset_parameters(generator)
        self.out_proj.weight.copy_(linear_init(d, d, generator, False)[0])
        for fc in (self.wavelet.fc1, self.wavelet.fc2):
            w, b = linear_init(d, d, generator)
            fc.weight.copy_(w)
            fc.bias.copy_(b)

    def forward(self, x: torch.Tensor,
                memory_fft: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                pos_phase: Optional[torch.Tensor] = None, sp_mesh=None,
                sp_layout: str = "contiguous", tp_mesh=None) -> torch.Tensor:
        """x (B, N, d); memory_fft (F_half, d) complex or None; pos_phase
        (B, F_half) or (F_half,) complex, non-causal only.  In train mode,
        dropout masks and the wavelet's on-mask come from ``generator``.

        ``sp_mesh``: x is this rank's shard of the sequence (``seq``
        axis); the non-causal mix runs the distributed four-step FFT in
        ``sp_layout`` (the fused branch is off, as in the JAX package), the
        causal one ``sp_segmented_causal_mix``.  ``tp_mesh``: this module
        holds its rank's heads (``parallel.mesh.shard_model``), which run
        on their channels of x, and ``out_proj``'s partial products are
        summed over ``model``."""
        if self.cfg.causal:
            if pos_phase is not None:
                raise ValueError("pos_phase is for the non-causal mix")
            return self._forward_causal(x, memory_fft, generator, sp_mesh,
                                        tp_mesh)
        return self._forward_noncausal(x, memory_fft, generator, pos_phase,
                                       sp_mesh, sp_layout, tp_mesh)

    def _forward_noncausal(self, x, memory_fft, generator, pos_phase,
                           sp_mesh, sp_layout, tp_mesh):
        cfg = self.cfg
        hcfg = self.heads.cfg
        b, n, d = x.shape
        if sp_mesh is None and n > cfg.n_fft:
            raise ValueError(f"sequence {n} exceeds n_fft {cfg.n_fft}")
        if (sp_mesh is not None and sp_layout == "strided"
                and cfg.wavelet_on_rate != 0.0):
            # not a bare assert: survives python -O.  The strided layout
            # hands each shard one residue class of the sequence, while the
            # Haar pyramid pairs adjacent natural positions
            raise ValueError(
                "wavelet refinement is order-sensitive and unsupported "
                "under sp_layout='strided'; use the contiguous SP layout "
                "or set wavelet_on_rate=0")
        xh = _local_heads(x, self.heads, cfg.num_heads, tp_mesh)
        hl, hd = xh.shape[2], xh.shape[3]
        dl = hl * hd
        memory_fft = _local_channels(memory_fft, dl, tp_mesh)
        branch = "sp" if sp_mesh is not None else _mix_branch(cfg)
        MIX_BRANCH_CALLS[branch] += 1
        if branch in ("fused", "wide"):
            # all heads' mixes are channel-pointwise: ONE d-wide mix with the
            # compact (B, F, H*G) gate
            q = _heads_linear(xh, self.heads.w_q)
            v = _heads_linear(xh, self.heads.w_v)
            q_pool = _pool_descriptor(self.heads, hcfg, q)
            gate = _compact_gate(_with_pos_phase(
                spectre_gate(self.heads, hcfg, q_pool), pos_phase))
            v_all = F.pad(v.reshape(b, n, dl), (0, 0, 0, cfg.n_fft - n))
            if branch == "fused":
                # the memory enters additively: its irfft is a constant that
                # the kernel (#1, #3 or #4 by n_fft) adds on its store
                mem_t = (None if memory_fft is None else fftops.irfft(
                    memory_fft, cfg.n_fft, dim=0).contiguous())
                mixed = spectral_mix(v_all, gate.real.contiguous(),
                                     gate.imag.contiguous(), mem_t,
                                     cfg.n_fft)[:, :n]
            else:
                mixed = unfused_mix(v_all, gate, memory_fft,
                                    cfg.n_fft)[:, :n]
            mixed = mixed.to(x.dtype)
            if self.training and cfg.dropout_p > 0.0:
                mixed = dropout(mixed, cfg.dropout_p, generator)
        else:
            mem_h = (None if memory_fft is None
                     else memory_fft.reshape(cfg.f_half, hl, hd))
            mixed, q_pool = spectre_head_apply(
                self.heads, hcfg, xh, pos_phase=pos_phase, memory_fft=mem_h,
                generator=generator, deterministic=not self.training,
                sp_mesh=sp_mesh, sp_layout=sp_layout)
            mixed = mixed.reshape(b, n, dl)
        refined = wavelet_refinement_apply(
            self.wavelet, mixed, q_pool.reshape(b, dl), cfg.wavelet_on_rate,
            generator=generator, training=self.training,
            reference_compat=cfg.wavelet_reference_compat, sp_mesh=sp_mesh,
            tp_mesh=tp_mesh)
        return _out_proj(self.out_proj, refined, tp_mesh)

    def _forward_causal(self, x, memory_fft, generator, sp_mesh, tp_mesh):
        cfg = self.cfg
        hcfg = self.heads.cfg
        b, n, d = x.shape
        xh = _local_heads(x, self.heads, cfg.num_heads, tp_mesh)
        hl, hd = xh.shape[2], xh.shape[3]
        dl = hl * hd
        memory_fft = _local_channels(memory_fft, dl, tp_mesh)
        chunk = min(cfg.causal_chunk, n)
        if sp_mesh is not None and (cfg.causal_impl != "segmented"
                                    or n % cfg.causal_chunk):
            raise ValueError(
                "causal sequence parallelism runs the segmented algorithm "
                "on whole chunks: causal_impl='segmented' and a shard-local "
                f"length ({n}) that is a multiple of causal_chunk "
                f"({cfg.causal_chunk})")
        if cfg.causal_impl == "segmented" and n % chunk == 0:
            # all heads as ONE d-wide segmented convolution; gate columns
            # h-major then group, so channel ch // d_g == h*G + g
            nc = n // chunk
            q = _heads_linear(xh, self.heads.w_q)
            v = _heads_linear(xh, self.heads.w_v).reshape(b, n, dl)
            gate = causal_chunk_gates(self.heads, hcfg, q, nc, chunk,
                                      sp_mesh).reshape(
                b, nc, hl * cfg.num_groups, cfg.f_half)
            if sp_mesh is None:
                mixed = segmented_causal_mix(v, gate, hcfg, chunk)
            else:
                mixed = sp_segmented_causal_mix(v, gate, hcfg, chunk, sp_mesh)
            if memory_fft is not None:
                pos0 = 0 if sp_mesh is None else sp_mesh.rank("seq") * n
                mixed = mixed + fftops.irfft(memory_fft, cfg.n_fft, dim=0)[
                    pos0:pos0 + n].to(mixed.dtype)
            if self.training and cfg.dropout_p > 0.0:
                mixed = dropout(mixed, cfg.dropout_p, generator)
            return _out_proj(self.out_proj, mixed, tp_mesh)
        mem_h = (None if memory_fft is None
                 else memory_fft.reshape(cfg.f_half, hl, hd))
        mixed, _ = spectre_head_apply_causal(
            self.heads, hcfg, xh, causal_chunk=cfg.causal_chunk,
            causal_impl=cfg.causal_impl, memory_fft=mem_h,
            generator=generator, deterministic=not self.training)
        return _out_proj(self.out_proj, mixed.reshape(b, n, dl), tp_mesh)


def spectre_multihead_init(cfg: SpectreConfig, generator: torch.Generator,
                           device=None) -> SpectreMultiHead:
    """A mixer with the JAX package's init distributions, drawn on the CPU
    from ``generator``, on ``device`` (the card unless ``"cpu"``), in eval
    mode (the JAX default ``deterministic=True``)."""
    device = resolve_device(device)
    mix = SpectreMultiHead(cfg)
    mix.reset_parameters(generator)
    return mix.to(device).eval()


def spectre_multihead_apply(mix: SpectreMultiHead, x: torch.Tensor, *,
                            memory_fft: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None,
                            pos_phase: Optional[torch.Tensor] = None,
                            sp_mesh=None, sp_layout: str = "contiguous",
                            tp_mesh=None):
    return mix(x, memory_fft=memory_fft, generator=generator,
               pos_phase=pos_phase, sp_mesh=sp_mesh, sp_layout=sp_layout,
               tp_mesh=tp_mesh)


class MLP(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(d, hidden)
        self.fc2 = Linear(hidden, d)

    def forward(self, x: torch.Tensor, tp_mesh=None) -> torch.Tensor:
        """Under ``tp_mesh`` fc1 holds this rank's rows of the hidden layer
        and fc2 its columns (Megatron's MLP), and the partial products of
        fc2 are summed over ``model``.  The biases stay replicated, as in
        the JAX package's rule: fc1's enters as this rank's slice and fc2's
        in rank 0's product alone (the others' times 0), so at one rank the
        arithmetic is the plain layer's to the bit.  Each rank then holds
        a share of their gradients, which ``parallel.mesh.sync_grads``
        sums over ``model`` with the other gradient sums."""
        if tp_mesh is None:
            return self.fc2(gelu_exact(self.fc1(x)))
        hl = self.fc1.weight.shape[0]
        r = tp_mesh.rank("model")
        x = comm.copy_to(x, tp_mesh, "model")
        h = gelu_exact(F.linear(x, self.fc1.weight.to(x.dtype),
                                self.fc1.bias[r * hl:(r + 1) * hl].to(
                                    x.dtype)))
        b2 = self.fc2.bias * float(r == 0)
        return comm.reduce_from(F.linear(h, self.fc2.weight.to(h.dtype),
                                         b2.to(h.dtype)), tp_mesh, "model")


class SpectreBlock(nn.Module):
    """Pre-LN residual block: x + mix(LN(x), memory); x + MLP(LN(x)), in
    ``cfg.compute_dtype`` (the parameters stay fp32).

    ``memory_fft`` is the frozen spectral memory, a buffer holding the real
    (2, bins, d) [re; im] pair of the JAX layout (absent when bins == 0)."""

    def __init__(self, cfg: SpectreConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.ln1 = LayerNorm(d, eps=1e-5)
        self.mix = SpectreMultiHead(cfg)
        self.ln2 = LayerNorm(d, eps=1e-5)
        self.mlp = MLP(d, cfg.mlp_ratio * d)
        bins = cfg.memory_freq_bins
        self.register_buffer(
            "memory_fft", torch.empty(2, bins, d) if bins > 0 else None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        d, hidden = self.cfg.embed_dim, self.cfg.mlp_ratio * self.cfg.embed_dim
        for ln in (self.ln1, self.ln2):
            ln.reset_parameters()
        self.mix.reset_parameters(generator)
        for fc, fan_in, fan_out in ((self.mlp.fc1, d, hidden),
                                    (self.mlp.fc2, hidden, d)):
            w, b = linear_init(fan_in, fan_out, generator)
            fc.weight.copy_(w)
            fc.bias.copy_(b)
        if self.memory_fft is not None:
            # complex randn / sqrt(d): real and imag each N(0, 1/(2d))
            self.memory_fft.copy_(
                torch.randn(self.memory_fft.shape, generator=generator)
                / math.sqrt(2.0 * d))

    def memory_complex(self) -> Optional[torch.Tensor]:
        """(F_half, d) complex spectral memory, zero-padded past its bins."""
        if self.memory_fft is None:
            return None
        mem = torch.complex(self.memory_fft[0], self.memory_fft[1])
        pad = self.cfg.f_half - mem.shape[0]
        if pad > 0:
            mem = torch.cat([mem, mem.new_zeros((pad, mem.shape[1]))])
        return mem

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None, sp_mesh=None,
                sp_layout: str = "contiguous", tp_mesh=None) -> torch.Tensor:
        """``sp_mesh``/``sp_layout``/``tp_mesh``: see
        ``SpectreMultiHead.forward``; the MLP runs Megatron's layout under
        ``tp_mesh``."""
        with forward_span("spectre.block"):
            x = x.to(DTYPES[self.cfg.compute_dtype])
            x = x + self.mix(self.ln1(x), memory_fft=self.memory_complex(),
                             generator=generator, sp_mesh=sp_mesh,
                             sp_layout=sp_layout, tp_mesh=tp_mesh)
            return x + self.mlp(self.ln2(x), tp_mesh=tp_mesh)


def spectre_block_init(cfg: SpectreConfig, generator: torch.Generator,
                       device=None) -> SpectreBlock:
    """A block with the JAX package's init distributions, drawn on the CPU
    from ``generator`` (one seed gives one block on every device), on
    ``device`` (the card unless ``"cpu"``), in eval mode (the JAX default
    ``deterministic=True``; ``.train()`` turns on dropout and the wavelet
    draw)."""
    device = resolve_device(device)
    block = SpectreBlock(cfg)
    block.reset_parameters(generator)
    return block.to(device).eval()


def spectre_block_apply(block: SpectreBlock, x: torch.Tensor, *,
                        generator: Optional[torch.Generator] = None,
                        sp_mesh=None, sp_layout: str = "contiguous",
                        tp_mesh=None) -> torch.Tensor:
    return block(x, generator=generator, sp_mesh=sp_mesh,
                 sp_layout=sp_layout, tp_mesh=tp_mesh)
