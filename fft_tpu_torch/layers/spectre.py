"""SPECTRE layers for causal models (mirror of ``fft_tpu/layers/spectre.py``).

Heads are stacked on a leading axis of their parameters (the JAX package
``vmap``s them) and run together as batched einsums.  Only what the causal
block needs is ported: the gate, the chunk-causal gates with the mean
pooler, the causal head with its 2N-FFT branch, the segmented multihead
branch and the block with its additive spectral memory.  Dropout on the
mixed values is on under ``module.train()`` and draws its mask from an
explicit ``torch.Generator``.  The wavelet branch, the non-causal mix, the
DCT/attention poolers and Toeplitz gates are queued in ROADMAP.md and raise
``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from fft_tpu_torch.config import SpectreConfig, SpectreHeadConfig
from fft_tpu_torch.layers.causal_seg import BRANCH_CALLS, segmented_causal_mix
from fft_tpu_torch.layers.common import (
    gelu_exact, layernorm_apply, linear_init,
)
from fft_tpu_torch.ops import fftops, interp_complex_1d, modrelu


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to fft_tpu_torch yet (see ROADMAP.md, "
        "'Modules to port')")


def _check_head_config(cfg: SpectreHeadConfig) -> None:
    if cfg.pooling_type != "mean":
        raise _not_ported(f"pooling_type={cfg.pooling_type!r}")
    if cfg.use_toeplitz:
        raise _not_ported("the Toeplitz gate")
    if cfg.interp_reference_compat:
        raise _not_ported("interp_reference_compat")
    if cfg.compute_dtype != "float32":
        raise _not_ported(f"compute_dtype={cfg.compute_dtype!r}")
    if cfg.fft_impl not in ("auto", "pallas"):
        # "jnp"/"matmul" pick among the JAX package's transforms; the port
        # has one path per shape (torch.fft and its kernels)
        raise _not_ported(f"fft_impl={cfg.fft_impl!r}")


class SpectreHeads(nn.Module):
    """The per-head parameters of one multihead mixer, stacked over heads.

    Linear weights are (H, fan_out, fan_in); ``modrelu_bias`` is (H, G,
    F_half)."""

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
    """Per-head linear: x (..., H, i), w (H, o, i) -> (..., H, o)."""
    y = torch.einsum("...hi,hoi->...ho", x, w)
    return y if b is None else y + b


def spectre_gate(heads: SpectreHeads, cfg: SpectreHeadConfig,
                 descriptor: torch.Tensor) -> torch.Tensor:
    """Content-adaptive complex gate from a pooled descriptor (..., H, hd)
    -> (..., H, G, F_half) complex64."""
    h = gelu_exact(_heads_linear(descriptor, heads.gate_fc1_w,
                                 heads.gate_fc1_b))
    raw = _heads_linear(h, heads.gate_fc2_w, heads.gate_fc2_b).float()
    raw = raw.reshape(*raw.shape[:-1], cfg.num_groups, cfg.buckets, 2)
    anchor = torch.complex(raw[..., 0], raw[..., 1])        # (..., H, G, Bk)
    gate = interp_complex_1d(anchor, cfg.f_half)
    return modrelu(gate, heads.modrelu_bias)


def causal_chunk_gates(heads: SpectreHeads, cfg: SpectreHeadConfig,
                       q: torch.Tensor, n_chunks: int,
                       causal_chunk: int) -> torch.Tensor:
    """Per-chunk gates from causal cumulative descriptors: the mean pooler
    over tokens up to and including each chunk's first position, divided by
    n_fft as decode does (so causal_chunk=1 reproduces decode).

    q: (B, N, H, hd) -> (B, nc, H, G, F_half) complex."""
    b, n = q.shape[:2]
    pad_n = n_chunks * causal_chunk
    if pad_n > n:
        q = torch.cat([q, q.new_zeros((b, pad_n - n) + q.shape[2:])], dim=1)
    sums = q.reshape(b, n_chunks, causal_chunk, *q.shape[2:]).sum(dim=2)
    excl = torch.cumsum(sums, dim=1) - sums
    descr = (excl + q[:, ::causal_chunk]) / cfg.n_fft
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
    q_pool = layernorm_apply(q.sum(dim=1) / cfg.n_fft, heads.q_norm_w,
                             heads.q_norm_b)
    if not deterministic and cfg.dropout_p > 0.0:
        y = dropout(y, cfg.dropout_p, generator)
    return y, q_pool


class WaveletRefinement(nn.Module):
    """The wavelet branch's gate MLP.  Its weights are carried so that a
    JAX checkpoint round-trips; causal models run with wavelet_on_rate=0 and
    never apply it."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(embed_dim, embed_dim)
        self.fc2 = nn.Linear(embed_dim, embed_dim)


class SpectreMultiHead(nn.Module):
    """Multi-head causal SPECTRE mixer."""

    def __init__(self, cfg: SpectreConfig):
        super().__init__()
        if not cfg.causal:
            raise _not_ported("the non-causal mix")
        if cfg.wavelet_on_rate != 0.0:
            raise ValueError("the wavelet branch is non-causal; set "
                             "wavelet_on_rate=0 for causal models")
        self.cfg = cfg
        self.heads = SpectreHeads(cfg.head_config(), cfg.num_heads)
        self.out_proj = nn.Linear(cfg.embed_dim, cfg.embed_dim, bias=False)
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
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, N, d); memory_fft (F_half, d) complex or None.  In train
        mode with dropout_p > 0, dropout masks come from ``generator``."""
        cfg = self.cfg
        hcfg = self.heads.cfg
        b, n, d = x.shape
        h, hd = cfg.num_heads, cfg.head_dim
        xh = x.reshape(b, n, h, hd)
        chunk = min(cfg.causal_chunk, n)
        if cfg.causal_impl == "segmented" and n % chunk == 0:
            # all heads as ONE d-wide segmented convolution; gate columns
            # h-major then group, so channel ch // d_g == h*G + g
            nc = n // chunk
            q = _heads_linear(xh, self.heads.w_q)
            v = _heads_linear(xh, self.heads.w_v)
            gate = causal_chunk_gates(self.heads, hcfg, q, nc, chunk)
            mixed = segmented_causal_mix(
                v.reshape(b, n, d),
                gate.reshape(b, nc, h * cfg.num_groups, cfg.f_half),
                hcfg, chunk)
            if memory_fft is not None:
                mixed = mixed + fftops.irfft(memory_fft, cfg.n_fft,
                                             dim=0)[:n]
            if self.training and cfg.dropout_p > 0.0:
                mixed = dropout(mixed, cfg.dropout_p, generator)
            return self.out_proj(mixed)
        mem_h = (None if memory_fft is None
                 else memory_fft.reshape(cfg.f_half, h, hd))
        mixed, _ = spectre_head_apply_causal(
            self.heads, hcfg, xh, causal_chunk=cfg.causal_chunk,
            causal_impl=cfg.causal_impl, memory_fft=mem_h,
            generator=generator, deterministic=not self.training)
        return self.out_proj(mixed.reshape(b, n, d))


def spectre_multihead_init(cfg: SpectreConfig,
                           generator: torch.Generator) -> SpectreMultiHead:
    mix = SpectreMultiHead(cfg)
    mix.reset_parameters(generator)
    return mix


def spectre_multihead_apply(mix: SpectreMultiHead, x: torch.Tensor, *,
                            memory_fft: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None):
    return mix(x, memory_fft=memory_fft, generator=generator)


class MLP(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu_exact(self.fc1(x)))


class SpectreBlock(nn.Module):
    """Pre-LN residual block: x + mix(LN(x), memory); x + MLP(LN(x)).

    ``memory_fft`` is the frozen spectral memory, a buffer holding the real
    (2, bins, d) [re; im] pair of the JAX layout (absent when bins == 0)."""

    def __init__(self, cfg: SpectreConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.ln1 = nn.LayerNorm(d, eps=1e-5)
        self.mix = SpectreMultiHead(cfg)
        self.ln2 = nn.LayerNorm(d, eps=1e-5)
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
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.mix(self.ln1(x), memory_fft=self.memory_complex(),
                         generator=generator)
        return x + self.mlp(self.ln2(x))


def spectre_block_init(cfg: SpectreConfig,
                       generator: torch.Generator) -> SpectreBlock:
    block = SpectreBlock(cfg)
    block.reset_parameters(generator)
    return block


def spectre_block_apply(block: SpectreBlock, x: torch.Tensor, *,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    return block(x, generator=generator)
