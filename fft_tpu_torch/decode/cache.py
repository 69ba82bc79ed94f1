"""Sliding-window prefix-FFT decode cache (mirror of
``fft_tpu/decode/cache.py``).

State is batched and multi-head, (B, H, ...), with the window's rFFT kept
as one complex64 tensor.  ``cache_decode_step`` updates the cache IN PLACE
(the ring buffers are (B, H, N, hd) each; copying them per token would
double the step's memory traffic) and returns it.  The position ``t`` is a
host integer, so a step needs no device round trip to find its slot.

Per step: evict the phasor of the overwritten token, add the new token's
phasor, write the ring buffers, keep the windowed query sum, then gate the
window spectrum and evaluate one output position of its irFFT in O(F*d).
With ``fft_tpu_torch.kernels.decode.ENABLE`` set, the phasor update, the
gated mix and the irFFT are one call of kernel #12 (``fused_decode_mix``).
All three gate descriptors of the JAX package are here (``reference``,
``consistent``, ``window``), and ``reference_compat`` reproduces the
original's Nyquist sign, frozen query sum and gated memory for the goldens.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from fft_tpu_torch.config import SpectreConfig
from fft_tpu_torch.kernels import decode as kd
from fft_tpu_torch.layers.common import layernorm_apply
from fft_tpu_torch.layers.spectre import (
    SpectreBlock, SpectreHeads, SpectreMultiHead, _heads_linear,
    spectre_gate,
)
from fft_tpu_torch.ops import (
    attention_pool, dct_pool_weights, fftops, pruned_irfft_single,
    rfft_phasor,
)
from fft_tpu_torch.utils.prof import span


@dataclasses.dataclass
class PrefixFFTCache:
    """Decode state for one SPECTRE layer (all heads, full batch)."""

    prefix: torch.Tensor     # (B, H, F_half, hd) complex64 window rFFT
    v_buf: torch.Tensor      # (B, H, N, hd) ring buffer of values
    q_buf: torch.Tensor      # (B, H, N, hd) ring buffer of queries
    sum_q: torch.Tensor      # (B, H, hd) windowed query sum
    t: int                   # last filled position (-1 = empty)

    @property
    def n_fft(self) -> int:
        return self.v_buf.shape[-2]


def cache_init(batch: int, num_heads: int, n_fft: int, head_dim: int,
               device=None) -> PrefixFFTCache:
    f_half = n_fft // 2 + 1
    shape = (batch, num_heads, n_fft, head_dim)
    return PrefixFFTCache(
        prefix=torch.zeros((batch, num_heads, f_half, head_dim),
                           dtype=torch.complex64, device=device),
        v_buf=torch.zeros(shape, device=device),
        q_buf=torch.zeros(shape, device=device),
        sum_q=torch.zeros((batch, num_heads, head_dim), device=device),
        t=-1,
    )


def cache_prefill(cache: PrefixFFTCache, q: torch.Tensor,
                  v: torch.Tensor) -> PrefixFFTCache:
    """Ingest a prompt: q, v are (B, H, L, hd) with L <= n_fft."""
    n = cache.n_fft
    length = q.shape[-2]
    if length > n:
        raise ValueError(f"prompt {length} exceeds the window {n}")
    # zero-pads to n; contiguous, as the decode kernel takes it (the card's
    # rfft along a non-last dim need not return it so)
    cache.prefix = fftops.rfft(v, n, dim=-2).contiguous()
    cache.v_buf[..., :length, :] = v
    cache.q_buf[..., :length, :] = q
    cache.sum_q = q.sum(dim=-2)
    cache.t = length - 1
    return cache


def _step_slot(cache: PrefixFFTCache) -> Tuple[int, int, int]:
    """(t, ring slot j, evict) of the token the next step appends."""
    t = cache.t + 1
    return t, t % cache.n_fft, int(t >= cache.n_fft)


def _append_query(cache: PrefixFFTCache, q_t: torch.Tensor, t: int, j: int,
                  evict: int, reference_compat: bool) -> None:
    """The windowed query sum and the query ring buffer for token t.

    ``reference_compat``: the original reads q_old as a view of the buffer
    and overwrites the buffer before using it, so once the window wraps its
    ``sum_q += q_t - q_old`` adds nothing and the descriptor stays at the
    prefill's sum."""
    if reference_compat:
        cache.sum_q = cache.sum_q + (1.0 - evict) * q_t
    else:
        cache.sum_q = cache.sum_q + q_t - evict * cache.q_buf[..., j, :]
    cache.q_buf[..., j, :] = q_t
    cache.t = t


def cache_decode_step(cache: PrefixFFTCache, q_t: torch.Tensor,
                      v_t: torch.Tensor,
                      reference_compat: bool = False) -> PrefixFFTCache:
    """Append one token (q_t, v_t: (B, H, hd)): rank-1 frequency update with
    eviction once the window wraps.  Updates ``cache`` in place.
    ``reference_compat`` freezes the query sum once the window wraps, as
    the original does (``_append_query``)."""
    n = cache.n_fft
    t, j, evict = _step_slot(cache)
    # insert phase exp(-2 pi i k t / n) == exp(-2 pi i k j / n), t = j mod n
    ph = rfft_phasor(n, j, device=v_t.device)[:, None]    # (F_half, 1)
    delta = v_t - evict * cache.v_buf[..., j, :]          # (B, H, hd)
    cache.prefix.add_(ph * delta[..., None, :])
    cache.v_buf[..., j, :] = v_t
    _append_query(cache, q_t, t, j, evict, reference_compat)
    return cache


def _decode_descriptor(heads: SpectreHeads,
                       cache: PrefixFFTCache) -> torch.Tensor:
    """Streaming gate descriptor -> (B, H, hd).

    - ``reference``: sum_q / N even while the window holds fewer than N
      tokens (the original's).
    - ``consistent``: sum_q over the true token count.
    - ``window``: the head's configured pooler over the ring buffer in
      chronological order, zeros in the slots not yet filled; equal to the
      forward once the window is full, and to the causal chunk gates
      (``causal_chunk_gates``) at every step.  Mean and attention pooling
      do not depend on the order of the slots, so they pool the buffer as
      it lies; the DCT pooler is a weighted sum, so its per-position
      weights are rolled to the buffer's slots instead of rolling the
      (B, H, N, hd) buffer (the same sum, in O(N) extra work)."""
    cfg = heads.cfg
    n = cache.n_fft
    if cfg.decode_descriptor == "window":
        q = cache.q_buf                                    # (B, H, N, hd)
        if cfg.pooling_type == "dct":
            oldest = 0 if cache.t < n else (cache.t + 1) % n
            w = torch.roll(dct_pool_weights(n, device=q.device), oldest)
            pooled = torch.einsum("bhnd,n->bhd", q, w)
        elif cfg.pooling_type == "attention":
            pooled = attention_pool(q, heads.pool_fc1_w, heads.pool_fc1_b,
                                    heads.pool_fc2_w, heads.pool_fc2_b)
        else:
            pooled = q.mean(dim=-2)
        return layernorm_apply(pooled, heads.q_norm_w, heads.q_norm_b)
    if cfg.decode_descriptor == "consistent":
        count = min(cache.t + 1, n)
    else:
        count = n
    return layernorm_apply(cache.sum_q / count, heads.q_norm_w,
                           heads.q_norm_b)


def spectre_multihead_decode_step(
    mix: SpectreMultiHead,
    x_t: torch.Tensor,                    # (B, d) current token (post-LN)
    cache: PrefixFFTCache,
    *,
    memory_fft: Optional[torch.Tensor] = None,   # (F_half, d) complex
    reference_compat: bool = False,
) -> Tuple[torch.Tensor, PrefixFFTCache]:
    """One decode step for all heads: project, update the cache, gate, mix
    in frequency, pruned single-position irFFT, concat, out_proj.

    With ``kernels.decode.ENABLE`` (and not ``reference_compat``, and
    ``fft_impl`` "auto" or "pallas", as the reference's
    decode/cache.py:214-216) the update, mix and irFFT are one call of
    ``fused_decode_mix``, which updates the prefix in place and reads the
    evicted row of ``v_buf`` before this step writes the new one.  ``reference_compat`` takes the
    plain branch and reproduces the original's Nyquist sign and frozen
    query sum.

    The spectral memory enters ungated, as in the forward: the newest token
    sits at window slot min(t, N-1), so it adds irfft(memory)[min(t, N-1)]."""
    cfg: SpectreConfig = mix.cfg
    b, d = x_t.shape
    h, hd = cfg.num_heads, cfg.head_dim
    hcfg = mix.heads.cfg
    n = cache.n_fft

    xh = x_t.reshape(b, h, hd)
    q_t = _heads_linear(xh, mix.heads.w_q)
    v_t = _heads_linear(xh, mix.heads.w_v)
    if (kd.ENABLE and not reference_compat
            and cfg.fft_impl in fftops.KERNEL_IMPLS):
        t, j, evict = _step_slot(cache)
        _append_query(cache, q_t, t, j, evict, False)
        gate = spectre_gate(mix.heads, hcfg,
                            _decode_descriptor(mix.heads, cache))
        y = kd.fused_decode_mix(cache.prefix, gate.contiguous(),
                                v_t.contiguous(), cache.v_buf, evict, j,
                                t % n).reshape(b, d)
        cache.v_buf[..., j, :] = v_t
    else:
        cache = cache_decode_step(cache, q_t, v_t,
                                  reference_compat=reference_compat)
        gate = spectre_gate(mix.heads, hcfg,
                            _decode_descriptor(mix.heads, cache))
        gate_bc = gate.transpose(-1, -2).repeat_interleave(hcfg.d_group,
                                                           dim=-1)
        y = pruned_irfft_single(gate_bc * cache.prefix, n, cache.t % n,
                                reference_compat=reference_compat
                                ).reshape(b, d)
    if memory_fft is not None:
        y = y + pruned_irfft_single(memory_fft, n, min(cache.t, n - 1),
                                    reference_compat=reference_compat)
    return mix.out_proj(y), cache


def spectre_block_prefill(block: SpectreBlock, x: torch.Tensor,
                          cache: PrefixFFTCache, *,
                          reference_compat: bool = False) -> PrefixFFTCache:
    """Prefill from a prompt (B, L, d) through the block's LN and per-head
    projections.  The spectral memory is added at decode time, ungated as
    in the forward; ``reference_compat=True`` instead adds it into the
    prefix here, the original's documented recipe, where the gate then
    multiplies it."""
    with span("prefill.cache"):
        b, length, d = x.shape
        h, hd = block.cfg.num_heads, block.cfg.head_dim
        xh = block.ln1(x).reshape(b, length, h, hd)
        # (B, H, L, hd)
        q = _heads_linear(xh, block.mix.heads.w_q).transpose(1, 2)
        v = _heads_linear(xh, block.mix.heads.w_v).transpose(1, 2)
        cache = cache_prefill(cache, q, v)
        mem = block.memory_complex()
        if reference_compat and mem is not None:
            # (F_half, d) -> (1, H, F_half, hd)
            cache.prefix = (cache.prefix
                            + mem.reshape(-1, h, hd).transpose(0, 1))
        return cache


def spectre_block_decode_step(
    block: SpectreBlock, x_t: torch.Tensor, cache: PrefixFFTCache, *,
    reference_compat: bool = False,
) -> Tuple[torch.Tensor, PrefixFFTCache]:
    """Block-level single-token step: pre-LN residual mix + MLP."""
    memory_fft = None if reference_compat else block.memory_complex()
    mix, cache = spectre_multihead_decode_step(
        block.mix, block.ln1(x_t), cache, memory_fft=memory_fft,
        reference_compat=reference_compat)
    x_t = x_t + mix
    return x_t + block.mlp(block.ln2(x_t)), cache
