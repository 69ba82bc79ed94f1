"""Causal sliding-window attention for the hybrid LM (mirror of
``fft_tpu/layers/attention.py``, BASELINE config 5).

The sequence is cut into blocks of ``window`` tokens (zero-padded at the
end); each block's queries attend to the previous block and their own, 2W
keys, under the band 0 <= i + W - j < W, with block 0's missing
predecessor masked.  Plain PyTorch: the JAX package has no Pallas kernel
here, so neither does the port (a fused sliding-window kernel is later
work), and no fused attention call (SDPA, flash) takes its place.

Precision follows the JAX package (:91-94): the scores are the products of
q and k accumulated and returned in fp32 (JAX's ``preferred_element_type``;
here q and k are widened to fp32 first, which gives the same products),
the softmax is fp32 and its probabilities are cast to v's dtype for the
product with v.  The block casts its input to the compute dtype.

All blocks' scores are one batched product, (B, nb, H, W, 2W).  The JAX
package maps over the blocks under ``jax.checkpoint`` because all blocks'
fp32 scores take 4.3 GB at the 1B's seq 32768; the port batches them
inside the group's ``torch.utils.checkpoint`` (``models/hybrid.py``), so a
step holds one group's scores at a time (PERF.md gives the peak memory).

The decode cache ``SWACache`` is a ring buffer over the window, updated in
place with a host-integer position, as ``decode/cache.py``'s
``PrefixFFTCache``.  Context parallelism (``cp_mesh``, the JAX package's
:105-147) is ``sliding_window_attention_cp``: the sequence sharded over the
mesh's ``seq`` axis, one halo hop of each rank's last K/V block to its
right neighbour, then the same banded attention on the rank's blocks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fft_tpu_torch.layers.common import DTYPES, LayerNorm, Linear, linear_init
from fft_tpu_torch.layers.spectre import MLP
from fft_tpu_torch.parallel import comm
from fft_tpu_torch.utils.device import resolve_device
from fft_tpu_torch.utils.prof import backward_span, forward_span


class SlidingWindowAttention(nn.Module):
    """The four bias-free projections, (d, d) each."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.w_q = Linear(embed_dim, embed_dim, bias=False)
        self.w_k = Linear(embed_dim, embed_dim, bias=False)
        self.w_v = Linear(embed_dim, embed_dim, bias=False)
        self.w_o = Linear(embed_dim, embed_dim, bias=False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        d = self.w_q.in_features
        for lin in (self.w_q, self.w_k, self.w_v, self.w_o):
            lin.weight.copy_(linear_init(d, d, generator, bias=False)[0])


def swa_init(embed_dim: int, generator: torch.Generator,
             device=None) -> SlidingWindowAttention:
    """The projections, drawn on the CPU from ``generator``, then moved to
    ``device``: the card unless ``"cpu"`` is asked for."""
    device = resolve_device(device)
    attn = SlidingWindowAttention(embed_dim)
    attn.reset_parameters(generator)
    return attn.to(device)


def _banded_block_attention(qb: torch.Tensor, kb: torch.Tensor,
                            vb: torch.Tensor, k_halo: torch.Tensor,
                            v_halo: torch.Tensor, gi0: int) -> torch.Tensor:
    """Blockwise causal window attention over (B, nb, W, H, hd) blocks.
    ``k_halo``/``v_halo`` (B, W, H, hd) is the block before qb's first
    (zeros at the sequence start); ``gi0`` is the global index of the first
    block, whose missing predecessor is masked at gi0 == 0."""
    b, nb, w, h, hd = qb.shape
    k_prev = torch.cat([k_halo[:, None], kb[:, :-1]], dim=1)
    v_prev = torch.cat([v_halo[:, None], vb[:, :-1]], dim=1)
    k2 = torch.cat([k_prev, kb], dim=2)                  # (B, nb, 2W, H, hd)
    v2 = torch.cat([v_prev, vb], dim=2)
    # query i attends key j of the 2W span iff 0 <= i + W - j < W
    qi = torch.arange(w, device=qb.device)[:, None]
    kj = torch.arange(2 * w, device=qb.device)[None, :]
    dist = qi + w - kj
    valid = ((dist >= 0) & (dist < w)).expand(nb, w, 2 * w).clone()
    if gi0 == 0:
        valid[0, :, :w] = False
    s = torch.einsum("bnqhd,bnkhd->bnhqk", qb.float(),
                     k2.float()) * (1.0 / math.sqrt(hd))
    s.masked_fill_(~valid[None, :, None], float("-inf"))
    p = torch.softmax(s, dim=-1).to(vb.dtype)
    return torch.einsum("bnhqk,bnkhd->bnqhd", p, v2)     # (B, nb, W, H, hd)


def sliding_window_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, window: int) -> torch.Tensor:
    """q, k, v (B, N, H, hd): causal attention over the last ``window``
    tokens.  A sequence that does not divide into windows is zero-padded
    at the end (causality keeps the pad out of every real query)."""
    b, n, h, hd = q.shape
    w = window
    pad = -n % w
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    nb = (n + pad) // w
    qb, kb, vb = (t.reshape(b, nb, w, h, hd) for t in (q, k, v))
    out = _banded_block_attention(qb, kb, vb, torch.zeros_like(kb[:, 0]),
                                  torch.zeros_like(vb[:, 0]), 0)
    return out.reshape(b, nb * w, h, hd)[:, :n]


def sliding_window_attention_cp(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, window: int, mesh,
                                seq_axis: str = "seq") -> torch.Tensor:
    """Context-parallel sliding-window attention: q, k, v (B, n, H, hd) are
    this rank's n positions of a sequence sharded over ``mesh[seq_axis]``.
    One halo hop (``comm.halo_right``) brings the previous rank's last
    (W, H, hd) K and V block (zeros on rank 0, the sequence's start);
    then the rank's blocks attend locally from global block rank * n / W.
    The shard-local length must be a multiple of the window."""
    b, n, h, hd = q.shape
    w = window
    if n % w:
        raise ValueError(f"shard-local length {n} must divide into windows "
                         f"of {w}")
    nb = n // w
    qb, kb, vb = (t.reshape(b, nb, w, h, hd) for t in (q, k, v))
    halo = comm.halo_right(torch.stack([kb[:, -1], vb[:, -1]]), mesh,
                           seq_axis)
    out = _banded_block_attention(qb, kb, vb, halo[0], halo[1],
                                  mesh.rank(seq_axis) * nb)
    return out.reshape(b, n, h, hd)


def swa_apply(attn: SlidingWindowAttention, x: torch.Tensor, num_heads: int,
              window: int, cp_mesh=None) -> torch.Tensor:
    """(B, N, d) -> (B, N, d) causal sliding-window multi-head attention;
    with ``cp_mesh`` x is this rank's shard of the sequence
    (``sliding_window_attention_cp``)."""
    b, n, d = x.shape
    hd = d // num_heads
    q = attn.w_q(x).reshape(b, n, num_heads, hd)
    k = attn.w_k(x).reshape(b, n, num_heads, hd)
    v = attn.w_v(x).reshape(b, n, num_heads, hd)
    if cp_mesh is None:
        out = sliding_window_attention(q, k, v, window)
    else:
        out = sliding_window_attention_cp(q, k, v, window, cp_mesh)
    return attn.w_o(out.reshape(b, n, d))


class SWABlock(nn.Module):
    """Pre-LN residual block: x + SWA(LN(x)); x + MLP(LN(x)), in the
    compute dtype it is given (the parameters stay fp32)."""

    def __init__(self, embed_dim: int, num_heads: int, window: int,
                 mlp_ratio: int = 4, compute_dtype: str = "float32"):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.num_heads = num_heads
        self.window = window
        self.compute_dtype = compute_dtype
        self.ln1 = LayerNorm(embed_dim, eps=1e-5)
        self.attn = SlidingWindowAttention(embed_dim)
        self.ln2 = LayerNorm(embed_dim, eps=1e-5)
        self.mlp = MLP(embed_dim, mlp_ratio * embed_dim)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        d, hidden = self.mlp.fc1.in_features, self.mlp.fc1.out_features
        for ln in (self.ln1, self.ln2):
            ln.reset_parameters()
        self.attn.reset_parameters(generator)
        for fc, fan_in, fan_out in ((self.mlp.fc1, d, hidden),
                                    (self.mlp.fc2, hidden, d)):
            w, b = linear_init(fan_in, fan_out, generator)
            fc.weight.copy_(w)
            fc.bias.copy_(b)

    def forward(self, x: torch.Tensor, cp_mesh=None) -> torch.Tensor:
        with forward_span("swa.block"):
            x = x.to(DTYPES[self.compute_dtype])
            h = self.ln1(x)
            with forward_span("swa.attention"):
                h = backward_span(
                    "swa.attention.backward",
                    lambda t: swa_apply(self.attn, t, self.num_heads,
                                        self.window, cp_mesh=cp_mesh), h)
            x = x + h
            return x + self.mlp(self.ln2(x))


def swa_block_init(embed_dim: int, num_heads: int, window: int,
                   generator: torch.Generator, mlp_ratio: int = 4,
                   compute_dtype: str = "float32", device=None) -> SWABlock:
    """A block with the JAX package's init distributions (LayerNorms at 1
    and 0, linears U(-1/sqrt(fan_in), 1/sqrt(fan_in))), drawn on the CPU
    from ``generator``, then moved to ``device``: the card unless ``"cpu"``
    is asked for."""
    device = resolve_device(device)
    block = SWABlock(embed_dim, num_heads, window, mlp_ratio, compute_dtype)
    block.reset_parameters(generator)
    return block.to(device)


def swa_block_apply(block: SWABlock, x: torch.Tensor,
                    cp_mesh=None) -> torch.Tensor:
    return block(x, cp_mesh=cp_mesh)


# ---------------------------------------------------------------------------
# Decode cache for sliding-window attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SWACache:
    """Ring-buffer KV cache over the attention window."""

    k_buf: torch.Tensor      # (B, H, W, hd)
    v_buf: torch.Tensor      # (B, H, W, hd)
    t: int                   # last filled position (-1 = empty)


def swa_cache_init(batch: int, num_heads: int, window: int, head_dim: int,
                   device=None) -> SWACache:
    """An empty ring on ``device``: the card unless ``"cpu"`` is asked
    for."""
    device = resolve_device(device)
    shape = (batch, num_heads, window, head_dim)
    return SWACache(torch.zeros(shape, device=device),
                    torch.zeros(shape, device=device), -1)


def swa_block_decode_step(block: SWABlock, x_t: torch.Tensor,
                          cache: SWACache) -> Tuple[torch.Tensor, SWACache]:
    """One token x_t (B, d), fp32 as the cache: write its key and value
    into ring slot (t + 1) mod W in place and attend over the filled
    slots."""
    b, d = x_t.shape
    h = block.num_heads
    hd = d // h
    w = cache.k_buf.shape[-2]
    h_ln = block.ln1(x_t)
    q = block.attn.w_q(h_ln).reshape(b, h, hd)
    k = block.attn.w_k(h_ln).reshape(b, h, hd)
    v = block.attn.w_v(h_ln).reshape(b, h, hd)
    t = cache.t + 1
    j = t % w
    cache.k_buf[..., j, :] = k
    cache.v_buf[..., j, :] = v
    cache.t = t
    scores = torch.einsum("bhd,bhwd->bhw", q, cache.k_buf) / math.sqrt(hd)
    if t < w - 1:                                 # before the first wrap
        scores[..., t + 1:] = float("-inf")
    probs = torch.softmax(scores, dim=-1)
    attn = torch.einsum("bhw,bhwd->bhd", probs, cache.v_buf).reshape(b, d)
    x_t = x_t + block.attn.w_o(attn)
    return x_t + block.mlp(block.ln2(x_t)), cache
