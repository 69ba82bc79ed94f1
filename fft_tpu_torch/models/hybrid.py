"""Hybrid LM: groups of causal SPECTRE blocks and one sliding-window
attention block (mirror of ``fft_tpu/models/hybrid.py``, BASELINE config
5: 1B parameters, seq 32k).

The spectral blocks carry global context, the attention block sharpens
local structure inside its window.  The JAX package scans stacked group
parameters; here the groups are a ``ModuleList`` (``spectre[g][s]`` and
``attn[g]``) run in a Python loop, each group under
``torch.utils.checkpoint`` when ``remat`` is set and grad is enabled, as
the 350M checkpoints each block (``models/lm.py``).  The hybrid trains
with ``deterministic=True`` (no dropout, and its wavelet rate is 0), so no
generator reaches the blocks.

Context parallelism (``cp_mesh``, a (data, seq, model=1) mesh): the hidden
states are this rank's rows and positions; the attention blocks exchange
one K/V halo (``sliding_window_attention_cp``, on the mesh at any ``seq``
size) and, where ``seq`` is larger than 1, the SPECTRE blocks run the
causal mix sequence parallel (``sp_segmented_causal_mix``), as the JAX
package's ``_apply_group`` describes (:109-112).

Decode runs the SPECTRE blocks' prefix-FFT step (kernel #12 on the card)
and the attention blocks' ring step, one token at a time: the prompt is
fed token by token, as JAX's ``hybrid_generate`` feeds it.  Decode is
fp32 whatever the compute dtype, as the LM's: JAX's ``hybrid_decode_step``
casts the embedding to the compute dtype, and in bf16 its scan then fails
(a bf16 carry in, an fp32 one out, since the first block's fp32
projections promote the residual), so it has no bf16 decode to follow.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from fft_tpu_torch.config import SpectreConfig
from fft_tpu_torch.decode.cache import (
    PrefixFFTCache, cache_init, spectre_block_decode_step,
)
from fft_tpu_torch.layers.attention import (
    SWABlock, SWACache, swa_block_decode_step, swa_cache_init,
)
from fft_tpu_torch.layers.common import LayerNorm
from fft_tpu_torch.layers.spectre import SpectreBlock
from fft_tpu_torch.models.lm import (
    embed_tokens, head_logits, local_batch, seq_shards,
)
from fft_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    vocab_size: int
    num_groups: int                      # layer groups
    spectre_per_group: int               # SPECTRE blocks per group
    block: SpectreConfig                 # SPECTRE block config (causal)
    attn_heads: int
    attn_window: int
    max_seq: int
    tie_embeddings: bool = True
    # rematerialize each (SPECTRE + SWA) group in backward
    remat: bool = False

    @property
    def embed_dim(self) -> int:
        return self.block.embed_dim

    @property
    def num_layers(self) -> int:
        return self.num_groups * (self.spectre_per_group + 1)


def hybrid_tiny_config(vocab_size: int = 256, seq: int = 2048
                       ) -> HybridConfig:
    """Small hybrid for CLI smoke runs and tests: 2x (SPECTRE + SWA)."""
    return HybridConfig(
        vocab_size=vocab_size,
        num_groups=2, spectre_per_group=1,
        block=SpectreConfig(
            embed_dim=256, num_heads=4, n_fft=seq, pooling_type="mean",
            wavelet_on_rate=0.0, causal=True,
            causal_chunk=max(128, seq // 8)),
        attn_heads=4, attn_window=max(64, seq // 8), max_seq=seq,
    )


def hybrid_1b_config(vocab_size: int = 50432, seq: int = 32768
                     ) -> HybridConfig:
    """Config 5: ~1B params, d=2048, seq 32k, SWA window 1024."""
    return HybridConfig(
        vocab_size=vocab_size,
        num_groups=8, spectre_per_group=1,   # 8x (SPECTRE + SWA) = 16 layers
        block=SpectreConfig(
            embed_dim=2048, num_heads=16, n_fft=seq, pooling_type="mean",
            wavelet_on_rate=0.0, causal=True, causal_chunk=1024,
            compute_dtype="bfloat16"),
        attn_heads=16, attn_window=1024, max_seq=seq, remat=True,
    )


class HybridLM(nn.Module):
    def __init__(self, cfg: HybridConfig):
        super().__init__()
        if not cfg.tie_embeddings:
            raise NotImplementedError(
                "an untied hybrid LM head is not ported to fft_tpu_torch "
                "(the JAX package's hybrid_init builds none either)")
        self.cfg = cfg
        d = cfg.embed_dim
        self.tok_emb = nn.Parameter(torch.empty(cfg.vocab_size, d))
        self.pos_emb = nn.Parameter(torch.empty(cfg.max_seq, d))
        self.spectre = nn.ModuleList(
            nn.ModuleList(SpectreBlock(cfg.block)
                          for _ in range(cfg.spectre_per_group))
            for _ in range(cfg.num_groups))
        self.attn = nn.ModuleList(
            SWABlock(d, cfg.attn_heads, cfg.attn_window,
                     compute_dtype=cfg.block.compute_dtype)
            for _ in range(cfg.num_groups))
        self.ln_f = LayerNorm(d, eps=1e-5)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for emb in (self.tok_emb, self.pos_emb):
            emb.copy_(torch.randn(emb.shape, generator=generator) * 0.02)
        for group in self.spectre:
            for block in group:
                block.reset_parameters(generator)
        for block in self.attn:
            block.reset_parameters(generator)
        self.ln_f.reset_parameters()

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token plus position embedding, in the blocks' compute dtype."""
        return embed_tokens(self, tokens)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, N) int -> logits (B, N, vocab) float32."""
        return hybrid_apply(self, tokens)


def hybrid_init(cfg: HybridConfig, generator: torch.Generator,
                device=None) -> HybridLM:
    """A model with the JAX package's init distributions, drawn on the CPU
    from ``generator`` (embeddings N(0, 0.02^2), then each SPECTRE block,
    then each attention block), then moved to ``device``: the card unless
    ``"cpu"`` is asked for.  In eval mode: the hybrid runs
    deterministically, in training too."""
    device = resolve_device(device)
    model = HybridLM(cfg)
    model.reset_parameters(generator)
    return model.to(device).eval()


def _apply_group(model: HybridLM, g: int, h: torch.Tensor,
                 cp_mesh=None) -> torch.Tensor:
    """One layer group: its SPECTRE blocks, then its SWA block."""
    sp_mesh = cp_mesh if seq_shards(cp_mesh) > 1 else None
    for block in model.spectre[g]:
        h = block(h, sp_mesh=sp_mesh)
    return model.attn[g](h, cp_mesh=cp_mesh)


def hybrid_hidden_local(model: HybridLM, tokens: torch.Tensor, *,
                        cp_mesh=None, pos0: int = 0) -> torch.Tensor:
    """``hybrid_hidden`` of tokens that are already this rank's shard, at
    positions pos0..."""
    if cp_mesh is not None and cp_mesh.size("model") != 1:
        raise ValueError("the hybrid LM runs no tensor parallelism: its "
                         "mesh's model axis must be 1")
    h = embed_tokens(model, tokens, pos0)
    remat = model.cfg.remat and torch.is_grad_enabled()
    for g in range(model.cfg.num_groups):
        if remat:
            h = checkpoint(_apply_group, model, g, h, cp_mesh,
                           use_reentrant=False)
        else:
            h = _apply_group(model, g, h, cp_mesh)
    return model.ln_f(h)


def hybrid_hidden(model: HybridLM, tokens: torch.Tensor, *,
                  cp_mesh=None) -> torch.Tensor:
    """tokens (B, N) -> final-LN hidden states (B, N, d); differentiable.
    With ``cfg.remat`` and grad enabled each group is recomputed in
    backward.  With ``cp_mesh`` tokens is the global batch and the result
    this rank's rows and positions."""
    tokens, pos0 = local_batch(tokens, cp_mesh)
    return hybrid_hidden_local(model, tokens, cp_mesh=cp_mesh, pos0=pos0)


def hybrid_head_matrix(model: HybridLM) -> torch.Tensor:
    """(d, vocab): the tied head, tok_emb transposed."""
    return model.tok_emb.T


@torch.no_grad()
def hybrid_apply(model: HybridLM, tokens: torch.Tensor, *,
                 cp_mesh=None) -> torch.Tensor:
    """tokens (B, N) -> logits (B, N, vocab) float32 (this rank's shard
    with ``cp_mesh``)."""
    return head_logits(hybrid_hidden(model, tokens, cp_mesh=cp_mesh),
                       hybrid_head_matrix(model))


HybridCaches = Tuple[List[List[PrefixFFTCache]], List[SWACache]]


def hybrid_decode_init(model: HybridLM, batch: int) -> HybridCaches:
    """Empty decode caches: a prefix-FFT cache per SPECTRE block (by group)
    and a ring cache per attention block, on the model's device."""
    cfg = model.cfg
    bc = cfg.block
    dev = model.tok_emb.device
    sp = [[cache_init(batch, bc.num_heads, bc.n_fft, bc.head_dim,
                      device=dev) for _ in range(cfg.spectre_per_group)]
          for _ in range(cfg.num_groups)]
    at = [swa_cache_init(batch, cfg.attn_heads, cfg.attn_window,
                         cfg.embed_dim // cfg.attn_heads, device=dev)
          for _ in range(cfg.num_groups)]
    return sp, at


@torch.no_grad()
def hybrid_decode_step(model: HybridLM, token: torch.Tensor, pos: int,
                       caches: HybridCaches
                       ) -> Tuple[torch.Tensor, HybridCaches]:
    """One autoregressive step: token (B,) at position ``pos`` -> (logits
    (B, vocab) float32, caches updated in place)."""
    sp, at = caches
    h = model.tok_emb[token] + model.pos_emb[pos]
    for g in range(model.cfg.num_groups):
        for s, block in enumerate(model.spectre[g]):
            h, sp[g][s] = spectre_block_decode_step(block, h, sp[g][s])
        h, at[g] = swa_block_decode_step(model.attn[g], h, at[g])
    return head_logits(model.ln_f(h), hybrid_head_matrix(model)), (sp, at)


@torch.no_grad()
def hybrid_generate(model: HybridLM, prompt: torch.Tensor, steps: int, *,
                    generator: Optional[torch.Generator] = None,
                    temperature: float = 0.0) -> torch.Tensor:
    """Greedy (temperature 0) or sampled generation from a (B, L) prompt
    through the decode caches, the prompt fed token by token.  Sampling
    draws from ``generator`` (on the model's device).  Returns (B, steps)
    tokens."""
    b, length = prompt.shape
    if length + steps > model.cfg.max_seq:
        raise ValueError(f"generation to position {length + steps} exceeds "
                         f"max_seq {model.cfg.max_seq} (pos_emb would run "
                         "out)")
    caches = hybrid_decode_init(model, b)
    logits = None
    for i in range(length):
        logits, caches = hybrid_decode_step(model, prompt[:, i], i, caches)
    toks = []
    for i in range(steps):
        if temperature <= 0.0:
            tok = logits.argmax(dim=-1)
        else:
            probs = torch.softmax(logits / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        toks.append(tok)
        if i + 1 < steps:
            logits, caches = hybrid_decode_step(model, tok, length + i,
                                                caches)
    return torch.stack(toks, dim=1)
