"""SPECTRE causal language model (mirror of ``fft_tpu/models/lm.py``).

Token + learned positional embeddings, a stack of causal SPECTRE blocks
(a Python loop over a ``ModuleList`` where the JAX package scans stacked
layers, each block under ``torch.utils.checkpoint`` when ``remat`` is set,
as the JAX package's ``jax.checkpoint``), final LayerNorm and the LM
head: ``tok_emb`` transposed when ``tie_embeddings`` (the default), else
its own (d, vocab) ``lm_head`` (JAX's lm.py:98-100), which every reader
of the head takes through ``lm_head_matrix``.  Serving: the forward,
batched prefill into per-layer decode caches, the O(F)-per-token decode
step and generation, all without autograd.  Training calls the
differentiable ``lm_hidden`` and ``lm_head_matrix`` (``fft_tpu_torch.train``).

Parallel training (``fft_tpu_torch.parallel``): ``lm_hidden`` with a
(data, seq, model) ``mesh`` takes the global batch and returns this rank's
shard, its rows of the batch and, where the mesh's ``seq`` axis is larger
than 1 (the JAX package's rule), its positions of the sequence, every
block running sequence parallel; the blocks' heads and MLPs run tensor
parallel over ``model``, and the vocab-sharded ``tok_emb`` is a masked
lookup summed over ``model``.  With ``pp_mesh`` the block stack runs as a
GPipe pipeline (``parallel/pipeline.py``), deterministically, as in the
JAX package.

With ``compute_dtype="bfloat16"`` the embedding plus position is cast to
bf16 and the blocks run in bf16, while the logits come out fp32 (the head
cast down for the product, the product cast up), the decode caches are
built from the prompt's hidden states in fp32 and decode runs in fp32, as
in the JAX package (lm.py:158-159, :183-184, :224-238, :269-279).  The
parameters stay fp32.
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
    spectre_block_prefill,
)
from fft_tpu_torch.layers.causal_chunk import preferred_causal_chunk
from fft_tpu_torch.layers.common import DTYPES, LayerNorm
from fft_tpu_torch.layers.spectre import SpectreBlock
from fft_tpu_torch.parallel import comm
from fft_tpu_torch.parallel.mesh import data_slice, seq_slice
from fft_tpu_torch.parallel.pipeline import pipeline_apply
from fft_tpu_torch.utils.device import resolve_device
from fft_tpu_torch.utils.prof import span


@dataclasses.dataclass(frozen=True)
class LMConfig:
    vocab_size: int
    num_layers: int
    block: SpectreConfig
    max_seq: int
    tie_embeddings: bool = True
    emb_init_std: float = 0.02
    remat: bool = False

    @property
    def embed_dim(self) -> int:
        return self.block.embed_dim

    def __post_init__(self):
        if self.block.causal and self.max_seq > self.block.n_fft:
            raise ValueError("causal LM sequences must fit the spectral "
                             "window")


def tiny_lm_config(vocab_size: int = 256, seq: int = 2048) -> LMConfig:
    """Config 2: 6-layer tiny LM, d=512, 8 heads, char-level, seq 2048."""
    return LMConfig(
        vocab_size=vocab_size,
        num_layers=6,
        max_seq=seq,
        block=SpectreConfig(
            embed_dim=512, num_heads=8, n_fft=seq, pooling_type="mean",
            wavelet_on_rate=0.0, causal=True, causal_chunk=128,
            memory_size=0),
    )


def spectre_350m_config(vocab_size: int = 50432,
                        seq: int = 16384) -> LMConfig:
    """Config 4: long-context causal SPECTRE-350M, seq 16k-64k: 24 layers,
    d=1024, 16 heads x 4 groups, each block rematerialized in backward.
    The causal chunk is the reference's choice for this seq (at least 512;
    2048 from seq 16k), since it is part of the model."""
    return LMConfig(
        vocab_size=vocab_size,
        num_layers=24,
        max_seq=seq,
        remat=True,
        block=SpectreConfig(
            embed_dim=1024, num_heads=16, n_fft=seq, pooling_type="mean",
            wavelet_on_rate=0.0, causal=True,
            causal_chunk=max(512, preferred_causal_chunk(seq, 1024)),
            memory_size=0),
    )


class SpectreLM(nn.Module):
    def __init__(self, cfg: LMConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.tok_emb = nn.Parameter(torch.empty(cfg.vocab_size, d))
        self.pos_emb = nn.Parameter(torch.empty(cfg.max_seq, d))
        self.blocks = nn.ModuleList(
            SpectreBlock(cfg.block) for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(d, eps=1e-5)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(d, cfg.vocab_size))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        std = self.cfg.emb_init_std
        self.tok_emb.copy_(torch.randn(self.tok_emb.shape,
                                       generator=generator) * std)
        self.pos_emb.copy_(torch.randn(self.pos_emb.shape,
                                       generator=generator) * std)
        for block in self.blocks:
            block.reset_parameters(generator)
        self.ln_f.reset_parameters()
        if not self.cfg.tie_embeddings:
            # drawn last, so a tied model's draws stay as they were
            self.lm_head.copy_(torch.randn(self.lm_head.shape,
                                           generator=generator) * std)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token plus position embedding, in the blocks' compute dtype."""
        return embed_tokens(self, tokens)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """fp32 logits of hidden states h (before the final LN)."""
        return head_logits(self.ln_f(h), lm_head_matrix(self))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, N) int -> logits (B, N, vocab) float32."""
        return lm_apply(self, tokens)


def lm_init(cfg: LMConfig, generator: torch.Generator,
            device=None) -> SpectreLM:
    """A model with the JAX package's init distributions, drawn on the CPU
    from ``generator`` (a CPU generator, so one seed gives one model on
    every device), then moved to ``device``: the card unless ``"cpu"`` is
    asked for (``resolve_device``)."""
    device = resolve_device(device)
    model = SpectreLM(cfg)
    model.reset_parameters(generator)
    return model.to(device).eval()


def _checkpointed(block: SpectreBlock, h: torch.Tensor,
                  generator: Optional[torch.Generator], **kw) -> torch.Tensor:
    """block(h) whose activations are recomputed in backward.  The
    recompute replays the forward's draws from ``generator`` and then puts
    the generator back where backward found it."""
    if generator is None:
        return checkpoint(block, h, use_reentrant=False, **kw)
    start = generator.get_state()
    ran = []

    def run(x):
        if not ran:                        # the forward
            ran.append(True)
            return block(x, generator=generator, **kw)
        now = generator.get_state()        # the recompute in backward
        generator.set_state(start)
        try:
            return block(x, generator=generator, **kw)
        finally:
            generator.set_state(now)

    return checkpoint(run, h, use_reentrant=False)


def seq_shards(mesh) -> int:
    return 1 if mesh is None else mesh.size("seq")


def local_batch(tokens: torch.Tensor, mesh) -> Tuple[torch.Tensor, int]:
    """(this rank's rows of a global batch, and its positions under SP;
    the first position) for a ``mesh`` (the whole batch without one)."""
    if mesh is None:
        return tokens, 0
    tokens = tokens[data_slice(mesh, tokens.shape[0])]
    if seq_shards(mesh) == 1:
        return tokens, 0
    sl = seq_slice(mesh, tokens.shape[1])
    return tokens[:, sl], sl.start


def embed_tokens(model: nn.Module, tokens: torch.Tensor, pos0: int = 0,
                 mesh=None) -> torch.Tensor:
    """Token plus position embedding of tokens at positions pos0..., in the
    blocks' compute dtype (the LM's and the hybrid's).  Under ``mesh``
    ``tok_emb`` holds this rank's rows of the vocab (``model`` axis): a
    masked lookup summed over ``model``."""
    n = tokens.shape[-1]
    if mesh is None:
        e = model.tok_emb[tokens]
    else:
        vl = model.tok_emb.shape[0]
        idx = tokens - mesh.rank("model") * vl
        inside = (idx >= 0) & (idx < vl)
        e = comm.reduce_from(model.tok_emb[idx.clamp(0, vl - 1)]
                             * inside[..., None], mesh, "model")
    h = e + model.pos_emb[pos0:pos0 + n]
    return h.to(DTYPES[model.cfg.block.compute_dtype])


def lm_hidden_local(model: SpectreLM, tokens: torch.Tensor, *,
                    generator: Optional[torch.Generator] = None,
                    mesh=None, pp_mesh=None, pos0: int = 0) -> torch.Tensor:
    """``lm_hidden`` of tokens that are already this rank's shard, at
    positions pos0..."""
    sp_mesh = mesh if seq_shards(mesh) > 1 else None
    h = embed_tokens(model, tokens, pos0, mesh)
    remat = model.cfg.remat and torch.is_grad_enabled()
    if pp_mesh is not None:
        h = pipeline_apply(
            model.blocks, lambda blk, x: (_checkpointed(blk, x, None)
                                          if remat else blk(x)),
            h, mesh=pp_mesh)
        return model.ln_f(h)
    kw = {} if mesh is None else {"sp_mesh": sp_mesh, "tp_mesh": mesh}
    for block in model.blocks:
        h = (_checkpointed(block, h, generator, **kw) if remat
             else block(h, generator=generator, **kw))
    return model.ln_f(h)


def lm_hidden(model: SpectreLM, tokens: torch.Tensor, *,
              generator: Optional[torch.Generator] = None, mesh=None,
              pp_mesh=None) -> torch.Tensor:
    """tokens (B, N) -> final-LN hidden states (B, N, d); differentiable.
    In train mode, dropout draws from ``generator``.  With ``cfg.remat``
    and grad enabled, each block is rematerialized in backward.

    With ``mesh`` (``parallel.make_mesh``, the model cut to this rank's
    shard by ``parallel.shard_model``) tokens is the global batch and the
    result this rank's shard: its rows, and its positions where the mesh's
    ``seq`` axis is larger than 1.  ``pp_mesh``: the blocks are this
    stage's and run as a pipeline."""
    tokens, pos0 = local_batch(tokens, mesh)
    return lm_hidden_local(model, tokens, generator=generator, mesh=mesh,
                           pp_mesh=pp_mesh, pos0=pos0)


def lm_head_matrix(model: SpectreLM) -> torch.Tensor:
    """(d, vocab): the LM head, tok_emb transposed when tied, else
    ``lm_head`` (JAX's lm.py:172-173); (d, this rank's vocab) for a tied
    head sharded over ``model``."""
    return model.tok_emb.T if model.cfg.tie_embeddings else model.lm_head


def head_logits(h: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """fp32 logits of final-LN hidden states h: the product in h's dtype
    (the head cast down), cast up, for a stable softmax in either mode."""
    return (h @ head.to(h.dtype)).float()


@torch.no_grad()
def lm_apply(model: SpectreLM, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, N) -> logits (B, N, vocab) float32."""
    return head_logits(lm_hidden(model, tokens), lm_head_matrix(model))


def lm_decode_init(model: SpectreLM, batch: int) -> List[PrefixFFTCache]:
    bc = model.cfg.block
    return [cache_init(batch, bc.num_heads, bc.n_fft, bc.head_dim,
                       device=model.tok_emb.device)
            for _ in model.blocks]


@torch.no_grad()
def lm_decode_step(model: SpectreLM, token: torch.Tensor, pos: int,
                   caches: List[PrefixFFTCache]
                   ) -> Tuple[torch.Tensor, List[PrefixFFTCache]]:
    """One autoregressive step: token (B,) at position ``pos`` ->
    (logits (B, vocab), caches updated in place)."""
    h = model.tok_emb[token] + model.pos_emb[pos]
    for i, block in enumerate(model.blocks):
        h, caches[i] = spectre_block_decode_step(block, h, caches[i])
    return model.logits(h), caches


@torch.no_grad()
def lm_prefill(model: SpectreLM, tokens: torch.Tensor
               ) -> Tuple[torch.Tensor, List[PrefixFFTCache]]:
    """One causal forward pass over the prompt builds every layer's decode
    cache (from each layer's input in fp32, whatever the compute dtype).
    Returns (last-position logits (B, vocab), caches)."""
    with span("prefill"):
        h = model.embed(tokens)
        caches = lm_decode_init(model, tokens.shape[0])
        for i, block in enumerate(model.blocks):
            caches[i] = spectre_block_prefill(block, h.float(), caches[i])
            h = block(h)
        return model.logits(h[:, -1]), caches


@torch.no_grad()
def lm_prefill_split(model: SpectreLM, tokens: torch.Tensor
                     ) -> Tuple[torch.Tensor, List[PrefixFFTCache]]:
    """``lm_prefill`` in two loops, the JAX package's public split of the
    same math: the forward collecting each layer's input hidden states,
    then the cache build over them.  Returns what ``lm_prefill`` returns."""
    h = model.embed(tokens)
    inputs = []
    for block in model.blocks:
        inputs.append(h)
        h = block(h)
    caches = lm_decode_init(model, tokens.shape[0])
    for i, (block, h_in) in enumerate(zip(model.blocks, inputs)):
        caches[i] = spectre_block_prefill(block, h_in.float(), caches[i])
    return model.logits(h[:, -1]), caches


@torch.no_grad()
def lm_generate(model: SpectreLM, prompt: torch.Tensor, steps: int, *,
                generator: Optional[torch.Generator] = None,
                temperature: float = 0.0) -> torch.Tensor:
    """Greedy (temperature 0) or sampled generation from a (B, L) prompt:
    batched prefill, then the decode step.  Returns (B, steps) tokens."""
    b, length = prompt.shape
    if length + steps > model.cfg.max_seq:
        raise ValueError(f"generation to position {length + steps} exceeds "
                         f"max_seq {model.cfg.max_seq}")
    logits, caches = lm_prefill(model, prompt)
    toks = []
    for i in range(steps):
        if temperature <= 0.0:
            tok = logits.argmax(dim=-1)
        else:
            probs = torch.softmax(logits / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        toks.append(tok)
        if i + 1 < steps:
            logits, caches = lm_decode_step(model, tok, length + i, caches)
    return torch.stack(toks, dim=1)
