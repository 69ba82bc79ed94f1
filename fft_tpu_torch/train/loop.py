"""Training loop (mirror of ``fft_tpu/train/loop.py``): AdamW with global-
norm clipping and a warmup-cosine schedule, written out as optax composes
them, the chunked next-token loss, the hybrid LM's loss and the ViT's
classification loss, and the train steps.

Everything trains except the frozen spectral memory, which is a buffer of
``SpectreBlock`` and so is outside the optimizer, as ``optax.masked`` keeps
it in the JAX package.  Unlike ``torch.optim.AdamW`` the update follows
optax to the formula: weight decay on every parameter (LayerNorms, biases
and embeddings included), no epsilon added to the clipping norm, lr 0 at
the first update.  ``train-vit`` uses ``optax.adamw(lr)`` alone (no clip,
a constant rate, b2 0.999, weight decay 1e-4): ``vit_train_config`` gives
the same AdamW those settings.

The JAX train step is a pure function of its state; here the steps update
the model, the optimizer's moments and the step count in place.

Parallel steps (``fft_tpu_torch.parallel``): ``train_step(mesh=,
pp_mesh=)`` and ``hybrid_train_step(cp_mesh=)`` take the global batch on
every rank and train the rank's shard of the model
(``parallel.shard_model``).  The loss is the global mean: each rank's sum
over its tokens, summed over ``data`` and ``seq`` (``comm.reduce_from``),
over the global token count.  Under tensor parallelism the tied head is
vocab-sharded, so the cross entropy takes a vocab-parallel logsumexp (max
and sum over ``model``) and the target's logit from the rank that holds
it.  The gradients are summed over ``data`` and ``seq``, the clipping norm
counts each parameter once across the ranks that share it
(``mesh.global_grad_norm``), and AdamW runs on the local shards.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fft_tpu_torch.layers.common import DTYPES
from fft_tpu_torch.models.hybrid import (
    HybridLM, hybrid_head_matrix, hybrid_hidden_local,
)
from fft_tpu_torch.models.lm import (
    SpectreLM, head_logits, lm_head_matrix, lm_hidden_local, local_batch,
)
from fft_tpu_torch.models.vit import ViT, vit_apply
from fft_tpu_torch.parallel import comm
from fft_tpu_torch.parallel.mesh import global_grad_norm, sync_grads
from fft_tpu_torch.utils.prof import forward_span, span


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.95
    warmup_steps: int = 100
    total_steps: int = 10000
    # None: no clipping (optax.adamw alone, as train-vit's)
    grad_clip: Optional[float] = 1.0
    min_lr_ratio: float = 0.1
    # AdamW first-moment dtype: None (the parameters', fp32) or "bfloat16"
    # (stored in bf16, as optax's adamw(mu_dtype=...)); the second moment
    # stays fp32
    mu_dtype: Optional[str] = None


def vit_train_config(learning_rate: float) -> TrainConfig:
    """``optax.adamw(learning_rate)`` as ``cli train-vit`` builds it: b1
    0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on every parameter, a
    constant rate, no clipping.  No warmup and an end value equal to the
    peak make ``make_schedule`` give exactly ``learning_rate`` at every
    count."""
    return TrainConfig(learning_rate=learning_rate, weight_decay=1e-4,
                       beta2=0.999, grad_clip=None, warmup_steps=0,
                       min_lr_ratio=1.0)


def make_schedule(tcfg: TrainConfig) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(init_value=0.0, peak_value=lr,
    warmup_steps, decay_steps=max(total_steps, warmup_steps + 1),
    end_value=lr * min_lr_ratio)``: linear from 0 over the warmup (so the
    first update, count 0, has lr 0), then cosine over decay_steps -
    warmup_steps down to end_value."""
    peak = tcfg.learning_rate
    warmup = tcfg.warmup_steps
    decay = max(tcfg.total_steps, warmup + 1) - warmup
    end = peak * tcfg.min_lr_ratio
    alpha = 0.0 if peak == 0.0 else end / peak

    def schedule(count: int) -> float:
        if count < warmup:
            frac = 1.0 - max(count, 0) / warmup
            return -peak * frac + peak
        t = min(count - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay))
        return peak * ((1.0 - alpha) * cosine + alpha)

    return schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), as
    the norm of the per-tensor norms."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1, b2,
    eps=1e-8, weight_decay, mu_dtype))`` over ``params`` (without the clip
    where ``grad_clip`` is None):

        g      = g                       if |g| < grad_clip
                 g / |g| * grad_clip     otherwise
        mu     = (1 - b1) g + b1 mu,  nu = (1 - b2) g^2 + b2 nu
        u      = mu / (1 - b1^k) / (sqrt(nu / (1 - b2^k)) + eps) + wd p
        p     += -lr(k - 1) u                                   (k = count)

    Each line is one multi-tensor (``torch._foreach_*``) op over all
    parameters: a per-parameter loop costs ~1300 launches a step at the
    tiny LM, host-bound on the card.  The clip stays on the device (no
    sync on the norm).

    With ``mu_dtype="bfloat16"`` mu is stored in bf16 and each step follows
    optax's ``scale_by_adam``: b1 mu is taken in bf16 (rounded, as jnp's
    bf16 times a Python float), the sum with (1 - b1) g in fp32, the update
    from that fp32 mu, and mu stored back rounded to bf16.  nu stays fp32.
    """

    eps = 1e-8

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 tcfg: TrainConfig):
        if tcfg.mu_dtype not in (None, *DTYPES):
            raise ValueError(f"mu_dtype={tcfg.mu_dtype!r}: None or one of "
                             f"{sorted(DTYPES)}")
        self.tcfg = tcfg
        self.schedule = make_schedule(tcfg)
        self.params: List[torch.nn.Parameter] = list(params)
        mu_dtype = DTYPES.get(tcfg.mu_dtype)
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in self.params]
        # whether mu is stored in a narrower type than it is computed in
        self.mu_rounds = mu_dtype not in (None, torch.float32)
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[Optional[torch.Tensor]],
             norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One update from ``grads`` (in the order of ``params``; None is a
        zero gradient, as JAX gives an unused leaf).  ``norm``: the global
        norm to clip by, where the parameters are shards of a larger tree
        (else the norm of ``grads``).  Returns the global norm of the
        unclipped gradients."""
        c = self.tcfg
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        if norm is None:
            norm = global_norm(grads)
        if c.grad_clip is not None:
            grads = torch._foreach_mul(grads, torch.where(
                norm < c.grad_clip, 1.0, c.grad_clip / norm))
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = 1.0 - c.beta1 ** self.count
        bc2 = 1.0 - c.beta2 ** self.count
        if self.mu_rounds:
            mu = [m.float() for m in torch._foreach_mul(self.mu, c.beta1)]
            torch._foreach_add_(mu, grads, alpha=1.0 - c.beta1)
            torch._foreach_copy_(self.mu, mu)
        else:
            torch._foreach_mul_(self.mu, c.beta1)
            torch._foreach_add_(self.mu, grads, alpha=1.0 - c.beta1)
            mu = self.mu
        torch._foreach_mul_(self.nu, c.beta2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - c.beta2)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(mu, bc1)
        torch._foreach_div_(u, denom)
        torch._foreach_add_(u, self.params, alpha=c.weight_decay)
        torch._foreach_add_(self.params, u, alpha=-lr)
        return norm


def make_optimizer(tcfg: TrainConfig,
                   params: Iterable[torch.nn.Parameter]) -> AdamW:
    return AdamW(params, tcfg)


def _chunk_ce(hc: torch.Tensor, head: torch.Tensor,
              tc: torch.Tensor) -> torch.Tensor:
    with forward_span("head_ce"):
        logits = head_logits(hc, head)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               tc.reshape(-1), reduction="sum")


def _vocab_parallel_chunk_ce(hc: torch.Tensor, emb: torch.Tensor,
                             tc: torch.Tensor, mesh) -> torch.Tensor:
    """The CE sum of a chunk against a tied head whose vocab is sharded
    over ``model``: emb (V_l, d) holds this rank's rows of ``tok_emb``."""
    with forward_span("head_ce"):
        vl = emb.shape[0]
        logits = head_logits(comm.copy_to(hc, mesh, "model"), emb.T)
        m = comm.all_reduce_max(logits.amax(dim=-1, keepdim=True), mesh,
                                "model")
        sumexp = comm.reduce_from(torch.exp(logits - m).sum(dim=-1), mesh,
                                  "model")
        idx = tc - mesh.rank("model") * vl
        inside = (idx >= 0) & (idx < vl)
        target = logits.gather(-1, idx.clamp(0, vl - 1)[..., None])[..., 0]
        target = comm.reduce_from(target * inside, mesh, "model")
        return (torch.log(sumexp) + m[..., 0] - target).sum()


def _ce_sum(h: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
            logits_chunk: int, mesh=None) -> torch.Tensor:
    """The summed CE over sequence chunks that backward recomputes; with a
    ``mesh``, ``head`` is this rank's ``tok_emb`` rows (vocab-parallel)."""
    n = h.shape[1]
    chunk = min(logits_chunk, n)
    if n % chunk:
        chunk = n                        # one shot, as the JAX package
    total = h.new_zeros((), dtype=torch.float32)
    for i in range(n // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        if mesh is None:
            total = total + checkpoint(_chunk_ce, h[:, sl], head,
                                       targets[:, sl], use_reentrant=False)
        else:
            total = total + checkpoint(_vocab_parallel_chunk_ce, h[:, sl],
                                       head, targets[:, sl], mesh,
                                       use_reentrant=False)
    return total


def chunked_softmax_ce(h: torch.Tensor, head: torch.Tensor,
                       targets: torch.Tensor,
                       logits_chunk: int = 2048) -> torch.Tensor:
    """Mean next-token CE from hidden states (B, N, d), head (d, vocab) and
    targets (B, N), without keeping the full (B, N, vocab) fp32 logits: the
    head matmul + softmax runs in sequence chunks that backward recomputes
    (``torch.utils.checkpoint``, as the JAX package's ``jax.checkpoint``)."""
    return (_ce_sum(h, head, targets, logits_chunk)
            / (targets.shape[0] * h.shape[1]))


def _global_mean(total: torch.Tensor, count: int, mesh) -> torch.Tensor:
    """total / count, the rank's sum made the global one under ``mesh``
    (summed over ``data`` and ``seq``; each rank backpropagates its own
    share)."""
    loss = total / count
    if mesh is not None:
        for axis in ("data", "seq"):
            loss = comm.reduce_from(loss, mesh, axis)
    return loss


def lm_loss(model: SpectreLM, tokens: torch.Tensor, *,
            generator: Optional[torch.Generator] = None,
            logits_chunk: int = 2048, mesh=None,
            pp_mesh=None) -> torch.Tensor:
    """Next-token cross entropy; tokens (B, N+1) int64 -> scalar mean nats.
    Dropout (train mode, dropout_p > 0) draws from ``generator``.  With
    ``mesh``/``pp_mesh`` tokens is the global batch, the model this rank's
    shard, and the loss the global mean on every rank."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    count = targets.numel()
    inputs, pos0 = local_batch(inputs, mesh)
    targets, _ = local_batch(targets, mesh)
    h = lm_hidden_local(model, inputs, generator=generator, mesh=mesh,
                        pp_mesh=pp_mesh, pos0=pos0)
    if mesh is not None and model.cfg.tie_embeddings:
        total = _ce_sum(h, model.tok_emb, targets, logits_chunk, mesh)
    else:
        total = _ce_sum(h, lm_head_matrix(model), targets, logits_chunk)
    return _global_mean(total, count, mesh)


def hybrid_loss(model: HybridLM, tokens: torch.Tensor, *,
                logits_chunk: int = 2048, cp_mesh=None) -> torch.Tensor:
    """Next-token cross entropy for the hybrid SPECTRE + SWA LM (config 5),
    tokens (B, N+1) -> scalar mean nats, through the chunked CE: at seq
    32k x 50k vocab the full fp32 logits would take 6.6 GB a batch row.
    With ``cp_mesh`` tokens is the global batch and the loss the global
    mean."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    count = targets.numel()
    inputs, pos0 = local_batch(inputs, cp_mesh)
    targets, _ = local_batch(targets, cp_mesh)
    h = hybrid_hidden_local(model, inputs, cp_mesh=cp_mesh, pos0=pos0)
    return _global_mean(_ce_sum(h, hybrid_head_matrix(model), targets,
                                logits_chunk), count, cp_mesh)


def classification_loss(model: ViT, images: torch.Tensor,
                        labels: torch.Tensor, *,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """Mean softmax cross entropy of the ViT's fp32 logits against integer
    labels (config 3).  In train mode the wavelet masks draw from
    ``generator``."""
    logits = vit_apply(model, images, generator=generator)
    return F.cross_entropy(logits, labels.long())


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: AdamW
    step: int
    generator: torch.Generator       # dropout masks (JAX: the rng key)


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def train_init(model: torch.nn.Module, tcfg: TrainConfig, seed: int = 0, *,
               deterministic: bool = False) -> TrainState:
    """Build ``model``'s optimizer and put it in train mode (dropout and
    the wavelet's draws on), or leave it in eval mode with
    ``deterministic`` (the hybrid's train step, JAX's
    ``deterministic=True``); the generator lives on the model's device,
    seeded with ``seed``."""
    model.train(not deterministic)
    generator = torch.Generator(device=_device(model)).manual_seed(seed)
    return TrainState(model=model,
                      optimizer=make_optimizer(tcfg, model.parameters()),
                      step=0, generator=generator)


def _optimizer_step(state: TrainState, loss_fn, mesh=None,
                    pp_mesh=None) -> dict:
    """Zero the gradients, backpropagate ``loss_fn()`` and update.  Returns
    {"loss", "grad_norm" (unclipped), "step"} as the JAX train steps'
    metrics; the parameter gradients stay in ``.grad`` (completed by
    ``sync_grads`` under ``mesh``).  Under a recording profiler the three
    phases are the spans ``train.forward``, ``train.backward`` and
    ``train.optimizer`` (``utils/prof.py::span``)."""
    params = state.optimizer.params
    for p in params:
        p.grad = None
    with span("train.forward"):
        loss = loss_fn()
    with span("train.backward"):
        loss.backward()
    with span("train.optimizer"):
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        norm = None
        if mesh is not None or pp_mesh is not None:
            names = {id(p): n for n, p in state.model.named_parameters()}
            named = [(names[id(p)], g) for p, g in zip(params, grads)]
            if mesh is not None:
                sync_grads(named, mesh)
            norm = global_grad_norm(named, mesh, pp_mesh)
        grad_norm = state.optimizer.step(grads, norm=norm)
    metrics = {"loss": loss.detach(), "grad_norm": grad_norm,
               "step": state.step}
    state.step += 1
    return metrics


def _tokens(state: TrainState, batch) -> torch.Tensor:
    return torch.as_tensor(batch).to(_device(state.model),
                                     dtype=torch.int64)


def train_step(state: TrainState, batch, *, mesh=None,
               pp_mesh=None) -> dict:
    """One optimizer step on an LM batch (B, N+1) of token ids (numpy or
    torch); see ``_optimizer_step``.  ``mesh`` (data, seq, model) and
    ``pp_mesh`` (stage): batch is the global one and the model this rank's
    shard; the pipeline runs deterministically (eval mode, no generator),
    as the JAX package's."""
    with span("train.step"):
        tokens = _tokens(state, batch)
        model = state.model
        if pp_mesh is None:
            return _optimizer_step(state, lambda: lm_loss(
                model, tokens, generator=state.generator, mesh=mesh), mesh)
        training = model.training
        model.eval()
        try:
            return _optimizer_step(state, lambda: lm_loss(
                model, tokens, mesh=mesh, pp_mesh=pp_mesh), mesh, pp_mesh)
        finally:
            model.train(training)


def hybrid_train_step(state: TrainState, batch, *, cp_mesh=None) -> dict:
    """One optimizer step on a hybrid-LM batch (B, N+1), deterministic as
    JAX's (``train_init(..., deterministic=True)``); with ``cp_mesh`` the
    global batch, context parallel (``models/hybrid.py``)."""
    with span("train.step"):
        tokens = _tokens(state, batch)
        return _optimizer_step(state, lambda: hybrid_loss(
            state.model, tokens, cp_mesh=cp_mesh), cp_mesh)


def vit_train_step(state: TrainState, images, labels) -> dict:
    """One optimizer step on a ViT batch: images (B, H, W, 3) float32 and
    labels (B,) integers (numpy or torch), the wavelet masks drawn from the
    state's generator, as ``cli train-vit``'s step."""
    dev = _device(state.model)
    images = torch.as_tensor(images).to(dev, dtype=torch.float32)
    labels = torch.as_tensor(labels).to(dev, dtype=torch.int64)
    return _optimizer_step(state, lambda: classification_loss(
        state.model, images, labels, generator=state.generator))
