"""The reference's training steps: the mean next-token cross entropy, its
gradients one batch row at a time, and AdamW as the configuration states
it (optax's chain of a global-norm clip and adamw, with a linear warmup
from 0 and a cosine decay).

``first_steps`` runs the steps that the check compares and returns what it
reads: each step's loss, each leaf's norm of the first gradient as AdamW
takes it (after the clip), and each leaf's norm of the change of the
parameters after the last step.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cardbench.reference import model as ref

CE_CHUNK = 2048


def _ce_sum(h, emb, targets, rnd):
    lg = ref.logits({"tok_emb": emb}, h, rnd).float()
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]), targets.reshape(-1),
                           reduction="sum")


def backward_row(params: dict, row: torch.Tensor, cfg: dict, rnd,
                 count: int) -> float:
    """Add the gradient of (sum of this row's token losses) / ``count`` to
    the parameters' ``.grad``; returns that share of the loss."""
    inputs, targets = row[None, :-1], row[None, 1:]
    n = inputs.shape[1]
    h = ref.hidden(params, inputs, cfg, rnd, remat=True)
    total = h.new_zeros((), dtype=torch.float32)
    for s in range(0, n, CE_CHUNK):
        total = total + checkpoint(_ce_sum, h[:, s:s + CE_CHUNK],
                                   params["tok_emb"],
                                   targets[:, s:s + CE_CHUNK], rnd,
                                   use_reentrant=False)
    share = total / count
    share.backward()
    return float(share.detach())


def schedule(opt: dict, count: int) -> float:
    """The learning rate at update ``count`` (0 for the first)."""
    peak, warm = opt["learning_rate"], opt["warmup_steps"]
    if count < warm:
        return peak * count / warm
    decay = max(opt["total_steps"], warm + 1) - warm
    t = min(count - warm, decay)
    alpha = opt["min_lr_ratio"]
    return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay))
                   + alpha)


class AdamW:
    """Clip the gradient to global norm ``grad_clip``, then
    mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2,
    p -= lr(k - 1) (mu / (1 - b1^k) / (sqrt(nu / (1 - b2^k)) + eps)
    + wd p), at the k-th update."""

    def __init__(self, params: dict, opt: dict):
        self.opt = opt
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: dict) -> dict:
        """Update ``params`` in place from their ``.grad``; returns the
        clipped gradients."""
        o = self.opt
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
        norm = math.sqrt(sum(float(g.double().pow(2).sum())
                             for g in grads.values()))
        if o["grad_clip"] is not None and norm >= o["grad_clip"]:
            grads = {k: g * (o["grad_clip"] / norm) for k, g in grads.items()}
        lr = schedule(o, self.count)
        self.count += 1
        bc1 = 1 - o["beta1"] ** self.count
        bc2 = 1 - o["beta2"] ** self.count
        for k, p in params.items():
            g = grads[k]
            self.mu[k].mul_(o["beta1"]).add_(g, alpha=1 - o["beta1"])
            self.nu[k].mul_(o["beta2"]).addcmul_(g, g, value=1 - o["beta2"])
            u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2)
                                      + o["eps"]) + o["weight_decay"] * p
            p.add_(u, alpha=-lr)
        return grads


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(t.double()))
            for k, t in tensors.items()}


def first_steps(params: dict, batches: list, cfg: dict, opt: dict,
                precision: str = "float32") -> dict:
    """Train ``params`` (float32 leaves, changed in place) on ``batches``,
    one (B, N + 1) batch of token ids a step.  Returns {"loss": [each
    step's loss], "grad": {leaf: norm of the clipped first gradient},
    "change": {leaf: norm of its change after the last step}}."""
    rnd = ref.ROUNDERS[precision]
    start = {k: v.detach().clone() for k, v in params.items()}
    for v in params.values():
        v.requires_grad_(True)
    adam = AdamW(params, opt)
    losses, first = [], None
    for batch in batches:
        for v in params.values():
            v.grad = None
        count = batch.shape[0] * (batch.shape[1] - 1)
        losses.append(sum(backward_row(params, row, cfg, rnd, count)
                          for row in batch))
        grads = adam.step(params)
        if first is None:
            first = leaf_norms(grads)
        del grads
    change = {k: float(torch.linalg.vector_norm((v.detach() - start[k])
                                                .double()))
              for k, v in params.items()}
    for v in params.values():
        v.grad = None
        v.requires_grad_(False)
    return {"loss": losses, "grad": first, "change": change}
