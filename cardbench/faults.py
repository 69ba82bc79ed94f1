"""Faults planted under the timed path, to show that the check catches
them (``cardbench/tests/test_faults.py`` on the CPU; ``cardbench.calibrate``
reads them on the card at a cell's own size).  Each is a context manager
that patches the program while it is open.

- ``state_unchanged``: the optimizer step returns with the parameters and
  its moments as they were;
- ``leaf_dropped``: the update of one parameter (the first, the token
  embedding) is undone after each step: a leaf the reference moves is
  left unmoved;
- ``half_batch``: the train step sees half the batch, its rows (or, for a
  batch of one row, its positions) after the first half left out, and
  takes the mean over the rest;
- ``token_altered``: each prompt reaches the prefill with its last token
  changed.
"""

from __future__ import annotations

import contextlib

import torch

from fft_tpu_torch.train import loop


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def state_unchanged():
    def step(self, grads, norm=None):
        return loop.global_norm([torch.zeros_like(p) if g is None else g
                                 for p, g in zip(self.params, grads)])
    return _patched(loop.AdamW, "step", step)


def leaf_dropped():
    real = loop.AdamW.step

    def step(self, grads, norm=None):
        leaf = self.params[0]
        keep = leaf.detach().clone()
        out = real(self, grads, norm)
        with torch.no_grad():
            leaf.copy_(keep)
        return out
    return _patched(loop.AdamW, "step", step)


def half_batch():
    real = loop._tokens

    def tokens(state, batch):
        t = real(state, batch)
        if t.shape[0] > 1:
            return t[:t.shape[0] // 2]
        return t[:, :t.shape[1] // 2 + 1]
    return _patched(loop, "_tokens", tokens)


def token_altered():
    from cardbench.loops import prefill

    def request(self, i):
        tok = self.prompts.prompt(i).clone()
        tok[:, -1] = (tok[:, -1] + 1) % self.cfg["vocab_size"]
        return prefill.lm_prefill(self.model, tok)
    return _patched(prefill.Run, "request", request)


FAULTS = {"state_unchanged": state_unchanged, "leaf_dropped": leaf_dropped,
          "half_batch": half_batch, "token_altered": token_altered}
# the faults each traffic kind can have
BY_KIND = {"train": ("state_unchanged", "leaf_dropped", "half_batch"),
           "prefill": ("token_altered",)}
