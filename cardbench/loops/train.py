"""Training traffic: a closed loop of the program's train step on a
``TrainState`` (``train_step`` for the SPECTRE LM, ``hybrid_train_step``
for the hybrid), one new batch a step, nothing synchronised between the
window's ends.

Set-up builds the one state the window uses and drives it through the
first ``checked_steps`` steps with the window's own call and feed; what the
check compares is read from those steps: each step's loss, each leaf's
norm of the first gradient as AdamW took it (its first moment after one
step over 1 - beta1), and each leaf's norm of the change of the parameters
after the last of them (against the weights drawn again from the seed).
"""

from __future__ import annotations

import gc
import statistics
import time

import torch

from cardbench import program, weights
from cardbench.reference import train as rtrain
from cardbench.traffic import TrainBatches
from fft_tpu_torch.train.loop import (
    TrainConfig, hybrid_train_step, train_init, train_step,
)

STEPS = {"spectre_lm": train_step, "hybrid_lm": hybrid_train_step}

# leaves whose reference gradient is under this share of the median leaf's
# move by round-off alone under AdamW: left out of the change compared
STILL = 1e-3


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.batches = TrainBatches(traffic, cfg, seed, self.device)
        self.tokens_per_step = traffic["batch"] * traffic["seq"]

    def setup(self) -> None:
        opt = self.traffic["optimizer"]
        self.model = program.build(self.cfg, self.seed, self.device)
        tcfg = TrainConfig(**{k: opt[k] for k in (
            "learning_rate", "weight_decay", "beta1", "beta2",
            "warmup_steps", "total_steps", "grad_clip", "min_lr_ratio")})
        self.state = train_init(
            self.model, tcfg, seed=self.seed % (2 ** 63),
            deterministic=self.cfg["model"] == "hybrid_lm")
        self.step_fn = STEPS[self.cfg["model"]]
        names = [n for n, _ in self.model.named_parameters()]
        losses, first = [], None
        for i in range(self.traffic["checked_steps"]):
            losses.append(self.step(i)["loss"])
            if first is None:
                first = torch._foreach_norm(self.state.optimizer.mu)
        start = weights.draw(self.cfg, self.seed, self.device)
        with torch.no_grad():
            change = [torch.linalg.vector_norm(p - start[n])
                      for n, p in self.model.named_parameters()]
        del start
        scale = 1.0 / (1.0 - opt["beta1"])
        self.readings = {
            "loss": [float(x) for x in losses],
            "grad": {n: float(g) * scale for n, g in zip(names, first)},
            "change": {n: float(c) for n, c in zip(names, change)}}
        self.next = self.traffic["checked_steps"]
        _sync(self.device)

    def step(self, i: int) -> dict:
        out = self.step_fn(self.state, self.batches[i])
        self.batches.drop(i)
        return out

    def window(self, seconds: float) -> dict:
        """Steps back to back for ``seconds``; the host's clock read at the
        window's start and after the last step has finished."""
        losses = []
        _sync(self.device)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            losses.append(self.step(self.next)["loss"])
            self.next += 1
        _sync(self.device)
        elapsed = time.perf_counter() - t0
        vals = torch.stack(losses).float()
        steps = len(losses)
        return {"attempted": steps,
                "failed": int((~torch.isfinite(vals)).sum()),
                "seconds": elapsed, "steps": steps,
                "tokens": steps * self.tokens_per_step,
                "metrics": {"train_tokens_per_s":
                            steps * self.tokens_per_step / elapsed}}

    def traced(self) -> dict:
        """The profiled steps, after the window."""
        n = self.traffic["traced_steps"]
        for _ in range(n):
            self.step(self.next)
            self.next += 1
        return {"steps": n}

    def free(self) -> None:
        del self.state, self.model, self.step_fn
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "float32") -> dict:
        """The reference's readings of the same steps on the same weights
        and batches."""
        params = weights.draw(self.cfg, self.seed, self.device)
        batches = [self.batches[i]
                   for i in range(self.traffic["checked_steps"])]
        out = rtrain.first_steps(params, batches, self.cfg,
                                 self.traffic["optimizer"], precision)
        for i in range(len(batches)):
            self.batches.drop(i)
        return out


def compare(got: dict, ref: dict) -> dict:
    """The numbers the check holds against their limits:

    - ``loss_gap``: the largest gap, in nats, between a step's loss and the
      reference's;
    - ``grad_gap``: over the leaves, the largest gap between the norm of a
      leaf's first gradient and the reference's, over the larger of the
      reference's norm of that leaf and of the median leaf;
    - ``change_gap``: the same for the change of the parameters after the
      steps, over the leaves whose reference gradient is at least
      ``STILL`` times the median leaf's."""
    g_ref = ref["grad"]
    med_g = statistics.median(g_ref.values())
    moving = [k for k in g_ref if g_ref[k] >= STILL * med_g]
    med_c = statistics.median(ref["change"][k] for k in moving)
    return {
        "loss_gap": max(abs(a - b) for a, b in zip(got["loss"],
                                                   ref["loss"])),
        "grad_gap": max(abs(got["grad"][k] - g) / max(g, med_g)
                        for k, g in g_ref.items()),
        "change_gap": max(abs(got["change"][k] - ref["change"][k])
                          / max(ref["change"][k], med_c) for k in moving)}
