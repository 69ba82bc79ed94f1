"""Prefill traffic: one client in a closed loop calls the program's
``lm_prefill`` on one prompt at a time; a request ends when its logits and
every layer's decode cache are ready on the card (a synchronise).

The check compares the sampled requests' answers as the window produced
them: the last position's logits whole, and of every layer's cache a
seeded sample of the prefix spectrum's bins and of the ring buffers'
positions, the query sum whole and the position count.
"""

from __future__ import annotations

import gc
import statistics
import time

import torch

from cardbench import program, weights
from cardbench.reference import model as ref
from cardbench.traffic import Prompts
from fft_tpu_torch.models.lm import lm_prefill


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _picker(bins, pos):
    def pick(_layer, cache):
        get = cache.get if isinstance(cache, dict) else \
            (lambda k: getattr(cache, k))
        return {"prefix": get("prefix")[:, :, bins].clone(),
                "v_buf": get("v_buf")[:, :, pos].clone(),
                "q_buf": get("q_buf")[:, :, pos].clone(),
                "sum_q": get("sum_q").clone()}
    return pick


class Run:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.prompts = Prompts(traffic, cfg, seed, self.device)

    def setup(self) -> None:
        self.model = program.build(self.cfg, self.seed, self.device)
        for n in self.prompts.sizes:            # each length once
            lm_prefill(self.model, self.prompts.pool[:, :n])
        self.next = 0
        self.answers = {}
        _sync(self.device)

    def request(self, i: int):
        return lm_prefill(self.model, self.prompts.prompt(i))

    def window(self, seconds: float) -> dict:
        sample = set(self.prompts.sample)
        latencies, tokens = [], 0
        _sync(self.device)
        t0 = end = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            i = self.next
            start = time.perf_counter()
            logits, caches = self.request(i)
            _sync(self.device)
            end = time.perf_counter()
            latencies.append(end - start)
            tokens += self.prompts.lengths[i] * self.prompts.batch
            if i in sample:
                self.answers[i] = self.digest(i, logits, caches)
            del logits, caches
            self.next += 1
        elapsed = end - t0
        lat = sorted(latencies)
        p95 = (statistics.quantiles(lat, n=20, method="inclusive")[18]
               if len(lat) > 1 else lat[0])
        return {"attempted": len(lat), "failed": 0, "seconds": elapsed,
                "requests": len(lat), "tokens": tokens,
                "lengths": self.prompts.lengths[:len(lat)],
                "metrics": {"prefill_tokens_per_s": tokens / elapsed,
                            "prefill_ms_p95": p95 * 1e3}}

    def digest(self, i: int, logits, caches) -> dict:
        bins, pos = self.prompts.picks(i, self.cfg["n_fft"])
        pick = _picker(bins, pos)
        return {"logits": logits.float().clone(),
                "t": [c.t for c in caches],
                "caches": [pick(j, c) for j, c in enumerate(caches)]}

    def traced(self) -> dict:
        n = self.traffic["traced_requests"]
        lengths = self.prompts.lengths[self.next:self.next + n]
        for _ in range(n):
            self.request(self.next)
            self.next += 1
        return {"requests": n, "lengths": lengths}

    def free(self) -> None:
        del self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @property
    def readings(self) -> dict:
        return self.answers

    def reference(self, precision: str = "float32") -> dict:
        """The reference's answers to the requests that were compared."""
        params = weights.draw(self.cfg, self.seed, self.device)
        rnd = ref.ROUNDERS[precision]
        out = {}
        for i in self.answers:
            bins, pos = self.prompts.picks(i, self.cfg["n_fft"])
            logits, caches = ref.prefill(params, self.prompts.prompt(i),
                                         self.cfg, rnd, _picker(bins, pos))
            out[i] = {"logits": logits,
                      "t": [self.prompts.lengths[i] - 1] * len(caches),
                      "caches": caches}
        return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max())


def compare(got: dict, want: dict) -> dict:
    """The numbers the check holds against their limits, over the requests
    compared (every one the reference answered must have an answer):

    - ``logits_rel``: the largest max |a - b| / max |b| of a request's
      logits against the reference's;
    - ``token_gap``: the widest gap by which the logit, in the reference,
      of the token the program puts first lies below the reference's best;
    - ``cache_rel``: the largest max |a - b| / max |b| of a layer's cache
      tensor (sampled), or infinity where a cache's position count is
      wrong."""
    if not want or set(want) - set(got):
        return {"logits_rel": float("inf"), "token_gap": float("inf"),
                "cache_rel": float("inf")}
    logits_rel = token_gap = cache_rel = 0.0
    for i, w in want.items():
        g = got[i]
        logits_rel = max(logits_rel, _rel(g["logits"], w["logits"]))
        top = g["logits"].argmax(dim=-1, keepdim=True)
        token_gap = max(token_gap, float(
            (w["logits"].max(dim=-1).values
             - w["logits"].gather(-1, top)[:, 0]).max()))
        if g["t"] != w["t"]:
            cache_rel = float("inf")
        for gc_, wc in zip(g["caches"], w["caches"]):
            for k, t in wc.items():
                cache_rel = max(cache_rel, _rel(gc_[k], t))
    return {"logits_rel": logits_rel, "token_gap": token_gap,
            "cache_rel": cache_rel}
