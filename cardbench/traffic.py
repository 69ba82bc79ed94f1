"""The one generator of the benchmark's traffic: token batches and prompts
drawn from the seed, as a traffic file of ``cardbench/traffic`` sets them.

A traffic file is data: its ``kind`` names the loop that drives the
program (``cardbench/loops/<kind>.py``), the rest its parameters.

- ``train``: ``batch`` rows of ``seq`` + 1 token ids a step, uniform over
  the vocabulary, every step's rows new; the first ``checked_steps`` steps
  are the ones the check compares, ``traced_steps`` more are profiled in a
  traced run; ``optimizer`` holds AdamW's settings.
- ``prefill``: one client in a closed loop, a prompt of ``batch`` rows a
  request; the lengths run through ``lengths`` (from, to, step), each block
  of requests a new order of all of them, so that every seed sends the
  same sizes; each prompt is a run of a pool of ``token_pool`` seeded
  token ids at a seeded offset; the check compares ``sample`` requests
  drawn from the first ``sample_from_first`` and the first longest.
"""

from __future__ import annotations

import torch

from cardbench.weights import SAMPLE, TOKENS, stream_seed


class TrainBatches:
    """Batch i of a run, drawn on the device from the seed the first time
    it is asked for; the same (seed, i) gives the same tokens."""

    def __init__(self, traffic: dict, cfg: dict, seed: int, device):
        self.shape = (traffic["batch"], traffic["seq"] + 1)
        self.vocab = cfg["vocab_size"]
        self.seed = stream_seed(seed, TOKENS)
        self.device = device
        self._made = {}

    def __getitem__(self, i: int) -> torch.Tensor:
        if i not in self._made:
            gen = torch.Generator(device=self.device).manual_seed(
                (self.seed + 104_729 * i) % (2 ** 63 - 1))
            self._made[i] = torch.randint(0, self.vocab, self.shape,
                                          generator=gen, device=self.device)
        return self._made[i]

    def drop(self, i: int) -> None:
        self._made.pop(i, None)


class Prompts:
    """The prompts of a prefill run: request i has ``lengths[i]`` tokens,
    ``prompt(i)`` its (batch, L) ids; ``sample`` the requests compared."""

    def __init__(self, traffic: dict, cfg: dict, seed: int, device,
                 count: int = 4096):
        lo, hi, step = (traffic["lengths"][k] for k in ("from", "to", "step"))
        sizes = list(range(lo, hi + 1, step))
        gen = torch.Generator().manual_seed(stream_seed(seed, SAMPLE))
        self.lengths = []
        while len(self.lengths) < count:
            self.lengths += [sizes[j] for j in torch.randperm(
                len(sizes), generator=gen).tolist()]
        pool = traffic["token_pool"]
        if pool < hi:
            raise ValueError(f"token_pool {pool} is shorter than a prompt")
        self.offsets = [int(torch.randint(0, pool - n + 1, (), generator=gen))
                        for n in self.lengths]
        first = traffic["sample_from_first"]
        picked = set(torch.randperm(first, generator=gen)[
            :traffic["sample"]].tolist())
        picked.add(self.lengths.index(hi))
        self.sample = sorted(picked)
        self.sizes = sizes
        self.batch = traffic["batch"]
        self.pool = torch.randint(
            0, cfg["vocab_size"], (self.batch, pool), device=device,
            generator=torch.Generator(device=device).manual_seed(
                stream_seed(seed, TOKENS)))
        self.seed = seed

    def prompt(self, i: int) -> torch.Tensor:
        off = self.offsets[i]
        return self.pool[:, off:off + self.lengths[i]]

    def picks(self, i: int, n_fft: int, count: int = 64) -> tuple:
        """(bins, positions) of request i's caches that the check reads:
        ``count`` of each, seeded, with the first and the last."""
        gen = torch.Generator().manual_seed(
            stream_seed(self.seed, SAMPLE) + i + 1)
        f_half, n = n_fft // 2 + 1, self.lengths[i]

        def pick(total):
            k = min(count, total)
            got = set(torch.randperm(total, generator=gen)[:k - 2].tolist())
            return sorted(got | {0, total - 1})

        return pick(f_half), pick(n)
