"""Weights drawn from the seed, on the device, in a few large calls.

Every parameter of a configuration (``reference.model.param_spec``) takes
its slice of one uniform and one normal draw from a generator on the
device, scaled by its init; the same seed gives the same weights to the
program and to the reference."""

from __future__ import annotations

import math

import torch

from cardbench.reference.model import param_spec

# what each draw of a run is for: its generator's seed is derived from the
# run's seed and this stream number, so two draws never share a stream
WEIGHTS, TOKENS, SAMPLE = 1, 2, 3


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for ``stream`` of a run's ``seed``."""
    return (int(seed) * 1_000_003 + stream * 7_919) % (2 ** 63 - 1)


def draw(cfg: dict, seed: int, device) -> dict:
    """{name: float32 tensor} of every parameter of ``cfg``."""
    spec = param_spec(cfg)
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, WEIGHTS))
    sizes = {kind: sum(math.prod(s) for _, s, (k, _) in spec if k == kind)
             for kind in ("uniform", "normal")}
    flat = {"uniform": torch.rand(sizes["uniform"], generator=gen,
                                  device=device).mul_(2.0).sub_(1.0),
            "normal": torch.randn(sizes["normal"], generator=gen,
                                  device=device)}
    at = {"uniform": 0, "normal": 0}
    out = {}
    for name, shape, (kind, value) in spec:
        if kind == "const":
            out[name] = torch.full(shape, value, device=device)
            continue
        n = math.prod(shape)
        out[name] = flat[kind][at[kind]:at[kind] + n].view(shape) * value
        at[kind] += n
    return out


@torch.no_grad()
def load(module: torch.nn.Module, weights: dict) -> None:
    """Copy ``weights`` into the module's parameters of the same names;
    raises if the two sets of names or shapes differ."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise ValueError(
            f"the program's parameters and the configuration's differ: "
            f"only the program's {sorted(set(params) - set(weights))[:5]}, "
            f"only the configuration's "
            f"{sorted(set(weights) - set(params))[:5]}")
    for name, p in params.items():
        p.copy_(weights[name])
