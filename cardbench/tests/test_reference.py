"""The plain reference against the program's plain path (its CPU
versions of the kernels), in float32 at tiny sizes: logits of both models,
the first training steps' readings, and a prefill's logits and caches."""

from __future__ import annotations

import json

import pytest
import torch

from cardbench import program, weights
from cardbench.loops import prefill as dprefill
from cardbench.loops import train as dtrain
from cardbench.reference import model as ref
from cardbench.reference import train as rtrain
from cardbench.tests.conftest import REPO, TINY
from fft_tpu_torch.models.hybrid import hybrid_apply
from fft_tpu_torch.models.lm import lm_apply, lm_prefill

# several layers of FFT round trips in float32
TOL = 1e-5


def tiny(model: str) -> dict:
    name = {"spectre_lm": "spectre350m-32k-bf16",
            "hybrid_lm": "hybrid1b-32k-bf16"}[model]
    cfg = json.loads((REPO / f"cardbench/configs/{name}.json").read_text())
    cfg = dict(cfg, num_layers=2, layer_groups=2, attn_heads=4,
               attn_window=32, compute_dtype="float32", **TINY)
    return cfg


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("model", ["spectre_lm", "hybrid_lm"])
def test_logits(model):
    cfg = tiny(model)
    net = program.build(cfg, 11, "cpu")
    p = weights.draw(cfg, 11, "cpu")
    tok = torch.randint(0, cfg["vocab_size"], (2, 256),
                        generator=torch.Generator().manual_seed(1))
    apply = lm_apply if model == "spectre_lm" else hybrid_apply
    with torch.no_grad():
        want = ref.logits(p, ref.hidden(p, tok, cfg, ref.ROUNDERS["float32"]),
                          ref.ROUNDERS["float32"])
    assert rel(apply(net, tok), want) < TOL


def test_partial_chunk_lengths():
    """Prompts shorter than the window: the chunk and the kernel's lags
    are cut to the prompt."""
    cfg = tiny("spectre_lm")
    net = program.build(cfg, 3, "cpu")
    p = weights.draw(cfg, 3, "cpu")
    for n in (64, 128, 192):
        tok = torch.randint(0, cfg["vocab_size"], (1, n),
                            generator=torch.Generator().manual_seed(n))
        with torch.no_grad():
            want = ref.logits(p, ref.hidden(p, tok, cfg, ref._exact),
                              ref._exact)
        assert rel(lm_apply(net, tok), want) < TOL


@pytest.mark.parametrize("model", ["spectre_lm", "hybrid_lm"])
def test_first_steps(model):
    cfg = tiny(model)
    traffic = json.loads((REPO / "cardbench/traffic/train-b4-32k.json")
                         .read_text())
    traffic = dict(traffic, batch=2, seq=256)
    run = dtrain.Run(cfg, traffic, 7, "cpu")
    run.setup()
    got = run.readings
    run.free()
    want = run.reference("float32")
    for a, b in zip(got["loss"], want["loss"]):
        assert abs(a - b) < 1e-5 * b
    for k, g in want["grad"].items():
        assert abs(got["grad"][k] - g) <= 1e-4 * g + 1e-9, k
    moving = [k for k, g in want["grad"].items() if g > 0]
    for k in moving:
        c = want["change"][k]
        assert abs(got["change"][k] - c) <= 1e-4 * c, k
    assert dtrain.compare(got, want)["change_gap"] < 1e-4


def test_reference_adamw_is_the_programs():
    """One update of the reference's AdamW against the program's on the
    same gradients (clip, warmup, bias corrections, weight decay)."""
    from fft_tpu_torch.train.loop import AdamW, TrainConfig

    traffic = json.loads((REPO / "cardbench/traffic/train-b4-32k.json")
                         .read_text())
    opt = dict(traffic["optimizer"], warmup_steps=2)
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(5, 3, generator=gen),
              "b": torch.randn(7, generator=gen)}
    grads = [{k: 3 * torch.randn(v.shape, generator=gen)
              for k, v in params.items()} for _ in range(3)]
    mine = {k: v.clone() for k, v in params.items()}
    theirs = [torch.nn.Parameter(v.clone()) for v in params.values()]
    tcfg = TrainConfig(**{k: opt[k] for k in (
        "learning_rate", "weight_decay", "beta1", "beta2", "warmup_steps",
        "total_steps", "grad_clip", "min_lr_ratio")})
    adam, radam = AdamW(theirs, tcfg), rtrain.AdamW(mine, opt)
    for g in grads:
        adam.step([g[k] for k in params])
        for k, v in mine.items():
            v.grad = g[k]
        radam.step(mine)
    for p, v in zip(theirs, mine.values()):
        torch.testing.assert_close(p.detach(), v, rtol=1e-6, atol=1e-7)


def test_prefill_caches():
    cfg = tiny("spectre_lm")
    net = program.build(cfg, 5, "cpu")
    p = weights.draw(cfg, 5, "cpu")
    tok = torch.randint(0, cfg["vocab_size"], (1, 192),
                        generator=torch.Generator().manual_seed(2))
    logits, caches = lm_prefill(net, tok)
    bins, pos = list(range(0, 129, 8)), list(range(0, 192, 5)) + [191]
    pick = dprefill._picker(bins, pos)
    want_logits, want = ref.prefill(p, tok, cfg, ref._exact, pick)
    assert rel(logits, want_logits) < TOL
    for i, c in enumerate(caches):
        assert c.t == 191
        for k, t in pick(i, c).items():
            assert rel(t, want[i][k]) < TOL, (i, k)


def test_control_rounds_to_fp8():
    x = torch.linspace(-3, 5, 101)
    y = ref.ROUNDERS["float8"](x)
    # 3 bits of mantissa: half a spacing is at most 2^-4 of the value
    assert bool(((x - y).abs() <= x.abs() * 2 ** -4 + 1e-6).all())
    assert float((x - y).abs().max()) > 0.01
    assert torch.equal(ref.ROUNDERS["float32"](x), x)
