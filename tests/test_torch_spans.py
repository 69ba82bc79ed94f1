"""The port's spans (``fft_tpu_torch/utils/prof.py::span`` and
``backward_span``) on the CPU, on a small LM and a small hybrid:

- with no profiler recording they change nothing: the same ops are
  dispatched as with the spans patched out (none of the profiler's), the
  same autograd graph is built, and losses and gradients are bitwise equal;
- under ``torch.profiler`` each span appears as often as its code runs
  (a block once in the forward and once in the remat's recompute; the
  forward spans not at all under ``no_grad``), inside its parent, as a
  ``user_annotation`` event of ``profile_trace``'s Chrome file;
- ``swa.attention.backward`` holds the attention's backward nodes and no
  LayerNorm's or MLP's.
"""

from __future__ import annotations

import collections
import contextlib
import json

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fft_tpu_torch.config import SpectreConfig
from fft_tpu_torch.decode import cache as dcache
from fft_tpu_torch.layers import attention, spectre
from fft_tpu_torch.models import lm as mlm
from fft_tpu_torch.models.hybrid import HybridConfig, hybrid_init
from fft_tpu_torch.models.lm import LMConfig, lm_init, lm_prefill
from fft_tpu_torch.train import loop
from fft_tpu_torch.utils.prof import SPAN_PREFIX, profile_trace

SEQ, VOCAB, LAYERS = 128, 64, 2
SPAN_MODULES = (loop, spectre, attention, mlm, dcache)


def _block() -> SpectreConfig:
    return SpectreConfig(embed_dim=64, num_heads=4, n_fft=SEQ,
                         pooling_type="mean", wavelet_on_rate=0.0,
                         causal=True, causal_chunk=32)


def _lm():
    cfg = LMConfig(vocab_size=VOCAB, num_layers=LAYERS, block=_block(),
                   max_seq=SEQ, remat=True)
    return lm_init(cfg, torch.Generator().manual_seed(0), device="cpu")


def _hybrid():
    cfg = HybridConfig(vocab_size=VOCAB, num_groups=LAYERS,
                       spectre_per_group=1, block=_block(), attn_heads=4,
                       attn_window=32, max_seq=SEQ, remat=True)
    return hybrid_init(cfg, torch.Generator().manual_seed(0), device="cpu")


MODELS = {"lm": (_lm, loop.train_step, loop.lm_loss, False),
          "hybrid": (_hybrid, loop.hybrid_train_step, loop.hybrid_loss,
                     True)}


def _tokens(seed: int = 1) -> torch.Tensor:
    return torch.randint(0, VOCAB, (2, SEQ + 1),
                         generator=torch.Generator().manual_seed(seed))


class _Ops(TorchDispatchMode):
    """The names of the ops dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _graph_nodes(t: torch.Tensor) -> int:
    seen, todo = set(), [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(n for n, _ in node.next_functions)
    return len(seen)


def _run(which: str) -> dict:
    make, step, loss_fn, deterministic = MODELS[which]
    model = make()
    nodes = _graph_nodes(loss_fn(model, _tokens()))
    state = loop.train_init(model, loop.TrainConfig(), seed=3,
                            deterministic=deterministic)
    with _Ops() as rec:
        loss = step(state, _tokens())["loss"]
    return {"nodes": nodes, "ops": rec.ops, "loss": loss,
            "grads": [p.grad for p in model.parameters()]}


@pytest.mark.parametrize("which", sorted(MODELS))
def test_spans_without_a_profiler_change_nothing(which, monkeypatch):
    with_spans = _run(which)
    for mod in SPAN_MODULES:
        for helper in ("span", "forward_span"):
            if hasattr(mod, helper):
                monkeypatch.setattr(mod, helper,
                                    lambda name: contextlib.nullcontext())
    monkeypatch.setattr(attention, "backward_span",
                        lambda name, fn, x: fn(x))
    without = _run(which)
    assert not [op for op in with_spans["ops"] if op.startswith("profiler")]
    assert with_spans["ops"] == without["ops"]
    assert with_spans["nodes"] == without["nodes"]
    assert torch.equal(with_spans["loss"], without["loss"])
    for a, b in zip(with_spans["grads"], without["grads"]):
        assert (a is None and b is None) or torch.equal(a, b)


def _traced(tmp_path, fn) -> list:
    """The complete events of ``profile_trace``'s Chrome file over fn()."""
    with profile_trace(tmp_path, device="cpu") as path:
        fn()
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X"]


def _spans(events) -> dict:
    """{span name without the prefix: [(tid, start, end)]}; each is a
    user_annotation."""
    out = collections.defaultdict(list)
    for e in events:
        if e["name"].startswith(SPAN_PREFIX):
            assert e["cat"] == "user_annotation"
            out[e["name"][len(SPAN_PREFIX):]].append(
                (e["tid"], e["ts"], e["ts"] + e["dur"]))
    return out


def _inside(child, parents) -> bool:
    tid, s, e = child
    return any(t == tid and ps <= s and e <= pe for t, ps, pe in parents)


def _count_in(spans, name, parent) -> int:
    return sum(_inside(c, spans[parent]) for c in spans[name])


def test_train_step_spans_nest_with_the_recompute_in_backward(tmp_path):
    model = _lm()
    state = loop.train_init(model, loop.TrainConfig(), seed=3)
    spans = _spans(_traced(tmp_path, lambda: loop.train_step(state,
                                                             _tokens())))
    for name in ("train.step", "train.forward", "train.backward",
                 "train.optimizer"):
        assert len(spans[name]) == 1, name
    for name in ("train.forward", "train.backward", "train.optimizer"):
        assert _count_in(spans, name, "train.step") == 1
    # one chunk of the CE: its forward and its recompute
    for name, per_pass in (("spectre.block", LAYERS),
                           ("spectre.gates", LAYERS), ("head_ce", 1)):
        assert len(spans[name]) == 2 * per_pass, name
        assert _count_in(spans, name, "train.forward") == per_pass
        assert _count_in(spans, name, "train.backward") == per_pass
    assert _count_in(spans, "spectre.gates", "spectre.block") == 2 * LAYERS
    assert "swa.attention.backward" not in spans


def test_prefill_spans_one_cache_build_a_layer(tmp_path):
    model = _lm()
    spans = _spans(_traced(tmp_path, lambda: lm_prefill(
        model, _tokens()[:, :SEQ])))
    assert len(spans["prefill"]) == 1
    assert len(spans["prefill.cache"]) == LAYERS
    assert _count_in(spans, "prefill.cache", "prefill") == LAYERS
    # the forward spans split training steps: none under no_grad
    assert set(spans) == {"prefill", "prefill.cache"}


BACKWARD_OF = {"SoftmaxBackward0", "BmmBackward0", "MmBackward0"}
NOT_ATTENTION = ("LayerNorm", "Gelu", "AddmmBackward0")


def test_swa_backward_span_holds_the_attention_backward_alone(tmp_path):
    model = _hybrid()
    state = loop.train_init(model, loop.TrainConfig(), seed=3,
                            deterministic=True)
    events = _traced(tmp_path, lambda: loop.hybrid_train_step(state,
                                                              _tokens()))
    spans = _spans(events)
    assert len(spans["swa.block"]) == 2 * LAYERS          # with the recompute
    assert _count_in(spans, "swa.attention", "swa.block") == 2 * LAYERS
    bwd = spans["swa.attention.backward"]
    assert len(bwd) == LAYERS
    assert _count_in(spans, "swa.attention.backward",
                     "train.backward") == LAYERS
    ops = [e for e in events if e["cat"] == "cpu_op"]
    for tid, s, e in bwd:
        inside = {o["name"] for o in ops
                  if o["tid"] == tid and s <= o["ts"] <= e}
        assert BACKWARD_OF <= inside
        assert "torch::autograd::AccumulateGrad" in inside
        assert not [n for n in inside if any(k in n for k in NOT_ATTENTION)]
    # the ops between the two markers' backward calls are the attention's
    every = {o["name"] for o in ops if "Backward" in o["name"]}
    assert {"NativeLayerNormBackward0", "GeluBackward0"} <= every
