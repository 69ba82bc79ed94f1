"""Model operations of a training step and of a prefill, from a
configuration's shapes (2 operations a multiply-add), for ``mfu.*``.

Forward, per row of n tokens:

- SPECTRE layer: the per-head projections q and v, 4 d hd a token; the
  output projection 2 d^2 and the MLP 4 r d^2 a token; per chunk, the gate
  MLP 2 H (hd d_gate + d_gate 2 G K) and the cubic interpolation of the
  anchors, 4 taps a bin, 16 H G F; the causal mix as the FFT-equivalent
  operations of the frozen work models: the gate kernels' inverse FFTs of
  n_fft points (H G nc lanes), #9's segment FFTs and #7's mix;
- sliding-window attention layer: the four projections 8 d^2 a token, the
  MLP 4 r d^2, and the banded score and value products that the window
  needs, 4 d a (query, key) pair, sum_t min(t + 1, W) pairs;
- head: 2 d V a token in training; at the last position only in a prefill,
  as the program computes it.

A training step counts its products three times (forward and backward)
and the causal mix's transforms once forward (the gate kernels' FFTs, #9,
#7) and once backward (their adjoints: the same FFTs, #9 again and #11).
The recomputed forward of the remat is not counted.  A prefill adds the
cache build: the projections q and v again in fp32 (4 d hd a token) and
the rFFT of v over n_fft points, d channels.  LayerNorms, softmax, the
embedding and elementwise work are not counted.
"""

from __future__ import annotations

from cardbench.reference.model import buckets, layers
from cardbench.workmodels import causal
from cardbench.workmodels.causal import fft_ops


def _spectre_parts(cfg: dict, n: int) -> tuple:
    """(product operations, forward transform operations, backward
    transform operations) of one SPECTRE layer over one row of n tokens."""
    d, h = cfg["embed_dim"], cfg["num_heads"]
    hd, g = d // h, cfg["gate_groups"]
    chunk = min(cfg["causal_chunk"], n)
    nc = n // chunk
    f_half = cfg["n_fft"] // 2 + 1
    per_token = 4 * d * hd + 2 * d * d + 4 * cfg["mlp_ratio"] * d * d
    per_chunk = (2 * h * (hd * cfg["d_gate"] + cfg["d_gate"] * 2 * g
                          * buckets(cfg)) + 16 * h * g * f_half)
    prod = n * per_token + nc * per_chunk
    calls = causal.layer_calls(cfg, 1, n)
    gate_ffts = h * g * nc * fft_ops(cfg["n_fft"])
    fwd = gate_ffts + calls["seg_rfft"].flops + calls["mix"].flops
    bwd = gate_ffts + calls["seg_rfft"].flops + calls["mix_bwd"].flops
    return prod, fwd, bwd


def _swa_prod(cfg: dict, n: int) -> float:
    d, w = cfg["embed_dim"], cfg["attn_window"]
    pairs = n * w - w * (w - 1) // 2 if n >= w else n * (n + 1) // 2
    return n * (8 * d * d + 4 * cfg["mlp_ratio"] * d * d) + 4 * d * pairs


def train_step(cfg: dict, batch: int, n: int) -> float:
    """Operations of one training step on ``batch`` rows of n tokens."""
    prod = 2 * cfg["embed_dim"] * cfg["vocab_size"] * n
    fft = 0.0
    for kind, _ in layers(cfg):
        if kind == "spectre":
            p, f, b = _spectre_parts(cfg, n)
            prod += p
            fft += f + b
        else:
            prod += _swa_prod(cfg, n)
    return batch * (3 * prod + fft)


def prefill(cfg: dict, n: int) -> float:
    """Operations of one prefill of a prompt of n tokens (one row)."""
    d, h = cfg["embed_dim"], cfg["num_heads"]
    total = 2 * d * cfg["vocab_size"]
    for kind, _ in layers(cfg):
        if kind != "spectre":
            raise ValueError("prefill counts SPECTRE layers only")
        p, f, _ = _spectre_parts(cfg, n)
        total += p + f + n * 4 * d * (d // h) + d * fft_ops(cfg["n_fft"])
    return total
