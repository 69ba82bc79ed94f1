"""The SPECTRE LM and the hybrid LM as plain float32 functions of a dict of
parameters, with the decode cache that a prefill builds.

Equations (``cfg`` is a configuration file of ``cardbench/configs``):

- embedding: h = tok_emb[tokens] + pos_emb[:N];
- SPECTRE block: x + W_o mix(LN1 x), then x + fc2 gelu(fc1 LN2 x).  The mix
  of head h (width hd, G gate groups of hd / G channels) on q = x W_q^h,
  v = x W_v^h: the sequence is cut into chunks of C tokens; chunk c's gate
  is g_c = modReLU(interp(A(LN_q(sum_{t <= cC} q_t / n_fft)))), A the gate
  MLP (hd -> d_gate -> gelu -> G x K complex anchors, K = max(4,
  floor(sqrt(n_fft / 2 + 1)))), interp the cubic (Keys, a = -0.75) map of
  the K anchors onto the n_fft / 2 + 1 bins with the end points aligned,
  modReLU(z) = relu(|z| + b) z / sqrt(|z|^2 + 1e-8); k_c = irfft(g_c, n_fft)
  with the imaginary parts of its DC and Nyquist bins dropped; and output
  position t of chunk c is y_t = sum_{m <= t} k_c[m] v_{t - m}, each gate
  group's kernel on its own channels;
- sliding-window attention block (hybrid): x + W_o attn(LN1 x), then the
  MLP; query t attends the keys t - W < s <= t, softmax over scores
  q.k / sqrt(hd) in float32;
- head: logits = LN_f(h) tok_emb^T (tied).

``ROUNDERS`` gives the precision: the reference rounds nothing; the control
rounds, in both directions, where the program rounds to its compute dtype.
Blocks are recomputed in backward (``torch.utils.checkpoint``), and the
causal mix runs one chunk at a time, so that one 32k-token row fits.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8 e4m3 with one scale for the tensor (its largest
    magnitude onto fp8's), returned in x's dtype."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = FP8_MAX / amax
    y = (x * scale).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
    return y.to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def _exact(x: torch.Tensor) -> torch.Tensor:
    return x


ROUNDERS = {"float32": _exact, "float8": _Fp8.apply}


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def buckets(cfg: dict) -> int:
    f_half = cfg["n_fft"] // 2 + 1
    return max(4, cfg.get("num_buckets") or int(math.sqrt(f_half)))


def _spectre_block_spec(p: str, cfg: dict) -> list:
    d, h = cfg["embed_dim"], cfg["num_heads"]
    hd, g, dg = d // h, cfg["gate_groups"], cfg["d_gate"]
    n_raw = 2 * g * buckets(cfg)
    f_half = cfg["n_fft"] // 2 + 1
    hid = cfg["mlp_ratio"] * d

    def uni(fan_in):
        return ("uniform", 1.0 / math.sqrt(fan_in))

    return [
        (p + "ln1.weight", (d,), ("const", 1.0)),
        (p + "ln1.bias", (d,), ("const", 0.0)),
        (p + "mix.heads.w_q", (h, hd, hd), uni(hd)),
        (p + "mix.heads.w_v", (h, hd, hd), uni(hd)),
        (p + "mix.heads.gate_fc1_w", (h, dg, hd), uni(hd)),
        (p + "mix.heads.gate_fc1_b", (h, dg), uni(hd)),
        (p + "mix.heads.gate_fc2_w", (h, n_raw, dg), uni(dg)),
        (p + "mix.heads.gate_fc2_b", (h, n_raw), uni(dg)),
        (p + "mix.heads.q_norm_w", (h, hd), ("const", 1.0)),
        (p + "mix.heads.q_norm_b", (h, hd), ("const", 0.0)),
        (p + "mix.heads.modrelu_bias", (h, g, f_half), ("const", -0.1)),
        (p + "mix.out_proj.weight", (d, d), uni(d)),
        # the wavelet branch's gate MLP: present, unused at a wavelet rate
        # of 0 (a causal model has none), so its gradient is zero
        (p + "mix.wavelet.fc1.weight", (d, d), uni(d)),
        (p + "mix.wavelet.fc1.bias", (d,), uni(d)),
        (p + "mix.wavelet.fc2.weight", (d, d), uni(d)),
        (p + "mix.wavelet.fc2.bias", (d,), uni(d)),
        (p + "ln2.weight", (d,), ("const", 1.0)),
        (p + "ln2.bias", (d,), ("const", 0.0)),
        (p + "mlp.fc1.weight", (hid, d), uni(d)),
        (p + "mlp.fc1.bias", (hid,), uni(d)),
        (p + "mlp.fc2.weight", (d, hid), uni(hid)),
        (p + "mlp.fc2.bias", (d,), uni(hid)),
    ]


def _swa_block_spec(p: str, cfg: dict) -> list:
    d = cfg["embed_dim"]
    hid = cfg["mlp_ratio"] * d
    u = ("uniform", 1.0 / math.sqrt(d))
    return [
        (p + "ln1.weight", (d,), ("const", 1.0)),
        (p + "ln1.bias", (d,), ("const", 0.0)),
        *((p + f"attn.{w}.weight", (d, d), u)
          for w in ("w_q", "w_k", "w_v", "w_o")),
        (p + "ln2.weight", (d,), ("const", 1.0)),
        (p + "ln2.bias", (d,), ("const", 0.0)),
        (p + "mlp.fc1.weight", (hid, d), u),
        (p + "mlp.fc1.bias", (hid,), u),
        (p + "mlp.fc2.weight", (d, hid), ("uniform", 1.0 / math.sqrt(hid))),
        (p + "mlp.fc2.bias", (d,), ("uniform", 1.0 / math.sqrt(hid))),
    ]


def param_spec(cfg: dict) -> list:
    """[(name, shape, init)] of every parameter of the configuration, init
    ("normal", std), ("uniform", bound) or ("const", value): the models'
    published init (embeddings N(0, 0.02^2), linear layers U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), LayerNorms 1 and 0, the modReLU bias -0.1)."""
    d = cfg["embed_dim"]
    emb = ("normal", cfg.get("emb_init_std", 0.02))
    spec = [("tok_emb", (cfg["vocab_size"], d), emb),
            ("pos_emb", (cfg["max_seq"], d), emb)]
    if cfg["model"] == "spectre_lm":
        for i in range(cfg["num_layers"]):
            spec += _spectre_block_spec(f"blocks.{i}.", cfg)
    elif cfg["model"] == "hybrid_lm":
        for gi in range(cfg["layer_groups"]):
            for s in range(cfg["spectre_per_group"]):
                spec += _spectre_block_spec(f"spectre.{gi}.{s}.", cfg)
        for gi in range(cfg["layer_groups"]):
            spec += _swa_block_spec(f"attn.{gi}.", cfg)
    else:
        raise ValueError(f"unknown model {cfg['model']!r}")
    spec += [("ln_f.weight", (d,), ("const", 1.0)),
             ("ln_f.bias", (d,), ("const", 0.0))]
    return spec


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

_INTERP = {}


def _keys_cubic(s: np.ndarray, a: float = -0.75) -> np.ndarray:
    s = np.abs(s)
    near = ((a + 2.0) * s - (a + 3.0)) * s * s + 1.0
    far = a * (((s - 5.0) * s + 8.0) * s - 4.0)
    return np.where(s <= 1.0, near, np.where(s < 2.0, far, 0.0))


def interp_matrix(k: int, size: int, device) -> torch.Tensor:
    """(k, size): cubic interpolation of k anchors onto ``size`` points,
    anchor 0 on point 0 and anchor k - 1 on point size - 1, taps clamped
    at the borders."""
    key = (k, size, str(device))
    if key not in _INTERP:
        t = np.arange(size, dtype=np.float64) * (k - 1) / (size - 1)
        f = np.floor(t)
        m = np.zeros((k, size))
        for off in (-1, 0, 1, 2):
            idx = np.clip(f + off, 0, k - 1).astype(np.int64)
            np.add.at(m, (idx, np.arange(size)), _keys_cubic(t - (f + off)))
        _INTERP[key] = torch.tensor(m, dtype=torch.float32, device=device)
    return _INTERP[key]


def _layer_norm(x, w, b, rnd):
    return rnd(F.layer_norm(x, x.shape[-1:], eps=1e-5) * w + b)


def _heads(x, w, rnd, b=None):
    """x (..., H, i) by the stacked per-head weights w (H, o, i)."""
    y = torch.einsum("...hi,hoi->...ho", x, rnd(w))
    return rnd(y if b is None else y + rnd(b))


def _linear(x, w, rnd, b=None):
    return rnd(F.linear(x, rnd(w), None if b is None else rnd(b)))


def spectre_gates(p: dict, pre: str, descr: torch.Tensor, cfg: dict,
                  rnd) -> torch.Tensor:
    """descr (..., H, hd) -> gates (..., H, G, F_half) complex64."""
    g = cfg["gate_groups"]
    k = buckets(cfg)
    f_half = cfg["n_fft"] // 2 + 1
    hid = rnd(F.gelu(_heads(descr, p[pre + "gate_fc1_w"], rnd,
                            p[pre + "gate_fc1_b"])))
    raw = torch.einsum("...hi,hoi->...ho", hid, rnd(p[pre + "gate_fc2_w"])) \
        + rnd(p[pre + "gate_fc2_b"])
    raw = raw.reshape(*raw.shape[:-1], g, k, 2)
    m = interp_matrix(k, f_half, descr.device)
    re, im = raw[..., 0] @ m, raw[..., 1] @ m
    mag = torch.sqrt(re * re + im * im)
    scale = torch.relu(mag + p[pre + "modrelu_bias"]) \
        / torch.sqrt(mag * mag + 1e-8)
    return torch.complex(re * scale, im * scale)


def causal_mix(v: torch.Tensor, gates: torch.Tensor, n_fft: int,
               chunk: int) -> torch.Tensor:
    """v (B, N, H, hd), gates (B, nc, H, G, F_half) -> y (B, N, H, hd): y_t
    of chunk c = sum_{m <= t} k_c[m] v_{t - m}, as a linear convolution
    through FFTs of 2N points, one chunk at a time."""
    b, n, h, hd = v.shape
    nc, g = gates.shape[1], gates.shape[3]
    f_half = gates.shape[-1]
    keep = torch.ones(f_half, device=v.device)
    keep[0] = 0.0
    if n_fft % 2 == 0:
        keep[n_fft // 2] = 0.0
    k_time = torch.fft.irfft(torch.complex(gates.real, gates.imag * keep),
                             n=n_fft, dim=-1)[..., :n]   # (B, nc, H, G, n)
    length = 2 * n
    vf = torch.fft.rfft(v, n=length, dim=1).reshape(
        b, length // 2 + 1, h, g, hd // g)
    out = []
    for c in range(nc):
        kf = torch.fft.rfft(k_time[:, c], n=length, dim=-1)  # (B, H, G, F)
        y = torch.fft.irfft(kf.permute(0, 3, 1, 2)[..., None] * vf,
                            n=length, dim=1)
        # a copy, so that the 2N-point output is freed at once
        out.append(y[:, c * chunk:(c + 1) * chunk].clone())
    return torch.cat(out, dim=1).reshape(b, n, h, hd)


def spectre_block(p: dict, pre: str, x: torch.Tensor, cfg: dict,
                  rnd) -> torch.Tensor:
    b, n, d = x.shape
    h = cfg["num_heads"]
    hd = d // h
    chunk = min(cfg["causal_chunk"], n)
    if n % chunk:
        raise ValueError(f"sequence {n} is not a multiple of chunk {chunk}")
    hp = pre + "mix.heads."
    xh = _layer_norm(x, p[pre + "ln1.weight"], p[pre + "ln1.bias"],
                     rnd).reshape(b, n, h, hd)
    q = _heads(xh, p[hp + "w_q"], rnd)
    v = _heads(xh, p[hp + "w_v"], rnd)
    descr = rnd(torch.cumsum(q, dim=1)[:, ::chunk] / cfg["n_fft"])
    descr = _layer_norm(descr, p[hp + "q_norm_w"], p[hp + "q_norm_b"], rnd)
    gates = spectre_gates(p, hp, descr, cfg, rnd)
    y = rnd(causal_mix(v, gates, cfg["n_fft"], chunk))
    x = rnd(x + _linear(y.reshape(b, n, d), p[pre + "mix.out_proj.weight"],
                        rnd))
    return rnd(x + _mlp(p, pre, x, rnd))


def _mlp(p, pre, x, rnd):
    h2 = _layer_norm(x, p[pre + "ln2.weight"], p[pre + "ln2.bias"], rnd)
    hid = rnd(F.gelu(_linear(h2, p[pre + "mlp.fc1.weight"], rnd,
                             p[pre + "mlp.fc1.bias"])))
    return _linear(hid, p[pre + "mlp.fc2.weight"], rnd,
                   p[pre + "mlp.fc2.bias"])


def window_attention(q, k, v, window: int, rnd,
                     block: int = 1024) -> torch.Tensor:
    """q, k, v (B, N, H, hd): query t attends keys t - window < s <= t,
    ``block`` queries at a time."""
    b, n, h, hd = q.shape
    out = []
    for s in range(0, n, block):
        e = min(n, s + block)
        k0 = max(0, s - window + 1)
        sc = torch.einsum("bqhd,bkhd->bhqk", q[:, s:e], k[:, k0:e]) \
            / math.sqrt(hd)
        dist = (torch.arange(s, e, device=q.device)[:, None]
                - torch.arange(k0, e, device=q.device)[None, :])
        sc = sc.masked_fill(~((dist >= 0) & (dist < window)), float("-inf"))
        pr = rnd(torch.softmax(sc, dim=-1))
        out.append(torch.einsum("bhqk,bkhd->bqhd", pr, v[:, k0:e]))
    return torch.cat(out, dim=1)


def swa_block(p: dict, pre: str, x: torch.Tensor, cfg: dict,
              rnd) -> torch.Tensor:
    b, n, d = x.shape
    h = cfg["attn_heads"]
    xn = _layer_norm(x, p[pre + "ln1.weight"], p[pre + "ln1.bias"], rnd)
    q, k, v = (_linear(xn, p[pre + f"attn.{w}.weight"], rnd).reshape(
        b, n, h, d // h) for w in ("w_q", "w_k", "w_v"))
    a = rnd(window_attention(q, k, v, cfg["attn_window"], rnd))
    x = rnd(x + _linear(a.reshape(b, n, d), p[pre + "attn.w_o.weight"], rnd))
    return rnd(x + _mlp(p, pre, x, rnd))


def layers(cfg: dict) -> list:
    """[(kind, parameter prefix)] in the order the blocks run."""
    if cfg["model"] == "spectre_lm":
        return [("spectre", f"blocks.{i}.") for i in range(cfg["num_layers"])]
    out = []
    for gi in range(cfg["layer_groups"]):
        out += [("spectre", f"spectre.{gi}.{s}.")
                for s in range(cfg["spectre_per_group"])]
        out.append(("swa", f"attn.{gi}."))
    return out


BLOCKS = {"spectre": spectre_block, "swa": swa_block}


def embed(p: dict, tokens: torch.Tensor, rnd) -> torch.Tensor:
    n = tokens.shape[-1]
    return rnd(p["tok_emb"][tokens] + p["pos_emb"][:n])


def hidden(p: dict, tokens: torch.Tensor, cfg: dict, rnd, *,
           remat: bool = False) -> torch.Tensor:
    """tokens (B, N) -> LN_f of the last block's output (B, N, d)."""
    h = embed(p, tokens, rnd)
    for kind, pre in layers(cfg):
        if remat:
            h = checkpoint(BLOCKS[kind], p, pre, h, cfg, rnd,
                           use_reentrant=False)
        else:
            h = BLOCKS[kind](p, pre, h, cfg, rnd)
    return _layer_norm(h, p["ln_f.weight"], p["ln_f.bias"], rnd)


def logits(p: dict, h: torch.Tensor, rnd) -> torch.Tensor:
    return rnd(h @ rnd(p["tok_emb"]).T)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(p: dict, tokens: torch.Tensor, cfg: dict, rnd, pick) -> tuple:
    """The forward over a prompt (1, L) of the SPECTRE LM: (last position's
    logits (1, vocab), [pick(layer, cache) for each layer]).  A layer's
    cache is built from that layer's input in float32: q = LN1(x) W_q, v =
    LN1(x) W_v per head, {"prefix": rfft(v, n_fft) (1, H, F_half, hd),
    "v_buf", "q_buf": v, q zero-padded to n_fft positions (1, H, n_fft,
    hd), "sum_q": the sum of q over the prompt (1, H, hd)}; ``pick``
    keeps what the comparison reads of it."""
    n_fft = cfg["n_fft"]
    h = embed(p, tokens, rnd)
    picked = []
    for i, (kind, pre) in enumerate(layers(cfg)):
        if kind != "spectre":
            raise ValueError("prefill builds SPECTRE caches only")
        x = h.float()
        b, n, d = x.shape
        heads = cfg["num_heads"]
        xh = F.layer_norm(x, (d,), p[pre + "ln1.weight"], p[pre + "ln1.bias"],
                          eps=1e-5).reshape(b, n, heads, d // heads)
        hp = pre + "mix.heads."
        q = torch.einsum("bnhi,hoi->bhno", xh, p[hp + "w_q"])
        v = torch.einsum("bnhi,hoi->bhno", xh, p[hp + "w_v"])
        pad = (0, 0, 0, n_fft - n)
        cache = {"prefix": torch.fft.rfft(v, n=n_fft, dim=-2),
                 "v_buf": F.pad(v, pad), "q_buf": F.pad(q, pad),
                 "sum_q": q.sum(dim=-2)}
        picked.append(pick(i, cache))
        del cache, q, v, xh
        h = spectre_block(p, pre, h, cfg, rnd)
    hl = _layer_norm(h[:, -1], p["ln_f.weight"], p["ln_f.bias"], rnd)
    return logits(p, hl, rnd).float(), picked
