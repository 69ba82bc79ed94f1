"""Weight bridge between the JAX parameter trees and the port's
``state_dict``s: one SPECTRE block (``spectre_block_init``'s tree <->
``SpectreBlock.state_dict()``), the LM and the ViT, which stack the
block's tree over layers, and the hybrid LM, which stacks its SPECTRE
blocks over (group, block) and its attention blocks over groups.

The JAX trees are taken as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``).  Their layout:

- linear kernels are (fan_in, fan_out); the port's are (fan_out, fan_in);
- per-head parameters are stacked on axis 0 (vmap over heads), among them
  the attention pooler's ``pool`` MLP and the real (2, klen)
  ``toeplitz_kernel`` pair where the config has them;
- blocks are stacked on axis 0 (scan over layers);
- ``modrelu_bias`` is (G, F_half) per head; ``memory_fft`` is a real
  (2, bins, d) pair, the same in both;
- the LM's head is ``tok_emb`` transposed when tied; an untied LM
  (``tie_embeddings=False``) has its own (d, vocab) ``lm_head`` leaf, the
  same in both.

Both directions only transpose and slice, so a round trip is bit-exact.

The decode caches bridge too (``cache_from_jax``/``cache_to_jax``, and
``swa_cache_from_jax``/``swa_cache_to_jax`` for the attention blocks' ring
caches), so both sides can start from one state: JAX's ``PrefixFFTCache``
keeps the window rFFT as real ``prefix_re``/``prefix_im`` planes and, for
the LM, stacks every field over layers; the port keeps one complex64
``prefix`` and a list of caches, one a layer.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch

from fft_tpu_torch.config import SpectreConfig
from fft_tpu_torch.decode.cache import PrefixFFTCache
from fft_tpu_torch.layers.attention import SWACache
from fft_tpu_torch.models.hybrid import HybridConfig
from fft_tpu_torch.models.lm import LMConfig
from fft_tpu_torch.models.vit import ViTConfig

# port name in SpectreHeads -> (JAX path under "heads", is a linear kernel)
_HEAD_KEYS = {
    "w_q": (("w_q", "w"), True),
    "w_v": (("w_v", "w"), True),
    "gate_fc1_w": (("gate_mlp", "fc1", "w"), True),
    "gate_fc1_b": (("gate_mlp", "fc1", "b"), False),
    "gate_fc2_w": (("gate_mlp", "fc2", "w"), True),
    "gate_fc2_b": (("gate_mlp", "fc2", "b"), False),
    "q_norm_w": (("q_norm", "scale"), False),
    "q_norm_b": (("q_norm", "bias"), False),
    "modrelu_bias": (("modrelu_bias",), False),
}
# the attention pooler's scorer (pooling_type="attention")
_POOL_KEYS = {
    "pool_fc1_w": (("pool", "fc1", "w"), True),
    "pool_fc1_b": (("pool", "fc1", "b"), False),
    "pool_fc2_w": (("pool", "fc2", "w"), True),
    "pool_fc2_b": (("pool", "fc2", "b"), False),
}

# port name in SpectreBlock -> (JAX path in the block, is a linear kernel)
_BLOCK_KEYS = {
    "ln1.weight": (("ln1", "scale"), False),
    "ln1.bias": (("ln1", "bias"), False),
    "ln2.weight": (("ln2", "scale"), False),
    "ln2.bias": (("ln2", "bias"), False),
    "mlp.fc1.weight": (("mlp", "fc1", "w"), True),
    "mlp.fc1.bias": (("mlp", "fc1", "b"), False),
    "mlp.fc2.weight": (("mlp", "fc2", "w"), True),
    "mlp.fc2.bias": (("mlp", "fc2", "b"), False),
    "mix.out_proj.weight": (("mix", "out_proj", "w"), True),
    "mix.wavelet.fc1.weight": (("mix", "wavelet", "fc1", "w"), True),
    "mix.wavelet.fc1.bias": (("mix", "wavelet", "fc1", "b"), False),
    "mix.wavelet.fc2.weight": (("mix", "wavelet", "fc2", "w"), True),
    "mix.wavelet.fc2.bias": (("mix", "wavelet", "fc2", "b"), False),
}


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _set(tree, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _block_entries(cfg: SpectreConfig):
    """(port key in SpectreBlock, JAX path in a block, transpose?)."""
    for name, (path, lin) in _BLOCK_KEYS.items():
        yield name, path, lin
    heads = dict(_HEAD_KEYS)
    if cfg.pooling_type == "attention":
        heads.update(_POOL_KEYS)
    if cfg.use_toeplitz:
        heads["toeplitz_kernel"] = (("toeplitz_kernel",), False)
    for name, (path, lin) in heads.items():
        yield f"mix.heads.{name}", ("mix", "heads") + path, lin
    if cfg.memory_freq_bins > 0:
        yield "memory_fft", ("memory_fft",), False


def block_from_jax_params(tree, cfg: SpectreConfig,
                          layer: Optional[int] = None
                          ) -> Dict[str, torch.Tensor]:
    """JAX block params (nested dicts of numpy arrays) -> the port's
    ``state_dict`` for ``SpectreBlock(cfg)``.  ``layer`` picks one block of
    a tree whose leaves are stacked over layers (the LM's)."""
    sd = {}
    for name, path, lin in _block_entries(cfg):
        a = np.asarray(_get(tree, path))
        if layer is not None:
            a = a[layer]
        if lin:
            a = np.swapaxes(a, -1, -2)
        sd[name] = torch.from_numpy(np.array(a, order="C"))    # a copy
    return sd


def block_to_jax_params(state_dict, cfg: SpectreConfig):
    """``SpectreBlock.state_dict()`` -> JAX block params as nested dicts of
    numpy arrays, heads stacked on axis 0."""
    tree = {}
    for name, path, lin in _block_entries(cfg):
        a = state_dict[name].detach().cpu().numpy()
        if lin:
            a = np.swapaxes(a, -1, -2)
        _set(tree, path, np.ascontiguousarray(a))
    return tree


def _stack(trees):
    """Nested dicts of equal structure -> one, leaves stacked on axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.ascontiguousarray(np.stack(trees))


def from_jax_params(tree, cfg: LMConfig) -> Dict[str, torch.Tensor]:
    """JAX LM params (nested dicts of numpy arrays) -> the port's
    ``state_dict`` for ``SpectreLM(cfg)``."""
    sd = {
        "tok_emb": torch.from_numpy(np.array(tree["tok_emb"])),
        "pos_emb": torch.from_numpy(np.array(tree["pos_emb"])),
        "ln_f.weight": torch.from_numpy(np.array(tree["ln_f"]["scale"])),
        "ln_f.bias": torch.from_numpy(np.array(tree["ln_f"]["bias"])),
    }
    if not cfg.tie_embeddings:
        sd["lm_head"] = torch.from_numpy(np.array(tree["lm_head"]))
    for i in range(cfg.num_layers):
        block = block_from_jax_params(tree["blocks"], cfg.block, layer=i)
        sd.update((f"blocks.{i}.{k}", t) for k, t in block.items())
    return sd


def to_jax_params(state_dict, cfg: LMConfig):
    """The port's ``state_dict`` -> JAX LM params as nested dicts of numpy
    arrays, layers and heads stacked on axis 0."""
    def arr(key):
        return state_dict[key].detach().cpu().numpy()

    blocks = []
    for i in range(cfg.num_layers):
        prefix = f"blocks.{i}."
        blocks.append(block_to_jax_params(
            {k[len(prefix):]: t for k, t in state_dict.items()
             if k.startswith(prefix)}, cfg.block))
    tree = {
        "tok_emb": arr("tok_emb"),
        "pos_emb": arr("pos_emb"),
        "ln_f": {"scale": arr("ln_f.weight"), "bias": arr("ln_f.bias")},
        "blocks": _stack(blocks),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = arr("lm_head")
    return tree


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))           # a copy


def _index(tree, idx):
    """Nested dicts of stacked arrays -> the same, each leaf at ``idx``."""
    if isinstance(tree, dict):
        return {k: _index(v, idx) for k, v in tree.items()}
    return np.asarray(tree)[idx]


def _linear(lin) -> Dict[str, torch.Tensor]:
    """A JAX linear {w (fan_in, fan_out)[, b]} -> weight (fan_out, fan_in)
    [and bias]."""
    sd = {"weight": _t(np.swapaxes(np.asarray(lin["w"]), -1, -2))}
    if "b" in lin:
        sd["bias"] = _t(lin["b"])
    return sd


def _layernorm(ln) -> Dict[str, torch.Tensor]:
    return {"weight": _t(ln["scale"]), "bias": _t(ln["bias"])}


def _prefixed(prefix: str, sd: Dict[str, torch.Tensor]):
    return {f"{prefix}.{k}": t for k, t in sd.items()}


def vit_from_jax_params(tree, cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    """JAX ViT params (nested dicts of numpy arrays, blocks stacked over
    layers) -> the port's ``state_dict`` for ``ViT(cfg)``."""
    sd = {"cls_token": _t(tree["cls_token"]), "pos_emb": _t(tree["pos_emb"])}
    sd.update(_prefixed("patch_proj", _linear(tree["patch_proj"])))
    sd.update(_prefixed("head", _linear(tree["head"])))
    sd.update(_prefixed("ln_f", _layernorm(tree["ln_f"])))
    for i in range(cfg.num_layers):
        sd.update(_prefixed(f"blocks.{i}", block_from_jax_params(
            tree["blocks"], cfg.block, layer=i)))
    return sd


def swa_block_from_jax_params(tree) -> Dict[str, torch.Tensor]:
    """JAX ``swa_block_init`` params -> the port's ``SWABlock``
    ``state_dict``."""
    sd = {}
    for name in ("ln1", "ln2"):
        sd.update(_prefixed(name, _layernorm(tree[name])))
    for name in ("w_q", "w_k", "w_v", "w_o"):
        sd.update(_prefixed(f"attn.{name}", _linear(tree["attn"][name])))
    for name in ("fc1", "fc2"):
        sd.update(_prefixed(f"mlp.{name}", _linear(tree["mlp"][name])))
    return sd


def hybrid_from_jax_params(tree, cfg: HybridConfig
                           ) -> Dict[str, torch.Tensor]:
    """JAX hybrid params (nested dicts of numpy arrays: ``spectre`` stacked
    over (G, S, ...), ``attn`` over (G, ...)) -> the port's ``state_dict``
    for ``HybridLM(cfg)``."""
    sd = {"tok_emb": _t(tree["tok_emb"]), "pos_emb": _t(tree["pos_emb"])}
    sd.update(_prefixed("ln_f", _layernorm(tree["ln_f"])))
    for g in range(cfg.num_groups):
        for s in range(cfg.spectre_per_group):
            sd.update(_prefixed(f"spectre.{g}.{s}", block_from_jax_params(
                _index(tree["spectre"], (g, s)), cfg.block)))
        sd.update(_prefixed(f"attn.{g}", swa_block_from_jax_params(
            _index(tree["attn"], g))))
    return sd


def swa_cache_from_jax(tree, device=None
                       ) -> Union[SWACache, List[SWACache]]:
    """JAX's ``SWACache`` (its NamedTuple, or a dict with its field names)
    -> the port's on ``device``, or a list of caches, one a group, when
    the fields are stacked over groups (``t`` of shape (G,))."""
    fields = {k: np.asarray(tree[k] if isinstance(tree, dict)
                            else getattr(tree, k))
              for k in ("k_buf", "v_buf", "t")}

    def one(i):
        a = {k: (v if i is None else v[i]) for k, v in fields.items()}
        return SWACache(
            k_buf=_t(a["k_buf"].astype(np.float32)).to(device),
            v_buf=_t(a["v_buf"].astype(np.float32)).to(device),
            t=int(a["t"]))

    if fields["t"].ndim == 0:
        return one(None)
    return [one(i) for i in range(fields["t"].shape[0])]


def swa_cache_to_jax(caches: Union[SWACache, List[SWACache]]):
    """The port's ring cache (or list, one a group) -> a dict of numpy
    arrays with the fields of JAX's ``SWACache`` (stacked over groups for
    a list)."""
    def one(c: SWACache):
        return {"k_buf": np.ascontiguousarray(c.k_buf.detach().cpu().numpy()),
                "v_buf": np.ascontiguousarray(c.v_buf.detach().cpu().numpy()),
                "t": np.asarray(c.t, np.int32)}

    if isinstance(caches, SWACache):
        return one(caches)
    return _stack([one(c) for c in caches])


_CACHE_FIELDS = ("prefix_re", "prefix_im", "v_buf", "q_buf", "sum_q", "t")


def cache_from_jax(tree, device=None
                   ) -> Union[PrefixFFTCache, List[PrefixFFTCache]]:
    """JAX's ``PrefixFFTCache`` (its NamedTuple, or a dict with its field
    names; arrays or numpy arrays) -> the port's cache on ``device`` (the
    CPU unless given), or a list of caches, one a layer, when the fields
    are stacked over layers (``t`` of shape (L,), as ``lm_prefill``
    returns them)."""
    fields = {k: np.asarray(tree[k] if isinstance(tree, dict)
                            else getattr(tree, k)) for k in _CACHE_FIELDS}

    def one(i):
        a = {k: (v if i is None else v[i]) for k, v in fields.items()}
        t = {k: torch.from_numpy(np.array(a[k], dtype=np.float32))
             for k in _CACHE_FIELDS[:-1]}
        return PrefixFFTCache(
            prefix=torch.complex(t["prefix_re"], t["prefix_im"]).to(device),
            v_buf=t["v_buf"].to(device), q_buf=t["q_buf"].to(device),
            sum_q=t["sum_q"].to(device), t=int(a["t"]))

    if fields["t"].ndim == 0:
        return one(None)
    return [one(i) for i in range(fields["t"].shape[0])]


def cache_to_jax(caches: Union[PrefixFFTCache, List[PrefixFFTCache]]):
    """The port's cache (or list of caches, one a layer) -> a dict of numpy
    arrays with the fields of JAX's ``PrefixFFTCache`` (stacked over layers
    for a list); ``PrefixFFTCache(**d)`` of ``jnp.asarray``s rebuilds it."""
    def one(c: PrefixFFTCache):
        def arr(x):
            return np.ascontiguousarray(x.detach().cpu().numpy())
        return {"prefix_re": arr(c.prefix.real),
                "prefix_im": arr(c.prefix.imag), "v_buf": arr(c.v_buf),
                "q_buf": arr(c.q_buf), "sum_q": arr(c.sum_q),
                "t": np.asarray(c.t, np.int32)}

    if isinstance(caches, PrefixFFTCache):
        return one(caches)
    return _stack([one(c) for c in caches])
