"""The system under test: the port's models built from a configuration file
(``cardbench/configs``), their weights drawn on the device from the seed.

This module and the traffic loops are the only ones of the benchmark
that import the program (``fft_tpu_torch``)."""

from __future__ import annotations

import torch

from cardbench import weights
from fft_tpu_torch.config import SpectreConfig
from fft_tpu_torch.models.hybrid import HybridConfig, HybridLM
from fft_tpu_torch.models.lm import LMConfig, SpectreLM


def spectre_config(cfg: dict) -> SpectreConfig:
    return SpectreConfig(
        embed_dim=cfg["embed_dim"], num_heads=cfg["num_heads"],
        n_fft=cfg["n_fft"], mlp_ratio=cfg["mlp_ratio"], d_gate=cfg["d_gate"],
        pooling_type=cfg["pooling_type"], num_groups=cfg["gate_groups"],
        num_buckets=cfg.get("num_buckets"), wavelet_on_rate=0.0,
        memory_size=0, causal=True, causal_chunk=cfg["causal_chunk"],
        compute_dtype=cfg["compute_dtype"])


def build(cfg: dict, seed: int, device) -> torch.nn.Module:
    """The configuration's model on ``device``, allocated there, with the
    weights ``cardbench.weights.draw`` gives for ``seed``; in eval mode."""
    block = spectre_config(cfg)
    if cfg["model"] == "spectre_lm":
        mcfg = LMConfig(vocab_size=cfg["vocab_size"],
                        num_layers=cfg["num_layers"], block=block,
                        max_seq=cfg["max_seq"],
                        tie_embeddings=cfg["tie_embeddings"],
                        emb_init_std=cfg["emb_init_std"], remat=cfg["remat"])
        cls = SpectreLM
    elif cfg["model"] == "hybrid_lm":
        mcfg = HybridConfig(
            vocab_size=cfg["vocab_size"], num_groups=cfg["layer_groups"],
            spectre_per_group=cfg["spectre_per_group"], block=block,
            attn_heads=cfg["attn_heads"], attn_window=cfg["attn_window"],
            max_seq=cfg["max_seq"], tie_embeddings=cfg["tie_embeddings"],
            remat=cfg["remat"])
        cls = HybridLM
    else:
        raise ValueError(f"unknown model {cfg['model']!r}")
    with torch.device(device):
        model = cls(mcfg)
    weights.load(model, weights.draw(cfg, seed, device))
    return model.eval()
