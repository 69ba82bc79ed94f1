"""Models built on SPECTRE blocks: the causal LM (tiny and 350M), the
hybrid SPECTRE + sliding-window LM and the ViT classifier."""

from fft_tpu_torch.models.hybrid import (
    HybridConfig, HybridLM, hybrid_apply, hybrid_generate, hybrid_init,
)
from fft_tpu_torch.models.lm import (
    LMConfig, SpectreLM, lm_apply, lm_generate, lm_init,
)
from fft_tpu_torch.models.vit import ViT, ViTConfig, vit_apply, vit_init

__all__ = ["LMConfig", "SpectreLM", "lm_init", "lm_apply", "lm_generate",
           "HybridConfig", "HybridLM", "hybrid_init", "hybrid_apply",
           "hybrid_generate", "ViTConfig", "ViT", "vit_init", "vit_apply"]
