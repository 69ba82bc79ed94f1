"""SPECTRE layers, causal and not (mirror of ``fft_tpu/layers``)."""

from fft_tpu_torch.layers.spectre import (
    SpectreBlock, SpectreMultiHead, spectre_block_apply, spectre_block_init,
    spectre_head_apply, spectre_multihead_apply, spectre_multihead_init,
    wavelet_refinement_apply,
)

__all__ = [
    "SpectreBlock", "SpectreMultiHead", "spectre_head_apply",
    "wavelet_refinement_apply",
    "spectre_multihead_init", "spectre_multihead_apply",
    "spectre_block_init", "spectre_block_apply",
]
