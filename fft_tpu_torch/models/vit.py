"""ViT-S-style image classifier with SPECTRE blocks in place of attention
(mirror of ``fft_tpu/models/vit.py``, BASELINE config 3: L = 197 tokens,
196 patches and CLS, ImageNet-1k).

The 197-token sequence runs the wavelet pyramid at an odd length, which
the port's Haar pyramid takes (``ops/wavelet.py``).  ``vit_s_config``
keeps ``fft_impl="auto"``, so each block's mix is the per-head branch
(``torch.fft``, cuFFT on the card): the ViT runs no hand-written kernel.

Randomness: in train mode (``model.train()``) each block draws its wavelet
on-mask (and dropout, where ``dropout_p`` > 0) from a generator of its
own, seeded by one draw a layer from the step's ``generator``, as the JAX
package splits the step's dropout key into one key a layer (its wavelet
key is ``fold_in(key, 1)`` of it).  The draws cannot match JAX's bits;
in eval mode the wavelet is on at rate >= 1 and off below, JAX's
``deterministic=True`` rule.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from fft_tpu_torch.config import SpectreConfig
from fft_tpu_torch.layers.common import DTYPES, LayerNorm, Linear, linear_init
from fft_tpu_torch.layers.spectre import SpectreBlock
from fft_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    in_channels: int = 3
    num_classes: int = 1000
    num_layers: int = 12
    block: SpectreConfig = dataclasses.field(
        default_factory=lambda: SpectreConfig(
            embed_dim=384, num_heads=6, n_fft=256, pooling_type="mean",
            wavelet_on_rate=0.1))
    pool: str = "cls"                     # "cls" | "mean"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1       # + CLS

    def __post_init__(self):
        if self.image_size % self.patch_size:
            raise ValueError("image_size must be a multiple of patch_size")
        if self.seq_len > self.block.n_fft:
            raise ValueError(f"{self.seq_len} tokens exceed n_fft "
                             f"{self.block.n_fft}")
        if self.pool not in ("cls", "mean"):
            raise ValueError(f"pool={self.pool!r}: 'cls' or 'mean'")


def vit_s_config(num_classes: int = 1000) -> ViTConfig:
    """ViT-S/16 geometry (d=384, 12 layers, 6 heads), L = 197."""
    return ViTConfig(num_classes=num_classes)


class ViT(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.block.embed_dim
        patch_dim = cfg.patch_size * cfg.patch_size * cfg.in_channels
        self.patch_proj = Linear(patch_dim, d)
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.pos_emb = nn.Parameter(torch.empty(cfg.seq_len, d))
        self.blocks = nn.ModuleList(
            SpectreBlock(cfg.block) for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(d, eps=1e-5)
        self.head = Linear(d, cfg.num_classes)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for lin in (self.patch_proj, self.head):
            w, b = linear_init(lin.in_features, lin.out_features, generator)
            lin.weight.copy_(w)
            lin.bias.copy_(b)
        for emb in (self.cls_token, self.pos_emb):
            emb.copy_(torch.randn(emb.shape, generator=generator) * 0.02)
        for block in self.blocks:
            block.reset_parameters(generator)
        self.ln_f.reset_parameters()

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return vit_apply(self, images, generator=generator)


def vit_init(cfg: ViTConfig, generator: torch.Generator,
             device=None) -> ViT:
    """A model with the JAX package's init distributions, drawn on the CPU
    from ``generator``, then moved to ``device`` (the card unless ``"cpu"``
    is asked for), in eval mode."""
    device = resolve_device(device)
    model = ViT(cfg)
    model.reset_parameters(generator)
    return model.to(device).eval()


def _patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/p * W/p, p*p*C): a reshape and a permute, no
    convolution."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def _layer_generators(model: ViT, generator: Optional[torch.Generator]):
    """One generator a layer in train mode (None in eval mode), each seeded
    by one draw from ``generator`` on the model's device."""
    if not model.training:
        return [None] * len(model.blocks)
    if generator is None:
        raise ValueError("vit_apply in train mode draws the wavelet masks "
                         "from an explicit torch.Generator: pass generator=")
    dev = model.pos_emb.device
    seeds = torch.randint(0, 2 ** 62, (len(model.blocks),),
                          generator=generator, device=generator.device)
    return [torch.Generator(device=dev).manual_seed(int(s))
            for s in seeds.tolist()]


def vit_apply(model: ViT, images: torch.Tensor, *,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """images (B, H, W, C) -> logits (B, num_classes) float32."""
    cfg = model.cfg
    b = images.shape[0]
    x = model.patch_proj(_patchify(
        images.to(DTYPES[cfg.block.compute_dtype]), cfg.patch_size))
    cls = model.cls_token.to(x.dtype).expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + model.pos_emb.to(x.dtype)
    for block, gen in zip(model.blocks, _layer_generators(model, generator)):
        x = block(x, generator=gen)
    x = model.ln_f(x)
    feat = x[:, 0] if cfg.pool == "cls" else x.mean(dim=1)
    return model.head(feat).float()
