"""ViT-S/14 semantic backbone (DINOv2-with-registers architecture).

Counterpart of ``nerf_qa_tpu/models/nr/vit.py``. Reference behaviour: the
NR models' frozen semantic encoder ``dinov2_vits14_reg`` (model.py:64) or
FeatUp's wrapped dinov2 (model_nr_v8.py:112-136): a 14x14 patch conv, a
CLS and 4 register tokens, learned position embeddings, 12 pre-norm
blocks (dim 384, 6 heads, LayerScale, LayerNorm eps 1e-6) and a final
LayerNorm. As in the JAX package, ``pos_embed`` covers the patch grid
only: no position is added to the CLS or register tokens.

Keys follow DINOv2's ``state_dict`` (``patch_embed.proj``, ``cls_token``,
``register_tokens``, ``pos_embed``, ``blocks.{i}.*``, ``norm``), except
that ``pos_embed`` is (1, grid², D) at the model's grid;
``compat/pretrained.resolve_vit_params`` drops the CLS row of a DINOv2
checkpoint and resamples its grid.
"""
from __future__ import annotations

import torch
from torch import nn

from nerf_qa_torch.models.nr.layers import TransformerBlock, init_lecun_normal_


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image -> (N, gh·gw, D) tokens, row-major over the grid."""
        return self.proj(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)


class ViTS14(nn.Module):
    def __init__(self, embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 patch_size: int = 14, num_registers: int = 4,
                 layer_scale_init: float = 1e-5, grid_size: int = 16):
        super().__init__()
        self.embed_dim = embed_dim
        self.patch_size = patch_size
        self.num_registers = num_registers
        self.grid_size = grid_size
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.register_tokens = nn.Parameter(torch.zeros(1, num_registers, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid_size * grid_size, embed_dim))
        self.blocks = nn.ModuleList(
            TransformerBlock(embed_dim, num_heads, layer_scale_init=layer_scale_init,
                             norm_eps=1e-6)
            for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> dict:
        """NHWC image batch (224² for the NR model) -> the token dict the
        reference consumes (``x_norm_patchtokens``, model_nr.py:123)."""
        b, h, w, _ = x.shape
        gh, gw = h // self.patch_size, w // self.patch_size
        if gh * gw != self.pos_embed.shape[1]:
            raise ValueError(f"{h}x{w} input gives a {gh}x{gw} patch grid; "
                             f"pos_embed holds {self.pos_embed.shape[1]} "
                             "positions")
        tokens = self.patch_embed(x) + self.pos_embed
        prefix = torch.cat([self.cls_token.expand(b, -1, -1),
                            self.register_tokens.expand(b, -1, -1)], dim=1)
        tokens = torch.cat([prefix, tokens], dim=1)
        for blk in self.blocks:
            tokens = blk(tokens)
        tokens = self.norm(tokens)
        n_prefix = 1 + self.num_registers
        return {
            "x_norm_clstoken": tokens[:, 0],
            "x_norm_regtokens": tokens[:, 1:n_prefix],
            "x_norm_patchtokens": tokens[:, n_prefix:],
            "grid": (gh, gw),
        }


def init_vit_(model: ViTS14, generator: torch.Generator) -> ViTS14:
    """Seeded random init in the JAX package's distribution: lecun-normal
    kernels, zero biases, N(0, 0.02) position embeddings, zero CLS and
    register tokens, LayerScale at its init value."""
    init_lecun_normal_(model, generator)
    with torch.no_grad():
        model.pos_embed.copy_(0.02 * torch.randn(model.pos_embed.shape,
                                                 generator=generator))
    return model
