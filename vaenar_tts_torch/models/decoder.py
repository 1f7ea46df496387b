"""Non-autoregressive mel decoder (counterpart of
``vaenar_tts_tpu/models/decoder.py``): pre-projection -> N
CrossAttentionBlocks over the text -> linear head of out_dim *
max_reduction_factor, sliced to r * out_dim and reshaped to r frames per
latent step -> PostNet residual."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .attention import CrossAttentionBlock
from .layers import PostNet


class TransformerDecoder(nn.Module):
    def __init__(self, latent_dim: int, memory_dim: int, nblk: int,
                 attention_dim: int, attention_heads: int, temperature: float,
                 ffn_hidden: int, post_n_conv: int, post_conv_filters: int,
                 post_conv_kernel: int, out_dim: int,
                 max_reduction_factor: int):
        super().__init__()
        self.out_dim = out_dim
        self.pre_projection = nn.Linear(latent_dim, attention_dim)
        self.names = [f"decoder_attention_{i}" for i in range(nblk)]
        for name in self.names:
            self.add_module(name, CrossAttentionBlock(
                attention_dim, memory_dim, attention_dim, attention_heads,
                temperature, ffn_hidden))
        self.linear_outputs = nn.Linear(attention_dim,
                                        out_dim * max_reduction_factor)
        self.postnet = PostNet(out_dim, post_n_conv, post_conv_filters,
                               post_conv_kernel)
        self.residual_outputs = nn.Linear(post_conv_filters, out_dim)

    def forward(self, inputs, text_embd, z_lengths=None, text_lengths=None,
                reduction_factor: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
        """latents [B, T, latent] -> (initial, refined), each
        [B, T * r, out_dim]."""
        batch, max_len = inputs.shape[0], inputs.shape[1]
        x = self.pre_projection(inputs)
        for name in self.names:
            x = getattr(self, name)(x, text_embd, z_lengths, text_lengths)
        full = self.linear_outputs(x)
        initial = full[:, :, : reduction_factor * self.out_dim].reshape(
            batch, max_len * reduction_factor, self.out_dim)
        outputs = self.residual_outputs(self.postnet(initial)) + initial
        return initial, outputs
