"""Attention-based VAE posterior q(z | mel, text) (counterpart of
``vaenar_tts_tpu/models/posterior.py:72-119``): PreNet -> positional encoding
-> N CrossAttentionBlocks over the text -> mu and logvar heads.

Synthesis does not run it. It is here so the exported parameter tree maps
onto the model in full; training, which needs it, is a later part of the
port. Dropout is off (inference mode)."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .attention import CrossAttentionBlock
from .layers import PreNet, positional_encoding


class TransformerPosterior(nn.Module):
    def __init__(self, in_dim: int, memory_dim: int, pre_hidden: int,
                 pre_activation: str, nblk: int, attention_dim: int,
                 attention_heads: int, temperature: float, ffn_hidden: int,
                 latent_dim: int):
        super().__init__()
        self.decoder_prenet = PreNet(in_dim, pre_hidden, pre_activation)
        self.pos_weight = nn.Parameter(torch.ones(()))
        self.names = [f"attention_{i}" for i in range(nblk)]
        for name in self.names:
            self.add_module(name, CrossAttentionBlock(
                pre_hidden, memory_dim, attention_dim, attention_heads,
                temperature, ffn_hidden))
        self.mu_projection = nn.Linear(attention_dim, latent_dim)
        self.logvar_projection = nn.Linear(attention_dim, latent_dim)

    def forward(self, inputs, src_enc, src_lengths=None, target_lengths=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """reduced mels [B, T, num_mels] -> (mu, logvar), [B, T, latent]."""
        x = self.decoder_prenet(inputs)
        pos = positional_encoding(x.shape[1], x.shape[2], device=x.device)
        x = x + self.pos_weight * pos[None]
        for name in self.names:
            x = getattr(self, name)(x, src_enc, target_lengths, src_lengths)
        return self.mu_projection(x).float(), self.logvar_projection(x).float()
