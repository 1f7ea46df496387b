"""Transformer text encoder (counterpart of
``vaenar_tts_tpu/models/encoder.py``): Embedding -> ConvPreNet -> positional
encoding scaled by a trained ``pos_weight`` at a fractional step -> N
SelfAttentionBlocks."""

from __future__ import annotations

import torch
from torch import nn

from .attention import SelfAttentionBlock
from .layers import ConvPreNet, positional_encoding


class TransformerEncoder(nn.Module):
    def __init__(self, vocab_size: int, embd_dim: int, pre_nconv: int,
                 pre_hidden: int, pre_conv_kernel: int, pre_activation: str,
                 bn_before_act: bool, nblk: int, attention_dim: int,
                 attention_heads: int, attention_temperature: float,
                 ffn_hidden: int):
        super().__init__()
        self.text_init_encoding = nn.Embedding(vocab_size, embd_dim)
        self.EncoderPrenet = ConvPreNet(embd_dim, pre_nconv, pre_hidden,
                                        pre_conv_kernel, pre_activation,
                                        bn_before_act)
        self.pos_weight = nn.Parameter(torch.ones(()))
        self.names = [f"self_attention{i}" for i in range(nblk)]
        for name in self.names:
            self.add_module(name, SelfAttentionBlock(
                pre_hidden, attention_dim, attention_heads,
                attention_temperature, ffn_hidden))

    def forward(self, inputs: torch.Tensor, input_lengths=None,
                pos_step: float = 1.0) -> torch.Tensor:
        """[B, T] int token ids -> [B, T, pre_hidden]."""
        x = self.EncoderPrenet(self.text_init_encoding(inputs))
        pos = positional_encoding(x.shape[1], x.shape[2], step=pos_step,
                                  device=x.device)
        x = x + self.pos_weight * pos[None]
        for name in self.names:
            x = getattr(self, name)(x, x, input_lengths, input_lengths)
        return x
