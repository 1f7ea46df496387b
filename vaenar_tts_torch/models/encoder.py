"""Transformer text encoder (counterpart of
``vaenar_tts_tpu/models/encoder.py``): Embedding -> ConvPreNet -> positional
encoding scaled by a trained ``pos_weight`` at a fractional step -> dropout
-> N SelfAttentionBlocks, each under ``maybe_remat`` (``ring``: their
self-attentions' sequence parallelism, ``models/attention.py``). In the compute dtype,
with the positional sum in fp32 as the JAX package's promotion makes it."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .attention import SelfAttentionBlock, maybe_remat
from .layers import ConvPreNet, Embedding, add_positions, dropout


class TransformerEncoder(nn.Module):
    def __init__(self, vocab_size: int, embd_dim: int, pre_nconv: int,
                 pre_hidden: int, pre_conv_kernel: int, pre_activation: str,
                 bn_before_act: bool, nblk: int, attention_dim: int,
                 attention_heads: int, attention_temperature: float,
                 ffn_hidden: int, prenet_drop_rate: float = 0.0,
                 pos_drop_rate: float = 0.0, dtype: torch.dtype = torch.float32,
                 remat="off", ring=None):
        super().__init__()
        self.remat = remat
        self.pos_drop_rate = pos_drop_rate
        self.compute_dtype = dtype
        self.text_init_encoding = Embedding(vocab_size, embd_dim, dtype)
        self.EncoderPrenet = ConvPreNet(embd_dim, pre_nconv, pre_hidden,
                                        pre_conv_kernel, pre_activation,
                                        bn_before_act, prenet_drop_rate, dtype)
        self.pos_weight = nn.Parameter(torch.ones(()))
        self.names = [f"self_attention{i}" for i in range(nblk)]
        for name in self.names:
            self.add_module(name, SelfAttentionBlock(
                pre_hidden, attention_dim, attention_heads,
                attention_temperature, ffn_hidden, dtype, ring))

    def forward(self, inputs: torch.Tensor, input_lengths=None,
                pos_step: float = 1.0, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, T] int token ids -> [B, T, pre_hidden]."""
        x = self.EncoderPrenet(self.text_init_encoding(inputs), train, generator)
        x = dropout(add_positions(x, self.pos_weight, self.compute_dtype, pos_step),
                    self.pos_drop_rate, train, generator)
        for name in self.names:
            x = maybe_remat(getattr(self, name), self.remat)(
                x, x, input_lengths, input_lengths)
        return x
