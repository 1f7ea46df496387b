"""Masked multi-head attention and the transformer blocks (counterpart of
``vaenar_tts_tpu/models/attention.py``).

Every attention goes through ``ops.flash_attention.masked_flash_attention``:
the hand-written kernel on CUDA tensors, its plain version on CPU tensors.
The blocks keep the reference's concat(input, context) -> Dense -> residual
-> LayerNorm topology. Alignments are never materialized on this path.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.flash_attention import attention_mask, masked_flash_attention
from .layers import FFN, LN_EPS

__all__ = ["attention_mask", "MultiHeadAttention", "SelfAttentionBlock",
           "CrossAttentionBlock"]


class MultiHeadAttention(nn.Module):
    """Projections without bias, heads split to [B, H, T, D], scale
    1/(sqrt(D)*temperature), length masks on queries and keys, optional
    causal band; returns [B, Tq, attention_dim]."""

    def __init__(self, query_dim: int, memory_dim: int, attention_dim: int,
                 num_heads: int, temperature: float = 1.0):
        super().__init__()
        if attention_dim % num_heads:
            raise ValueError(f"attention_dim {attention_dim} is not a "
                             f"multiple of num_heads {num_heads}")
        self.num_heads = num_heads
        self.head_dim = attention_dim // num_heads
        self.scale = 1.0 / (math.sqrt(float(self.head_dim)) * temperature)
        self.query_layer = nn.Linear(query_dim, attention_dim, bias=False)
        self.key_layer = nn.Linear(memory_dim, attention_dim, bias=False)
        self.value_layer = nn.Linear(memory_dim, attention_dim, bias=False)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return x.reshape(b, t, self.num_heads, self.head_dim).transpose(1, 2).contiguous()

    def forward(self, inputs: torch.Tensor, memory: torch.Tensor,
                query_lengths: Optional[torch.Tensor] = None,
                memory_lengths: Optional[torch.Tensor] = None,
                causal: bool = False) -> torch.Tensor:
        q = self._split(self.query_layer(inputs))
        k = self._split(self.key_layer(memory))
        v = self._split(self.value_layer(memory))
        o, _, _ = masked_flash_attention(q, k, v, query_lengths, memory_lengths,
                                         scale=self.scale, causal=causal)
        b, _, tq, _ = o.shape
        return o.transpose(1, 2).reshape(b, tq, self.num_heads * self.head_dim)


class SelfAttentionBlock(nn.Module):
    """MHA -> concat(input, ctx) -> Dense(input_dim) -> residual + LN -> FFN."""

    def __init__(self, input_dim: int, attention_dim: int, attention_heads: int,
                 attention_temperature: float = 1.0, ffn_hidden: int = 1024):
        super().__init__()
        self.attention = MultiHeadAttention(input_dim, input_dim, attention_dim,
                                            attention_heads, attention_temperature)
        self.att_proj = nn.Linear(input_dim + attention_dim, input_dim)
        self.layer_norm = nn.LayerNorm(input_dim, eps=LN_EPS)
        self.ffn = FFN(input_dim, ffn_hidden)

    def forward(self, inputs, memory, query_lengths=None, memory_lengths=None,
                causal: bool = False) -> torch.Tensor:
        att = self.attention(inputs, memory, query_lengths, memory_lengths,
                             causal=causal)
        projected = self.att_proj(torch.cat([inputs, att], dim=-1))
        return self.ffn(self.layer_norm(inputs + projected))


class CrossAttentionBlock(nn.Module):
    """Causal self-attention sublayer, cross-attention sublayer over
    ``memory``, each concat -> project -> residual -> LN, then FFN.
    ``input_dim`` equals ``attention_dim`` in every use."""

    def __init__(self, input_dim: int, memory_dim: int, attention_dim: int,
                 attention_heads: int, attention_temperature: float = 1.0,
                 ffn_hidden: int = 1024):
        super().__init__()
        self.self_attention = MultiHeadAttention(
            input_dim, input_dim, attention_dim, attention_heads,
            attention_temperature)
        self.att_proj1 = nn.Linear(input_dim + attention_dim, input_dim)
        self.layer_norm1 = nn.LayerNorm(input_dim, eps=LN_EPS)
        self.cross_attention = MultiHeadAttention(
            input_dim, memory_dim, attention_dim, attention_heads,
            attention_temperature)
        self.att_proj2 = nn.Linear(input_dim + attention_dim, attention_dim)
        self.layer_norm2 = nn.LayerNorm(attention_dim, eps=LN_EPS)
        self.ffn = FFN(attention_dim, ffn_hidden)

    def forward(self, inputs, memory, query_lengths=None,
                memory_lengths=None) -> torch.Tensor:
        self_att = self.self_attention(inputs, inputs, query_lengths,
                                       query_lengths, causal=True)
        h = self.att_proj1(torch.cat([inputs, self_att], dim=-1))
        h = self.layer_norm1(h + inputs)
        cross = self.cross_attention(h, memory, query_lengths, memory_lengths)
        h2 = self.att_proj2(torch.cat([h, cross], dim=-1))
        h2 = self.layer_norm2(h2 + h)
        return self.ffn(h2)
