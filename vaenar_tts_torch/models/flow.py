"""Normalizing-flow layers of the Glow prior, forward direction only
(counterpart of ``vaenar_tts_tpu/models/flow.py``): ActNorm (apply),
InvertibleLinear, TransformerTransform and TransformerCoupling.

Flow math is fp32. On CUDA the model turns TF32 off for matmuls and cuDNN
(``models.vaenar.resolve_device``), which this channel mix needs to stay
invertible.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .attention import CrossAttentionBlock
from .layers import positional_encoding, sequence_mask


def _length_logdet(logdet_scalar: torch.Tensor, lengths: Optional[torch.Tensor],
                   batch: int, max_time: int) -> torch.Tensor:
    """Per-example logdet = frames * per-frame logdet."""
    if lengths is None:
        return torch.full((batch,), float(max_time),
                          device=logdet_scalar.device) * logdet_scalar
    return lengths.float() * logdet_scalar


class ActNorm(nn.Module):
    """y = x * exp(log_scale) + bias, per channel."""

    def __init__(self, channels: int):
        super().__init__()
        self.log_scale = nn.Parameter(torch.zeros(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, lengths=None) -> Tuple[torch.Tensor, torch.Tensor]:
        out = x.float() * torch.exp(self.log_scale) + self.bias
        return out, _length_logdet(self.log_scale.sum(), lengths,
                                   x.shape[0], x.shape[1])


class InvertibleLinear(nn.Module):
    """Channel mix y = x @ W with logdet = frames * log|det W|."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.eye(channels))

    def forward(self, x, lengths=None) -> Tuple[torch.Tensor, torch.Tensor]:
        w = self.weight.float()
        _, logabsdet = torch.linalg.slogdet(w)
        out = torch.matmul(x.float(), w)
        return out, _length_logdet(logabsdet, lengths, x.shape[0], x.shape[1])


class TransformerTransform(nn.Module):
    """Text-conditioned scale/shift net inside a coupling: pre-projection ->
    positional encoding -> N CrossAttentionBlocks over the text -> scale and
    shift heads."""

    def __init__(self, in_dim: int, memory_dim: int, nblk: int,
                 attention_dim: int, attention_heads: int, temperature: float,
                 ffn_hidden: int, out_dim: int):
        super().__init__()
        self.pre_projection = nn.Linear(in_dim, attention_dim)
        self.pos_weight = nn.Parameter(torch.ones(()))
        self.names = [f"attention_{i}" for i in range(nblk)]
        for name in self.names:
            self.add_module(name, CrossAttentionBlock(
                attention_dim, memory_dim, attention_dim, attention_heads,
                temperature, ffn_hidden))
        self.log_scale_projection = nn.Linear(attention_dim, out_dim)
        self.shift_projection = nn.Linear(attention_dim, out_dim)

    def forward(self, inputs, condition_inputs, condition_lengths=None,
                target_lengths=None) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.pre_projection(inputs)
        pos = positional_encoding(x.shape[1], x.shape[2], device=x.device)
        x = x + self.pos_weight * pos[None]
        for name in self.names:
            x = getattr(self, name)(x, condition_inputs, target_lengths,
                                    condition_lengths)
        return self.log_scale_projection(x), self.shift_projection(x)


class TransformerCoupling(nn.Module):
    """Affine coupling: one half of the channels conditions the scale and
    shift of the other; 'upper' transforms the second half, 'lower' the
    first. scale = sigmoid(log_scale + 2)."""

    def __init__(self, channels: int, memory_dim: int, nblk: int,
                 attention_dim: int, attention_heads: int, temperature: float,
                 ffn_hidden: int, order: str = "upper"):
        super().__init__()
        if order not in ("upper", "lower"):
            raise ValueError(f"order must be 'upper' or 'lower', got {order!r}")
        self.order = order
        self.net = TransformerTransform(
            channels // 2, memory_dim, nblk, attention_dim, attention_heads,
            temperature, ffn_hidden, channels // 2)

    def forward(self, inputs, condition_inputs, inputs_lengths=None,
                condition_lengths=None) -> Tuple[torch.Tensor, torch.Tensor]:
        inputs = inputs.float()
        half = inputs.shape[-1] // 2
        lower, upper = inputs[..., :half], inputs[..., half:]
        z, zp = (lower, upper) if self.order == "upper" else (upper, lower)
        log_scale, shift = self.net(z, condition_inputs,
                                    condition_lengths=condition_lengths,
                                    target_lengths=inputs_lengths)
        scale = torch.sigmoid(log_scale.float() + 2.0)
        zp = scale * zp + shift.float()
        if inputs_lengths is not None:
            mask = sequence_mask(inputs_lengths, inputs.shape[1],
                                 torch.float32)[..., None]
        else:
            mask = torch.ones_like(scale)
        logdet = torch.sum(torch.log(scale) * mask, dim=(1, 2))
        out = (torch.cat([z, zp], dim=-1) if self.order == "upper"
               else torch.cat([zp, z], dim=-1))
        return out, logdet
