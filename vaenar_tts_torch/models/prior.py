"""Glow-style flow prior p(z | text), sampling direction (counterpart of
``vaenar_tts_tpu/models/prior.py:72-123``): base noise -> n_blk x (ActNorm
-> InvertibleLinear -> TransformerCoupling), with alternating coupling
order. All fp32."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from .flow import ActNorm, InvertibleLinear, TransformerCoupling
from .layers import sequence_mask

LOG_2PI = math.log(2.0 * math.pi)


class TransformerPrior(nn.Module):
    def __init__(self, n_blk: int, channels: int, memory_dim: int,
                 n_transformer_blk: int, attention_dim: int,
                 attention_heads: int, temperature: float, ffn_hidden: int):
        super().__init__()
        self.channels = channels
        self.n_blk = n_blk
        for i in range(n_blk):
            self.add_module(f"actnorm_{i}", ActNorm(channels))
            self.add_module(f"invertible_linear_{i}", InvertibleLinear(channels))
            self.add_module(f"transformerCoupling{i}", TransformerCoupling(
                channels, memory_dim, n_transformer_blk, attention_dim,
                attention_heads, temperature, ffn_hidden,
                order=("upper", "lower")[i % 2]))

    def _initial_sample(self, targets_lengths: torch.Tensor, max_length: int,
                        temperature: float = 1.0,
                        generator: Optional[torch.Generator] = None,
                        epsilon: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Base noise N(0, 1) * temperature and its masked log-prob. Pass
        ``epsilon`` [B, max_length, channels] to inject the standard-normal
        draw instead of taking it from ``generator``."""
        batch = targets_lengths.shape[0]
        if epsilon is None:
            epsilon = torch.randn((batch, max_length, self.channels),
                                  generator=generator,
                                  device=targets_lengths.device)
        epsilon = epsilon.float() * temperature
        logprobs = -0.5 * (LOG_2PI + epsilon ** 2)
        mask = sequence_mask(targets_lengths, max_length, torch.float32)[..., None]
        return epsilon, torch.sum(mask * logprobs, dim=(1, 2))

    def _forward_stack(self, z, logprobs, condition_inputs, targets_lengths,
                       condition_lengths) -> Tuple[torch.Tensor, torch.Tensor]:
        for i in range(self.n_blk):
            z, logdet = getattr(self, f"actnorm_{i}")(z, targets_lengths)
            logprobs = logprobs - logdet
            z, logdet = getattr(self, f"invertible_linear_{i}")(z, targets_lengths)
            logprobs = logprobs - logdet
            z, logdet = getattr(self, f"transformerCoupling{i}")(
                z, condition_inputs, inputs_lengths=targets_lengths,
                condition_lengths=condition_lengths)
            logprobs = logprobs - logdet
        return z, logprobs

    def sample(self, targets_lengths, condition_inputs, condition_lengths=None,
               max_length: Optional[int] = None, temperature: float = 1.0,
               generator: Optional[torch.Generator] = None,
               epsilon: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """z ~ p(z | text): [B, max_length, channels] and logprobs [B]."""
        if max_length is None:
            raise ValueError("max_length must be provided")
        eps, logprobs = self._initial_sample(targets_lengths, max_length,
                                             temperature, generator, epsilon)
        return self._forward_stack(eps, logprobs, condition_inputs,
                                   targets_lengths, condition_lengths)
