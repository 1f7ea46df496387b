"""Attention-based VAE posterior q(z | mel, text) (counterpart of
``vaenar_tts_tpu/models/posterior.py``): PreNet -> positional encoding ->
dropout -> N CrossAttentionBlocks over the text (under ``maybe_remat``) -> mu and logvar heads, and
the reparameterised sample and its masked diagonal-Gaussian log-prob.
Training runs it; synthesis does not. The net runs in the compute dtype;
the mu and logvar heads, which the JAX package builds without a dtype, run
in fp32 on the promoted input, and the log-prob is fp32."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..parallel.data_group import draw
from .attention import CrossAttentionBlock, maybe_remat
from .layers import Dense, PreNet, add_positions, dropout, sequence_mask

LOG_2PI = math.log(2.0 * math.pi)


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor, nsamples: int = 1,
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """samples = eps * exp(logvar / 2) + mu with eps ~ N(0, 1) drawn from
    ``generator``, or the given ``eps``; returns (samples, eps), each
    [B, nsamples, T, dim]."""
    batch, max_time, dim = mu.shape
    if eps is None:
        eps = draw(torch.randn, (batch, nsamples, max_time, dim), generator=generator,
                   device=mu.device, dtype=mu.dtype)
    std = torch.exp(0.5 * logvar)
    return eps * std[:, None] + mu[:, None], eps


def gaussian_log_probability(mu: torch.Tensor, logvar: torch.Tensor,
                             z: Optional[torch.Tensor] = None,
                             eps: Optional[torch.Tensor] = None,
                             seq_lengths: Optional[torch.Tensor] = None,
                             epsilon: float = 1e-8) -> torch.Tensor:
    """Masked diagonal-Gaussian log-prob in fp32, [B, nsamples], of the
    samples ``z`` or of their standard-normal draws ``eps``."""
    batch, max_time, dim = mu.shape
    mu32, logvar32 = mu.float(), logvar.float()
    if eps is None:
        std = torch.exp(0.5 * logvar32)
        eps = (z.float() - mu32[:, None]) / (std[:, None] + epsilon)
    else:
        eps = eps.float()
    time_level = -0.5 * (float(dim) * LOG_2PI
                         + torch.sum(logvar32[:, None] + eps ** 2, dim=3))
    if seq_lengths is not None:
        mask = sequence_mask(seq_lengths, max_time, torch.float32)
    else:
        mask = torch.ones((batch, max_time), dtype=torch.float32, device=mu.device)
    return torch.sum(mask[:, None] * time_level, dim=2)


class TransformerPosterior(nn.Module):
    def __init__(self, in_dim: int, memory_dim: int, pre_hidden: int,
                 pre_activation: str, nblk: int, attention_dim: int,
                 attention_heads: int, temperature: float, ffn_hidden: int,
                 latent_dim: int, pre_drop_rate: float = 0.0,
                 pos_drop_rate: float = 0.0, dtype: torch.dtype = torch.float32,
                 remat="off", ring=None):
        super().__init__()
        self.remat = remat
        self.pos_drop_rate = pos_drop_rate
        self.compute_dtype = dtype
        self.decoder_prenet = PreNet(in_dim, pre_hidden, pre_activation,
                                     pre_drop_rate, dtype)
        self.pos_weight = nn.Parameter(torch.ones(()))
        self.names = [f"attention_{i}" for i in range(nblk)]
        for name in self.names:
            self.add_module(name, CrossAttentionBlock(
                pre_hidden, memory_dim, attention_dim, attention_heads,
                temperature, ffn_hidden, dtype, ring))
        self.mu_projection = Dense(attention_dim, latent_dim)
        self.logvar_projection = Dense(attention_dim, latent_dim)

    def forward(self, inputs, src_enc, src_lengths=None, target_lengths=None,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """reduced mels [B, T, num_mels] -> (mu, logvar), [B, T, latent]."""
        x = self.decoder_prenet(inputs, train, generator)
        x = dropout(add_positions(x, self.pos_weight, self.compute_dtype),
                    self.pos_drop_rate, train, generator)
        for name in self.names:
            x = maybe_remat(getattr(self, name), self.remat)(
                x, src_enc, target_lengths, src_lengths)
        return self.mu_projection(x), self.logvar_projection(x)
