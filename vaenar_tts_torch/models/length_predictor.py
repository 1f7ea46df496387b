"""Utterance length predictor (counterpart of
``vaenar_tts_tpu/models/length_predictor.py``): a per-token Dense(1) on the
text embeddings, in the compute dtype (a bf16 logit at bfloat16); the
predicted frame count is the masked sum over tokens of exp(projection), in
fp32. An optional second head reads the trained
quantile of the frame count instead of its mean; training holds it to that
quantile with ``pinball_log_loss``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import Dense, get_activation, sequence_mask


def masked_exp_sum(proj: torch.Tensor,
                   input_lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """[B, T, 1] logits -> [B] frame counts."""
    proj = proj.float()
    if input_lengths is not None:
        mask = sequence_mask(input_lengths, proj.shape[1], torch.float32)[..., None]
    else:
        mask = torch.ones_like(proj)
    return torch.sum(torch.exp(proj) * mask, dim=(1, 2))


def pinball_log_loss(predicted_lengths: torch.Tensor,
                     target_lengths: torch.Tensor, tau: float,
                     reduce: bool = False) -> torch.Tensor:
    """Quantile (pinball) loss in log-length space: with residual =
    log(target) - log(predicted), max(tau * residual, (tau - 1) * residual),
    [B] or its mean."""
    residual = torch.log(target_lengths.float()) - torch.log(predicted_lengths)
    loss = torch.maximum(tau * residual, (tau - 1.0) * residual)
    return loss.mean() if reduce else loss


class DenseLengthPredictor(nn.Module):
    def __init__(self, in_dim: int, activation: str = "identity",
                 quantile: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        if not 0.0 <= quantile < 1.0:
            raise ValueError(f"quantile must be in [0, 1), got {quantile}")
        self.act = get_activation(activation)
        self.quantile = quantile
        self.projection = Dense(in_dim, 1, dtype=dtype)
        self.q_projection = Dense(in_dim, 1, dtype=dtype) if quantile else None

    def forward(self, inputs, input_lengths=None) -> torch.Tensor:
        """Mean-head frame counts [B] (float)."""
        return masked_exp_sum(self.act(self.projection(inputs)), input_lengths)

    def quantile_lengths(self, inputs, input_lengths=None) -> torch.Tensor:
        """Quantile-head frame counts [B] (float)."""
        if self.q_projection is None:
            raise ValueError("quantile head disabled (quantile == 0)")
        return masked_exp_sum(self.act(self.q_projection(inputs)), input_lengths)
