"""Normalizing-flow layers of the Glow prior (counterpart of
``vaenar_tts_tpu/models/flow.py``): ActNorm, InvertibleLinear,
TransformerTransform and TransformerCoupling. Each layer runs in both
directions: forward (sampling, ``reverse=False``) and reverse (the
log-probability of a latent, ``reverse=True``), and returns its output with
the per-example logdet of that direction. ActNorm also has the
data-dependent init of a cold start.

Flow math is fp32 whatever the compute dtype: ActNorm, the channel mix, its
inverse and slogdet, the affine coupling and every logdet. Only the
coupling's conditioning net (``TransformerTransform``) runs in the compute
dtype, and the coupling casts its scale and shift back to fp32. On CUDA the
model turns TF32 off for matmuls and cuDNN (``models.vaenar.resolve_device``),
which this channel mix, its inverse and its slogdet need to stay
invertible.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .attention import CrossAttentionBlock, maybe_remat
from ..parallel.data_group import active
from .layers import Dense, add_positions, sequence_mask


def _length_logdet(logdet_scalar: torch.Tensor, lengths: Optional[torch.Tensor],
                   batch: int, max_time: int) -> torch.Tensor:
    """Per-example logdet = frames * per-frame logdet."""
    if lengths is None:
        return torch.full((batch,), float(max_time),
                          device=logdet_scalar.device) * logdet_scalar
    return lengths.float() * logdet_scalar


def actnorm_init_stats(x: torch.Tensor, init_scale: float = 1.0,
                       epsilon: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Data-dependent ActNorm init: (log_scale, bias) that bring ``x`` to zero
    mean and ``init_scale`` std per channel, with the statistics taken over
    ALL positions, padding included, and the biased std (correction 0), as
    the JAX package's ``ActNorm(data_init=True)``. In a data group the
    statistics are the global batch's: the processes' sums and counts are
    summed, then the sums of squared deviations from the global mean."""
    flat = x.float().reshape(-1, x.shape[-1])
    group = active()
    if group is None:
        mean = flat.mean(dim=0)
        std = flat.std(dim=0, correction=0)
    else:
        count = torch.full((1,), float(flat.shape[0]), device=flat.device)
        sums = group.all_reduce_sum(torch.cat([flat.sum(dim=0), count]))
        mean = sums[:-1] / sums[-1]
        std = torch.sqrt(group.all_reduce_sum(torch.square(flat - mean).sum(dim=0))
                         / sums[-1])
    return torch.log(init_scale / (std + epsilon)), -mean / (std + epsilon)


class ActNorm(nn.Module):
    """y = x * exp(log_scale) + bias, per channel; the reverse is
    (y - bias) / (exp(log_scale) + 1e-8)."""

    def __init__(self, channels: int):
        super().__init__()
        self.log_scale = nn.Parameter(torch.zeros(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, lengths=None, reverse: bool = False,
                stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                epsilon: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
        """``stats``: (log_scale, bias) to apply in place of the parameters
        (the init pass applies the statistics it has just computed)."""
        log_scale, bias = stats if stats is not None else (self.log_scale, self.bias)
        x = x.float()
        if reverse:
            out = (x - bias) / (torch.exp(log_scale) + epsilon)
            logdet = -log_scale.sum()
        else:
            out = x * torch.exp(log_scale) + bias
            logdet = log_scale.sum()
        return out, _length_logdet(logdet, lengths, x.shape[0], x.shape[1])


def precompute_invertible_stack(weights: torch.Tensor, reverse: bool
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batched LU over a stack of invertible-linear weights [n, C, C]
    (``vaenar_tts_tpu/models/flow.py:90``): (the matrix each layer multiplies
    by, [n, C, C]: W forward, W⁻¹ from ``lu_solve`` against the identity in
    reverse; and the unsigned log|det W| of each, [n], the sum of
    log|diag U|). The sign of the determinant does not enter the density."""
    weights = weights.float()
    # the _ex forms skip the singularity check, a device-to-host sync that
    # stream capture refuses (training.steps.make_epoch_runner)
    lu, pivots, _ = torch.linalg.lu_factor_ex(weights, check_errors=False)
    logabsdets = torch.log(torch.abs(torch.diagonal(lu, dim1=-2, dim2=-1))).sum(-1)
    if not reverse:
        return weights, logabsdets
    eye = torch.eye(weights.shape[-1], dtype=torch.float32,
                    device=weights.device).expand_as(weights)
    return torch.linalg.lu_solve(lu, pivots, eye), logabsdets


class InvertibleLinear(nn.Module):
    """Channel mix y = x @ W with logdet = frames * log|det W|; the reverse
    multiplies by inv(W) and takes logdet = -frames * log|det W|. A caller
    that factored the whole stack at once (``precompute_invertible_stack``)
    passes this layer's (matrix, log|det W|) as ``precomputed``."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.eye(channels))

    def forward(self, x, lengths=None, reverse: bool = False,
                precomputed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if precomputed is not None:
            w, logabsdet = precomputed
        else:
            w = self.weight.float()
            _, logabsdet = torch.linalg.slogdet(w)
            if reverse:
                w = torch.linalg.inv_ex(w, check_errors=False)[0]
        if reverse:
            logabsdet = -logabsdet
        out = torch.matmul(x.float(), w)
        return out, _length_logdet(logabsdet, lengths, x.shape[0], x.shape[1])


class TransformerTransform(nn.Module):
    """Text-conditioned scale/shift net inside a coupling: pre-projection ->
    positional encoding -> N CrossAttentionBlocks over the text (under
    ``maybe_remat``) -> scale and shift heads."""

    def __init__(self, in_dim: int, memory_dim: int, nblk: int,
                 attention_dim: int, attention_heads: int, temperature: float,
                 ffn_hidden: int, out_dim: int, dtype: torch.dtype = torch.float32,
                 remat="off", ring=None):
        super().__init__()
        self.remat = remat
        self.compute_dtype = dtype
        self.pre_projection = Dense(in_dim, attention_dim, dtype=dtype)
        self.pos_weight = nn.Parameter(torch.ones(()))
        self.names = [f"attention_{i}" for i in range(nblk)]
        for name in self.names:
            self.add_module(name, CrossAttentionBlock(
                attention_dim, memory_dim, attention_dim, attention_heads,
                temperature, ffn_hidden, dtype, ring))
        self.log_scale_projection = Dense(attention_dim, out_dim, dtype=dtype)
        self.shift_projection = Dense(attention_dim, out_dim, dtype=dtype)

    def forward(self, inputs, condition_inputs, condition_lengths=None,
                target_lengths=None) -> Tuple[torch.Tensor, torch.Tensor]:
        x = add_positions(self.pre_projection(inputs), self.pos_weight,
                          self.compute_dtype)
        for name in self.names:
            x = maybe_remat(getattr(self, name), self.remat)(
                x, condition_inputs, target_lengths, condition_lengths)
        return self.log_scale_projection(x), self.shift_projection(x)


class TransformerCoupling(nn.Module):
    """Affine coupling: one half of the channels conditions the scale and
    shift of the other; 'upper' transforms the second half, 'lower' the
    first. scale = sigmoid(log_scale + 2); forward zp -> scale * zp + shift,
    reverse zp -> (zp - shift) / (scale + 1e-12), with the masked logdet of
    that direction."""

    def __init__(self, channels: int, memory_dim: int, nblk: int,
                 attention_dim: int, attention_heads: int, temperature: float,
                 ffn_hidden: int, order: str = "upper",
                 dtype: torch.dtype = torch.float32, remat="off", ring=None):
        super().__init__()
        if order not in ("upper", "lower"):
            raise ValueError(f"order must be 'upper' or 'lower', got {order!r}")
        self.order = order
        self.net = TransformerTransform(
            channels // 2, memory_dim, nblk, attention_dim, attention_heads,
            temperature, ffn_hidden, channels // 2, dtype, remat, ring)

    def forward(self, inputs, condition_inputs, inputs_lengths=None,
                condition_lengths=None, reverse: bool = False,
                epsilon: float = 1e-12) -> Tuple[torch.Tensor, torch.Tensor]:
        inputs = inputs.float()
        half = inputs.shape[-1] // 2
        lower, upper = inputs[..., :half], inputs[..., half:]
        z, zp = (lower, upper) if self.order == "upper" else (upper, lower)
        log_scale, shift = self.net(z, condition_inputs,
                                    condition_lengths=condition_lengths,
                                    target_lengths=inputs_lengths)
        scale = torch.sigmoid(log_scale.float() + 2.0)
        if reverse:
            zp = (zp - shift.float()) / (scale + epsilon)
        else:
            zp = scale * zp + shift.float()
        if inputs_lengths is not None:
            mask = sequence_mask(inputs_lengths, inputs.shape[1],
                                 torch.float32)[..., None]
        else:
            mask = torch.ones_like(scale)
        logdet = torch.sum(torch.log(scale) * mask, dim=(1, 2))
        if reverse:
            logdet = -logdet
        out = (torch.cat([z, zp], dim=-1) if self.order == "upper"
               else torch.cat([zp, z], dim=-1))
        return out, logdet
