"""Glow-style flow prior p(z | text) (counterpart of
``vaenar_tts_tpu/models/prior.py``): n_blk x (ActNorm -> InvertibleLinear ->
TransformerCoupling), with alternating coupling order. The flow math is fp32; the couplings'
conditioning nets run in the compute dtype. Three entry points:

* ``sample``: base noise -> forward through the stack; the log-prob
  accumulates -logdet of each layer;
* ``log_probability``: the stack in reverse, from z back to the base noise;
  log p(z | text) = N(eps) + the sum of the reverse logdets;
* ``init_pass``: the forward stack with ActNorm's data-dependent init; each
  ActNorm applies the statistics of its own input, and the pass returns them
  (``flow_init``) for the caller to copy into the parameters.

With ``batched_lu`` (``hp.prior.batched_lu``) each direction factors the
stacked invertible-linear weights with one batched LU
(``flow.precompute_invertible_stack``) in place of a slogdet and, in
reverse, an inverse a layer: the same math, an A/B knob.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .flow import (ActNorm, InvertibleLinear, TransformerCoupling, actnorm_init_stats,
                   precompute_invertible_stack)
from ..parallel.data_group import draw
from .layers import sequence_mask

LOG_2PI = math.log(2.0 * math.pi)


class TransformerPrior(nn.Module):
    def __init__(self, n_blk: int, channels: int, memory_dim: int,
                 n_transformer_blk: int, attention_dim: int,
                 attention_heads: int, temperature: float, ffn_hidden: int,
                 dtype: torch.dtype = torch.float32, batched_lu: bool = False,
                 remat="off", ring=None):
        super().__init__()
        self.channels = channels
        self.n_blk = n_blk
        self.batched_lu = batched_lu
        for i in range(n_blk):
            self.add_module(f"actnorm_{i}", ActNorm(channels))
            self.add_module(f"invertible_linear_{i}", InvertibleLinear(channels))
            self.add_module(f"transformerCoupling{i}", TransformerCoupling(
                channels, memory_dim, n_transformer_blk, attention_dim,
                attention_heads, temperature, ffn_hidden,
                order=("upper", "lower")[i % 2], dtype=dtype, remat=remat, ring=ring))

    def _linear_precompute(self, reverse: bool) -> list:
        """Each layer's ``precomputed`` for InvertibleLinear: one batched LU
        over the stack with ``batched_lu``, else None a layer."""
        if not self.batched_lu:
            return [None] * self.n_blk
        weights = torch.stack([getattr(self, f"invertible_linear_{i}").weight
                               for i in range(self.n_blk)])
        mats, logabsdets = precompute_invertible_stack(weights, reverse)
        return [(mats[i], logabsdets[i]) for i in range(self.n_blk)]

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
            epsilon = draw(torch.randn, (batch, max_length, self.channels),
                           generator=generator, device=targets_lengths.device)
        epsilon = epsilon.float() * temperature
        logprobs = -0.5 * (LOG_2PI + epsilon ** 2)
        mask = sequence_mask(targets_lengths, max_length, torch.float32)[..., None]
        return epsilon, torch.sum(mask * logprobs, dim=(1, 2))

    def _forward_stack(self, z, logprobs, condition_inputs, targets_lengths,
                       condition_lengths,
                       flow_init: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``flow_init``: a dict to fill with each ActNorm's data-dependent
        (log_scale, bias), which that ActNorm then applies."""
        pre = self._linear_precompute(reverse=False)
        for i in range(self.n_blk):
            stats = None
            if flow_init is not None:
                stats = flow_init[f"actnorm_{i}"] = actnorm_init_stats(z)
            z, logdet = getattr(self, f"actnorm_{i}")(z, targets_lengths,
                                                      stats=stats)
            logprobs = logprobs - logdet
            z, logdet = getattr(self, f"invertible_linear_{i}")(z, targets_lengths,
                                                                precomputed=pre[i])
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

    def log_probability(self, z, condition_inputs, z_lengths=None,
                        condition_lengths=None) -> torch.Tensor:
        """log p(z | text) [B]: the stack in reverse down to the base
        noise."""
        epsilon = z.float()
        accum_logdet = torch.zeros((z.shape[0],), dtype=torch.float32,
                                   device=z.device)
        pre = self._linear_precompute(reverse=True)
        for i in reversed(range(self.n_blk)):
            epsilon, logdet = getattr(self, f"transformerCoupling{i}")(
                epsilon, condition_inputs, inputs_lengths=z_lengths,
                condition_lengths=condition_lengths, reverse=True)
            accum_logdet = accum_logdet + logdet
            epsilon, logdet = getattr(self, f"invertible_linear_{i}")(
                epsilon, z_lengths, reverse=True, precomputed=pre[i])
            accum_logdet = accum_logdet + logdet
            epsilon, logdet = getattr(self, f"actnorm_{i}")(
                epsilon, z_lengths, reverse=True)
            accum_logdet = accum_logdet + logdet
        logprobs = -0.5 * (LOG_2PI + epsilon ** 2)
        mask = sequence_mask(z_lengths, z.shape[1], torch.float32)[..., None]
        return torch.sum(mask * logprobs, dim=(1, 2)) + accum_logdet

    def init_pass(self, conditions, targets_lengths, condition_lengths=None,
                  max_length: Optional[int] = None,
                  generator: Optional[torch.Generator] = None,
                  epsilon: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, Tuple[torch.Tensor, torch.Tensor]]]:
        """The forward stack from base noise with ActNorm's data-dependent
        init; returns (z, flow_init) with flow_init[f"actnorm_{i}"] =
        (log_scale, bias). The parameters are left as they are."""
        if max_length is None:
            raise ValueError("max_length must be provided")
        eps, logprobs = self._initial_sample(targets_lengths, max_length,
                                             1.0, generator, epsilon)
        flow_init: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        z, _ = self._forward_stack(eps, logprobs, conditions, targets_lengths,
                                   condition_lengths, flow_init=flow_init)
        return z, flow_init
