"""Shared layers: sequence mask, sinusoidal positional encoding with a
fractional step, Conv1D + BatchNorm, ConvPreNet, PreNet, FFN and PostNet
(counterpart of ``vaenar_tts_tpu/models/layers.py``).

Activations are ``[batch, time, channels]`` as in the JAX package; Conv1D
transposes around ``F.conv1d``. Submodule names follow the flax names, so
``interop.weights`` maps a parameter tree onto them one to one. Norms use
eps 1e-3 (the Keras default the reference trained with).

Training and inference differ through an explicit ``train`` flag, as in the
JAX package, not through ``nn.Module.train()``: with ``train=True`` dropout
draws its mask from the caller's ``torch.Generator`` and BatchNorm
normalises with the batch's statistics and updates its running ones the way
flax does (``BatchNorm`` below).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-3
BN_EPS = 1e-3

_ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "identity": lambda x: x,
    None: lambda x: x,
}


def get_activation(name):
    return _ACTIVATIONS[name]


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: with ``train`` and a rate above 0, keep each
    element with probability 1 - rate, drawn from ``generator``, and scale
    the kept ones by 1 / (1 - rate); otherwise the identity."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over [batch, channels, time] with flax's semantics.

    ``train=False`` normalises with the running statistics. ``train=True``
    normalises with the batch's mean and *biased* variance over (batch,
    time), padding included, var = max(mean(x²) - mean(x)², 0), and updates
    the running statistics as 0.99 * old + 0.01 * batch with that same
    biased variance. ``nn.BatchNorm1d`` in training mode would update
    ``running_var`` with the unbiased variance instead, and drift from the
    JAX package from the first step. Torch momentum 0.01 is flax momentum
    0.99; the parameter and buffer names are ``nn.BatchNorm1d``'s."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=BN_EPS, momentum=0.01)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        mean = x.mean(dim=(0, 2))
        var = torch.clamp((x * x).mean(dim=(0, 2)) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[None, :, None]) * mul[None, :, None] + self.bias[None, :, None]


def sequence_mask(lengths: torch.Tensor, maxlen: int,
                  dtype: torch.dtype = torch.bool) -> torch.Tensor:
    """[batch, maxlen]: position < length."""
    pos = torch.arange(maxlen, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).to(dtype)


def positional_encoding(length: int, dim: int, step: float = 1.0,
                        device: Optional[torch.device] = None) -> torch.Tensor:
    """[length, dim] float32; pe[p, i] = sin(p*step / 10000^(i/dim)) for even
    i and cos(p*step / 10000^((i-1)/dim)) for odd i. ``step`` scales
    positions (the text encoder uses mel_text_len_ratio / r)."""
    pos = torch.arange(length, dtype=torch.float32, device=device) * step
    idx = torch.arange(dim, dtype=torch.float32, device=device)
    even_freq = torch.pow(10000.0, idx / dim)
    odd_freq = torch.pow(10000.0, (idx - 1.0) / dim)
    angle_even = pos[:, None] / even_freq[None, :]
    angle_odd = pos[:, None] / odd_freq[None, :]
    is_even = (torch.arange(dim, device=device) % 2) == 0
    return torch.where(is_even[None, :], torch.sin(angle_even),
                       torch.cos(angle_odd))


class Conv1D(nn.Module):
    """SAME-padded conv -> BatchNorm around the activation -> dropout."""

    def __init__(self, in_channels: int, filters: int, kernel_size: int,
                 activation: Optional[str] = "relu",
                 bn_before_act: bool = False, drop_rate: float = 0.0):
        super().__init__()
        self.conv1d = nn.Conv1d(in_channels, filters, kernel_size)
        self.batch_norm = BatchNorm(filters)
        self.act = get_activation(activation)
        self.bn_before_act = bn_before_act
        self.drop_rate = drop_rate
        # flax SAME: total padding k-1, the smaller half on the left
        self.pad = ((kernel_size - 1) // 2, kernel_size - 1 - (kernel_size - 1) // 2)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.conv1d(F.pad(x.transpose(1, 2), self.pad))
        if self.bn_before_act:
            y = self.act(self.batch_norm(y, train))
        else:
            y = self.batch_norm(self.act(y), train)
        return dropout(y.transpose(1, 2), self.drop_rate, train, generator)


class ConvPreNet(nn.Module):
    """N x Conv1D -> linear projection."""

    def __init__(self, in_channels: int, nconv: int, hidden: int,
                 conv_kernel: int, activation: str = "relu",
                 bn_before_act: bool = True, drop_rate: float = 0.0):
        super().__init__()
        self.names = [f"PreNetConv{i}" for i in range(nconv)]
        for i, name in enumerate(self.names):
            self.add_module(name, Conv1D(in_channels if i == 0 else hidden,
                                         hidden, conv_kernel, activation,
                                         bn_before_act, drop_rate))
        self.projection = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for name in self.names:
            x = getattr(self, name)(x, train, generator)
        return self.projection(x)


class PreNet(nn.Module):
    """2 x (Dense -> activation -> dropout)."""

    def __init__(self, in_dim: int, units: int, activation: str = "relu",
                 drop_rate: float = 0.0):
        super().__init__()
        self.dense_1 = nn.Linear(in_dim, units)
        self.dense_2 = nn.Linear(units, units)
        self.act = get_activation(activation)
        self.drop_rate = drop_rate

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(self.act(self.dense_1(x)), self.drop_rate, train, generator)
        return dropout(self.act(self.dense_2(x)), self.drop_rate, train, generator)


class FFN(nn.Module):
    """LN(x + W2 relu(W1 x))."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.dense1 = nn.Linear(dim, hidden)
        self.dense2 = nn.Linear(hidden, dim)
        self.layer_norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer_norm(self.dense2(torch.relu(self.dense1(x))) + x)


class PostNet(nn.Module):
    """Conv stack with tanh activations, identity on the last conv, each
    with BatchNorm and dropout."""

    def __init__(self, in_channels: int, n_conv: int, conv_filters: int,
                 conv_kernel: int, drop_rate: float = 0.0):
        super().__init__()
        self.names = [f"conv_{i}" for i in range(n_conv)]
        for i, name in enumerate(self.names):
            self.add_module(name, Conv1D(
                in_channels if i == 0 else conv_filters, conv_filters,
                conv_kernel, "tanh" if i < n_conv - 1 else "identity",
                bn_before_act=False, drop_rate=drop_rate))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for name in self.names:
            x = getattr(self, name)(x, train, generator)
        return x
