"""Shared layers: sequence mask, sinusoidal positional encoding with a
fractional step, Conv1D + BatchNorm, ConvPreNet, PreNet, FFN and PostNet
(counterpart of ``vaenar_tts_tpu/models/layers.py``).

Activations are ``[batch, time, channels]`` as in the JAX package; Conv1D
transposes around ``F.conv1d``. Submodule names follow the flax names, so
``interop.weights`` maps a parameter tree onto them one to one. Norms use
eps 1e-3 (the Keras default the reference trained with); BatchNorm has torch
momentum 0.01, which is flax momentum 0.99.
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
    """SAME-padded conv -> BatchNorm around the activation (inference only:
    BatchNorm reads its running statistics and dropout is off)."""

    def __init__(self, in_channels: int, filters: int, kernel_size: int,
                 activation: Optional[str] = "relu",
                 bn_before_act: bool = False):
        super().__init__()
        self.conv1d = nn.Conv1d(in_channels, filters, kernel_size)
        self.batch_norm = nn.BatchNorm1d(filters, eps=BN_EPS, momentum=0.01)
        self.act = get_activation(activation)
        self.bn_before_act = bn_before_act
        # flax SAME: total padding k-1, the smaller half on the left
        self.pad = ((kernel_size - 1) // 2, kernel_size - 1 - (kernel_size - 1) // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1d(F.pad(x.transpose(1, 2), self.pad))
        if self.bn_before_act:
            y = self.act(self.batch_norm(y))
        else:
            y = self.batch_norm(self.act(y))
        return y.transpose(1, 2)


class ConvPreNet(nn.Module):
    """N x Conv1D -> linear projection."""

    def __init__(self, in_channels: int, nconv: int, hidden: int,
                 conv_kernel: int, activation: str = "relu",
                 bn_before_act: bool = True):
        super().__init__()
        self.names = [f"PreNetConv{i}" for i in range(nconv)]
        for i, name in enumerate(self.names):
            self.add_module(name, Conv1D(in_channels if i == 0 else hidden,
                                         hidden, conv_kernel, activation,
                                         bn_before_act))
        self.projection = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.names:
            x = getattr(self, name)(x)
        return self.projection(x)


class PreNet(nn.Module):
    """2 x (Dense -> activation); dropout is off at inference."""

    def __init__(self, in_dim: int, units: int, activation: str = "relu"):
        super().__init__()
        self.dense_1 = nn.Linear(in_dim, units)
        self.dense_2 = nn.Linear(units, units)
        self.act = get_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.dense_2(self.act(self.dense_1(x))))


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
    """Conv stack with tanh activations, identity on the last conv."""

    def __init__(self, in_channels: int, n_conv: int, conv_filters: int,
                 conv_kernel: int):
        super().__init__()
        self.names = [f"conv_{i}" for i in range(n_conv)]
        for i, name in enumerate(self.names):
            self.add_module(name, Conv1D(
                in_channels if i == 0 else conv_filters, conv_filters,
                conv_kernel, "tanh" if i < n_conv - 1 else "identity",
                bn_before_act=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.names:
            x = getattr(self, name)(x)
        return x
