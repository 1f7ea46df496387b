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
flax does (``BatchNorm`` below). Inside a data group
(``parallel/data_group.py``: this process's rows of a multi-process global
batch) the mask is this process's rows of the global batch's draw and the
statistics are the global batch's.

Compute dtype. Every module takes a ``dtype`` (``train.compute_dtype``:
fp32 or bf16), the counterpart of flax's ``dtype=`` field, and rounds where
flax does, by explicit casts (``torch.autocast`` rounds elsewhere: it keeps
LayerNorm's output fp32, for one). Parameters and BatchNorm statistics stay
fp32. ``Dense``, ``Conv`` and ``Embedding`` cast their input, weight and
bias to the dtype and return it: the product is rounded to it, then the bias
is added in it, as ``flax.linen.Dense`` does. ``LayerNorm`` and
``BatchNorm`` take their statistics and normalise in fp32 and return the
dtype. Elementwise operations follow the promotion of their operands, which
for tensors with dimensions is JAX's (bf16 with fp32 gives fp32).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.data_group import active, draw

LN_EPS = 1e-3
BN_EPS = 1e-3
# ``train.compute_dtype`` -> the torch dtype the transformer stacks run in
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

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
    mask = draw(torch.rand, x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=dtype)``. In fp32 one ``F.linear``; in bf16 the
    input, weight and bias are cast, the product rounded to bf16 and the
    bias added in bf16. With ``tp`` (``parallel/mesh.shard_params``) the
    weight holds this process's output columns: the product of the columns
    is gathered over the model group, then the bias is added."""

    tp = None  # a parallel.mesh.ColumnShard once sharded

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.tp is not None:
            y = self.tp.gather(F.linear(self.tp.enter(x).to(dt), self.weight.to(dt)), -1)
            return y if self.bias is None else y + self.bias.to(dt)
        if dt == torch.float32:
            return F.linear(x.float(), self.weight, self.bias)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class Conv(nn.Conv1d):
    """flax ``nn.Conv(dtype=dtype)`` on [batch, channels, time] that the
    caller has padded: in bf16 the input and weight are cast, the product
    rounded to bf16 and the bias added in bf16. ``groups`` is flax's
    ``feature_group_count`` (``groups=channels``: depthwise). With ``tp``
    the weight holds this process's output channels (as ``Dense``)."""

    tp = None

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dtype: torch.dtype = torch.float32, groups: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, groups=groups)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.tp is not None:
            y = self.tp.gather(F.conv1d(self.tp.enter(x).to(dt), self.weight.to(dt)), 1)
            return y + self.bias.to(dt)[None, :, None]
        if dt == torch.float32:
            return super().forward(x.float())
        return (F.conv1d(x.to(dt), self.weight.to(dt), groups=self.groups)
                + self.bias.to(dt)[None, :, None])


class Embedding(nn.Embedding):
    """flax ``nn.Embed(dtype=dtype)``: rows of the fp32 table, in dtype.
    With ``tp`` the table holds this process's columns of each row."""

    tp = None

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_embeddings, embedding_dim)
        self.compute_dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            return self.tp.gather(F.embedding(ids, self.weight), -1).to(self.compute_dtype)
        return super().forward(ids).to(self.compute_dtype)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(epsilon=eps, dtype=dtype)``: statistics and
    normalisation in fp32, the result in dtype. The model's norms use
    eps 1e-3; flax's default, which the vocoder keeps, is 1e-6."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32, eps: float = LN_EPS):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(self.compute_dtype)


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over [batch, channels, time] with flax's semantics.

    ``train=False`` normalises with the running statistics. ``train=True``
    normalises with the batch's mean and *biased* variance over (batch,
    time), padding included, var = max(mean(x²) - mean(x)², 0) (in a data
    group, mean(x) and mean(x²) of the global batch: the processes' means
    averaged, with the gradient carried back to every process), and updates
    the running statistics as 0.99 * old + 0.01 * batch with that same
    biased variance. ``nn.BatchNorm1d`` in training mode would update
    ``running_var`` with the unbiased variance instead, and drift from the
    JAX package from the first step. Torch momentum 0.01 is flax momentum
    0.99; the parameter and buffer names are ``nn.BatchNorm1d``'s. Both
    modes compute in fp32 and return ``dtype``, as flax's ``dtype=``."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__(channels, eps=BN_EPS, momentum=0.01)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.float()
        if not train:
            y = F.batch_norm(x, self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.eps)
            return y.to(self.compute_dtype)
        mean, mean_sq = x.mean(dim=(0, 2)), (x * x).mean(dim=(0, 2))
        group = active()
        if group is not None:  # the global batch's statistics
            mean, mean_sq = group.global_mean(torch.stack([mean, mean_sq])).unbind(0)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[None, :, None]) * mul[None, :, None] + self.bias[None, :, None]
        return y.to(self.compute_dtype)


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


def add_positions(x: torch.Tensor, pos_weight: torch.Tensor, dtype: torch.dtype,
                  step: float = 1.0) -> torch.Tensor:
    """x + pos_weight * PE as the JAX package computes it: the encoding is
    made in ``dtype`` (rounded to it), and the fp32 ``pos_weight`` parameter
    promotes the product, and so the sum, to fp32 (JAX promotes with a 0-d
    array; torch would not, hence the explicit ``float()``)."""
    pos = positional_encoding(x.shape[1], x.shape[2], step=step, device=x.device)
    return x + pos_weight * pos.to(dtype).float()[None]


class Conv1D(nn.Module):
    """SAME-padded conv -> BatchNorm around the activation -> dropout."""

    def __init__(self, in_channels: int, filters: int, kernel_size: int,
                 activation: Optional[str] = "relu",
                 bn_before_act: bool = False, drop_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1d = Conv(in_channels, filters, kernel_size, dtype)
        self.batch_norm = BatchNorm(filters, dtype)
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
                 bn_before_act: bool = True, drop_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.names = [f"PreNetConv{i}" for i in range(nconv)]
        for i, name in enumerate(self.names):
            self.add_module(name, Conv1D(in_channels if i == 0 else hidden,
                                         hidden, conv_kernel, activation,
                                         bn_before_act, drop_rate, dtype))
        self.projection = Dense(hidden, hidden, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for name in self.names:
            x = getattr(self, name)(x, train, generator)
        return self.projection(x)


class PreNet(nn.Module):
    """2 x (Dense -> activation -> dropout)."""

    def __init__(self, in_dim: int, units: int, activation: str = "relu",
                 drop_rate: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense_1 = Dense(in_dim, units, dtype=dtype)
        self.dense_2 = Dense(units, units, dtype=dtype)
        self.act = get_activation(activation)
        self.drop_rate = drop_rate

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(self.act(self.dense_1(x)), self.drop_rate, train, generator)
        return dropout(self.act(self.dense_2(x)), self.drop_rate, train, generator)


class FFN(nn.Module):
    """LN(x + W2 relu(W1 x))."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense1 = Dense(dim, hidden, dtype=dtype)
        self.dense2 = Dense(hidden, dim, dtype=dtype)
        self.layer_norm = LayerNorm(dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer_norm(self.dense2(torch.relu(self.dense1(x))) + x)


class PostNet(nn.Module):
    """Conv stack with tanh activations, identity on the last conv, each
    with BatchNorm and dropout."""

    def __init__(self, in_channels: int, n_conv: int, conv_filters: int,
                 conv_kernel: int, drop_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.names = [f"conv_{i}" for i in range(n_conv)]
        for i, name in enumerate(self.names):
            self.add_module(name, Conv1D(
                in_channels if i == 0 else conv_filters, conv_filters,
                conv_kernel, "tanh" if i < n_conv - 1 else "identity",
                bn_before_act=False, drop_rate=drop_rate, dtype=dtype))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for name in self.names:
            x = getattr(self, name)(x, train, generator)
        return x
