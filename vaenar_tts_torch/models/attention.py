"""Masked multi-head attention and the transformer blocks (counterpart of
``vaenar_tts_tpu/models/attention.py``).

Every attention goes through ``ops.flash_attention.MaskedFlashAttention``:
the hand-written forward kernel and, for the gradient, the two backward
kernels on CUDA tensors; their plain versions on CPU tensors. q, k and v
reach it in the compute dtype (the projections' output), and o comes back
in it.
The blocks keep the reference's concat(input, context) -> Dense -> residual
-> LayerNorm topology, with the JAX package's promotions: a block whose
input is fp32 (the first block after a positional encoding) concatenates
and adds in fp32, and its LayerNorm returns the compute dtype.

Alignments (the attention weights, which the kernel never writes out) are
computed only when asked for (``return_weights``, the decoder's
cross-attention when synthesis is asked for alignments): the plain masked
softmax of the same q and k in fp32, as ``masked_attention_xla`` of the JAX
package forms them, with the finite NEG, so a row with no key stays
uniform. The contexts still come from the kernel, so the outputs are the
same with and without them.

Sequence parallelism: built with ``ring`` (a
``parallel.ring_attention.SequenceParallel``, from ``VAENAR(seq_mesh=)``),
a self-attention call (``inputs is memory``, one lengths tensor for queries
and keys, or none) whose length divides the ring's axis and reaches its
``min_seq`` runs on the ring (``ring_self_attention``) instead of the
kernel, exactly where the JAX package's ``MultiHeadAttention`` rings
(``vaenar_tts_tpu/models/attention.py:156-167``). Cross-attention and the
alignments stay on the kernel path.

``maybe_remat`` (``train.remat``) wraps a block's call in activation
checkpointing, at the sites where the JAX package's ``maybe_remat`` wraps
the block class: "on" keeps only the block's inputs and recomputes the
whole block in the backward, attention kernels included; "dots" keeps the
outputs of the matrix products (``aten.mm``, ``bmm`` and ``addmm``, as
``jax.checkpoint_policies.dots_saveable`` keeps dot_general's) and
recomputes the rest, the attention kernels too, whose outputs are not
products that the policy sees. The blocks draw no random numbers (dropout
lives in the prenets and positional encodings, outside them), so the
recompute needs no generator state put back and the RNG state is not
stashed.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch
from torch import nn
from torch.utils import checkpoint as _checkpoint

from ..ops.flash_attention import NEG, MaskedFlashAttention, attention_mask
from ..parallel.ring_attention import SequenceParallel, ring_self_attention
from .layers import FFN, Dense, LayerNorm

__all__ = ["attention_mask", "maybe_remat", "MultiHeadAttention",
           "SelfAttentionBlock", "CrossAttentionBlock"]

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    return (_checkpoint.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_mode(remat) -> str:
    """``train.remat`` as "off", "on" or "dots" (False, None and "off" are
    off; True, "on" and "full" on); any other value raises."""
    if remat in (False, None, "off"):
        return "off"
    if remat in (True, "on", "full"):
        return "on"
    if remat == "dots":
        return "dots"
    raise ValueError(f"remat must be 'off', 'on' or 'dots'; got {remat!r}")


def maybe_remat(block: nn.Module, remat) -> Callable:
    """``block`` itself with remat off, or while no gradient is recorded;
    otherwise a callable that runs it under non-reentrant
    ``torch.utils.checkpoint`` with the mode's policy."""
    mode = remat_mode(remat)
    if mode == "off" or not torch.is_grad_enabled():
        return block
    context_fn = (functools.partial(_checkpoint.create_selective_checkpoint_contexts,
                                    _dots_saveable) if mode == "dots"
                  else _checkpoint.noop_context_fn)
    return functools.partial(_checkpoint.checkpoint, block, use_reentrant=False,
                             preserve_rng_state=False, context_fn=context_fn)


class MultiHeadAttention(nn.Module):
    """Projections without bias, heads split to [B, H, T, D], scale
    1/(sqrt(D)*temperature), length masks on queries and keys, optional
    causal band; returns [B, Tq, attention_dim]."""

    def __init__(self, query_dim: int, memory_dim: int, attention_dim: int,
                 num_heads: int, temperature: float = 1.0,
                 dtype: torch.dtype = torch.float32,
                 ring: Optional[SequenceParallel] = None):
        super().__init__()
        self.ring = ring
        if attention_dim % num_heads:
            raise ValueError(f"attention_dim {attention_dim} is not a "
                             f"multiple of num_heads {num_heads}")
        self.num_heads = num_heads
        self.head_dim = attention_dim // num_heads
        self.scale = 1.0 / (math.sqrt(float(self.head_dim)) * temperature)
        self.query_layer = Dense(query_dim, attention_dim, bias=False, dtype=dtype)
        self.key_layer = Dense(memory_dim, attention_dim, bias=False, dtype=dtype)
        self.value_layer = Dense(memory_dim, attention_dim, bias=False, dtype=dtype)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return x.reshape(b, t, self.num_heads, self.head_dim).transpose(1, 2).contiguous()

    def forward(self, inputs: torch.Tensor, memory: torch.Tensor,
                query_lengths: Optional[torch.Tensor] = None,
                memory_lengths: Optional[torch.Tensor] = None,
                causal: bool = False, return_weights: bool = False):
        """The contexts [B, Tq, attention_dim], and with ``return_weights``
        also the attention weights, fp32 [B, H, Tq, Tk]."""
        q = self._split(self.query_layer(inputs))
        k = self._split(self.key_layer(memory))
        v = self._split(self.value_layer(memory))
        b, tq = q.shape[0], q.shape[2]
        if (self.ring is not None and inputs is memory and self.ring.eligible(tq, k.shape[2])
                and (query_lengths is None or memory_lengths is None
                     or query_lengths is memory_lengths)):
            lengths = query_lengths if query_lengths is not None else memory_lengths
            if lengths is None:
                lengths = torch.full((b,), tq, dtype=torch.int32, device=q.device)
            o = ring_self_attention(q, k, v, lengths, self.ring.dist, self.scale, causal,
                                    self.ring.axis)
        else:
            o = MaskedFlashAttention.apply(q, k, v, query_lengths, memory_lengths,
                                           self.scale, causal)
        out = o.transpose(1, 2).reshape(b, tq, self.num_heads * self.head_dim)
        if not return_weights:
            return out
        mask = attention_mask(query_lengths, memory_lengths, b, tq, k.shape[2], causal,
                              q.device)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * self.scale
        return out, torch.softmax(logits.masked_fill(~mask, NEG), dim=-1)


class SelfAttentionBlock(nn.Module):
    """MHA -> concat(input, ctx) -> Dense(input_dim) -> residual + LN -> FFN."""

    def __init__(self, input_dim: int, attention_dim: int, attention_heads: int,
                 attention_temperature: float = 1.0, ffn_hidden: int = 1024,
                 dtype: torch.dtype = torch.float32,
                 ring: Optional[SequenceParallel] = None):
        super().__init__()
        self.attention = MultiHeadAttention(input_dim, input_dim, attention_dim,
                                            attention_heads, attention_temperature,
                                            dtype, ring)
        self.att_proj = Dense(input_dim + attention_dim, input_dim, dtype=dtype)
        self.layer_norm = LayerNorm(input_dim, dtype)
        self.ffn = FFN(input_dim, ffn_hidden, dtype)

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
                 ffn_hidden: int = 1024, dtype: torch.dtype = torch.float32,
                 ring: Optional[SequenceParallel] = None):
        super().__init__()
        self.self_attention = MultiHeadAttention(
            input_dim, input_dim, attention_dim, attention_heads,
            attention_temperature, dtype, ring)
        self.att_proj1 = Dense(input_dim + attention_dim, input_dim, dtype=dtype)
        self.layer_norm1 = LayerNorm(input_dim, dtype)
        self.cross_attention = MultiHeadAttention(
            input_dim, memory_dim, attention_dim, attention_heads,
            attention_temperature, dtype)
        self.att_proj2 = Dense(input_dim + attention_dim, attention_dim, dtype=dtype)
        self.layer_norm2 = LayerNorm(attention_dim, dtype)
        self.ffn = FFN(attention_dim, ffn_hidden, dtype)

    def forward(self, inputs, memory, query_lengths=None,
                memory_lengths=None, return_alignment: bool = False):
        """The block's output, and with ``return_alignment`` also the
        cross-attention's weights, fp32 [B, H, Tq, T_memory]."""
        self_att = self.self_attention(inputs, inputs, query_lengths,
                                       query_lengths, causal=True)
        h = self.att_proj1(torch.cat([inputs, self_att], dim=-1))
        h = self.layer_norm1(h + inputs)
        cross = self.cross_attention(h, memory, query_lengths, memory_lengths,
                                     return_weights=return_alignment)
        if return_alignment:
            cross, alignment = cross
        h2 = self.att_proj2(torch.cat([h, cross], dim=-1))
        h2 = self.layer_norm2(h2 + h)
        out = self.ffn(h2)
        return (out, alignment) if return_alignment else out
