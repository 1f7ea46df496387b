"""Non-autoregressive mel decoder (counterpart of
``vaenar_tts_tpu/models/decoder.py``): pre-projection -> N
CrossAttentionBlocks over the text -> linear head of out_dim *
max_reduction_factor, sliced to r * out_dim and reshaped to r frames per
latent step -> PostNet residual, the blocks under ``maybe_remat``. All in the compute dtype: at bfloat16 the
mels come out bf16, and the losses and the synthesis entry points cast them
to fp32. Asked for alignments, it also returns each block's cross-attention
weights, ``{"dec_<i>": fp32 [B, H, T, T_text]}``, as the JAX package's
plots path does (``vaenar_tts_tpu/models/decoder.py:53-67``)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .attention import CrossAttentionBlock, maybe_remat
from .layers import Dense, PostNet


class TransformerDecoder(nn.Module):
    def __init__(self, latent_dim: int, memory_dim: int, nblk: int,
                 attention_dim: int, attention_heads: int, temperature: float,
                 ffn_hidden: int, post_n_conv: int, post_conv_filters: int,
                 post_conv_kernel: int, out_dim: int,
                 max_reduction_factor: int, post_drop_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32, remat="off", ring=None):
        super().__init__()
        self.remat = remat
        self.out_dim = out_dim
        self.pre_projection = Dense(latent_dim, attention_dim, dtype=dtype)
        self.names = [f"decoder_attention_{i}" for i in range(nblk)]
        for name in self.names:
            self.add_module(name, CrossAttentionBlock(
                attention_dim, memory_dim, attention_dim, attention_heads,
                temperature, ffn_hidden, dtype, ring))
        self.linear_outputs = Dense(attention_dim, out_dim * max_reduction_factor,
                                    dtype=dtype)
        self.postnet = PostNet(out_dim, post_n_conv, post_conv_filters,
                               post_conv_kernel, post_drop_rate, dtype)
        self.residual_outputs = Dense(post_conv_filters, out_dim, dtype=dtype)

    def forward(self, inputs, text_embd, z_lengths=None, text_lengths=None,
                reduction_factor: int = 2, train: bool = False,
                generator: Optional[torch.Generator] = None,
                return_alignments: bool = False):
        """latents [B, T, latent] -> (initial, refined), each
        [B, T * r, out_dim], and with ``return_alignments`` the dict of
        alignments as a third value."""
        batch, max_len = inputs.shape[0], inputs.shape[1]
        x = self.pre_projection(inputs)
        alignments: Dict[str, torch.Tensor] = {}
        for i, name in enumerate(self.names):
            if return_alignments:
                x, alignments[f"dec_{i}"] = getattr(self, name)(
                    x, text_embd, z_lengths, text_lengths, return_alignment=True)
            else:
                x = maybe_remat(getattr(self, name), self.remat)(
                    x, text_embd, z_lengths, text_lengths)
        full = self.linear_outputs(x)
        initial = full[:, :, : reduction_factor * self.out_dim].reshape(
            batch, max_len * reduction_factor, self.out_dim)
        outputs = (self.residual_outputs(self.postnet(initial, train, generator))
                   + initial)
        return (initial, outputs, alignments) if return_alignments else (initial, outputs)
