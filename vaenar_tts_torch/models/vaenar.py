"""VAENAR synthesis (counterpart of ``vaenar_tts_tpu/models/vaenar.py:252-335``):
text -> encoder (fractional positional step mel_text_len_ratio / r) ->
length head -> flow-prior sample -> decoder + PostNet -> mel.

``load_model`` builds the model from a model directory holding
``hparams.json`` and ``export.npz``, on ``cuda`` unless the caller asks for
the CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
from torch import nn

from ..configs.hparams import HParams
from ..configs.serialize import load_hparams
from ..utils.export import EXPORT_NAME, load_npz
from .decoder import TransformerDecoder
from .encoder import TransformerEncoder
from .length_predictor import DenseLengthPredictor
from .posterior import TransformerPosterior
from .prior import TransformerPrior


def resolve_device(device="cuda") -> torch.device:
    """The device to run on. ``cuda`` without a card raises; there is no
    silent fall back to the CPU. On CUDA, TF32 is turned off for matmuls and
    cuDNN convolutions: the model's numerics are fp32 throughout."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' was asked for but no CUDA device "
                               "is available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return dev


class VAENAR(nn.Module):
    """Submodule names follow the flax tree, so ``interop.weights`` maps an
    export onto it key for key."""

    def __init__(self, hp: HParams):
        super().__init__()
        self.hp = hp
        enc, dec, pri = hp.encoder, hp.decoder, hp.prior
        text_dim = enc.pre_hidden
        self.mel_text_len_ratio = hp.common.mel_text_len_ratio
        self.length_quantile = float(hp.length_predictor.quantile)
        self.text_encoder = TransformerEncoder(
            enc.vocab_size, enc.embd_dim, enc.n_conv, enc.pre_hidden,
            enc.conv_kernel, enc.pre_activation, enc.bn_before_act, enc.n_blk,
            enc.attention_dim, enc.attention_heads, enc.attention_temperature,
            enc.ffn_hidden)
        self.decoder = TransformerDecoder(
            hp.common.latent_dim, text_dim, dec.nblk, dec.attention_dim,
            dec.attention_heads, dec.attention_temperature, dec.ffn_hidden,
            dec.post_n_conv, dec.post_conv_filters, dec.post_conv_kernel,
            hp.common.output_dim, hp.common.max_reduction_factor)
        self.length_predictor = DenseLengthPredictor(
            text_dim, hp.length_predictor.activation, self.length_quantile)
        post = hp.posterior
        self.posterior = TransformerPosterior(
            hp.audio.num_mels, text_dim, post.pre_hidden, post.pre_activation,
            post.nblk, post.attention_dim, post.attention_heads,
            post.temperature, post.ffn_hidden, hp.common.latent_dim)
        self.prior = TransformerPrior(
            pri.n_blk, hp.common.latent_dim, text_dim, pri.n_transformer_blk,
            pri.attention_dim, pri.attention_heads, pri.temperature,
            pri.ffn_hidden)

    def _encode(self, inputs, text_lengths, reduction_factor: int):
        return self.text_encoder(inputs, text_lengths,
                                 pos_step=self.mel_text_len_ratio / float(reduction_factor))

    @torch.no_grad()
    def infer(self, inputs, mel_lengths, text_lengths=None,
              reduction_factor: int = 2, max_mel_length: Optional[int] = None,
              temperature: float = 1.0,
              generator: Optional[torch.Generator] = None,
              epsilon: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sample z from the prior for the given mel lengths and decode."""
        r = reduction_factor
        if max_mel_length is None:
            raise ValueError("max_mel_length must be provided")
        reduced_lens = (mel_lengths + r - 1) // r
        text_embd = self._encode(inputs, text_lengths, r)
        z, _ = self.prior.sample(reduced_lens, text_embd, text_lengths,
                                 max_length=-(-max_mel_length // r),
                                 temperature=temperature, generator=generator,
                                 epsilon=epsilon)
        _, mel = self.decoder(z, text_embd, reduced_lens, text_lengths, r)
        return mel

    @torch.no_grad()
    def predict_lengths(self, inputs, text_lengths, reduction_factor: int = 2
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(mean-head, quantile-head or None) frame counts [B]."""
        text_embd = self._encode(inputs, text_lengths, reduction_factor)
        mean = self.length_predictor(text_embd, text_lengths)
        q = (self.length_predictor.quantile_lengths(text_embd, text_lengths)
             if self.length_quantile else None)
        return mean, q

    @torch.no_grad()
    def infer_with_length_prediction(
            self, inputs, text_lengths, max_mel_length: int,
            reduction_factor: int = 2, temperature: float = 0.0,
            length_headroom: int = 80, use_length_quantile: bool = False,
            generator: Optional[torch.Generator] = None,
            epsilon: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Predict lengths from the text (mean or quantile head), add
        ``length_headroom`` frames, clamp to ``max_mel_length``, sample and
        decode. Returns (mels [B, max_mel_length, out_dim], lengths [B])."""
        r = reduction_factor
        text_embd = self._encode(inputs, text_lengths, r)
        head = (self.length_predictor.quantile_lengths if use_length_quantile
                else self.length_predictor)
        predicted = torch.clamp(head(text_embd, text_lengths), 1.0,
                                float(max_mel_length))
        mel_lens = torch.clamp(predicted.to(torch.int32) + length_headroom,
                               max=max_mel_length)
        reduced_lens = (mel_lens + r - 1) // r
        z, _ = self.prior.sample(reduced_lens, text_embd, text_lengths,
                                 max_length=-(-max_mel_length // r),
                                 temperature=temperature, generator=generator,
                                 epsilon=epsilon)
        _, mel = self.decoder(z, text_embd, reduced_lens, text_lengths, r)
        return mel, mel_lens


def build_model(hp: HParams, params: dict, batch_stats: dict,
                device="cuda") -> VAENAR:
    """A VAENAR in eval mode on ``device`` with the given flax trees."""
    from ..interop.weights import load_jax_weights
    dev = resolve_device(device)
    model = VAENAR(hp)
    load_jax_weights(model, params, batch_stats)
    return model.eval().to(dev)


def load_model(model_dir: str, device="cuda") -> Tuple[HParams, VAENAR, int]:
    """(hparams, model, epoch) from ``model_dir``'s hparams.json and
    export.npz."""
    hp = load_hparams(model_dir)
    if hp is None:
        raise FileNotFoundError(f"no hparams.json in {model_dir}")
    path = os.path.join(model_dir, EXPORT_NAME)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {EXPORT_NAME} in {model_dir}")
    state = load_npz(path)
    model = build_model(hp, state["params"], state["batch_stats"], device)
    return hp, model, state["epoch"]
