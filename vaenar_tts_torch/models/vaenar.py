"""The VAENAR model (counterpart of ``vaenar_tts_tpu/models/vaenar.py``).

Training forward (``forward``, the ELBO): frame-reduce the mels by stride
slicing -> encode the text (fractional positional step mel_text_len_ratio /
r) -> both length heads on the detached text embedding -> posterior mu and
logvar -> reparameterise n_sample times -> decode (L2 on the initial and the
PostNet outputs) -> the prior's log-prob of the samples through the reverse
flow -> KL as the mean log-prob difference.

Synthesis (``infer``, ``infer_with_length_prediction``): text -> encoder ->
length head -> flow-prior sample -> decoder + PostNet -> mel.

``init_pass`` and ``merge_flow_init``: the data-dependent ActNorm init of a
cold start. ``load_model`` builds the model from a model directory holding
``hparams.json`` and checkpoints or ``export.npz``, on ``cuda`` unless the
caller asks for the CPU.

Precision follows ``train.compute_dtype`` as in the JAX package: at
bfloat16 the transformer stacks (encoder, length heads' logits, posterior
net, couplings' conditioning nets, decoder and PostNet) run in bf16 on fp32
parameters, while the flow, the length heads' exp-sum, the Gaussian
log-probs, the posterior's mu and logvar heads and every loss are fp32; the
synthesized mels are returned as fp32.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.hparams import HParams
from ..configs.serialize import load_hparams
from ..parallel.ring_attention import SequenceParallel
from ..utils.export import EXPORT_NAME, load_npz
from .decoder import TransformerDecoder
from .encoder import TransformerEncoder
from .attention import remat_mode
from .layers import COMPUTE_DTYPES, sequence_mask
from .length_predictor import DenseLengthPredictor, pinball_log_loss
from .posterior import (TransformerPosterior, gaussian_log_probability,
                        reparameterize)
from .prior import TransformerPrior


def resolve_device(device="cuda") -> torch.device:
    """The device to run on. ``cuda`` without a card raises; there is no
    silent fall back to the CPU. On CUDA, TF32 is turned off for matmuls and
    cuDNN convolutions, so that fp32 products stay fp32: the flow's always,
    and the transformer stacks' at ``compute_dtype`` float32 (at bfloat16
    they are bf16 products on the tensor cores, which TF32 does not touch)."""
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
    export onto it key for key.

    ``seq_mesh`` (a ``parallel.distributed.DistContext``, the port's
    counterpart of the JAX package's device mesh) turns on sequence
    parallelism, as ``VAENAR(hp, seq_mesh=, seq_axis=)`` does in the JAX
    package (``vaenar_tts_tpu/models/vaenar.py:46-72``): every
    self-attention whose length divides the mesh's ``seq_axis`` and
    reaches ``hp.train.ring_min_seq`` runs on the ring
    (``parallel/ring_attention.py``), over the processes of one model
    group, which all run this model on the same rows. Cross-attention and
    everything else stay as they are."""

    def __init__(self, hp: HParams, seq_mesh=None, seq_axis: str = "model"):
        super().__init__()
        self.hp = hp
        enc, dec, pri = hp.encoder, hp.decoder, hp.prior
        text_dim = enc.pre_hidden
        self.mel_text_len_ratio = hp.common.mel_text_len_ratio
        self.max_reduction_factor = hp.common.max_reduction_factor
        self.n_sample = hp.train.num_samples
        self.length_quantile = float(hp.length_predictor.quantile)
        dtype = COMPUTE_DTYPES[hp.train.compute_dtype]
        remat = remat_mode(hp.train.remat)
        ring = None
        if seq_mesh is not None:
            if seq_axis != "model":
                raise ValueError(f"the ring runs over the mesh's model axis, not {seq_axis!r}")
            ring = SequenceParallel(seq_mesh, seq_axis, hp.train.ring_min_seq)
        self.text_encoder = TransformerEncoder(
            enc.vocab_size, enc.embd_dim, enc.n_conv, enc.pre_hidden,
            enc.conv_kernel, enc.pre_activation, enc.bn_before_act, enc.n_blk,
            enc.attention_dim, enc.attention_heads, enc.attention_temperature,
            enc.ffn_hidden, enc.pre_drop_rate, enc.pos_drop_rate, dtype, remat, ring)
        self.decoder = TransformerDecoder(
            hp.common.latent_dim, text_dim, dec.nblk, dec.attention_dim,
            dec.attention_heads, dec.attention_temperature, dec.ffn_hidden,
            dec.post_n_conv, dec.post_conv_filters, dec.post_conv_kernel,
            hp.common.output_dim, hp.common.max_reduction_factor,
            dec.post_drop_rate, dtype, remat, ring)
        self.length_predictor = DenseLengthPredictor(
            text_dim, hp.length_predictor.activation, self.length_quantile, dtype)
        post = hp.posterior
        self.posterior = TransformerPosterior(
            hp.audio.num_mels, text_dim, post.pre_hidden, post.pre_activation,
            post.nblk, post.attention_dim, post.attention_heads,
            post.temperature, post.ffn_hidden, hp.common.latent_dim,
            post.pre_drop_rate, post.pos_drop_rate, dtype, remat, ring)
        self.prior = TransformerPrior(
            pri.n_blk, hp.common.latent_dim, text_dim, pri.n_transformer_blk,
            pri.attention_dim, pri.attention_heads, pri.temperature,
            pri.ffn_hidden, dtype, pri.batched_lu, remat, ring)

    def _encode(self, inputs, text_lengths, reduction_factor: int,
                train: bool = False, generator: Optional[torch.Generator] = None):
        return self.text_encoder(inputs, text_lengths,
                                 pos_step=self.mel_text_len_ratio / float(reduction_factor),
                                 train=train, generator=generator)

    # -- training forward (vaenar_tts_tpu/models/vaenar.py:138-249) ---------

    def _l2_loss(self, reconstructed, targets, lengths, reduce: bool):
        """Masked per-frame L2 over [B * n, T, D], averaged over the n
        samples of each example: [B] or its mean."""
        n = self.n_sample
        max_time, dim = reconstructed.shape[1], reconstructed.shape[2]
        r = reconstructed.float().reshape(-1, n, max_time, dim)
        t = targets.float().reshape(-1, n, max_time, dim)
        mask = sequence_mask(lengths, max_time, torch.float32).reshape(-1, n, max_time)
        lens = lengths.reshape(-1, n).float()
        per_t = torch.mean(torch.square(r - t), dim=-1)
        l2 = torch.mean(torch.sum(per_t * mask, dim=-1) / lens, dim=-1)
        return l2.mean() if reduce else l2

    def forward(self, inputs, mel_targets, mel_lengths, text_lengths,
                reduction_factor: int = 2, train: bool = True,
                reduce_loss: bool = True,
                generator: Optional[torch.Generator] = None,
                epsilon: Optional[torch.Tensor] = None):
        """The ELBO terms of a batch: (decoded mels [B * n, T_mel, D],
        mel_l2, kl, length_loss, pinball), each loss [B] or its mean. The
        length loss includes the quantile head's pinball term, which is also
        returned alone (None without a quantile head). ``generator`` draws
        dropout and the posterior noise; ``epsilon`` [B, n, T_reduced,
        latent] injects that noise instead."""
        r = reduction_factor
        n = self.n_sample
        batch, mel_max_len = mel_targets.shape[0], mel_targets.shape[1]
        reduced_mels = mel_targets[:, ::r, :]
        reduced_lens = (mel_lengths + r - 1) // r
        reduced_max = reduced_mels.shape[1]

        text_embd = self._encode(inputs, text_lengths, r, train, generator)
        # the length heads learn from the text embedding but do not train it
        detached = text_embd.detach()
        predicted = self.length_predictor(detached, text_lengths)
        length_loss = torch.square(torch.log(predicted)
                                   - torch.log(mel_lengths.float()))
        length_loss = length_loss.mean() if reduce_loss else length_loss
        pinball = None
        if self.length_quantile:
            q_lengths = self.length_predictor.quantile_lengths(detached, text_lengths)
            pinball = pinball_log_loss(q_lengths, mel_lengths,
                                       self.length_quantile, reduce=reduce_loss)
            length_loss = length_loss + pinball

        mu, logvar = self.posterior(reduced_mels, text_embd, text_lengths,
                                    reduced_lens, train, generator)
        samples, eps = reparameterize(mu, logvar, n, generator, epsilon)
        posterior_logprobs = gaussian_log_probability(mu, logvar, eps=eps,
                                                      seq_lengths=reduced_lens)

        def tile(x):
            return torch.repeat_interleave(x, n, dim=0) if n > 1 else x

        batched_samples = samples.reshape(batch * n, reduced_max, samples.shape[-1])
        b_text_embd, b_mels = tile(text_embd), tile(mel_targets)
        b_mel_lens, b_reduced_lens = tile(mel_lengths), tile(reduced_lens)
        b_text_lens = tile(text_lengths)

        initial, outs = self.decoder(batched_samples, b_text_embd, b_reduced_lens,
                                     b_text_lens, r, train, generator)
        initial, outs = initial[:, :mel_max_len], outs[:, :mel_max_len]
        l2_loss = (self._l2_loss(outs, b_mels, b_mel_lens, reduce_loss)
                   + self._l2_loss(initial, b_mels, b_mel_lens, reduce_loss))

        prior_logprobs = self.prior.log_probability(
            batched_samples, b_text_embd, b_reduced_lens, b_text_lens)
        kl = torch.mean(posterior_logprobs - prior_logprobs.reshape(batch, n), dim=1)
        kl = kl.mean() if reduce_loss else kl
        return outs, l2_loss, kl, length_loss, pinball

    # -- data-dependent init (vaenar_tts_tpu/models/vaenar.py:342-380) ------

    def init_pass(self, inputs, mel_lengths, text_lengths, max_mel_length: int,
                  generator: Optional[torch.Generator] = None,
                  epsilon: Optional[torch.Tensor] = None
                  ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """Encode (train mode: dropout from ``generator``, BatchNorm on the
        batch's statistics) and run the prior's init pass at the maximum
        reduction factor; returns the ActNorm statistics, keyed
        ``prior.actnorm_{i}``, for ``merge_flow_init``. The JAX package's
        pass also decodes the flow's output; nothing of that is kept, so it
        is left out here. BatchNorm's running statistics move in this pass,
        as they do in the JAX pass; ``training.steps.run_data_dependent_init``
        puts them back, as the JAX caller keeps only ``flow_init``."""
        r = self.max_reduction_factor
        reduced_lens = (mel_lengths + r - 1) // r
        text_embd = self._encode(inputs, text_lengths, r, True, generator)
        _, flow_init = self.prior.init_pass(
            text_embd, reduced_lens, text_lengths,
            max_length=-(-max_mel_length // r), generator=generator,
            epsilon=epsilon)
        return {f"prior.{k}": v for k, v in flow_init.items()}

    @torch.no_grad()
    def merge_flow_init(self, flow_init: Dict[str, Tuple[torch.Tensor, torch.Tensor]]
                        ) -> None:
        """Copy ``init_pass``'s ActNorm statistics into the parameters."""
        modules = dict(self.named_modules())
        for name, (log_scale, bias) in flow_init.items():
            modules[name].log_scale.copy_(log_scale)
            modules[name].bias.copy_(bias)

    @torch.no_grad()
    def infer(self, inputs, mel_lengths, text_lengths=None,
              reduction_factor: int = 2, max_mel_length: Optional[int] = None,
              temperature: float = 1.0,
              generator: Optional[torch.Generator] = None,
              epsilon: Optional[torch.Tensor] = None,
              return_alignments: bool = False):
        """Sample z from the prior for the given mel lengths and decode:
        mels [B, max_mel_length, out_dim], and with ``return_alignments``
        the decoder's ``{"dec_<i>": [B, H, T_reduced, T_text]}`` too."""
        r = reduction_factor
        if max_mel_length is None:
            raise ValueError("max_mel_length must be provided")
        reduced_lens = (mel_lengths + r - 1) // r
        text_embd = self._encode(inputs, text_lengths, r)
        z, _ = self.prior.sample(reduced_lens, text_embd, text_lengths,
                                 max_length=-(-max_mel_length // r),
                                 temperature=temperature, generator=generator,
                                 epsilon=epsilon)
        decoded = self.decoder(z, text_embd, reduced_lens, text_lengths, r,
                               return_alignments=return_alignments)
        mel = decoded[1].float()
        return (mel, decoded[2]) if return_alignments else mel

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
            epsilon: Optional[torch.Tensor] = None,
            return_alignments: bool = False):
        """Predict lengths from the text (mean or quantile head), add
        ``length_headroom`` frames, clamp to ``max_mel_length``, sample and
        decode. Returns (mels [B, max_mel_length, out_dim], lengths [B]),
        and with ``return_alignments`` the decoder's alignments (``infer``)
        as a third value."""
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
        decoded = self.decoder(z, text_embd, reduced_lens, text_lengths, r,
                               return_alignments=return_alignments)
        mel = decoded[1].float()
        return (mel, mel_lens, decoded[2]) if return_alignments else (mel, mel_lens)


def build_model(hp: HParams, params: dict, batch_stats: dict,
                device="cuda") -> VAENAR:
    """A VAENAR in eval mode on ``device`` with the given flax trees."""
    from ..interop.weights import load_jax_weights
    dev = resolve_device(device)
    model = VAENAR(hp)
    load_jax_weights(model, params, batch_stats)
    return model.eval().to(dev)


def load_model(model_dir: str, device="cuda", compute_dtype: Optional[str] = None,
               epoch: Optional[int] = None) -> Tuple[HParams, VAENAR, int]:
    """(hparams, model, epoch) from ``model_dir``: its hparams.json, and the
    weights of its newest checkpoint (``utils.checkpoint``), or of the
    checkpoint of ``epoch``; only a directory without checkpoints falls back
    to its export.npz, as the JAX package's ``load_model_state``
    (``vaenar_tts_tpu/cli/inference.py:37-89``) does. ``compute_dtype``
    ("float32" or "bfloat16") overrides the file's ``train.compute_dtype``:
    the parameters are fp32 either way."""
    from ..utils.checkpoint import CheckpointManager
    hp = load_hparams(model_dir)
    if hp is None:
        raise FileNotFoundError(f"no hparams.json in {model_dir}")
    if compute_dtype:
        hp = dataclasses.replace(hp, train=dataclasses.replace(
            hp.train, compute_dtype=compute_dtype))
    ckpt = CheckpointManager(model_dir)
    epochs = ckpt.epochs()
    if epoch is not None and epoch not in epochs:
        raise FileNotFoundError(f"no epoch-{epoch} checkpoint in {model_dir}")
    if epochs:
        model = VAENAR(hp).to(resolve_device(device))
        return hp, model.eval(), ckpt.restore(model, epoch=epoch)
    path = os.path.join(model_dir, EXPORT_NAME)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint and no {EXPORT_NAME} in {model_dir}")
    state = load_npz(path)
    model = build_model(hp, state["params"], state["batch_stats"], device)
    return hp, model, state["epoch"]
