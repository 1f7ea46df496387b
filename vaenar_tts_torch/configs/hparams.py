"""Hyper-parameter trees, the port's own copy of ``vaenar_tts_tpu.configs``.

Frozen dataclasses with the field names and defaults of the JAX package,
holding only the fields that synthesis reads: a ``hparams.json`` written by
JAX training loads unchanged, and the rest of it (the ``train`` section,
dropout rates, the audio front end) is ignored. The port computes in fp32
whatever ``train.compute_dtype`` says.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class DatasetConfig:
    mel_bucket: int = 120  # multiple of lcm(2,3,4,5)=60 so every r divides it
    text_bucket: int = 32


@dataclass(frozen=True)
class TextConfig:
    pad: str = "_"
    bos: str = "^"
    eos: str = "~"
    characters: str = "_^~abcdefghijklmnopqrstuvwxyz!'\"(),-.:;? []"


@dataclass(frozen=True)
class AudioConfig:
    num_mels: int = 80


@dataclass(frozen=True)
class CommonConfig:
    latent_dim: int = 128
    output_dim: int = 80
    final_reduction_factor: int = 2
    max_reduction_factor: int = 5
    mel_text_len_ratio: float = 5.59


@dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 43
    embd_dim: int = 512
    n_conv: int = 3
    pre_hidden: int = 512
    conv_kernel: int = 5
    pre_activation: str = "relu"
    bn_before_act: bool = False
    n_blk: int = 4
    attention_dim: int = 256
    attention_heads: int = 4
    attention_temperature: float = 1.0
    ffn_hidden: int = 1024


@dataclass(frozen=True)
class DecoderConfig:
    nblk: int = 2
    attention_dim: int = 256
    attention_heads: int = 4
    attention_temperature: float = 1.0
    ffn_hidden: int = 1024
    post_n_conv: int = 5
    post_conv_filters: int = 256
    post_conv_kernel: int = 5


@dataclass(frozen=True)
class PosteriorConfig:
    pre_hidden: int = 256
    pre_activation: str = "relu"
    nblk: int = 2
    attention_dim: int = 256
    attention_heads: int = 4
    temperature: float = 1.0
    ffn_hidden: int = 1024


@dataclass(frozen=True)
class PriorConfig:
    n_blk: int = 6
    n_transformer_blk: int = 2
    attention_dim: int = 256
    attention_heads: int = 4
    temperature: float = 1.0
    ffn_hidden: int = 1024


@dataclass(frozen=True)
class LengthPredictorConfig:
    activation: str = "identity"
    # > 0: a second Dense(1) head trained at this quantile of the frame count
    quantile: float = 0.0


@dataclass(frozen=True)
class HParams:
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    text: TextConfig = field(default_factory=TextConfig)
    audio: AudioConfig = field(default_factory=AudioConfig)
    common: CommonConfig = field(default_factory=CommonConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    posterior: PosteriorConfig = field(default_factory=PosteriorConfig)
    prior: PriorConfig = field(default_factory=PriorConfig)
    length_predictor: LengthPredictorConfig = field(
        default_factory=LengthPredictorConfig)
