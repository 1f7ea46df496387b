"""Hyper-parameter trees, the port's own copy of ``vaenar_tts_tpu.configs``.

Frozen dataclasses with the field names and defaults of the JAX package,
holding only the fields that the port's synthesis, vocoder and training
read: a ``hparams.json`` written by JAX training loads unchanged, and the
rest of it (the TPU-only knobs such as ``use_pallas_attention``) is
ignored. The two presets are ``LJSpeechConfig`` and ``DataBakerConfig``
(16 kHz Mandarin pinyin); ``get_config`` looks one up by its CLI name.
``train.compute_dtype`` ("bfloat16", the default, or "float32") is the
transformer stacks' dtype, as in the JAX package; the flow stays fp32
(``models/vaenar.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# the values ``train.remat`` takes, as the JAX package's ``maybe_remat``
# reads them: False, None and "off" are off; True, "on" and "full" on
REMAT_MODES = (False, None, "off", True, "on", "full", "dots")


@dataclass(frozen=True)
class TrainConfig:
    random_seed: int = 123456
    epochs: int = 2000
    train_batch_size: int = 32
    test_batch_size: int = 8
    # every this many epochs the loop synthesizes one test batch to wavs,
    # plots and quality metrics (``training/loop.py``)
    test_interval: int = 50
    shuffle: bool = True
    num_samples: int = 1
    length_weight: float = 1.0
    kl_weight_init: float = 1e-5
    kl_weight_increase_epoch: int = 1
    kl_weight_end: float = 1e-5
    learning_rate: float = 1.25e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-7
    reduction_factors: Tuple[int, ...] = (5, 4, 3, 2)
    reduce_interval: Tuple[int, ...] = (0, 200, 400, 600)
    # transformer-stack dtype on fp32 parameters; the flow stays fp32
    compute_dtype: str = "bfloat16"
    # micro-batches per step: gradients averaged, one Adam update
    grad_accum: int = 1
    # activation checkpointing of every transformer block: "off", "on"
    # (recompute the whole block in the backward) or "dots" (keep the
    # matmul outputs, recompute the rest); models/attention.maybe_remat
    remat: str = "off"
    # the shortest self-attention that rings over the mesh's sequence axis
    # when the model is built with ``VAENAR(seq_mesh=)``
    # (parallel/ring_attention.py); 0 rings every one whose length divides
    # the axis
    ring_min_seq: int = 1024
    # > 0: when the train split (and the dev split, counted here too) fits
    # in this many MB and every train batch has one shape, the loop keeps
    # the batches on the device for the whole run (training/loop.py)
    device_data_cache_mb: int = 0
    # the JAX package's one-dispatch epoch over the cache; the port has no
    # counterpart yet and refuses True at the start of training
    device_cache_epoch_scan: bool = False
    checkpoint_max_to_keep: int = 20
    checkpoint_keep_every_n_hours: float = 4.0
    checkpoint_every_n_epochs: int = 1

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"train.compute_dtype must be 'float32' or 'bfloat16'; "
                             f"got {self.compute_dtype!r}")
        if self.remat not in REMAT_MODES:
            raise ValueError(f"train.remat must be 'off', 'on' or 'dots'; got {self.remat!r}")

    def kl_weight_at(self, epoch: int) -> float:
        """KL-anneal schedule (``vaenar_tts_tpu/configs/hparams.py:119``)."""
        step = (self.kl_weight_end - self.kl_weight_init) / self.kl_weight_increase_epoch
        if epoch <= self.kl_weight_increase_epoch:
            return self.kl_weight_init + step * epoch
        return self.kl_weight_end

    def reduction_factor_at(self, epoch: int) -> int:
        """Reduction-factor curriculum: the factor of the last interval that
        has started by ``epoch``."""
        i = 0
        while i < len(self.reduce_interval) and self.reduce_interval[i] <= epoch:
            i += 1
        i = i - 1 if i > 0 else 0
        return self.reduction_factors[i]


@dataclass(frozen=True)
class DatasetConfig:
    record_split: int = 8  # train shards written by preprocessing
    dev_set_rate: float = 0.01
    test_set_rate: float = 0.01
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
    num_freq: int = 1025
    min_mel_freq: float = 0.0
    max_mel_freq: float = 8000.0
    sample_rate: int = 22050
    frame_length_sample: int = 1024
    frame_shift_sample: int = 256
    n_mfcc: int = 13
    preemphasize: Optional[float] = 0.97
    min_level_db: float = -100.0
    ref_level_db: float = 20.0
    max_abs_value: float = 1.0
    symmetric_specs: bool = False
    griffin_lim_iters: int = 60
    power: float = 1.5
    center: bool = True

    @property
    def n_fft(self) -> int:
        return (self.num_freq - 1) * 2


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
    pre_drop_rate: float = 0.1
    pos_drop_rate: float = 0.1
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
    post_drop_rate: float = 0.2


@dataclass(frozen=True)
class PosteriorConfig:
    pre_hidden: int = 256
    pos_drop_rate: float = 0.2
    pre_drop_rate: float = 0.5
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
    # factor the whole invertible-linear stack with one batched LU a pass
    # (models/flow.precompute_invertible_stack) in place of a slogdet and an
    # inverse a layer; the same math either way
    batched_lu: bool = False


@dataclass(frozen=True)
class LengthPredictorConfig:
    activation: str = "identity"
    # > 0: a second Dense(1) head trained at this quantile of the frame count
    quantile: float = 0.0


@dataclass(frozen=True)
class HParams:
    name: str = "ljspeech"
    train: TrainConfig = field(default_factory=TrainConfig)
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

    def replace(self, **kwargs) -> "HParams":
        """A copy with the top-level fields in ``kwargs`` replaced."""
        return dataclasses.replace(self, **kwargs)


def LJSpeechConfig() -> HParams:
    """The LJSpeech preset: the defaults."""
    return HParams(name="ljspeech")


def DataBakerConfig() -> HParams:
    """The DataBaker Mandarin preset: 16 kHz audio, 800-sample windows and
    200-sample hops, a pinyin character set of 39 symbols."""
    return HParams(
        name="databaker",
        train=TrainConfig(random_seed=12),
        text=TextConfig(characters="_^~abcdefghijklmnopqrstuvwxyz12345,./- "),
        audio=AudioConfig(sample_rate=16000, frame_length_sample=800,
                          frame_shift_sample=200, min_level_db=-115.0),
        common=CommonConfig(mel_text_len_ratio=4.21),
        encoder=EncoderConfig(vocab_size=39),
    )


_PRESETS = {"ljspeech": LJSpeechConfig, "databaker": DataBakerConfig}


def get_config(name: str, **overrides) -> HParams:
    """The preset of a CLI dataset name, with top-level fields replaced by
    ``overrides``."""
    if name not in _PRESETS:
        raise KeyError(f"unknown dataset preset {name!r}; choices: {sorted(_PRESETS)}")
    hp = _PRESETS[name]()
    return hp.replace(**overrides) if overrides else hp


def tiny_test_config(vocab_size: int = 43) -> HParams:
    """A miniature config for fast tests: every stack 1-2 blocks deep and
    16-32 wide, 2 heads of width 8, fp32 (the JAX package's
    ``tiny_test_config`` without its TPU attention switch, which the port
    has no counterpart of)."""
    return HParams(
        name="tiny",
        train=TrainConfig(train_batch_size=2, test_batch_size=2, compute_dtype="float32"),
        encoder=EncoderConfig(
            vocab_size=vocab_size, embd_dim=32, n_conv=2, pre_hidden=32,
            conv_kernel=3, n_blk=2, attention_dim=16, attention_heads=2,
            ffn_hidden=32,
        ),
        decoder=DecoderConfig(
            nblk=1, attention_dim=16, attention_heads=2, ffn_hidden=32,
            post_n_conv=2, post_conv_filters=16, post_conv_kernel=3,
        ),
        posterior=PosteriorConfig(
            pre_hidden=16, nblk=1, attention_dim=16, attention_heads=2,
            ffn_hidden=32,
        ),
        prior=PriorConfig(
            n_blk=2, n_transformer_blk=1, attention_dim=16, attention_heads=2,
            ffn_hidden=32,
        ),
        common=CommonConfig(latent_dim=8, output_dim=80),
    )
