"""Hyper-parameter trees and their JSON form."""
from .overrides import apply_overrides
from .serialize import hparams_from_dict, hparams_to_dict, load_hparams, save_hparams
from .hparams import (
    AudioConfig,
    CommonConfig,
    DataBakerConfig,
    DatasetConfig,
    DecoderConfig,
    EncoderConfig,
    HParams,
    LengthPredictorConfig,
    LJSpeechConfig,
    PosteriorConfig,
    PriorConfig,
    TextConfig,
    TrainConfig,
    get_config,
)

__all__ = [
    "apply_overrides",
    "hparams_from_dict",
    "hparams_to_dict",
    "load_hparams",
    "save_hparams",
    "AudioConfig",
    "CommonConfig",
    "DataBakerConfig",
    "DatasetConfig",
    "DecoderConfig",
    "EncoderConfig",
    "HParams",
    "LengthPredictorConfig",
    "LJSpeechConfig",
    "PosteriorConfig",
    "PriorConfig",
    "TextConfig",
    "TrainConfig",
    "get_config",
]
