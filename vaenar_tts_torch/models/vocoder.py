"""Neural mel -> waveform vocoder with an inverse-STFT head (counterpart of
``vaenar_tts_tpu/models/vocoder.py``): one parallel pass in place of
Griffin-Lim's iterations.

    mel [B, T, num_mels] -> Conv1D embed -> LayerNorm -> N ConvNeXt blocks
    (depthwise conv -> LayerNorm -> pointwise MLP with tanh-GELU, residual)
    -> LayerNorm -> fp32 Dense head: log-magnitude, re, im per bin ->
    complex STFT frames mag · (re, im) / |(re, im)| -> window · irfft ->
    overlap-add / window sum-square -> waveform [B, hop · (T - 1)].

As in flax: convolutions pad SAME (3 and 3 at kernel 7) and the block's
``dwconv`` is depthwise; LayerNorm eps is 1e-6; ``compute_dtype`` bf16 runs
the convolutions, norms' outputs and MLP in bf16 while the head and
everything after it are fp32; the log-magnitude is clipped to
±``log_magnitude_clip`` before ``exp``; the phasor divides by
sqrt(re² + im² + 1e-9). The mel input is the TTS model's normalized
log-mel of preemphasized audio, so the waveform is in the preemphasized
domain and callers apply the inverse preemphasis, as for Griffin-Lim
(``audio/export.py``).

The ISTFT is ``ops.stft.istft_frames`` (cuFFT's irfft, which ignores the
imaginary part of the DC and Nyquist bins, as the JAX package's inverse DFT
basis does) and ``ops.griffin_lim.overlap_add``, on the spectra's device;
``istft_ri_host`` is its numpy twin. None of it is a hand-written kernel:
the JAX package has no Pallas kernel here either.

A trained vocoder directory holds ``vocoder_config.json`` (the JAX format:
``{"vocoder": ..., "audio": ...}``) and the port's numbered checkpoints
(``utils.checkpoint``, the step number in place of the epoch). A directory
of the JAX package's Orbax steps raises ``ForeignCheckpointError`` before
anything is read or written.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs.hparams import AudioConfig
from ..ops.griffin_lim import overlap_add, window_sumsquare
from ..ops.stft import istft_frames
from .layers import COMPUTE_DTYPES, Conv, Dense, LayerNorm

VOCODER_LN_EPS = 1e-6
CONFIG_NAME = "vocoder_config.json"


@dataclass(frozen=True)
class VocoderConfig:
    """The ISTFT-head vocoder's hyper-parameters, with the JAX package's
    names and defaults (a tree of its own, beside HParams)."""

    hidden: int = 256
    n_blocks: int = 4
    kernel_size: int = 7
    mlp_ratio: int = 3
    compute_dtype: str = "float32"  # or "bfloat16"; the head stays fp32
    # training
    segment_frames: int = 120  # crop length in frames
    batch_size: int = 16
    learning_rate: float = 2e-4
    adam_b1: float = 0.9
    adam_b2: float = 0.99
    steps: int = 20000
    log_magnitude_clip: float = 8.0
    # multi-resolution STFT loss scales: (n_fft, hop, win_length)
    stft_loss_scales: Tuple[Tuple[int, int, int], ...] = (
        (512, 128, 512), (1024, 256, 1024), (2048, 512, 2048))

    def dtype(self) -> torch.dtype:
        return COMPUTE_DTYPES[self.compute_dtype]


def _same(conv: Conv, x: torch.Tensor) -> torch.Tensor:
    """flax SAME padding around a conv of [B, T, C]: (k - 1) // 2 frames
    before, the rest after."""
    k = conv.kernel_size[0]
    padded = F.pad(x.transpose(1, 2), ((k - 1) // 2, k - 1 - (k - 1) // 2))
    return conv(padded).transpose(1, 2)


class ConvNeXtBlock(nn.Module):
    """Depthwise conv (k wide) -> LayerNorm -> pointwise MLP, residual."""

    def __init__(self, hidden: int, kernel_size: int, mlp_ratio: int, dtype: torch.dtype):
        super().__init__()
        self.dwconv = Conv(hidden, hidden, kernel_size, dtype, groups=hidden)
        self.norm = LayerNorm(hidden, dtype, eps=VOCODER_LN_EPS)
        self.pw1 = Dense(hidden, mlp_ratio * hidden, dtype=dtype)
        self.pw2 = Dense(mlp_ratio * hidden, hidden, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(_same(self.dwconv, x))
        return x + self.pw2(F.gelu(self.pw1(h), approximate="tanh"))


class MelVocoder(nn.Module):
    """mel [B, T, num_mels] -> real and imaginary STFT frames [B, 2 · bins,
    T] (the layout of the JAX package's ``_istft_ola``). Submodule names
    follow the flax tree, so ``interop.weights.vocoder_from_jax`` maps its
    parameters key for key."""

    def __init__(self, cfg: VocoderConfig, audio: AudioConfig):
        super().__init__()
        self.cfg, self.audio = cfg, audio
        dt = cfg.dtype()
        self.n_bins = 1 + audio.n_fft // 2
        self.embed = Conv(audio.num_mels, cfg.hidden, cfg.kernel_size, dt)
        self.embed_norm = LayerNorm(cfg.hidden, dt, eps=VOCODER_LN_EPS)
        self.names = [f"block_{i}" for i in range(cfg.n_blocks)]
        for name in self.names:
            self.add_module(name, ConvNeXtBlock(cfg.hidden, cfg.kernel_size, cfg.mlp_ratio, dt))
        self.head_norm = LayerNorm(cfg.hidden, dt, eps=VOCODER_LN_EPS)
        self.head = Dense(cfg.hidden, 3 * self.n_bins)  # fp32

    def head_output(self, mel: torch.Tensor) -> torch.Tensor:
        """The head's raw output, fp32 [B, T, 3 · bins]: (log magnitude,
        re, im) along the last dimension."""
        x = self.embed_norm(_same(self.embed, mel.to(self.cfg.dtype())))
        for name in self.names:
            x = getattr(self, name)(x)
        return self.head(self.head_norm(x).float())

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return head_to_frames(self.head_output(mel), self.cfg.log_magnitude_clip)


def head_to_frames(head: torch.Tensor, clip: float) -> torch.Tensor:
    """The head's (log magnitude, re, im) [B, T, 3 · bins] -> STFT frames
    [B, 2 · bins, T]: magnitude exp(clip(log magnitude)) along the
    direction of (re, im). Where |(re, im)| is near 0 that direction turns
    with any rounding of re and im."""
    log_mag, re, im = head.chunk(3, dim=-1)
    mag = torch.exp(torch.clamp(log_mag, -clip, clip))
    norm = torch.sqrt(re * re + im * im + 1e-9)
    return torch.cat([mag * re / norm, mag * im / norm], dim=-1).transpose(1, 2)


def spec_to_wav(spec_ri: torch.Tensor, audio: AudioConfig) -> torch.Tensor:
    """[B, 2 · bins, T] STFT frames -> waveforms [B, hop · (T - 1)] on their
    device: window · irfft, overlap-add, divided by the window sum-square (1
    where it is below 1e-11), the first n_fft / 2 samples trimmed, as the
    JAX package's ``spec_to_wav``."""
    n_fft, hop, win = audio.n_fft, audio.frame_shift_sample, audio.frame_length_sample
    n_bins, n_frames = spec_ri.shape[1] // 2, spec_ri.shape[2]
    spec = torch.complex(spec_ri[:, :n_bins].float(), spec_ri[:, n_bins:].float())
    y = overlap_add(istft_frames(spec.transpose(1, 2), n_fft, win), hop)
    y = y / window_sumsquare(n_fft, win, hop, n_frames, str(spec_ri.device))
    return y[:, n_fft // 2: n_fft // 2 + hop * (n_frames - 1)]


def istft_ri_host(spec_ri: np.ndarray, audio: AudioConfig) -> np.ndarray:
    """The numpy twin of ``spec_to_wav`` (``vaenar_tts_tpu/models/vocoder.py:
    131``): scipy's irfft and the DSP's hop-phase overlap-add, with
    ``nola_inverse``'s normalization (0 where the window sum-square is
    below 1e-11)."""
    from scipy import fft as sp_fft

    from ..audio.dsp import _pad_center, hann_window, hop_phase_overlap_add, nola_inverse
    n_fft, hop = audio.n_fft, audio.frame_shift_sample
    n_bins = 1 + n_fft // 2
    spec_ri = np.asarray(spec_ri, np.float32)
    n_frames = spec_ri.shape[2]
    S = (spec_ri[:, :n_bins] + 1j * spec_ri[:, n_bins:]).astype(np.complex64)
    frames = sp_fft.irfft(S.transpose(0, 2, 1), n=n_fft, axis=2)
    window = _pad_center(hann_window(audio.frame_length_sample), n_fft).astype(np.float32)
    y = hop_phase_overlap_add(frames * window, hop) * nola_inverse(window, hop, n_frames)
    return y[:, n_fft // 2: n_fft // 2 + hop * (n_frames - 1)]


@torch.no_grad()
def vocode(model: MelVocoder, mel: torch.Tensor, istft_on_device: bool = True):
    """mel [B, T, num_mels] on the model's device -> preemphasized waveforms
    [B, hop · (T - 1)]: a tensor on that device, or with
    ``istft_on_device=False`` a numpy array from ``istft_ri_host``."""
    spec = model(mel)
    if istft_on_device:
        return spec_to_wav(spec, model.audio)
    return istft_ri_host(spec.float().cpu().numpy(), model.audio)


def save_vocoder_config(model_dir: str, cfg: VocoderConfig, audio: AudioConfig) -> None:
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, CONFIG_NAME), "w") as f:
        json.dump({"vocoder": dataclasses.asdict(cfg), "audio": dataclasses.asdict(audio)},
                  f, indent=2)


def _fields(cls, raw: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in raw.items() if k in names}


def load_vocoder_config(model_dir: str) -> Tuple[VocoderConfig, AudioConfig]:
    with open(os.path.join(model_dir, CONFIG_NAME)) as f:
        raw = json.load(f)
    voc = _fields(VocoderConfig, raw["vocoder"])
    voc["stft_loss_scales"] = tuple(tuple(s) for s in voc.get(
        "stft_loss_scales", VocoderConfig.stft_loss_scales))
    return VocoderConfig(**voc), AudioConfig(**_fields(AudioConfig, raw["audio"]))


def load_vocoder(model_dir: str, device="cuda") -> Tuple[MelVocoder, int]:
    """(the model in eval mode on ``device``, its step) from the newest
    checkpoint of a trained vocoder directory. A directory of another
    writer's checkpoints raises ``ForeignCheckpointError`` first."""
    from ..utils.checkpoint import CheckpointManager, checkpoint_epochs
    from .vaenar import resolve_device
    checkpoint_epochs(model_dir)
    cfg, audio = load_vocoder_config(model_dir)
    model = MelVocoder(cfg, audio).to(resolve_device(device))
    step = CheckpointManager(model_dir).restore(model)
    if step is None:
        raise FileNotFoundError(f"no vocoder checkpoint in {model_dir}")
    return model.eval(), step
