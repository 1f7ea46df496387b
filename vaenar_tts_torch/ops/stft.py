"""The batched STFT and mel frontend in torch, fp32 (counterpart of
``vaenar_tts_tpu/ops/stft.py``): preemphasis -> center reflect-pad ->
frames -> periodic Hann window -> DFT -> magnitude -> mel filterbank -> dB
-> [0, 1] normalization, over a batch of waveforms ``[B, T]``.

The JAX package forms the DFT as a gather and one matmul with the windowed
DFT basis because that maps onto the TPU's matrix unit. On the card the DFT
is cuFFT's ``torch.fft.rfft`` over strided frames: O(n log n) a frame,
where the basis product does 2·n_fft·bins fp32 operations a frame, and an
fp32 basis product (TF32 off) was both slower and less exact on an H100
(PERF.md). None of this is a hand-written kernel: the JAX package has no
Pallas here either.

Spectra are complex ``[B, F, bins]``; ``audio/dsp.py`` is the reference
that these functions are held against.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Iterator, Optional

import numpy as np
import torch

from ..audio.dsp import hann_window, mel_filterbank
from ..configs.hparams import AudioConfig

@contextlib.contextmanager
def full_fp32_matmuls() -> Iterator[None]:
    """TF32 off for CUDA matmuls inside the block, restored after it: the
    mel filterbank and its pseudo-inverse are fp32 products, whether or not
    the caller went through ``resolve_device``."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@functools.lru_cache(maxsize=8)
def padded_window(n_fft: int, win_length: int, device: str) -> torch.Tensor:
    """The periodic Hann window of ``win_length`` centered in ``n_fft``,
    fp32 [n_fft]."""
    w = np.zeros(n_fft)
    lpad = (n_fft - win_length) // 2
    w[lpad:lpad + win_length] = hann_window(win_length)
    return torch.tensor(w, dtype=torch.float32, device=device)


def stft(y: torch.Tensor, n_fft: int, hop: int, win_length: int) -> torch.Tensor:
    """Complex spectra [B, F, bins] of pre-padded signals ``y`` [B, T],
    F = 1 + (T - n_fft) // hop."""
    frames = y.unfold(-1, n_fft, hop)  # [B, F, n_fft], a strided view
    return torch.fft.rfft(frames * padded_window(n_fft, win_length, str(y.device)), n=n_fft)


def istft_frames(spec: torch.Tensor, n_fft: int, win_length: int) -> torch.Tensor:
    """Windowed time frames [B, F, n_fft] of complex spectra [B, F, bins]:
    window · irfft."""
    return torch.fft.irfft(spec, n=n_fft) * padded_window(n_fft, win_length, str(spec.device))


def preemphasis(y: torch.Tensor, coef: float) -> torch.Tensor:
    """y[t] - coef·y[t-1], the first sample passed through
    (``scipy.signal.lfilter([1, -coef], [1], y)``)."""
    return torch.cat([y[..., :1], y[..., 1:] - coef * y[..., :-1]], dim=-1)


def center_pad(y: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Reflect-pad n_fft // 2 samples on both sides of [B, T]."""
    return torch.nn.functional.pad(y[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]


def batched_stft_magnitude(y: torch.Tensor, n_fft: int, hop: int, win_length: int,
                           center: bool = True) -> torch.Tensor:
    """|STFT| of [B, T] (or [T]) fp32 signals -> [B, F, bins], with the
    JAX package's sqrt(re² + im² + 1e-30)."""
    if y.dim() == 1:
        y = y[None]
    if center:
        y = center_pad(y, n_fft)
    ri = torch.view_as_real(stft(y, n_fft, hop, win_length))
    return torch.sqrt(ri.square().sum(-1) + 1e-30)


@functools.lru_cache(maxsize=4)
def mel_basis(cfg: AudioConfig, device: str) -> torch.Tensor:
    """The Slaney mel filterbank of ``cfg``, fp32 [bins, num_mels]."""
    fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.num_mels, cfg.min_mel_freq,
                        cfg.max_mel_freq)
    return torch.tensor(fb.T, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=4)
def inv_mel_basis(cfg: AudioConfig, device: str) -> torch.Tensor:
    """The pseudo-inverse of the mel filterbank, fp32 [num_mels, bins]
    (``AudioProcessor.inv_mel_basis`` transposed)."""
    fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.num_mels, cfg.min_mel_freq,
                        cfg.max_mel_freq)
    return torch.tensor(np.linalg.pinv(fb).T, dtype=torch.float32, device=device)


def batched_melspectrogram(y: torch.Tensor, cfg: AudioConfig, apply_preemphasis: bool = True,
                           center: Optional[bool] = None) -> torch.Tensor:
    """Normalized log-mel of [B, T] fp32 waveforms -> [B, F, num_mels]
    (``AudioProcessor.melspectrogram`` transposed to the records' [frames,
    mels] layout). ``center=False`` takes signals that the caller padded
    item by item, as a ragged batch needs."""
    if y.dim() == 1:
        y = y[None]
    if apply_preemphasis and cfg.preemphasize is not None:
        y = preemphasis(y, cfg.preemphasize)
    mag = batched_stft_magnitude(y, cfg.n_fft, cfg.frame_shift_sample, cfg.frame_length_sample,
                                 cfg.center if center is None else center)
    with full_fp32_matmuls():
        mel = torch.matmul(mag, mel_basis(cfg, str(y.device)))
    S = 20.0 * torch.log10(torch.clamp(mel, min=1e-5)) - cfg.ref_level_db
    return normalize(S, cfg)


def normalize(S: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """dB -> the clip-normalized range (``AudioProcessor.normalize``)."""
    scaled = (S - cfg.min_level_db) / (-cfg.min_level_db)
    if cfg.symmetric_specs:
        return torch.clamp(2 * cfg.max_abs_value * scaled - cfg.max_abs_value,
                           -cfg.max_abs_value, cfg.max_abs_value)
    return torch.clamp(cfg.max_abs_value * scaled, 0.0, cfg.max_abs_value)


def denormalize(S: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """The clip-normalized range -> dB (``AudioProcessor.denormalize``)."""
    m = cfg.max_abs_value
    if cfg.symmetric_specs:
        return ((torch.clamp(S, -m, m) + m) * (-cfg.min_level_db) / (2 * m)
                + cfg.min_level_db)
    return torch.clamp(S, 0.0, m) * (-cfg.min_level_db) / m + cfg.min_level_db
