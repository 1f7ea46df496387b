"""Batched Griffin-Lim on the card (counterpart of
``vaenar_tts_tpu/ops/griffin_lim.py``): ``griffin_lim`` (``griffin_lim_jax``
l.148), the streaming window ``gl_window`` (``gl_window_fn`` l.183) and the
vocoder ``mel_to_wav`` (``mel_to_wav_jax`` l.245), in fp32 torch ops on the
tensors' device. The whole loop stays there: no tensor leaves it before the
last iteration.

The conventions are the JAX package's, which differ from the numpy
``audio/dsp.py::gl_core`` in three places:

* the initial phase is uniform in [0, 2π) in a [B, bins, F] layout
  (``jax.random.uniform(key, (B, bins, F), 0, 2π)``); the numpy loop draws
  ``exp(2πi·u)`` in a [bins, F] layout and transposes. Callers pass either
  a ``torch.Generator`` or that phase itself (``init_phase``), so that a
  test can feed the phase JAX drew;
* the overlap-add divides by the window sum-square set to 1 where it is
  below 1e-11 (``_window_sumsquare``); numpy's ``nola_inverse`` sets 0;
* each iteration re-analyzes the synthesized signal before its center
  padding is trimmed (the same F frames), where numpy trims it and
  reflect-pads it again; the update divides by sqrt(|X|² + 1e-12).

Synthesis is window · irfft and an overlap-add of n_fft / hop shifted
slice-adds, not ``torch.istft``, whose NOLA check and normalization differ
from ``_istft_ola``. The DFTs are cuFFT's.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from ..configs.hparams import AudioConfig
from .stft import denormalize, full_fp32_matmuls, inv_mel_basis, istft_frames, padded_window, stft


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """[B, F, n_fft] windowed frames -> [B, n_fft + hop·(F-1)] by n_fft / hop
    shifted slice-adds (``_overlap_add_sliceadd``)."""
    B, n_frames, n_fft = frames.shape
    if n_fft % hop:
        raise ValueError(f"n_fft {n_fft} must be a multiple of the hop {hop}")
    k = n_fft // hop
    chunks = frames.reshape(B, n_frames, k, hop)
    y = frames.new_zeros((B, n_frames + k - 1, hop))
    for j in range(k):
        y[:, j:j + n_frames] += chunks[:, :, j]
    return y.reshape(B, (n_frames + k - 1) * hop)


def _sum_square(window_sq: torch.Tensor, hop: int) -> torch.Tensor:
    """The overlap-added squared window [B, T] of [B, F, n_fft] frames, 1
    where it is below 1e-11."""
    wss = overlap_add(window_sq, hop)
    return torch.where(wss < 1e-11, torch.ones_like(wss), wss)


@functools.lru_cache(maxsize=8)
def window_sumsquare(n_fft: int, win_length: int, hop: int, n_frames: int,
                     device: str) -> torch.Tensor:
    """[n_fft + hop·(F-1)] fp32, the NOLA normalization of F frames."""
    w2 = padded_window(n_fft, win_length, device).square()
    return _sum_square(w2.expand(1, n_frames, n_fft), hop)[0]


def _iterate(spec: torch.Tensor, mag: torch.Tensor, wss: torch.Tensor, n_fft: int,
             hop: int, win_length: int, n_iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_iters`` Griffin-Lim updates of complex ``spec`` [B, F, bins]
    towards magnitudes ``mag``; returns (the untrimmed signal of the last
    spectrum [B, n_fft + hop·(F-1)], that spectrum)."""

    def synthesize(s):
        return overlap_add(istft_frames(s, n_fft, win_length), hop) / wss

    for _ in range(n_iters):
        ri = torch.view_as_real(stft(synthesize(spec), n_fft, hop, win_length))
        spec = torch.view_as_complex(ri * (mag / torch.sqrt(ri.square().sum(-1) + 1e-12))[..., None])
    return synthesize(spec), spec


def initial_phase(shape, generator: Optional[torch.Generator],
                  init_phase: Optional[torch.Tensor], device) -> torch.Tensor:
    """[B, bins, F] fp32: ``init_phase``, or uniform in [0, 2π) from
    ``generator`` on ``device``."""
    if init_phase is not None:
        if tuple(init_phase.shape) != tuple(shape):
            raise ValueError(f"init_phase must be {tuple(shape)}; got {tuple(init_phase.shape)}")
        return init_phase.to(device=device, dtype=torch.float32)
    if generator is None:
        raise ValueError("pass a torch.Generator or init_phase: the initial phase is random")
    return torch.rand(shape, generator=generator, device=device) * (2.0 * math.pi)


def griffin_lim(magnitudes: torch.Tensor, cfg: AudioConfig,
                generator: Optional[torch.Generator] = None,
                init_phase: Optional[torch.Tensor] = None,
                n_iters: Optional[int] = None) -> torch.Tensor:
    """Batched Griffin-Lim: magnitudes [B, F, bins] -> waveforms [B,
    hop·(F-1)] (center padding trimmed), fp32 on the magnitudes' device.
    ``init_phase`` [B, bins, F] or ``generator`` gives the initial phase."""
    n_fft, hop, win = cfg.n_fft, cfg.frame_shift_sample, cfg.frame_length_sample
    n_iters = cfg.griffin_lim_iters if n_iters is None else n_iters
    mag = magnitudes.float()
    B, F, n_bins = mag.shape
    phase0 = initial_phase((B, n_bins, F), generator, init_phase, mag.device)
    spec = torch.polar(mag, phase0.transpose(1, 2))
    wss = window_sumsquare(n_fft, win, hop, F, str(mag.device))
    y, _ = _iterate(spec, mag, wss, n_fft, hop, win, n_iters)
    return y[:, n_fft // 2: y.shape[1] - n_fft // 2]


def gl_window(mag: torch.Tensor, init: torch.Tensor, n_valid: int, n_fft: int, hop: int,
              win_length: int, n_iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fixed-shape streaming window (``gl_window_fn``): magnitudes
    [W, bins] and the caller's initial phases ``init`` [W, bins] (complex,
    unit modulus) -> (the center-trimmed signal [hop·(W-1)], the converged
    unit phases [W, bins], 0 where the spectrum vanished). Frames at or past
    ``n_valid`` are padding: their magnitudes are zeroed and the NOLA
    normalization sums the valid frames' windows only, so the valid region
    comes out as an unpadded window's would."""
    W = mag.shape[0]
    valid = (torch.arange(W, device=mag.device) < n_valid).float()
    mag_m = (mag.float() * valid[:, None])[None]
    w2 = padded_window(n_fft, win_length, str(mag.device)).square()
    wss = _sum_square(w2[None, None, :] * valid[None, :, None], hop)
    y, spec = _iterate(mag_m * init.to(torch.complex64)[None], mag_m, wss, n_fft, hop,
                       win_length, n_iters)
    norm = spec.abs()
    unit = torch.where(norm > 1e-16, 1.0 / torch.clamp(norm, min=1e-16), torch.zeros_like(norm))
    total = n_fft + hop * (W - 1)
    return y[0, n_fft // 2: total - n_fft // 2], (spec * unit)[0]


def mel_to_wav(mel: torch.Tensor, cfg: AudioConfig, generator: Optional[torch.Generator] = None,
               init_phase: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The vocoder: normalized log-mels [B, F, num_mels] -> waveforms [B,
    hop·(F-1)] on the mels' device (denormalize -> dB to amplitude ->
    pseudo-inverse of the mel basis, floored at 1e-10 -> ** power ->
    Griffin-Lim), as ``AudioProcessor.inv_mel_spectrogram`` does on the host.
    The inverse preemphasis is left to the caller (``export.TestUtils``)."""
    amp = torch.pow(10.0, (denormalize(mel.float(), cfg) + cfg.ref_level_db) * 0.05)
    with full_fp32_matmuls():
        linear = torch.clamp(torch.matmul(amp, inv_mel_basis(cfg, str(mel.device))), min=1e-10)
    return griffin_lim(linear ** cfg.power, cfg, generator, init_phase)
