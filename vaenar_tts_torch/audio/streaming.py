"""Streaming vocoder: chunked Griffin-Lim with cross-chunk phase hand-off
(the port's copy of ``vaenar_tts_tpu/audio/streaming.py``).

Each chunk runs Griffin-Lim on a window of [left context | chunk | right
context] frames. The left-context frames start from the converged phases of
the previous window, the other frames from one seeded random phase field of
the whole utterance; consecutive pieces are joined by an equal-power Hann
cross-fade, and the inverse-preemphasis IIR filter carries its state across
chunks (scipy ``lfilter`` zi), so the stream is sample-continuous. The
first piece's time is the time-to-first-audio.

Backends: ``"host"`` runs each window through the numpy ``dsp.gl_core``;
``"device"`` through ``ops.griffin_lim.gl_window`` on ``device`` (the card
unless the caller says otherwise), at one static window of chunk + 2 ·
context frames, shorter edge windows zero-padded and masked inside it.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch
from scipy import signal as sp_signal

from .dsp import AudioProcessor, gl_core


class StreamingVocoder:
    """Chunked Griffin-Lim streamer over one AudioProcessor config.

    ``chunk_frames`` mel frames are emitted per yield (~1.16 s at
    hop 256 / 22.05 kHz for the default 100); ``context_frames`` of left and
    right context surround each chunk inside the GL window. Larger context =
    better seams, more redundant work.
    """

    def __init__(self, ap: AudioProcessor, chunk_frames: int = 100,
                 context_frames: int = 24, crossfade_samples: int = 256,
                 iters: Optional[int] = None, backend: str = "host",
                 device="cuda"):
        if chunk_frames < 1:
            raise ValueError("chunk_frames must be >= 1")
        if context_frames < 1:
            # the emit-region geometry relies on >=1 frame of right context
            # for every non-final chunk (len(y) = hop*(W-1) would otherwise
            # truncate each chunk one hop short)
            raise ValueError("context_frames must be >= 1")
        if crossfade_samples < 0:
            raise ValueError("crossfade_samples must be >= 0")
        if not ap.cfg.center:
            raise NotImplementedError(
                "StreamingVocoder assumes center=True STFT geometry "
                "(sample offsets are frame*hop); center=False configs must "
                "use the whole-utterance vocoder")
        if backend not in ("host", "device"):
            raise ValueError(f"backend must be 'host' or 'device', "
                             f"got {backend!r}")
        self.ap = ap
        self.cfg = ap.cfg
        self.chunk = chunk_frames
        self.ctx = context_frames
        self.xfade = crossfade_samples
        self.iters = self.cfg.griffin_lim_iters if iters is None else iters
        self.backend = backend
        # one static window (chunk + both contexts) for every chunk; shorter
        # edge windows are zero-padded and masked inside gl_window, so the
        # valid region matches an unpadded run
        self._w_bucket = chunk_frames + 2 * context_frames
        self.device = torch.device(device)

    def _gl_window(self, mag_w: np.ndarray, init: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
        """One GL window -> (center-trimmed signal, converged phases),
        host (dsp.gl_core) or device (ops/griffin_lim.gl_window)."""
        cfg = self.cfg
        if self.backend == "host":
            return gl_core(mag_w, init, cfg.n_fft, cfg.frame_shift_sample,
                           cfg.frame_length_sample, self.iters, cfg.center)
        from ..ops.griffin_lim import gl_window
        w_true = mag_w.shape[0]
        pad = self._w_bucket - w_true
        mag_p = torch.from_numpy(np.pad(mag_w, ((0, pad), (0, 0))))
        init_p = torch.from_numpy(np.pad(init, ((0, pad), (0, 0))))
        y, fin = gl_window(mag_p.to(self.device), init_p.to(self.device), w_true,
                           cfg.n_fft, cfg.frame_shift_sample,
                           cfg.frame_length_sample, self.iters)
        hop = cfg.frame_shift_sample
        return (y[: hop * (w_true - 1)].cpu().numpy(),
                fin[:w_true].cpu().numpy().astype(np.complex64))

    def stream(self, mel: np.ndarray,
               rng: np.random.Generator | None = None
               ) -> Iterator[np.ndarray]:
        """Yield float32 wav pieces for ``mel`` [n_frames, num_mels].

        Concatenated pieces are the full utterance: same length and
        preemphasis semantics as
        ``inv_preemphasize(inv_mel_spectrogram(mel.T))``.
        """
        ap, cfg = self.ap, self.cfg
        rng = rng or np.random.default_rng()
        hop = cfg.frame_shift_sample

        # mel -> linear magnitude ** power, as inv_mel_spectrogram does
        S = ap.mel_to_linear(
            ap.db_to_amp(ap.denormalize(mel.T) + cfg.ref_level_db))
        S = S ** cfg.power
        mag = np.ascontiguousarray(S.T.astype(np.float32))  # [frames, bins]
        n = mag.shape[0]
        if n < 2:
            raise ValueError("need at least 2 mel frames to vocode")
        total_samples = hop * (n - 1)  # center-trimmed ISTFT length

        # one global random phase field: a chunked run and a whole-utterance
        # run start from the same per-frame initialization
        angles_global = np.exp(
            2j * np.pi * rng.random((mag.shape[1], n))).T.astype(np.complex64)

        # inverse-preemphasis IIR state carried across chunks
        if cfg.preemphasize is not None:
            b, a = [1.0], [1.0, -cfg.preemphasize]
            zi = sp_signal.lfilter_zi(b, a) * 0.0
        prev_angles: np.ndarray | None = None
        prev_ws = 0
        prev_tail: np.ndarray | None = None  # prev window's post-emit samples
        fade_out = 0.5 * (1.0 + np.cos(
            np.linspace(0.0, np.pi, self.xfade, dtype=np.float32)))
        emitted = 0

        for s in range(0, n, self.chunk):
            e = min(s + self.chunk, n)
            ws = max(0, s - self.ctx)
            we = min(n, e + self.ctx)
            init = angles_global[ws:we].copy()
            if prev_angles is not None and s > ws:
                # left-context frames [ws, s): converged phases of the
                # previous window
                init[: s - ws] = prev_angles[ws - prev_ws: s - prev_ws]
            y, fin = self._gl_window(mag[ws:we], init)
            # window signal y covers absolute samples [ws*hop, ws*hop+len(y))
            lo = (s - ws) * hop  # emit region starts at frame s
            hi = min(lo + (e - s) * hop, len(y),
                     total_samples - ws * hop)
            piece = y[lo:hi].copy()
            if prev_tail is not None and len(piece):
                m = min(len(prev_tail), len(piece), self.xfade)
                # ramp over the ACTUAL overlap m: slicing the full-length
                # ramp would end at a nonzero weight and leave a step at the
                # blend boundary when m < xfade
                w = (fade_out[:m] if m == self.xfade else
                     0.5 * (1.0 + np.cos(
                         np.linspace(0.0, np.pi, m, dtype=np.float32))))
                piece[:m] = prev_tail[:m] * w + piece[:m] * (1.0 - w)
            # keep the samples this window computed past its emit region for
            # cross-fading the next chunk's start
            prev_tail = y[hi: hi + self.xfade].copy() if hi < len(y) else None
            prev_angles, prev_ws = fin, ws
            if cfg.preemphasize is not None and len(piece):
                piece, zi = sp_signal.lfilter(b, a, piece, zi=zi)
                piece = piece.astype(np.float32)
            emitted += len(piece)
            if len(piece):
                yield piece
        assert emitted == total_samples, (emitted, total_samples)

    def synthesize(self, mel: np.ndarray,
                   rng: np.random.Generator | None = None) -> np.ndarray:
        """Whole-utterance convenience wrapper over ``stream``."""
        return np.concatenate(list(self.stream(mel, rng)))
