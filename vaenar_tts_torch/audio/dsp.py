"""Audio DSP in numpy and scipy: the port's own copy of
``vaenar_tts_tpu/audio/dsp.py``.

Center-padded reflect STFT with a periodic Hann window, the Slaney mel
filterbank, the dB chain with its [0, 1] clip-normalization, preemphasis,
wav IO, and the float32 Griffin-Lim ``gl_core`` that the host vocoder and
the streaming vocoder run. It is the
host vocoder, and the reference that the torch ops of ``ops/stft.py`` and
``ops/griffin_lim.py`` are held against. The original's linear
``spectrogram`` and ``inv_spectrogram``, its float64 ``griffin_lim`` loop,
``mfcc``, ``find_endpoint`` and ``roundtrip_report`` are left out: no path
of the port calls them.
"""

from __future__ import annotations

import numpy as np

from ..configs.hparams import AudioConfig


# ---------------------------------------------------------------------------
# Windows / framing
# ---------------------------------------------------------------------------

def hann_window(win_length: int) -> np.ndarray:
    """Periodic ('fftbins') Hann window, matching scipy.signal.get_window
    ('hann', n, fftbins=True), which is what librosa.stft uses."""
    n = np.arange(win_length, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)


def _pad_center(window: np.ndarray, size: int) -> np.ndarray:
    lpad = (size - len(window)) // 2
    rpad = size - len(window) - lpad
    return np.pad(window, (lpad, rpad))


def stft(y: np.ndarray, n_fft: int, hop_length: int, win_length: int,
         center: bool = True) -> np.ndarray:
    """Complex STFT, shape [1 + n_fft//2, n_frames] (librosa layout)."""
    if y.ndim != 1:
        raise ValueError("stft expects a 1-D signal")
    window = _pad_center(hann_window(win_length), n_fft)
    if center:
        y = np.pad(y, n_fft // 2, mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop_length
    if n_frames < 1:
        raise ValueError(f"signal too short for n_fft={n_fft}")
    frames = np.lib.stride_tricks.as_strided(
        y,
        shape=(n_frames, n_fft),
        strides=(y.strides[0] * hop_length, y.strides[0]),
    )
    spec = np.fft.rfft(frames * window, n=n_fft, axis=1)
    return spec.T.astype(np.complex128)


def istft(stft_matrix: np.ndarray, hop_length: int, win_length: int,
          center: bool = True, length: int | None = None) -> np.ndarray:
    """Inverse STFT via NOLA-normalized overlap-add (librosa semantics)."""
    n_fft = 2 * (stft_matrix.shape[0] - 1)
    window = _pad_center(hann_window(win_length), n_fft)
    frames = np.fft.irfft(stft_matrix.T, n=n_fft, axis=1)  # [n_frames, n_fft]
    n_frames = frames.shape[0]
    expected_len = n_fft + hop_length * (n_frames - 1)
    y = np.zeros(expected_len, dtype=np.float64)
    wsum = np.zeros(expected_len, dtype=np.float64)
    wsq = window ** 2
    for i in range(n_frames):
        s = i * hop_length
        y[s:s + n_fft] += frames[i] * window
        wsum[s:s + n_fft] += wsq
    nz = wsum > np.finfo(np.float64).tiny
    y[nz] /= wsum[nz]
    if center:
        y = y[n_fft // 2: expected_len - n_fft // 2]
    if length is not None:
        y = y[:length] if len(y) >= length else np.pad(y, (0, length - len(y)))
    return y


def fast_griffin_lim(S: np.ndarray, n_fft: int, hop_length: int,
                     win_length: int, iters: int, center: bool = True,
                     rng: np.random.Generator | None = None) -> np.ndarray:
    """Griffin-Lim phase reconstruction, optimized for the host vocoder loop.

    Same algorithm and random-phase seeding order as
    ``AudioProcessor.griffin_lim`` (reference audio/audio.py:95-102), with the
    per-iteration cost cut down for the path where host vocoding dominates
    end-to-end synthesis time:

      * float32/complex64 throughout via scipy.fft (np.fft always promotes
        to double; phase estimation needs no double),
      * overlap-add vectorized over hop-phases (ceil(n_fft/hop) strided adds
        per ISTFT instead of one Python loop iteration per frame),
      * the NOLA window-sum normalization precomputed once — it is constant
        across all ``iters`` iterations,
      * phase extraction as D/|D| instead of exp(1j*angle(D)).

    ``S`` is the magnitude spectrogram in librosa layout [1+n_fft//2,
    n_frames]. Returns the float32 time signal with the same length semantics
    as ``istft`` (center-trimmed).
    """
    rng = rng or np.random.default_rng()
    # identical phase-init sampling order to the reference-parity path
    angles = np.exp(2j * np.pi * rng.random(S.shape)).T.astype(np.complex64)
    mag = np.ascontiguousarray(np.abs(S).T.astype(np.float32))
    y, _ = gl_core(mag, angles, n_fft, hop_length, win_length, iters, center)
    return y


def nola_inverse(window: np.ndarray, hop_length: int,
                 n_frames: int) -> np.ndarray:
    """1 / sum-of-squared-windows normalization for overlap-add synthesis
    ([expected_len] float32; zeros where NOLA fails). Constant for a fixed
    (window, hop, n_frames) — compute once, reuse across GL iterations."""
    n_fft = len(window)
    expected_len = n_fft + hop_length * (n_frames - 1)
    wsq = (window * window).astype(np.float32)
    wsum = np.zeros(expected_len, np.float32)
    for i in range(n_frames):
        wsum[i * hop_length: i * hop_length + n_fft] += wsq
    tiny = np.finfo(np.float32).tiny
    return np.where(wsum > tiny, 1.0 / np.maximum(wsum, tiny),
                    0.0).astype(np.float32)


def hop_phase_overlap_add(fw: np.ndarray, hop_length: int) -> np.ndarray:
    """Overlap-add of WINDOWED frames [..., F, n_fft] ->
    [..., n_fft + hop*(F-1)] via ceil(n_fft/hop) strided adds instead of a
    per-frame Python loop (the overlap-add of ``gl_core``)."""
    *lead, F, n_fft = fw.shape
    k = -(-n_fft // hop_length)  # hop-phases per frame (8 at 2048/256)
    pad_cols = k * hop_length - n_fft
    if pad_cols:
        fw = np.pad(fw, [(0, 0)] * len(lead) + [(0, 0), (0, pad_cols)])
    fw = fw.reshape(*lead, F, k, hop_length)
    buf = np.zeros((*lead, F + k, hop_length), np.float32)
    for r in range(k):
        buf[..., r: r + F, :] += fw[..., :, r, :]
    total = n_fft + hop_length * (F - 1)
    return buf.reshape(*lead, (F + k) * hop_length)[..., :total]


def gl_core(mag: np.ndarray, angles: np.ndarray, n_fft: int, hop_length: int,
            win_length: int, iters: int, center: bool = True
            ) -> tuple[np.ndarray, np.ndarray]:
    """The Griffin-Lim iteration kernel on frames-major float32 arrays.

    ``mag``/``angles``: [n_frames, 1+n_fft//2] float32 / complex64. Returns
    ``(signal, final_angles)`` so callers (the streaming vocoder,
    audio/streaming.py) can propagate converged phases across chunks.
    """
    from scipy import fft as sp_fft  # slow to import: where used
    window = _pad_center(hann_window(win_length), n_fft).astype(np.float32)
    n_frames = mag.shape[0]
    expected_len = n_fft + hop_length * (n_frames - 1)
    wsum_inv = nola_inverse(window, hop_length, n_frames)
    trim = n_fft // 2 if center else 0

    def ola(frames: np.ndarray) -> np.ndarray:
        """Windowed overlap-add of irfft frames [n_frames, n_fft] -> signal."""
        y = hop_phase_overlap_add(frames * window, hop_length) * wsum_inv
        return y[trim: expected_len - trim] if center else y

    def frame_fft(y: np.ndarray) -> np.ndarray:
        """Center-padded windowed rfft -> [n_frames, bins] (matches stft)."""
        if center:
            y = np.pad(y, n_fft // 2, mode="reflect")
        frames = np.lib.stride_tricks.as_strided(
            y, shape=(n_frames, n_fft),
            strides=(y.strides[0] * hop_length, y.strides[0]))
        return sp_fft.rfft(frames * window, n=n_fft, axis=1)

    y = ola(sp_fft.irfft(mag * angles, n=n_fft, axis=1))
    tiny = np.float32(1e-16)
    for _ in range(iters):
        D = frame_fft(y)
        angles = D / np.maximum(np.abs(D), tiny)
        y = ola(sp_fft.irfft(mag * angles, n=n_fft, axis=1))
    return y, angles


# ---------------------------------------------------------------------------
# Mel filterbank (Slaney scale + Slaney norm, librosa defaults)
# ---------------------------------------------------------------------------

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(f):
    f = np.asanyarray(f, dtype=np.float64)
    mels = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mels = np.where(log_region,
                    _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP,
                    mels)
    return mels


def mel_to_hz(m):
    m = np.asanyarray(m, dtype=np.float64)
    freqs = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    freqs = np.where(log_region,
                     _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
                     freqs)
    return freqs


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """Triangular mel filterbank, shape [n_mels, 1 + n_fft//2]
    (reference audio/audio.py:174-181 builds this via librosa.filters.mel)."""
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]  # [n_mels+2, n_bins]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney-style energy normalization
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float64)


# ---------------------------------------------------------------------------
# The Audio processor (reference parity surface)
# ---------------------------------------------------------------------------

class AudioProcessor:
    """STFT/mel/Griffin-Lim pipeline bound to an AudioConfig
    (reference audio/audio.py:11)."""

    def __init__(self, cfg: AudioConfig):
        self.cfg = cfg
        self._mel_basis: np.ndarray | None = None
        self._inv_mel_basis: np.ndarray | None = None

    # -- wav IO -------------------------------------------------------------

    def load_wav(self, path: str) -> np.ndarray:
        """Load and resample to cfg.sample_rate, float32 mono in [-1, 1]
        (reference audio.py:15-16 via librosa.core.load)."""
        from scipy.io import wavfile  # slow to import: where used
        sr, data = wavfile.read(path)
        if data.dtype == np.int16:
            y = data.astype(np.float32) / 32768.0
        elif data.dtype == np.int32:
            y = data.astype(np.float32) / 2147483648.0
        elif data.dtype == np.uint8:
            y = (data.astype(np.float32) - 128.0) / 128.0
        else:
            y = data.astype(np.float32)
        if y.ndim == 2:
            y = y.mean(axis=1)
        if sr != self.cfg.sample_rate:
            from math import gcd
            from scipy import signal as sp_signal  # slow to import: where used
            g = gcd(self.cfg.sample_rate, sr)
            y = sp_signal.resample_poly(
                y, self.cfg.sample_rate // g, sr // g).astype(np.float32)
        return y

    def save_wav(self, wav: np.ndarray, path: str) -> None:
        # reference audio.py:18-21
        from scipy.io import wavfile  # slow to import: where used
        wav = wav * (32767 / max(0.01, float(np.max(np.abs(wav)))))
        wavfile.write(path, self.cfg.sample_rate, wav.astype(np.int16))

    # -- spectrograms ---------------------------------------------------------

    def _stft(self, y: np.ndarray) -> np.ndarray:
        return stft(y, self.cfg.n_fft, self.cfg.frame_shift_sample,
                    self.cfg.frame_length_sample, self.cfg.center)

    def _istft(self, spec: np.ndarray) -> np.ndarray:
        return istft(spec, self.cfg.frame_shift_sample,
                     self.cfg.frame_length_sample, self.cfg.center)

    def mel_basis(self) -> np.ndarray:
        if self._mel_basis is None:
            self._mel_basis = mel_filterbank(
                self.cfg.sample_rate, self.cfg.n_fft, self.cfg.num_mels,
                self.cfg.min_mel_freq, self.cfg.max_mel_freq)
        return self._mel_basis

    def inv_mel_basis(self) -> np.ndarray:
        if self._inv_mel_basis is None:
            self._inv_mel_basis = np.linalg.pinv(self.mel_basis())
        return self._inv_mel_basis

    def linear_to_mel(self, spec: np.ndarray) -> np.ndarray:
        return self.mel_basis() @ spec

    def mel_to_linear(self, mel_spec: np.ndarray) -> np.ndarray:
        # reference audio.py:165-172
        return np.maximum(1e-10, self.inv_mel_basis() @ mel_spec)

    @staticmethod
    def amp_to_db(x: np.ndarray) -> np.ndarray:
        return 20.0 * np.log10(np.maximum(1e-5, x))

    @staticmethod
    def db_to_amp(x: np.ndarray) -> np.ndarray:
        return np.power(10.0, x * 0.05)

    def normalize(self, S: np.ndarray) -> np.ndarray:
        # reference audio.py:191-201
        c = self.cfg
        if c.symmetric_specs:
            return np.clip(
                (2 * c.max_abs_value) * ((S - c.min_level_db) / (-c.min_level_db))
                - c.max_abs_value,
                -c.max_abs_value, c.max_abs_value)
        return np.clip(
            c.max_abs_value * ((S - c.min_level_db) / (-c.min_level_db)),
            0, c.max_abs_value)

    def denormalize(self, S: np.ndarray) -> np.ndarray:
        # reference audio.py:203-212
        c = self.cfg
        if c.symmetric_specs:
            return ((np.clip(S, -c.max_abs_value, c.max_abs_value)
                     + c.max_abs_value) * (-c.min_level_db)
                    / (2 * c.max_abs_value) + c.min_level_db)
        return (np.clip(S, 0, c.max_abs_value) * (-c.min_level_db)
                / c.max_abs_value + c.min_level_db)

    def spectrogram(self, y: np.ndarray, clip_norm: bool = True) -> np.ndarray:
        """[num_freq, n_frames] normalized log-magnitude spectrogram."""
        D = self._stft(y)
        S = self.amp_to_db(np.abs(D)) - self.cfg.ref_level_db
        return self.normalize(S) if clip_norm else S

    def melspectrogram(self, y: np.ndarray, clip_norm: bool = True) -> np.ndarray:
        """[num_mels, n_frames] normalized log-mel (reference audio.py:74-79)."""
        D = self._stft(y)
        S = self.amp_to_db(self.linear_to_mel(np.abs(D))) - self.cfg.ref_level_db
        return self.normalize(S) if clip_norm else S

    # -- inversion / vocoding --------------------------------------------------

    def griffin_lim(self, S: np.ndarray, rng: np.random.Generator | None = None
                    ) -> np.ndarray:
        """Griffin-Lim phase reconstruction of magnitudes S [num_freq, F]
        (reference audio.py:95-102) in complex128, one STFT and one iSTFT an
        iteration, from random phases drawn from ``rng``."""
        rng = rng or np.random.default_rng()
        angles = np.exp(2j * np.pi * rng.random(S.shape))
        S_complex = np.abs(S).astype(np.complex128)
        y = self._istft(S_complex * angles)
        for _ in range(self.cfg.griffin_lim_iters):
            angles = np.exp(1j * np.angle(self._stft(y)))
            y = self._istft(S_complex * angles)
        return y

    def griffin_lim_fast(self, S: np.ndarray,
                         rng: np.random.Generator | None = None) -> np.ndarray:
        """float32 vectorized Griffin-Lim (``fast_griffin_lim``)."""
        c = self.cfg
        return fast_griffin_lim(S, c.n_fft, c.frame_shift_sample, c.frame_length_sample,
                                c.griffin_lim_iters, c.center, rng)

    def inv_spectrogram(self, spectrogram: np.ndarray,
                        rng: np.random.Generator | None = None,
                        fast: bool = True) -> np.ndarray:
        """Normalized log-magnitude spectrogram [num_freq, F] -> wav, through
        ``griffin_lim_fast`` or, with ``fast=False``, ``griffin_lim``."""
        S = self.db_to_amp(self.denormalize(spectrogram) + self.cfg.ref_level_db)
        gl = self.griffin_lim_fast if fast else self.griffin_lim
        return gl(S ** self.cfg.power, rng)

    def inv_mel_spectrogram(self, mel_spectrogram: np.ndarray,
                            rng: np.random.Generator | None = None,
                            fast: bool = True) -> np.ndarray:
        """The host vocoder (reference audio.py:81-84): normalized log-mel
        [num_mels, F] -> wav, through the float32 ``fast_griffin_lim`` or,
        with ``fast=False``, the complex128 ``griffin_lim``."""
        S = self.mel_to_linear(self.db_to_amp(
            self.denormalize(mel_spectrogram) + self.cfg.ref_level_db))
        gl = self.griffin_lim_fast if fast else self.griffin_lim
        return gl(S ** self.cfg.power, rng)

    # -- preemphasis -----------------------------------------------------------

    def preemphasize(self, x: np.ndarray) -> np.ndarray:
        # reference audio.py:214-226
        if self.cfg.preemphasize is None:
            return x
        from scipy import signal as sp_signal  # slow to import: where used
        return sp_signal.lfilter([1, -self.cfg.preemphasize], [1], x)

    def inv_preemphasize(self, x: np.ndarray) -> np.ndarray:
        # reference audio.py:228-242
        if self.cfg.preemphasize is None:
            return x
        from scipy import signal as sp_signal  # slow to import: where used
        return sp_signal.lfilter([1], [1, -self.cfg.preemphasize], x)

    # -- misc -------------------------------------------------------------------

    def roundtrip_report(self, y: np.ndarray, clip_norm: bool = True) -> float:
        """Diagnostic mel->linear round-trip error (reference audio.py:48-72,
        Audio.test): returns mean |linear - mel_to_linear(mel)| and prints
        the value ranges along the chain."""
        src = np.abs(self._stft(y))
        mel_db = self.amp_to_db(self.linear_to_mel(src)) - self.cfg.ref_level_db
        S = self.normalize(mel_db) if clip_norm else mel_db
        back = self.denormalize(S) if clip_norm else S
        linear_re = self.mel_to_linear(self.db_to_amp(back + self.cfg.ref_level_db))
        err = float(np.mean(np.abs(src - linear_re)))
        print(f"linear range [{src.min():.4g}, {src.max():.4g}], "
              f"mel-db range [{mel_db.min():.4g}, {mel_db.max():.4g}], "
              f"roundtrip mean abs err {err:.4g}")
        return err

    def mfcc(self, y: np.ndarray) -> np.ndarray:
        """MFCCs, their deltas and delta-deltas, [3 * n_mfcc, n_frames]
        (reference audio.py:244-257; a delta is the central difference over
        edge-padded frames, in place of librosa.feature.delta)."""
        from scipy.fftpack import dct  # slow to import: where used
        power = self.linear_to_mel(np.abs(self._stft(self.preemphasize(y))) ** 2)
        power_db = 10.0 * np.log10(np.maximum(1e-10, power))
        mfcc = dct(power_db, axis=0, type=2, norm="ortho")[: self.cfg.n_mfcc]
        d1 = delta(mfcc)
        return np.concatenate([mfcc, d1, delta(d1)], axis=0)

    def find_endpoint(self, wav: np.ndarray, threshold_db: float = -40.0,
                      min_silence_sec: float = 0.8) -> int:
        """The sample after the first silent window (every sample below
        ``threshold_db``, ``min_silence_sec`` long, hops of a quarter
        window), or len(wav) (reference audio.py:86-93)."""
        window_length = int(self.cfg.sample_rate * min_silence_sec)
        hop_length = window_length // 4
        threshold = self.db_to_amp(np.array(threshold_db))
        for x in range(hop_length, len(wav) - window_length, hop_length):
            if np.max(wav[x: x + window_length]) < threshold:
                return x + hop_length
        return len(wav)


def delta(x: np.ndarray) -> np.ndarray:
    """The central difference of x [n, F] along frames, edges padded by
    repetition: (x[:, t + 1] - x[:, t - 1]) / 2."""
    padded = np.pad(x, ((0, 0), (1, 1)), mode="edge")
    return (padded[:, 2:] - padded[:, :-2]) / 2.0
