"""The procedural toy corpus and its letter decoder, the port's numpy copy
of ``vaenar_tts_tpu/data/toy.py``: the same seeds give the same waveforms,
mels, shards and transcripts.

Every letter is a harmonic tone at a letter-specific fundamental (a
chromatic scale), spaces are silence, and utterances are random letter
strings, rendered as waveforms and featurized through ``audio/dsp.py``, so
the corpus runs text frontend -> waveform -> mel -> records end to end.
Version 2 (``ToySpecV2``) adds a random tempo, duration jitter,
coarticulation, pitch declination and a noise floor, so that a model has to
follow the acoustics frame by frame to align text and time.
``ToyLetterDecoder`` transcribes a toy-v2 mel back to letters, and
``letter_error_rate`` scores the transcript: the quality metric of models
trained on this corpus.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from ..audio.dsp import AudioProcessor
from ..configs.hparams import HParams
from ..text.tokenizer import CharTokenizer
from .records import RecordShardWriter

LETTERS = "abcdefghijklmnopqrstuvwxyz"


@dataclass
class ToySpec:
    """Deterministic per-symbol acoustics."""

    base_f0: float = 110.0  # letter 'a'; 'z' lands ~467 Hz
    n_harmonics: int = 4
    harmonic_decay: float = 0.6
    min_frames: int = 7  # per-letter duration = min_frames + (k % spread)
    frame_spread: int = 8
    silence_frames: int = 4  # per space

    def f0(self, k: int) -> float:
        return self.base_f0 * 2.0 ** (k / 12.0)

    def frames(self, k: int) -> int:
        return self.min_frames + (k % self.frame_spread)


def synthesize_utterance(text: str, hp: HParams,
                         spec: ToySpec | None = None) -> np.ndarray:
    """Render cleaned toy text (letters + spaces) to a waveform."""
    spec = spec or ToySpec()
    sr = hp.audio.sample_rate
    shift = hp.audio.frame_shift_sample
    segments: List[np.ndarray] = []
    for ch in text:
        if ch == " ":
            segments.append(np.zeros(spec.silence_frames * shift))
            continue
        k = LETTERS.index(ch)
        n = spec.frames(k) * shift
        t = np.arange(n) / sr
        seg = np.zeros(n)
        for h in range(1, spec.n_harmonics + 1):
            seg += spec.harmonic_decay ** h * np.sin(
                2 * np.pi * h * spec.f0(k) * t)
        # attack/decay envelope: audible (and spectrally visible) onsets
        env = np.minimum(np.arange(n), n - 1 - np.arange(n))
        env = np.minimum(env / (0.15 * n), 1.0)
        segments.append(seg * env)
    # leading/trailing silence like a real recording
    pad = np.zeros(2 * shift)
    wav = np.concatenate([pad] + segments + [pad])
    return (0.6 * wav / max(np.abs(wav).max(), 1e-6)).astype(np.float32)


@dataclass
class ToySpecV2:
    """Speech-like per-symbol acoustics.

    In version 1 letter durations were a deterministic
    function of the text, so a model could locate segment boundaries by
    counting durations from the text alone — monotonic alignment was nearly
    positional. V2 removes every such shortcut:

      * per-utterance TEMPO drawn randomly (durations are not a function of
        the text) plus per-letter duration jitter;
      * COARTICULATION: f0, amplitude and spectral tilt are smoothed across
        segment boundaries, so letter onsets/offsets glide into their
        neighbors instead of switching instantaneously;
      * PITCH DECLINATION: the whole utterance drifts down a random number of
        semitones, so absolute pitch does not identify a letter — only pitch
        relative to the declination trend does;
      * a NOISE FLOOR under everything, silence included.

    The model must therefore track the acoustics frame by frame to know which
    letter it is inside, the burden real speech puts on cross-attention.
    """

    base_f0: float = 110.0
    n_harmonics: int = 4
    min_frames: int = 7
    frame_spread: int = 8
    silence_frames: int = 4
    tempo_range: Tuple[float, float] = (0.7, 1.4)  # per-utterance
    jitter_frames: int = 2  # per-letter duration jitter, +/- uniform
    declination_semitones: Tuple[float, float] = (1.0, 4.0)  # per-utterance
    coart_ms: float = 35.0  # smoothing window over f0/amp/tilt tracks
    noise_db: float = -34.0  # noise floor relative to peak

    def f0(self, k: int) -> float:
        return self.base_f0 * 2.0 ** (k / 12.0)

    def harmonic_decay(self, k: int) -> float:
        """Per-letter spectral tilt: a second, pitch-independent cue."""
        return 0.35 + 0.5 * ((k * 7) % 26) / 25.0


def synthesize_utterance_v2(text: str, hp: HParams, rng: np.random.Generator,
                            spec: ToySpecV2 | None = None) -> np.ndarray:
    """Render toy-v2 text to a waveform with utterance-level randomness.

    Builds per-sample f0 / amplitude / spectral-tilt tracks, smooths them with
    a coarticulation window (glides at every boundary), integrates phase once
    for the whole utterance (no phase resets at boundaries), and adds a noise
    floor.
    """
    spec = spec or ToySpecV2()
    sr = hp.audio.sample_rate
    shift = hp.audio.frame_shift_sample

    tempo = float(rng.uniform(*spec.tempo_range))
    decl_semis = float(rng.uniform(*spec.declination_semitones))

    # per-segment frame counts: tempo-scaled base + jitter, floor of 3 frames
    f0s, amps, tilts, frames = [], [], [], []
    for ch in text:
        if ch == " ":
            n = max(2, int(round(tempo * spec.silence_frames
                                 + rng.integers(-1, 2))))
            f0s.append(0.0)  # filled by smoothing: glide through silence
            amps.append(0.0)
            tilts.append(0.5)
            frames.append(n)
            continue
        k = LETTERS.index(ch)
        base = spec.min_frames + (k % spec.frame_spread)
        n = max(3, int(round(tempo * base
                             + rng.integers(-spec.jitter_frames,
                                            spec.jitter_frames + 1))))
        f0s.append(spec.f0(k))
        amps.append(1.0)
        tilts.append(spec.harmonic_decay(k))
        frames.append(n)

    # 3+ frames of lead silence so the coarticulation smear (coart_ms) of the
    # first onset stays clear of the very start, like a real recording's
    # room-tone head
    pad = max(3, int(round(3 * tempo)))
    f0s = [0.0] + f0s + [0.0]
    amps = [0.0] + amps + [0.0]
    tilts = [0.5] + tilts + [0.5]
    frames = [pad] + frames + [pad]

    # expand to per-sample tracks
    n_samples = sum(frames) * shift
    f0_track = np.zeros(n_samples)
    amp_track = np.zeros(n_samples)
    tilt_track = np.zeros(n_samples)
    pos = 0
    for f0, amp, tilt, n in zip(f0s, amps, tilts, frames):
        s = n * shift
        f0_track[pos:pos + s] = f0
        amp_track[pos:pos + s] = amp
        tilt_track[pos:pos + s] = tilt
        pos += s

    # silence carries no pitch target: let the glide pass through it by
    # interpolating f0 over zero-amp gaps before smoothing
    voiced = amp_track > 0
    if voiced.any():
        idx = np.arange(n_samples)
        f0_track = np.interp(idx, idx[voiced], f0_track[voiced])

    # pitch declination: exponential drift down decl_semis semitones
    t01 = np.linspace(0.0, 1.0, n_samples)
    f0_track = f0_track * 2.0 ** (-decl_semis * t01 / 12.0)

    # coarticulation: moving-average the tracks (boxcar, ~coart_ms)
    w = max(1, int(spec.coart_ms / 1000.0 * sr))
    kernel = np.ones(w) / w
    f0_track = np.convolve(f0_track, kernel, mode="same")
    amp_track = np.convolve(amp_track, kernel, mode="same")
    tilt_track = np.convolve(tilt_track, kernel, mode="same")

    # one continuous phase integral; harmonic stack with time-varying tilt
    phase = 2.0 * np.pi * np.cumsum(f0_track) / sr
    wav = np.zeros(n_samples)
    for h in range(1, spec.n_harmonics + 1):
        wav += tilt_track ** h * np.sin(h * phase)
    wav *= amp_track

    noise = rng.standard_normal(n_samples) * 10.0 ** (spec.noise_db / 20.0)
    wav = wav + noise
    return (0.6 * wav / max(np.abs(wav).max(), 1e-6)).astype(np.float32)


def random_text(rng: np.random.Generator, min_letters: int = 8,
                max_letters: int = 22) -> str:
    """Random words of 2-5 letters joined by spaces."""
    n = int(rng.integers(min_letters, max_letters + 1))
    words, used = [], 0
    while used < n:
        w = int(min(rng.integers(2, 6), n - used))
        if w == 1:
            # a 1-letter remainder would force a word outside the 2-5 range
            # (and the old +1 bump overran max_letters); extend the previous
            # word instead
            words[-1] += str(rng.choice(list(LETTERS)))
            used += 1
            continue
        words.append("".join(rng.choice(list(LETTERS), w)))
        used += w
    return " ".join(words)


def generate_corpus(save_dir: str, hp: HParams, n_train: int = 960,
                    n_dev: int = 32, n_test: int = 16, seed: int = 0,
                    train_split: int | None = None, version: int = 1) -> dict:
    """Write toy train/dev/test .vrs shards. Returns corpus stats
    (frames-per-token ratio, max lengths) for configuring the model.
    ``version=2`` uses the speech-like ToySpecV2 acoustics (random tempo,
    coarticulation, declination, noise floor)."""
    os.makedirs(save_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    ap = AudioProcessor(hp.audio)
    tok = CharTokenizer(hp.text)
    train_split = train_split or hp.dataset.record_split

    ratios: List[float] = []
    max_text, max_mel = 0, 0

    def make(fid: str) -> Tuple[str, np.ndarray, np.ndarray]:
        nonlocal max_text, max_mel
        text = random_text(rng)
        if version == 2:
            wav = synthesize_utterance_v2(text, hp, rng)
        else:
            wav = synthesize_utterance(text, hp)
        mel = ap.melspectrogram(wav).T.astype(np.float32)  # [T, num_mels]
        ids = np.asarray(tok.encode(text), np.int32)
        ratios.append(mel.shape[0] / len(ids))
        max_text = max(max_text, len(ids))
        max_mel = max(max_mel, mel.shape[0])
        return fid, ids, mel

    counts = {"train": n_train, "dev": n_dev, "test": n_test}
    for mode, count in counts.items():
        n_shards = train_split if mode == "train" else 1
        writers = [RecordShardWriter(
            os.path.join(save_dir, f"{mode}-{i}.vrs"), hp.audio.num_mels)
            for i in range(n_shards)]
        for i in range(count):
            fid, ids, mel = make(f"{mode}{i:05d}")
            writers[i % n_shards].add(fid, ids, mel)
        for w in writers:
            w.close()

    return {
        "n_train": n_train, "n_dev": n_dev, "n_test": n_test,
        "version": version,
        "mel_text_len_ratio": float(np.mean(ratios)),
        "max_text_len": int(max_text),
        "max_mel_len": int(max_mel),
    }


class ToyLetterDecoder:
    """Transcription decoder for toy-v2 audio: mel -> letter string.

    The objective intelligibility metric for free-text synthesis: every
    toy-v2 letter is identifiable from a single
    frame's spectrum — its pitch-class on the chromatic scale AND its
    pitch-independent spectral tilt (ToySpecV2.harmonic_decay) — so a mel
    produced from text can be transcribed back and scored with letter error
    rate (``letter_error_rate``).

    Method: render every (letter, declination-shift) pair as a stationary
    harmonic stack through the SAME AudioProcessor mel frontend the corpus
    uses, plus the bare noise floor as a dedicated SILENCE class, then
    classify each frame by correlation (per-frame mean removed before the
    cosine — the normalized-dB floor is a large common baseline that
    otherwise saturates every similarity at ~0.999); segment runs collapse
    to letters, silence runs to spaces, with repeat counts estimated from
    the utterance-level tempo (median segment-duration ratio vs the
    per-letter base duration).
    """

    def __init__(self, hp: HParams, spec: ToySpecV2 | None = None,
                 decl_step: float = 0.25, decl_max: float = 5.0):
        self.spec = spec or ToySpecV2()
        self.ap = AudioProcessor(hp.audio)
        self.decl_step = decl_step
        sr = hp.audio.sample_rate
        n = int(0.25 * sr)
        t = np.arange(n) / sr
        rng = np.random.default_rng(0)
        noise = rng.standard_normal(n) * 10.0 ** (self.spec.noise_db / 20.0)

        def mid_mel(w: np.ndarray) -> np.ndarray:
            mel = self.ap.melspectrogram(w.astype(np.float32)).T
            return mel[mel.shape[0] // 4: 3 * mel.shape[0] // 4].mean(axis=0)

        self.shifts = np.arange(0.0, decl_max + 1e-9, decl_step)
        letter_temps, sil = [], None
        for k in range(len(LETTERS)):
            tilt = self.spec.harmonic_decay(k)
            row = []
            for d in self.shifts:
                f0 = self.spec.f0(k) * 2.0 ** (-d / 12.0)
                w = np.zeros(n)
                for h in range(1, self.spec.n_harmonics + 1):
                    w += tilt ** h * np.sin(2 * np.pi * h * f0 * t)
                scale = 0.6 / max(np.abs(w + noise).max(), 1e-6)
                row.append(mid_mel(scale * (w + noise)))
                if k == 0 and d == 0.0:
                    # silence class: the noise floor at its IN-UTTERANCE
                    # scale (an utterance normalizes its tone peak to 0.6;
                    # silence is NOT renormalized to full scale)
                    sil = mid_mel(scale * noise)
            letter_temps.append(row)
        lt = np.asarray(letter_temps, np.float32)  # [26, S, num_mels]
        self.letter_templates = lt - lt.mean(axis=2, keepdims=True)
        self.sil_template = (sil - sil.mean()).astype(np.float32)

    def frame_symbols(self, mel: np.ndarray) -> np.ndarray:
        """Per-frame symbol indices: 0-25 letters, -1 silence.
        ``mel``: [T, num_mels] in the corpus' normalized mel domain.

        The declination is fit GLOBALLY before classifying: letter k shifted
        by a semitone is nearly letter k-1 unshifted (the tilt cue separates
        neighbors but not every pitch-shifted pair), so per-frame free choice
        of (letter, shift) is ambiguous — but the corpus applies ONE linear
        drift per utterance (synthesize_utterance_v2 declination), so the
        decoder grid-searches the total drift, constrains each frame's shift
        to the drift line, and classifies letters under that constraint.
        A width-3 median filter then removes single-frame blips."""
        mel = np.asarray(mel, np.float32)
        mel = mel - mel.mean(axis=1, keepdims=True)
        T = mel.shape[0]
        t01 = (np.arange(T) / max(T - 1, 1)).astype(np.float32)
        # distances to every (letter, shift) and to silence, computed once
        lt = self.letter_templates  # [26, S, M]
        d2 = (np.sum(mel ** 2, axis=1)[:, None, None]
              - 2.0 * np.einsum("tm,ksm->tks", mel, lt)
              + np.sum(lt ** 2, axis=2)[None])  # [T, 26, S]
        d2_sil = np.sum((mel - self.sil_template) ** 2, axis=1)  # [T]
        best_cost, best_syms = np.inf, None
        n_shifts = lt.shape[1]
        for decl in np.arange(0.0, self.shifts[-1] + 1e-9, self.decl_step):
            idx = np.clip(np.round(decl * t01 / self.decl_step), 0,
                          n_shifts - 1).astype(np.int32)
            dl = d2[np.arange(T), :, idx]  # [T, 26] under this drift line
            letter_min = dl.min(axis=1)
            cost = float(np.minimum(letter_min, d2_sil).sum())
            if cost < best_cost:
                best_cost = cost
                syms = np.where(d2_sil < letter_min, -1,
                                dl.argmin(axis=1)).astype(np.int32)
                best_syms = syms
        syms = best_syms
        if len(syms) >= 3:
            stacked = np.stack([syms[:-2], syms[1:-1], syms[2:]])
            syms[1:-1] = np.median(stacked, axis=0).astype(np.int32)
        return syms

    def _base(self, s: int) -> int:
        return self.spec.min_frames + (s % self.spec.frame_spread)

    def decode(self, mel: np.ndarray, min_run: int = 2) -> str:
        """Transcribe a mel to a letter string (words separated by single
        spaces; leading/trailing silence stripped). Two-pass segmentation:
        estimate the utterance tempo from the letter segments, drop glide
        artifacts (segments far shorter than the letter's tempo-scaled base
        duration), then emit letters with duration-derived repeat counts
        (adjacent identical letters render as one long segment)."""
        syms = self.frame_symbols(mel)
        runs: List[Tuple[int, int]] = []  # (symbol, length)
        for s in syms:
            if runs and runs[-1][0] == s:
                runs[-1] = (s, runs[-1][1] + 1)
            else:
                runs.append((int(s), 1))
        segs = [(s, ln) for s, ln in runs if ln >= min_run]
        letter_segs = [(s, ln) for s, ln in segs if s >= 0]
        if not letter_segs:
            return ""
        # pass 1: tempo from the duration-weighted segments (long segments
        # are real letters; glide blips are short and drag the median down)
        ratios = np.repeat([ln / self._base(s) for s, ln in letter_segs],
                           [ln for _, ln in letter_segs])
        tempo = float(np.median(ratios))
        tempo = min(max(tempo, self.spec.tempo_range[0]),
                    self.spec.tempo_range[1])
        # pass 2: drop glide artifacts, emit with repeat counts
        chars: List[str] = []
        for s, ln in segs:
            if s < 0:
                if chars and chars[-1] != " ":
                    chars.append(" ")
                continue
            expected = tempo * self._base(s)
            if ln < 0.55 * expected:
                continue  # coarticulation glide passing through this letter
            count = max(1, int(round(ln / expected)))
            chars.extend(LETTERS[s] * count)
        return "".join(chars).strip()


def letter_error_rate(hyp: str, ref: str) -> float:
    """Levenshtein distance over characters (spaces included) / len(ref)."""
    m, n = len(hyp), len(ref)
    if n == 0:
        return float(m > 0)
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (hyp[i - 1] != ref[j - 1]))
        prev = cur
    return prev[n] / n
