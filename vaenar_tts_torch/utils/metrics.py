"""Mel metrics and take selection in numpy: the port's own copy of
``mel_l1``, ``mel_l2``, ``mcd``, ``mcd_dtw``, ``medoid_take`` and
``alignment_diagonality`` and ``batch_summary`` of
``vaenar_tts_tpu/utils/metrics.py``. The synthesis CLI's multi-take
selection (``--take_score medoid`` and ``coverage``) reads them, and the
training loop's test-interval quality metrics read ``batch_summary``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def mel_l1(pred: np.ndarray, ref: np.ndarray) -> float:
    """Mean absolute error over the overlapping frames of two [T, D] mels."""
    n = min(pred.shape[0], ref.shape[0])
    return float(np.mean(np.abs(pred[:n].astype(np.float64)
                                - ref[:n].astype(np.float64))))


def mel_l2(pred: np.ndarray, ref: np.ndarray) -> float:
    n = min(pred.shape[0], ref.shape[0])
    return float(np.mean((pred[:n].astype(np.float64)
                          - ref[:n].astype(np.float64)) ** 2))


def mcd(pred: np.ndarray, ref: np.ndarray, n_coeffs: int = 13) -> float:
    """Mel-cepstral distortion (dB) over overlapping frames of [T, D] log-mel
    inputs, via DCT-II cepstra: standard MCD-13 takes coefficients c1..c13
    (c0, the energy term, excluded)."""
    from scipy.fftpack import dct
    n = min(pred.shape[0], ref.shape[0])
    c_pred = dct(pred[:n], type=2, axis=1, norm="ortho")[:, 1:n_coeffs + 1]
    c_ref = dct(ref[:n], type=2, axis=1, norm="ortho")[:, 1:n_coeffs + 1]
    k = 10.0 / np.log(10.0) * np.sqrt(2.0)
    return float(np.mean(k * np.sqrt(np.sum((c_pred - c_ref) ** 2, axis=1))))


def _cepstra(mel: np.ndarray, n_coeffs: int) -> np.ndarray:
    from scipy.fftpack import dct
    return dct(mel.astype(np.float64), type=2, axis=1,
               norm="ortho")[:, 1:n_coeffs + 1]


def mcd_dtw(pred: np.ndarray, ref: np.ndarray, n_coeffs: int = 13) -> float:
    """MCD (dB) under a DTW alignment of the two cepstral sequences,
    normalized by path length — the standard timing-invariant variant.

    Plain frame-wise ``mcd`` penalizes timing differences: synthesis sampled
    from the prior picks ITS OWN plausible per-segment durations (tempo and
    duration are latent in the corpus/speech), so frame t of the synthesis
    need not correspond to frame t of ground truth. DTW charges for spectral
    mismatch along the best monotonic frame correspondence instead.
    """
    cp, cr = _cepstra(pred, n_coeffs), _cepstra(ref, n_coeffs)
    k = 10.0 / np.log(10.0) * np.sqrt(2.0)
    d = k * np.sqrt(((cp[:, None, :] - cr[None, :, :]) ** 2).sum(-1))
    tp, tr = d.shape
    inf = np.inf
    cost = np.full((tp + 1, tr + 1), inf)
    steps = np.zeros((tp + 1, tr + 1), np.int32)
    cost[0, 0] = 0.0
    choice = np.zeros((tp, tr), np.int8)
    for i in range(1, tp + 1):
        # vectorized over j: min of (diag, up); the left move needs the
        # running row, so do one cumulative pass for it
        prev = np.minimum(cost[i - 1, :-1], cost[i - 1, 1:])  # diag/up per j
        row = np.empty(tr + 1)
        row[0] = inf
        for j in range(1, tr + 1):
            best = min(prev[j - 1], row[j - 1])
            row[j] = d[i - 1, j - 1] + best
            choice[i - 1, j - 1] = (0 if best == cost[i - 1, j - 1] else
                                    (1 if best == cost[i - 1, j] else 2))
        cost[i] = row
    # traceback for path length
    i, j, n = tp, tr, 0
    while i > 0 and j > 0:
        n += 1
        c = choice[i - 1, j - 1]
        if c == 0:  # diagonal: consumed one frame of each
            i, j = i - 1, j - 1
        elif c == 1:  # up: came from the previous pred frame, same ref frame
            i -= 1
        else:  # left: same pred frame, previous ref frame
            j -= 1
    n += i + j
    return float(cost[tp, tr] / max(n, 1))


def medoid_take(mels: Sequence[np.ndarray], frame_stride: int = 4
                ) -> tuple:
    """Content-aware multi-take selection: the MEDOID by pairwise DTW-MCD.

    ``mels``: one utterance's takes, each [T_t, D] trimmed to its own
    predicted length. Prior-sample synthesis occasionally breaks down
    mid-utterance (garbled or skipped content); such takes are OUTLIERS of
    the take ensemble — spectrally far from every sibling — while healthy
    takes of the same text agree up to timing. The take minimizing the
    summed DTW-MCD to all others is therefore the consensus render, with no
    reference audio and no saturating attention statistic involved (the
    diagonality-coverage score saturates ~0.95 on trained models and cannot
    rank takes, DESIGN.md §10 / ALIGNMENT.md).

    ``frame_stride`` subsamples frames before the O(T^2) host-side DTW;
    medoid choice is insensitive to it (the outlier gap is tens of dB).

    Returns ``(medoid_index, distance_matrix)`` — the matrix is the
    takes x takes DTW-MCD table (dB) for diagnostics/logging.
    """
    n = len(mels)
    d = np.zeros((n, n))
    if n > 1:
        sub = [np.asarray(m)[::max(frame_stride, 1)] for m in mels]
        for i in range(n):
            for j in range(i + 1, n):
                d[i, j] = d[j, i] = mcd_dtw(sub[i], sub[j])
    return int(np.argmin(d.sum(axis=1))), d


def alignment_diagonality(ali: np.ndarray, mel_len: int, text_len: int
                          ) -> Dict[str, float]:
    """Monotonic-alignment score for one utterance's cross-attention.

    ``ali``: [heads, mel_frames, text_tokens] attention weights (any padded
    size; cropped to the valid ``mel_len`` x ``text_len`` region). Returns

      * ``diagonality``: the best head's Pearson correlation between the frame
        index and the attention-expected text position -- 1.0 for a perfectly
        monotonic alignment, ~0 for unstructured attention;
      * ``focus``: that head's mean max attention weight per frame (how peaked
        the alignment is; uniform attention gives 1/text_len);
      * ``coverage``: the fraction of text tokens the best head attends at
        some frame with at least twice the uniform weight. A perfectly
        diagonal alignment that never reaches the last tokens (a truncated
        render) or skips tokens mid-utterance scores < 1 here while its
        diagonality can still be ~1 — coverage is the truncation/omission
        detector diagonality is blind to. Uniform (unlearned) attention
        scores 0: its per-token peak is exactly 1/text_len.

    This is the quantitative version of the diagonal alignment plots the
    reference eyeballs every test interval (reference train.py:309-325).
    """
    a = np.asarray(ali, np.float64)[:, :mel_len, :text_len]
    a = a / np.maximum(a.sum(axis=-1, keepdims=True), 1e-12)
    frames = np.arange(mel_len, dtype=np.float64)
    positions = np.arange(text_len, dtype=np.float64)
    best_corr, best_focus, best_cov = -1.0, 0.0, 0.0
    for h in range(a.shape[0]):
        expected = a[h] @ positions  # [mel_len] expected text position
        if expected.std() < 1e-9 or frames.std() < 1e-9:
            corr = 0.0
        else:
            corr = float(np.corrcoef(frames, expected)[0, 1])
        if corr > best_corr:
            best_corr = corr
            best_focus = float(np.mean(a[h].max(axis=-1)))
            token_peak = a[h].max(axis=0)  # [text_len] peak over frames
            best_cov = float(np.mean(token_peak >= 2.0 / text_len))
    return {"diagonality": best_corr, "focus": best_focus,
            "coverage": best_cov}


def batch_diagonality(ali_batch: np.ndarray, mel_lens: Sequence[int],
                      text_lens: Sequence[int], n_valid: int | None = None
                      ) -> Dict[str, float]:
    """The mean of ``alignment_diagonality``'s scores over the first
    ``n_valid`` items (all when None) of a padded batch ``ali_batch`` [batch,
    heads, mel_frames, text_tokens], and their count ``n``."""
    n = n_valid if n_valid is not None else ali_batch.shape[0]
    scores = [alignment_diagonality(ali_batch[i], int(mel_lens[i]), int(text_lens[i]))
              for i in range(n)]
    out = {key: float(np.mean([sc[key] for sc in scores]))
           for key in ("diagonality", "focus", "coverage")}
    out["n"] = len(scores)
    return out


def batch_summary(pairs: Sequence[tuple], dtw: bool = False) -> Dict[str, float]:
    """The means of ``mel_l1``, ``mel_l2`` and ``mcd`` over (pred, ref) mel
    pairs, with their count ``n``; ``dtw=True`` adds ``mcd_dtw_db``."""
    out = {"mel_l1": float(np.mean([mel_l1(p, r) for p, r in pairs])),
           "mel_l2": float(np.mean([mel_l2(p, r) for p, r in pairs])),
           "mcd_db": float(np.mean([mcd(p, r) for p, r in pairs])),
           "n": len(pairs)}
    if dtw:
        out["mcd_dtw_db"] = float(np.mean([mcd_dtw(p, r) for p, r in pairs]))
    return out
