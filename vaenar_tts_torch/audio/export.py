"""Synthesis artifacts (the port's counterpart of ``TestUtils`` in
``vaenar_tts_tpu/audio/export.py``): trimmed mel ``.npy`` files, Griffin-Lim
wavs (batched on the device, or numpy on host threads), wavs of the neural
ISTFT-head vocoder (``models/vocoder.py``), streaming wavs with
time-to-first-audio, and mel and alignment plots.

The vocoders run on the device that the model was asked to run on
(``device``); the JAX package's capability probe and its
``VAENAR_JAX_VOCODER`` switch are not part of this port.
``synthesize_and_save_wavs_auto`` takes the neural vocoder when one was
given (``neural_vocoder_dir``, loaded at construction, so that a broken or
mismatched vocoder fails at once and not at the first test interval), else
Griffin-Lim on a CUDA device, else Griffin-Lim on host threads. Plots import
matplotlib when they are drawn, with the Agg backend; a plot asked for
without matplotlib raises.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.hparams import HParams
from ..text.tokenizer import CharTokenizer
from .dsp import AudioProcessor


def _agg_pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("drawing plots needs matplotlib, which is not installed; "
                           "pass --no-draw_alignments (cli.inference) or "
                           "--no-draw_plots (cli.train)") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


class TestUtils:
    __test__ = False  # not a pytest class

    def __init__(self, hps: HParams, save_dir: str, device="cuda",
                 neural_vocoder_dir: Optional[str] = None):
        self.hps = hps
        self.save_dir = save_dir
        self.device = torch.device(device)
        os.makedirs(save_dir, exist_ok=True)
        self.audio = AudioProcessor(hps.audio)
        self.tokenizer = CharTokenizer(hps.text)
        self.neural_vocoder = (self._load_neural_vocoder(neural_vocoder_dir)
                               if neural_vocoder_dir else None)

    def _load_neural_vocoder(self, vocoder_dir: str):
        """The vocoder of ``vocoder_dir`` on ``device``; raise when it was
        trained under another audio config than the model's (a mismatched
        hop or rate would cut and stamp the wavs wrongly)."""
        from ..models.vocoder import load_vocoder
        model, _ = load_vocoder(vocoder_dir, self.device)
        va, ta = model.audio, self.hps.audio
        mismatches = {k: (getattr(va, k), getattr(ta, k))
                      for k in ("sample_rate", "frame_shift_sample", "frame_length_sample",
                                "num_mels", "num_freq")
                      if getattr(va, k) != getattr(ta, k)}
        if mismatches:
            raise ValueError(
                f"neural vocoder at {vocoder_dir} was trained under a different audio "
                f"config than this model: {mismatches} (vocoder, model). Retrain it "
                f"with the matching --dataset.")
        return model

    def _path(self, prefix: str, tag, fid, suffix: str) -> str:
        return os.path.join(self.save_dir, f"{prefix}-{tag}-{fid}{suffix}")

    def write_mels(self, tag, mel_batch: np.ndarray, mel_lengths, ids,
                   prefix: str = "") -> List[str]:
        """Each mel trimmed to its length, as ``<prefix>-<tag>-<id>.npy``."""
        paths = []
        for i, mel in enumerate(mel_batch):
            path = self._path(prefix, tag, ids[i], ".npy")
            np.save(path, mel[: int(mel_lengths[i])])
            paths.append(path)
        return paths

    def synthesize_and_save_wavs(self, tag, mel_batch: np.ndarray, mel_lengths, ids,
                                 prefix: str = "", seed: int = 0) -> List[str]:
        """The host vocoder: each mel trimmed to its length, numpy
        Griffin-Lim (``dsp.gl_core``) seeded with ``seed + i``, on up to 8
        threads."""

        def synth(i):
            mel = mel_batch[i][: int(mel_lengths[i])]
            wav = self.audio.inv_mel_spectrogram(mel.T, np.random.default_rng(seed + i))
            path = self._path(prefix, tag, ids[i], ".wav")
            self.audio.save_wav(self.audio.inv_preemphasize(wav), path)
            return path

        workers = min(8, os.cpu_count() or 1, len(mel_batch) or 1)
        with ThreadPoolExecutor(max_workers=workers) as ex:
            return list(ex.map(synth, range(len(mel_batch))))

    def synthesize_and_save_wavs_device(self, tag, mel_batch: np.ndarray, mel_lengths, ids,
                                        prefix: str = "", seed: int = 0) -> List[str]:
        """The device vocoder (``synthesize_and_save_wavs_jax``): the padded
        batch through ``ops.griffin_lim.mel_to_wav`` on ``device``, the
        initial phase from a ``torch.Generator`` seeded with ``seed``; each
        wav trimmed to mel length · hop, then inverse preemphasis and the
        file on the host."""
        from ..ops.griffin_lim import mel_to_wav
        gen = torch.Generator(device=self.device).manual_seed(seed)
        mels = torch.as_tensor(np.asarray(mel_batch, np.float32), device=self.device)
        wavs = mel_to_wav(mels, self.hps.audio, gen).cpu().numpy()
        hop = self.hps.audio.frame_shift_sample
        paths = []
        for i in range(len(mel_batch)):
            path = self._path(prefix, tag, ids[i], ".wav")
            wav = self.audio.inv_preemphasize(wavs[i][: int(mel_lengths[i]) * hop])
            self.audio.save_wav(wav, path)
            paths.append(path)
        return paths

    def synthesize_and_save_wavs_neural(self, tag, mel_batch: np.ndarray, mel_lengths, ids,
                                        prefix: str = "") -> List[str]:
        """The neural vocoder given at construction: the padded batch in
        one pass on ``device``, each wav
        trimmed to max(mel length - 1, 1) · hop samples (the ISTFT head gives
        hop · (T - 1) for T frames, where Griffin-Lim's cut is mel length ·
        hop), then inverse preemphasis and the file on the host."""
        from ..models.vocoder import vocode
        if self.neural_vocoder is None:
            raise ValueError("no neural vocoder: construct TestUtils with neural_vocoder_dir")
        mels = torch.as_tensor(np.asarray(mel_batch, np.float32), device=self.device)
        wavs = vocode(self.neural_vocoder, mels).cpu().numpy()
        hop = self.hps.audio.frame_shift_sample
        paths = []
        for i in range(len(mel_batch)):
            path = self._path(prefix, tag, ids[i], ".wav")
            n = max(int(mel_lengths[i]) - 1, 1) * hop
            self.audio.save_wav(self.audio.inv_preemphasize(wavs[i][:n]), path)
            paths.append(path)
        return paths

    def synthesize_and_save_wavs_auto(self, tag, mel_batch: np.ndarray, mel_lengths, ids,
                                      prefix: str = "", seed: int = 0) -> List[str]:
        """The neural vocoder when one was given, else Griffin-Lim on a CUDA
        ``device``, else Griffin-Lim on host threads (the caller asked for
        the CPU)."""
        if self.neural_vocoder is not None:
            return self.synthesize_and_save_wavs_neural(tag, mel_batch, mel_lengths, ids,
                                                        prefix=prefix)
        if self.device.type == "cuda":
            return self.synthesize_and_save_wavs_device(tag, mel_batch, mel_lengths, ids,
                                                        prefix, seed)
        return self.synthesize_and_save_wavs(tag, mel_batch, mel_lengths, ids, prefix, seed)

    def synthesize_and_save_wavs_streaming(self, tag, mel_batch: np.ndarray, mel_lengths, ids,
                                           prefix: str = "", seed: int = 0,
                                           chunk_frames: int = 100, backend: str = "device"
                                           ) -> Tuple[List[str], List[float]]:
        """The streaming vocoder (``audio/streaming.py``), ``backend``
        "device" (on ``device``) or "host"; returns the paths and each
        utterance's time to its first piece in seconds."""
        from .streaming import StreamingVocoder
        sv = StreamingVocoder(self.audio, chunk_frames=chunk_frames, backend=backend,
                              device=self.device)
        paths, ttfas = [], []
        for i in range(len(mel_batch)):
            mel = mel_batch[i][: int(mel_lengths[i])]
            t0 = time.perf_counter()
            pieces = []
            for piece in sv.stream(mel, np.random.default_rng(seed + i)):
                if not pieces:
                    ttfas.append(time.perf_counter() - t0)
                pieces.append(piece)
            path = self._path(prefix, tag, ids[i], ".wav")
            self.audio.save_wav(np.concatenate(pieces), path)
            paths.append(path)
        return paths, ttfas

    def draw_melspectrograms(self, tag, mel_batch: np.ndarray, mel_lengths, ids,
                             prefix: str = "") -> List[str]:
        plt = _agg_pyplot()
        paths = []
        for i, mel in enumerate(mel_batch):
            fig = plt.figure(figsize=(10, 4))
            plt.imshow(mel[: int(mel_lengths[i])].T, aspect="auto", origin="lower",
                       interpolation="none")
            plt.colorbar()
            plt.tight_layout()
            path = self._path(prefix, tag, ids[i], "-mel.pdf")
            fig.savefig(path)
            plt.close(fig)
            paths.append(path)
        return paths

    def ids_to_text(self, token_ids: Sequence[int]) -> str:
        """The symbols of ``token_ids``, pad, BOS and EOS kept (reference
        audio/utils.py:62-70)."""
        return self.tokenizer.decode(token_ids, strip_specials=False)

    def multi_draw_attention_alignments(self, alignments: np.ndarray, text_lengths,
                                        mel_lengths, tag, ids, prefix: str = "",
                                        reduction_factor: int = 1) -> List[str]:
        """``alignments`` [B, heads, T_query, T_text] -> one grid of heads a
        PDF per utterance, cropped to its text length and its query length:
        the mel length over ``reduction_factor``, rounded up. (The JAX
        package crops the decoder's reduced queries at the mel length, which
        is past their end.)"""
        plt = _agg_pyplot()
        paths = []
        n_heads = alignments.shape[1]
        cols = 2 if n_heads > 1 else 1
        rows = -(-n_heads // cols)
        for i in range(alignments.shape[0]):
            tl = int(text_lengths[i])
            ql = -(-int(mel_lengths[i]) // reduction_factor)
            fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3 * rows), squeeze=False)
            for h in range(n_heads):
                ax = axes[h // cols][h % cols]
                ax.imshow(alignments[i, h, :ql, :tl].T, aspect="auto", origin="lower",
                          interpolation="none")
                ax.set_title(f"head {h}")
            plt.tight_layout()
            path = self._path(prefix, tag, ids[i], "-ali.pdf")
            fig.savefig(path)
            plt.close(fig)
            paths.append(path)
        return paths


def require_matplotlib() -> None:
    """Raise at once, before any synthesis, when plots are asked for and
    matplotlib is missing."""
    _agg_pyplot()
