"""In-training product-metric probes (counterpart of
``vaenar_tts_tpu/training/probe.py``).

Alignment in VAENAR-style models forms at run- and epoch-dependent times,
and the free-text letter error rate of one run's late checkpoints swings
widely (ALIGNMENT.md). So the checkpoint is selected by the product metric,
measured during training: a probe runs on the checkpoint cadence,
synthesizes held-out inputs through the real inference path (prior sample,
predicted lengths) and appends its metric to a jsonl file in its directory.

* ``make_toy_ler_probe``: held-out toy-v2 texts, transcribed back to
  letters by ``data.toy.ToyLetterDecoder``; the letters-only LER goes to
  ``ler_probe.jsonl``.
* ``make_dev_mcd_probe``: the first dev utterances of a record directory;
  DTW-aligned MCD against their mels and the decoder's alignment
  diagonality go to ``mcd_probe.jsonl``. The alignments are the ones that
  synthesis computes beside the attention kernel when asked
  (``return_alignments``).
* Every probe that improves on the best value so far (resumed from the
  jsonl history) also writes ``export_best.npz`` (the JAX package's
  ``export.npz`` format, float16) and ``export_best.json``, so the best
  probed weights survive however the run ends.
* ``with_early_stop`` asks the loop to stop once the metric reaches a
  target, and leaves a ``PROBE_STOP`` file.

A probe here is called as ``probe(epoch, model)`` with the port's
``VAENAR`` module, where the JAX package's takes ``(epoch, state)``; it
synthesizes on the model's device (the attention kernels on CUDA) with
``torch.no_grad()``, and builds its decoder and inputs on its first call.
"""

from __future__ import annotations

import functools
import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

__all__ = ["make_toy_ler_probe", "make_dev_mcd_probe", "with_early_stop"]


class _BestExporter:
    """Writes ``export_best.npz`` and ``export_best.json`` whenever a probe
    improves on the lowest ``metric`` seen so far. The best value resumes
    from ``export_best.json``, or else from the jsonl history, but only
    when the export itself exists."""

    def __init__(self, out_dir: str, metric: str, jsonl_name: str):
        self.out_dir = out_dir
        self.metric = metric
        self.best = float("inf")
        hist = os.path.join(out_dir, jsonl_name)
        side = os.path.join(out_dir, "export_best.json")
        exported = os.path.exists(os.path.join(out_dir, "export_best.npz"))
        if exported and os.path.exists(side):
            try:
                with open(side) as f:
                    self.best = float(json.load(f)[metric])
            except (ValueError, KeyError, TypeError):
                pass
        elif exported and os.path.exists(hist):
            try:
                with open(hist) as f:
                    self.best = min(float(json.loads(line)[metric]) for line in f)
            except (ValueError, KeyError, TypeError):
                pass

    def maybe_export(self, epoch: int, model: torch.nn.Module, value: float) -> bool:
        if not np.isfinite(value) or value >= self.best:
            return False
        from ..interop.weights import torch_to_jax
        from ..utils.export import save_npz
        self.best = float(value)
        params, batch_stats = torch_to_jax(model)
        save_npz(os.path.join(self.out_dir, "export_best.npz"),
                 {"params": params, "batch_stats": batch_stats, "epoch": epoch})
        with open(os.path.join(self.out_dir, "export_best.json"), "w") as f:
            json.dump({"epoch": epoch, self.metric: round(value, 4)}, f)
        return True


def with_early_stop(probe: Callable, metric: str, target: float, workdir: str) -> Callable:
    """``probe`` that asks the loop to stop once ``metric`` is at or under
    ``target``, and writes ``workdir/PROBE_STOP`` (epoch and value) so that
    a script that restarts runs does not start this one again."""
    def wrapped(epoch, model):
        scalars = probe(epoch, model)
        if scalars and scalars.get(metric, float("inf")) <= target:
            scalars["stop_training"] = True
            with open(os.path.join(workdir, "PROBE_STOP"), "w") as f:
                f.write(f"{epoch} {metric}={scalars[metric]:.4f}\n")
        return scalars
    return wrapped


def _append(path: str, record: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def _synthesize(model, texts: np.ndarray, text_lens: np.ndarray, max_mel: int,
                reduction_factor: int, temperature: float, seed: int,
                return_alignments: bool = False):
    """One batch through the model's length head, prior sample and decoder
    on its device, at the mean length head and no headroom; numpy out."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        out = model.infer_with_length_prediction(
            torch.from_numpy(np.asarray(texts, np.int64)).to(device),
            torch.from_numpy(np.asarray(text_lens, np.int32)).to(device),
            max_mel_length=max_mel, reduction_factor=reduction_factor,
            temperature=temperature, length_headroom=0, use_length_quantile=False,
            generator=gen, return_alignments=return_alignments)
    mels, lens = out[0].float().cpu().numpy(), out[1].cpu().numpy()
    if return_alignments:
        return mels, lens, {k: a.float().cpu().numpy() for k, a in out[2].items()}
    return mels, lens


class ToyLerProbe:
    """``probe(epoch, model) -> {"probe_ler": mean letters-only LER}`` over
    ``n_texts`` texts of ``random_text(default_rng(text_seed))`` (the texts
    of ``scripts/freetext_toyv2_eval.py``), averaged over ``sample_seeds``
    prior draws (generator seeds 0, 1, ...)."""

    def __init__(self, hp, out_dir: str, n_texts: int = 8, text_seed: int = 4242,
                 sample_seeds: int = 2, temperature: float = 0.6):
        self.hp = hp
        self.out_dir = out_dir
        self.n_texts = n_texts
        self.text_seed = text_seed
        self.sample_seeds = sample_seeds
        self.temperature = temperature
        self.exporter = _BestExporter(out_dir, "probe_ler", "ler_probe.jsonl")

    @functools.cached_property
    def _inputs(self):
        """(texts, padded ids [n, text_max], lengths, mel budget, decoder),
        built on first use: the decoder renders its templates."""
        from ..data.corpus import CORPORA
        from ..data.loader import pad_to_multiple
        from ..data.toy import ToyLetterDecoder, random_text
        hp = self.hp
        rng = np.random.default_rng(self.text_seed)
        texts = [random_text(rng) for _ in range(self.n_texts)]
        corpus = CORPORA["ljspeech"](None, None, hp)
        seqs = [corpus.text_to_array(t) for t in texts]
        text_lens = np.asarray([len(s) for s in seqs], np.int32)
        text_max = pad_to_multiple(int(text_lens.max()), hp.dataset.text_bucket)
        batch = np.zeros((len(texts), text_max), np.int64)
        for i, s in enumerate(seqs):
            batch[i, :len(s)] = s
        max_mel = pad_to_multiple(int(text_max * hp.common.mel_text_len_ratio * 2) + 160,
                                  hp.dataset.mel_bucket)
        return texts, batch, text_lens, max_mel, ToyLetterDecoder(hp)

    @property
    def texts(self) -> List[str]:
        return self._inputs[0]

    def synthesize(self, model) -> List[List[np.ndarray]]:
        """Per prior draw, each text's mel [length, num_mels] (at least one
        frame)."""
        _, batch, text_lens, max_mel, _ = self._inputs
        out = []
        for seed in range(self.sample_seeds):
            mels, lens = _synthesize(model, batch, text_lens, max_mel,
                                     self.hp.common.final_reduction_factor,
                                     self.temperature, seed)
            out.append([mels[b, :max(int(lens[b]), 1)] for b in range(len(lens))])
        return out

    def mean_ler(self, model) -> float:
        from ..data.toy import letter_error_rate
        draws = self.synthesize(model)
        texts, decoder = self._inputs[0], self._inputs[4]
        return float(np.mean([
            letter_error_rate(decoder.decode(mel).replace(" ", ""), text.replace(" ", ""))
            for mels in draws for mel, text in zip(mels, texts)]))

    def __call__(self, epoch: int, model) -> Optional[Dict[str, float]]:
        ler = self.mean_ler(model)
        _append(os.path.join(self.out_dir, "ler_probe.jsonl"),
                {"epoch": epoch, "probe_ler": round(ler, 4), "n_texts": self.n_texts,
                 "sample_seeds": self.sample_seeds, "temperature": self.temperature})
        t = time.perf_counter()
        if self.exporter.maybe_export(epoch, model, ler):
            print(f"  probe: new best LER {ler:.4f} at epoch {epoch} -> export_best.npz "
                  f"({time.perf_counter() - t:.2f} s)")
        return {"probe_ler": ler}


def make_toy_ler_probe(hp, out_dir: str, n_texts: int = 8, text_seed: int = 4242,
                       sample_seeds: int = 2, temperature: float = 0.6) -> ToyLerProbe:
    """The toy-v2 letter-error-rate probe (``ToyLerProbe``); nothing heavy
    is built until its first call."""
    return ToyLerProbe(hp, out_dir, n_texts, text_seed, sample_seeds, temperature)


class DevMcdProbe:
    """``probe(epoch, model) -> {"probe_mcd_dtw", "probe_diag"}``: the first
    ``n_utts`` dev utterances of ``data_dir`` synthesized (predicted
    lengths, prior sample at ``temperature``, mel budget the longest dev mel
    + 80 frames), scored by DTW-aligned MCD against their mels with every
    ``frame_stride``-th frame, and by the best decoder block's alignment
    diagonality; each averaged over utterances and ``sample_seeds``
    draws."""

    def __init__(self, hp, data_dir: str, out_dir: str, n_utts: int = 8,
                 sample_seeds: int = 1, temperature: float = 0.6, frame_stride: int = 2):
        self.hp = hp
        self.data_dir = data_dir
        self.out_dir = out_dir
        self.n_utts = n_utts
        self.sample_seeds = sample_seeds
        self.temperature = temperature
        self.frame_stride = frame_stride
        self.exporter = _BestExporter(out_dir, "probe_mcd_dtw", "mcd_probe.jsonl")

    @functools.cached_property
    def dev_batch(self):
        """(the first ``n_utts`` dev utterances as a Batch, the mel budget),
        read on first use."""
        from ..data.loader import BucketedLoader, pad_to_multiple
        from ..data.records import list_shards
        hp = self.hp
        loader = BucketedLoader(list_shards(self.data_dir, "dev"), self.n_utts,
                                mel_bucket=hp.dataset.mel_bucket,
                                text_bucket=hp.dataset.text_bucket, shuffle=False, seed=0)
        batch = next(iter(loader.epoch(0)))
        return batch, pad_to_multiple(batch.mels.shape[1] + 80, hp.dataset.mel_bucket)

    def measure(self, model) -> Dict[str, float]:
        from ..utils.metrics import alignment_diagonality, mcd_dtw
        batch, max_mel = self.dev_batch
        r, stride = self.hp.common.final_reduction_factor, self.frame_stride
        mcds, diags = [], []
        for seed in range(self.sample_seeds):
            mels, lens, ali = _synthesize(model, batch.texts, batch.text_lengths, max_mel, r,
                                          self.temperature, seed, return_alignments=True)
            for b in range(batch.n_valid):
                pl = max(int(lens[b]), stride)
                gt = batch.mels[b][: int(batch.mel_lengths[b])]
                mcds.append(mcd_dtw(mels[b, :pl:stride], gt[::stride]))
                red = -(-pl // r)
                diags.append(max((alignment_diagonality(a[b], red, int(batch.text_lengths[b]))
                                  ["diagonality"] for a in ali.values()), default=-1.0))
        return {"probe_mcd_dtw": float(np.mean(mcds)), "probe_diag": float(np.mean(diags))}

    def __call__(self, epoch: int, model) -> Optional[Dict[str, float]]:
        scalars = self.measure(model)
        _append(os.path.join(self.out_dir, "mcd_probe.jsonl"), dict(
            epoch=epoch, n_utts=self.n_utts, sample_seeds=self.sample_seeds,
            temperature=self.temperature, **{k: round(v, 4) for k, v in scalars.items()}))
        t = time.perf_counter()
        if self.exporter.maybe_export(epoch, model, scalars["probe_mcd_dtw"]):
            print(f"  probe: new best MCD-DTW {scalars['probe_mcd_dtw']:.3f} dB at epoch "
                  f"{epoch} -> export_best.npz ({time.perf_counter() - t:.2f} s)")
        return scalars


def make_dev_mcd_probe(hp, data_dir: str, out_dir: str, n_utts: int = 8,
                       sample_seeds: int = 1, temperature: float = 0.6,
                       frame_stride: int = 2) -> DevMcdProbe:
    """The real-corpus probe (``DevMcdProbe``): the checkpoint-selection
    metric where no toy transcriber exists; its dev batch is read on its
    first call."""
    return DevMcdProbe(hp, data_dir, out_dir, n_utts, sample_seeds, temperature, frame_stride)
