"""Neural vocoder training (counterpart of ``vaenar_tts_tpu/training/vocoder.py``):
a multi-resolution STFT loss over (mel, wav) crops, no adversary.

Pairs come from the procedural toy corpus (``data/toy.py``) or a directory
of wavs, with the mels of the TTS data pipeline's host DSP chain
(preemphasis -> melspectrogram), so that a vocoder trained here takes the
acoustic model's mels. ``PairSampler`` draws the JAX package's crops from
the same seed. The optimizer is ``torch.optim.Adam(lr, (b1, b2),
eps=1e-8)``, optax's ``adam`` with its default eps.
"""

from __future__ import annotations

import glob
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..audio.dsp import AudioProcessor
from ..configs.hparams import AudioConfig
from ..models.vocoder import MelVocoder, VocoderConfig, save_vocoder_config, spec_to_wav
from ..ops.stft import batched_stft_magnitude

ADAM_EPS = 1e-8  # optax.adam's default


def multires_stft_loss(pred: torch.Tensor, target: torch.Tensor,
                       scales: Sequence[Tuple[int, int, int]]) -> torch.Tensor:
    """Spectral convergence plus log-magnitude L1, averaged over the
    resolutions (n_fft, hop, win); ``pred`` and ``target`` are [B, S]
    waveforms in the preemphasized domain."""
    total = 0.0
    for n_fft, hop, win in scales:
        p = batched_stft_magnitude(pred, n_fft, hop, win)
        t = batched_stft_magnitude(target, n_fft, hop, win)
        sc = (torch.sqrt(((t - p) ** 2).sum(dim=(1, 2)) + 1e-12)
              / torch.sqrt((t ** 2).sum(dim=(1, 2)) + 1e-12))
        log_l1 = (torch.log(p + 1e-5) - torch.log(t + 1e-5)).abs().mean(dim=(1, 2))
        total = total + sc.mean() + log_l1.mean()
    return total / len(scales)


class PairSampler:
    """Random fixed-length (mel, wav) crops from a set of utterances. Mel
    frame f is centered at sample f · hop, so the crop mel[s : s + F] pairs
    with wav[s · hop : s · hop + hop · (F - 1)], the ISTFT head's trim."""

    def __init__(self, utterances: List[np.ndarray], audio: AudioConfig,
                 segment_frames: int, seed: int = 0):
        self.audio = audio
        self.ap = AudioProcessor(audio)
        self.seg = segment_frames
        self.hop = audio.frame_shift_sample
        self.rng = np.random.default_rng(seed)
        self.pairs = []
        for wav in utterances:
            pre = np.asarray(self.ap.preemphasize(wav), np.float32)
            self.pairs.append((pre, self.ap.melspectrogram(pre).T.astype(np.float32)))

    def sample(self, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
        F, hop = self.seg, self.hop
        mels = np.zeros((batch_size, F, self.audio.num_mels), np.float32)
        wavs = np.zeros((batch_size, hop * (F - 1)), np.float32)
        for b in range(batch_size):
            pre, mel = self.pairs[self.rng.integers(len(self.pairs))]
            s = int(self.rng.integers(0, max(mel.shape[0] - F, 0) + 1))
            crop = mel[s: s + F]
            mels[b, : crop.shape[0]] = crop
            w = pre[s * hop: s * hop + hop * (F - 1)]
            wavs[b, : len(w)] = w
        return mels, wavs


def toy_utterances(audio: AudioConfig, n: int = 64, seed: int = 0,
                   version: int = 1) -> List[np.ndarray]:
    """Procedural training audio from ``data/toy.py``: ``version=2`` is the
    speech-like toy-v2 rendering."""
    import dataclasses

    from ..configs.hparams import get_config
    from ..data.toy import random_text, synthesize_utterance, synthesize_utterance_v2
    hp = dataclasses.replace(get_config("ljspeech"), audio=audio)
    rng = np.random.default_rng(seed)
    if version == 2:
        return [synthesize_utterance_v2(random_text(rng), hp, rng) for _ in range(n)]
    return [synthesize_utterance(random_text(rng), hp) for _ in range(n)]


def wav_dir_utterances(wav_dir: str, audio: AudioConfig,
                       limit: Optional[int] = None) -> List[np.ndarray]:
    paths = sorted(glob.glob(os.path.join(wav_dir, "*.wav")))
    if limit:
        paths = paths[:limit]
    if not paths:
        raise FileNotFoundError(f"no .wav files in {wav_dir}")
    ap = AudioProcessor(audio)
    return [ap.load_wav(p) for p in paths]


def make_vocoder_optimizer(cfg: VocoderConfig, model: MelVocoder) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=cfg.learning_rate,
                            betas=(cfg.adam_b1, cfg.adam_b2), eps=ADAM_EPS)


def vocoder_loss(model: MelVocoder, mels: torch.Tensor, wavs: torch.Tensor) -> torch.Tensor:
    scales = tuple(tuple(s) for s in model.cfg.stft_loss_scales)
    return multires_stft_loss(spec_to_wav(model(mels), model.audio), wavs, scales)


def vocoder_train_step(model: MelVocoder, optimizer: torch.optim.Optimizer,
                       mels: torch.Tensor, wavs: torch.Tensor) -> torch.Tensor:
    """One Adam update on the batch; returns the loss (a device scalar)."""
    optimizer.zero_grad(set_to_none=True)
    loss = vocoder_loss(model, mels, wavs)
    loss.backward()
    optimizer.step()
    return loss.detach()


def init_vocoder(cfg: VocoderConfig, audio: AudioConfig, seed: int = 0) -> MelVocoder:
    """A fresh vocoder on the CPU in flax's initializer families, drawn from
    a generator seeded with ``seed``: conv and Dense kernels lecun_normal
    (truncated normal, variance 1 / fan_in) with zero biases, LayerNorm
    scale 1 and bias 0."""
    from .steps import _lecun_normal_
    model = MelVocoder(cfg, audio)
    g = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, torch.nn.Conv1d):
                fan_in = module.weight.shape[1] * module.weight.shape[2]
                _lecun_normal_(module.weight, fan_in, g)
                module.bias.zero_()
            elif isinstance(module, torch.nn.Linear):
                _lecun_normal_(module.weight, module.in_features, g)
                module.bias.zero_()
            elif isinstance(module, torch.nn.LayerNorm):
                module.reset_parameters()
    return model


def train_vocoder(cfg: VocoderConfig, audio: AudioConfig, sampler: PairSampler,
                  model_dir: str, log_every: int = 100, save_every: int = 2000,
                  seed: int = 0, device="cuda"):
    """A whole run; returns (model, {"first_loss", "last_loss",
    "losses": {step: loss at each logged step}, "ms_per_step", "start"}).
    Resumes from the newest checkpoint in ``model_dir``. A directory of
    another writer's checkpoints raises before anything is written."""
    from ..models.vaenar import resolve_device
    from ..utils.checkpoint import CheckpointManager, checkpoint_epochs
    checkpoint_epochs(model_dir)
    dev = resolve_device(device)
    model = init_vocoder(cfg, audio, seed).to(dev)
    optimizer = make_vocoder_optimizer(cfg, model)
    mgr = CheckpointManager(model_dir)
    start = mgr.restore(model, optimizer) or 0
    save_vocoder_config(model_dir, cfg, audio)
    if start:
        print(f"vocoder: resumed from step {start}")
    losses = {}
    loss = torch.tensor(float("nan"))
    t0 = time.time()
    for it in range(start, cfg.steps):
        mels, wavs = sampler.sample(cfg.batch_size)
        loss = vocoder_train_step(model, optimizer, torch.from_numpy(mels).to(dev),
                                  torch.from_numpy(wavs).to(dev))
        if (it + 1) % log_every == 0 or it == start:
            losses[it + 1] = float(loss)
            print(f"vocoder step {it + 1}/{cfg.steps}: loss {losses[it + 1]:.4f} "
                  f"({(time.time() - t0) / max(it - start + 1, 1) * 1e3:.1f} ms/step)",
                  flush=True)
        if (it + 1) % save_every == 0:
            mgr.save(it + 1, model, optimizer)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ms = (time.time() - t0) / max(cfg.steps - start, 1) * 1e3
    mgr.save(cfg.steps, model, optimizer)
    logged = list(losses.values())
    return model, {"start": start, "losses": losses, "ms_per_step": ms,
                   "first_loss": logged[0] if logged else float("nan"),
                   "last_loss": float(loss)}
