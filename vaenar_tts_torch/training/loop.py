"""The training loop (counterpart of ``vaenar_tts_tpu/training/loop.py``,
single process):

* resume from the latest checkpoint in ``model_dir``, or cold start: fresh
  parameters, the data-dependent flow init on the first batch at the
  maximum reduction factor, the epoch-0 checkpoint, and one priming step at
  the maximum reduction factor;
* epochs with the KL-weight and reduction-factor schedules, each on its own
  seeded generator (so a resumed run draws what an uninterrupted one would);
  ``steps_per_epoch`` cuts an epoch short;
* the dev loss after each epoch, weighted by real utterances;
* a checkpoint every ``checkpoint_every_n_epochs`` and after the last epoch;
* an optional product-metric probe (``training/probe.py``) every
  ``probe_every`` epochs from ``probe_start`` on, run after that epoch's
  checkpoint (a probed epoch is always checkpointed, so that it can be
  selected); a probe that asks for ``stop_training`` ends the run after its
  epoch, and a probe that raises is printed and does not end the run.

Metrics go to stdout and, one JSON line per epoch and split (``train``,
``dev``, ``probe``), to ``log_dir/metrics.jsonl``. A model directory that
holds another writer's numbered checkpoints is refused before anything is
written (``utils.checkpoint.checkpoint_epochs``). Left out of the port so
far: the device data cache, test-interval wavs and plots, SIGTERM handling,
logging to tensorboard, prefetching and multi-process training.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..configs.hparams import HParams
from ..configs.serialize import save_hparams
from ..data.loader import Batch, BucketedLoader
from ..data.records import list_shards
from ..models.vaenar import resolve_device
from ..utils.checkpoint import CheckpointManager, checkpoint_epochs
from .steps import (dev_step, init_model, make_optimizer, metric_floats,
                    run_data_dependent_init, train_step)


def make_loaders(hp: HParams, data_dir: str):
    """(train, dev): bucketed loaders over the ``train-*`` and ``dev-*``
    shards; train shuffles its batch order per epoch and drops a short last
    batch, dev keeps both."""
    mel_b, text_b = hp.dataset.mel_bucket, hp.dataset.text_bucket
    train = BucketedLoader(list_shards(data_dir, "train"), hp.train.train_batch_size,
                           mel_bucket=mel_b, text_bucket=text_b,
                           shuffle=hp.train.shuffle, seed=hp.train.random_seed,
                           drop_last=True)
    dev = BucketedLoader(list_shards(data_dir, "dev"), hp.train.train_batch_size,
                         mel_bucket=mel_b, text_bucket=text_b, shuffle=False,
                         seed=hp.train.random_seed)
    return train, dev


def to_device(batch: Batch, device: torch.device):
    """(texts int64, mels, text lengths, mel lengths) on ``device``."""
    return (torch.from_numpy(batch.texts).long().to(device),
            torch.from_numpy(batch.mels).to(device),
            torch.from_numpy(batch.text_lengths).to(device),
            torch.from_numpy(batch.mel_lengths).to(device))


def epoch_generator(device: torch.device, seed: int, epoch: int) -> torch.Generator:
    """The generator of dropout and posterior noise for one epoch (epoch 0
    is the cold start's init and priming step)."""
    return torch.Generator(device=device).manual_seed(seed * 10007 + epoch)


def _log(log_dir: str, record: dict) -> None:
    with open(os.path.join(log_dir, "metrics.jsonl"), "a") as f:
        f.write(json.dumps(record) + "\n")


def train(hp: HParams, data_dir: str, model_dir: str, log_dir: str,
          max_epochs: Optional[int] = None,
          steps_per_epoch: Optional[int] = None, log_every: int = 50,
          device="cuda", probe: Optional[Callable] = None, probe_every: int = 0,
          probe_start: int = 0) -> Dict[str, object]:
    """Run or resume training. ``max_epochs`` is inclusive ("run through
    epoch N"); without it the run ends before ``hp.train.epochs``.
    ``probe(epoch, model) -> dict or None`` runs after the checkpoint of
    every ``probe_every``-th epoch from ``probe_start`` on. Returns
    {"epoch": last epoch, "initial": the priming step's metrics or None,
    "train", "dev", "probe": {epoch: metrics}}."""
    checkpoint_epochs(model_dir)  # a foreign directory raises before any write
    dev = resolve_device(device)
    os.makedirs(log_dir, exist_ok=True)
    train_loader, dev_loader = make_loaders(hp, data_dir)
    print(f"train batches/epoch: {len(train_loader)}, dev: {len(dev_loader)}")
    print(f"shape census (text_max, mel_max) -> count: {train_loader.shape_census()}")

    seed = hp.train.random_seed
    model = init_model(hp, seed, dev)
    optimizer = make_optimizer(hp, model)
    ckpt = CheckpointManager(model_dir, hp.train.checkpoint_max_to_keep,
                             hp.train.checkpoint_keep_every_n_hours)
    start = ckpt.restore(model, optimizer)
    # written after the restore attempt, so that a resume that fails on a
    # mismatched architecture leaves the trained one's hparams.json alone
    save_hparams(hp, model_dir)
    history: Dict[str, object] = {"initial": None, "train": {}, "dev": {}, "probe": {}}
    if start is not None:
        print(f"Restored from epoch {start}")
    else:
        print("Initializing from scratch (data-dependent flow init).")
        start = 0
        gen = epoch_generator(dev, seed, 0)
        texts, mels, t_lens, m_lens = to_device(next(iter(train_loader.epoch(0))), dev)
        run_data_dependent_init(model, texts, t_lens, m_lens,
                                max_mel_length=mels.shape[1], generator=gen)
        ckpt.save(0, model, optimizer)
        initial = metric_floats(train_step(
            model, optimizer, hp, texts, mels, t_lens, m_lens,
            hp.train.kl_weight_init, hp.common.max_reduction_factor, gen))
        print("Initial step:", initial)
        history["initial"] = initial

    total_epochs = max_epochs + 1 if max_epochs is not None else hp.train.epochs
    epoch = start
    for epoch in range(start + 1, total_epochs):
        gen = epoch_generator(dev, seed, epoch)
        kl_weight = hp.train.kl_weight_at(epoch)
        r = hp.train.reduction_factor_at(epoch)
        print(f"Epoch {epoch}: kl_weight={kl_weight}, reduction_factor={r}")
        epoch_start = time.time()
        sums: Dict[str, torch.Tensor] = {}
        n_steps = 0
        for batch in train_loader.epoch(epoch):
            if steps_per_epoch and n_steps >= steps_per_epoch:
                break
            step_start = time.time()
            m = train_step(model, optimizer, hp, *to_device(batch, dev),
                           kl_weight, r, gen)
            n_steps += 1
            if n_steps % log_every == 0 or n_steps == 1:
                print(f"  step {n_steps}: " + ", ".join(
                    f"{k} {v:.6f}" for k, v in metric_floats(m).items())
                    + f", time {time.time() - step_start:.3f}s")
            sums = {k: sums[k] + v if k in sums else v for k, v in m.items()}
        train_avg = {k: float(v) / max(n_steps, 1) for k, v in sums.items()}
        print(f"Epoch {epoch} train done in {time.time() - epoch_start:.1f}s: {train_avg}")

        dev_sums: Dict[str, float] = {}
        n_dev = 0
        for batch in dev_loader.epoch(epoch):
            vmask = torch.from_numpy(
                (np.arange(batch.texts.shape[0]) < batch.n_valid).astype(np.float32)).to(dev)
            m = dev_step(model, hp, *to_device(batch, dev), kl_weight, vmask, r, gen)
            for k, v in metric_floats(m).items():
                dev_sums[k] = dev_sums.get(k, 0.0) + v * batch.n_valid
            n_dev += batch.n_valid
        dev_avg = {k: v / max(n_dev, 1) for k, v in dev_sums.items()}
        print(f"Epoch {epoch} dev: {dev_avg}")
        history["train"][epoch], history["dev"][epoch] = train_avg, dev_avg
        _log(log_dir, {"epoch": epoch, "split": "train", **train_avg})
        _log(log_dir, {"epoch": epoch, "split": "dev", **dev_avg})

        saved = epoch % hp.train.checkpoint_every_n_epochs == 0 or epoch == total_epochs - 1
        if saved:
            ckpt.save(epoch, model, optimizer)
        if (probe is not None and probe_every > 0 and epoch >= probe_start
                and epoch % probe_every == 0):
            if not saved:  # a probed epoch is a checkpoint to select from
                ckpt.save(epoch, model, optimizer)
            stop = False
            try:
                scalars = probe(epoch, model)
                if scalars:
                    stop = bool(scalars.pop("stop_training", False))
                    print(f"Epoch {epoch} probe: " + ", ".join(
                        f"{k} {v:.4f}" for k, v in scalars.items()))
                    history["probe"][epoch] = scalars
                    _log(log_dir, {"epoch": epoch, "split": "probe", **scalars})
            except Exception as e:  # a probe never ends the run
                print(f"probe failed at epoch {epoch}: {e!r}")
            if stop:
                print(f"stopping after epoch {epoch}: probe requested early stop")
                break
    history["epoch"] = epoch
    return history
