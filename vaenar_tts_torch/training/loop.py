"""The training loop (counterpart of ``vaenar_tts_tpu/training/loop.py``):

* resume from the latest checkpoint in ``model_dir``, or cold start: fresh
  parameters, the data-dependent flow init on the first batch at the
  maximum reduction factor, the epoch-0 checkpoint, and one priming step at
  the maximum reduction factor;
* epochs with the KL-weight and reduction-factor schedules, each on its own
  seeded generator (so a resumed run draws what an uninterrupted one would);
  ``steps_per_epoch`` cuts an epoch short. Batches are assembled and copied
  to the device one ahead of the step, in a prefetch thread
  (``utils/prefetch.py``), on the same default stream as the compute;
* the device data cache (``train.device_data_cache_mb`` > 0): when every
  train batch has one shape and the train and dev splits together fit in
  the cap (the JAX package counts the train split alone), both are copied to
  the device once, and each step takes its batch by index. With
  ``train.device_cache_epoch_scan`` as well, each epoch's train steps run
  through ``steps.make_epoch_runner`` (the JAX package's one ``lax.scan``
  dispatch an epoch): on the card a CUDA graph of one step, captured per
  reduction factor and replayed once a step (Adam is capturable on the card
  whatever the flag, so both paths run one arithmetic), with ``train.remat``
  as the eager step runs it (the captured backward recomputes the
  checkpointed blocks); on the CPU the same eager steps. The init pass, the
  priming step, dev, the test artifacts, probes and checkpoints stay eager,
  as in the JAX package;
* the dev loss after each epoch, weighted by real utterances;
* a checkpoint every ``checkpoint_every_n_epochs`` and after the last epoch;
* an optional product-metric probe (``training/probe.py``) every
  ``probe_every`` epochs from ``probe_start`` on, run after that epoch's
  checkpoint (a probed epoch is always checkpointed, so that it can be
  selected); a probe that asks for ``stop_training`` ends the run after its
  epoch, and a probe that raises is printed and does not end the run;
* every ``test_interval`` epochs, one batch of the ``test`` split is
  synthesized at its mel lengths (``steps.test_step``, temperature 0): its
  mel L1, L2 and MCD against the records go to the dev metrics, its wavs
  (``TestUtils.synthesize_and_save_wavs_auto``: the neural vocoder of
  ``neural_vocoder_dir`` if given, else Griffin-Lim on the model's device)
  and, with ``draw_plots``, its mel and decoder-alignment plots to
  ``test_dir``;
* SIGTERM: a step in flight finishes, the rest of the epoch is discarded,
  the last completed epoch is checkpointed if it was not (from a copy of
  the state taken when that epoch ended), and the run returns normally; a
  signal after an epoch's last step stops the run at that epoch's end. The
  previous handler is put back on the way out.

Metrics go to stdout and, as the JAX package writes them
(``utils/logging.MetricsWriter``), one JSON line an epoch to
``log_dir/train/metrics.jsonl`` and ``log_dir/dev/metrics.jsonl`` (the
probe's and the test artifacts' scalars go to dev). A model directory that
holds another writer's numbered checkpoints is refused before anything is
written (``utils.checkpoint.checkpoint_epochs``).

Multi-process data parallelism (``dist``, a ``parallel.distributed.
DistContext`` of several processes), as the JAX package's ``dist`` path:

* each process's train loader owns a disjoint set of train shards
  (``partition_shards``) with the local batch train_batch_size / processes
  and the seed random_seed + process index; the dev loader takes a round
  robin of the dev batches; the test loader is the same everywhere; the
  startup checks (batch sizes that divide, a dev batch for every process)
  raise on every process alike;
* every process runs the same number of steps an epoch, the least of the
  local counts (``lockstep cap:``), and pads step i to the element-wise
  max of the processes' natural shapes, agreed once an epoch (``lockstep
  bucket schedule``); the dev steps follow one such schedule, a process
  whose slice ran dry re-feeding its last batch, re-padded, with no real
  rows;
* the model is broadcast from process 0 after the init or restore; the
  data-dependent init runs on the first global batch; each step computes
  what one process computes on the global batch (``training/steps.py``),
  so every process logs the same losses;
* process 0 writes the checkpoints and ``hparams.json`` (the others wait),
  the metrics of process i > 0 go to ``train_p{i}`` and ``dev_p{i}``, and
  the test-interval batch is synthesized by every process on its rows,
  gathered, and written by process 0;
* SIGTERM stops the whole fleet at the end of the epoch in which any
  process was signalled (a process cannot leave mid-epoch while the others
  wait in a collective); the epoch is checkpointed if it was not;
* each process writes ``log_dir/process_<i>.json``: its device, backend,
  batch packer, kernel launch counts and the checkpoints it wrote.

Left out under ``dist``, as in the JAX package: the device data cache (so
``device_cache_epoch_scan`` does nothing) and the probes (each prints that
it is off).
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import signal
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..audio.export import TestUtils, require_matplotlib
from ..configs.hparams import HParams
from ..configs.serialize import save_hparams
from ..data.loader import Batch, BucketedLoader, repad_batch
from ..data.records import list_shards
from ..models.vaenar import resolve_device
from ..ops.flash_attention import launch_counts
from ..parallel.data_group import data_group
from ..utils.checkpoint import CheckpointManager, checkpoint_epochs
from ..utils.logging import MetricsWriter
from ..utils.metrics import batch_summary
from ..utils.prefetch import prefetch
from .steps import (dev_step, init_model, make_epoch_runner, make_optimizer, metric_floats,
                    run_data_dependent_init, test_step, train_step)


def make_loaders(hp: HParams, data_dir: str, dist=None):
    """(train, dev, test): bucketed loaders over the ``train-*``, ``dev-*``
    and ``test-*`` shards; train shuffles its batch order per epoch and
    drops a short last batch, dev and test keep both, and test batches hold
    ``test_batch_size`` utterances. A split without shards has no batches.
    With ``dist`` of several processes, this process's loaders (see the
    module's docstring); the checks raise on every process alike."""
    mel_b, text_b = hp.dataset.mel_bucket, hp.dataset.text_bucket
    if dist is not None and dist.process_count > 1:
        from ..parallel.distributed import partition_shards
        pc, index = dist.process_count, dist.process_index
        local_bs = hp.train.train_batch_size // pc
        if local_bs * pc != hp.train.train_batch_size:
            raise ValueError(f"train_batch_size {hp.train.train_batch_size} must divide by "
                             f"process_count {pc}")
        train = BucketedLoader(partition_shards(list_shards(data_dir, "train"), index, pc),
                               local_bs, mel_bucket=mel_b, text_bucket=text_b,
                               shuffle=hp.train.shuffle, seed=hp.train.random_seed + index,
                               drop_last=True)
        dev = BucketedLoader(list_shards(data_dir, "dev"), local_bs, mel_bucket=mel_b,
                             text_bucket=text_b, shuffle=False, seed=hp.train.random_seed,
                             shard_index=index, shard_count=pc)
        n_dev_groups = -(-dev.num_utterances // local_bs)
        if n_dev_groups < pc:
            raise ValueError(f"dev set too small for this fleet: {n_dev_groups} dev batch(es) "
                             f"of {local_bs} < {pc} processes; shrink the process count or "
                             f"grow the dev set")
        if hp.train.test_batch_size % pc:
            raise ValueError(f"test_batch_size {hp.train.test_batch_size} must divide by "
                             f"process_count {pc}")
        test = BucketedLoader(list_shards(data_dir, "test"), hp.train.test_batch_size,
                              mel_bucket=mel_b, text_bucket=text_b, shuffle=False,
                              seed=hp.train.random_seed)
        return train, dev, test
    train = BucketedLoader(list_shards(data_dir, "train"), hp.train.train_batch_size,
                           mel_bucket=mel_b, text_bucket=text_b,
                           shuffle=hp.train.shuffle, seed=hp.train.random_seed,
                           drop_last=True)
    dev = BucketedLoader(list_shards(data_dir, "dev"), hp.train.train_batch_size,
                         mel_bucket=mel_b, text_bucket=text_b, shuffle=False,
                         seed=hp.train.random_seed)
    test = BucketedLoader(list_shards(data_dir, "test"), hp.train.test_batch_size,
                          mel_bucket=mel_b, text_bucket=text_b, shuffle=False,
                          seed=hp.train.random_seed)
    return train, dev, test


def to_device(batch: Batch, device: torch.device):
    """(texts int64, mels, text lengths, mel lengths) on ``device``."""
    return (torch.from_numpy(batch.texts).long().to(device),
            torch.from_numpy(batch.mels).to(device),
            torch.from_numpy(batch.text_lengths).to(device),
            torch.from_numpy(batch.mel_lengths).to(device))


def valid_mask(batch: Batch, device: torch.device) -> torch.Tensor:
    """1 on the batch's real rows, 0 on its repeated ones."""
    return torch.from_numpy((np.arange(batch.texts.shape[0]) < batch.n_valid)
                            .astype(np.float32)).to(device)


def epoch_generator(device: torch.device, seed: int, epoch: int) -> torch.Generator:
    """The generator of dropout and posterior noise for one epoch (epoch 0
    is the cold start's init and priming step)."""
    return torch.Generator(device=device).manual_seed(seed * 10007 + epoch)


def _split_mb(loader: BucketedLoader) -> float:
    """MB (1e6 bytes) that the loader's batches take on the device, as
    ``to_device`` and ``valid_mask`` make them: int64 texts, fp32 mels, two
    int32 lengths and an fp32 mask a row."""
    row = lambda t, m: 8 * t + 4 * m * loader.num_mels + 12  # noqa: E731
    return sum(n * loader.batch_size * row(t, m)
               for (t, m), n in loader.shape_census().items()) / 1e6


def device_cache(hp: HParams, train_loader: BucketedLoader, dev_loader: BucketedLoader,
                 device: torch.device):
    """(train cache, dev cache), or (None, None) with the reason printed.
    The train cache is the train batches stacked in their base order, a
    tuple of [n_batches, ...] tensors on ``device``; the dev cache is a list
    of (texts, mels, text lengths, mel lengths, valid mask, n_valid), one a
    dev batch. Both splits count against ``device_data_cache_mb``. The ON
    line ends with how the train steps will run over the cache."""
    cap = hp.train.device_data_cache_mb
    if not cap or cap <= 0 or len(train_loader) == 0:
        return None, None
    census = train_loader.shape_census()
    if len(census) != 1:
        print(f"device data cache OFF: {len(census)} static train batch shapes "
              f"(the cache needs exactly 1)")
        return None, None
    train_mb, dev_mb = _split_mb(train_loader), _split_mb(dev_loader)
    if train_mb + dev_mb > cap:
        print(f"device data cache OFF: train {train_mb:.3f} MB + dev {dev_mb:.3f} MB "
              f"(the dev split counted) > device_data_cache_mb={cap}")
        return None, None
    batches = train_loader.all_batches()
    train_cache = tuple(torch.stack(parts) for parts in
                        zip(*(to_device(b, device) for b in batches)))
    dev_cache = [(*to_device(b, device), valid_mask(b, device), b.n_valid)
                 for b in dev_loader.all_batches()]
    if not hp.train.device_cache_epoch_scan:
        mode = "per-step dispatch over device gathers"
    elif device.type == "cuda":
        mode = "one CUDA graph of a train step per reduction factor, replayed once a step"
    else:
        mode = "the epoch runner's eager steps (no CUDA graph off the card)"
    print(f"device data cache ON: {len(batches)} train batches ({train_mb:.3f} MB) + "
          f"{len(dev_cache)} dev batches ({dev_mb:.3f} MB), both counted against "
          f"device_data_cache_mb={cap}, on {device}; {mode}")
    return train_cache, dev_cache


def _snapshot(model: torch.nn.Module, optimizer: torch.optim.Optimizer):
    """Copies of the model's and the optimizer's state, on their device."""
    return ({k: v.detach().clone() for k, v in model.state_dict().items()},
            copy.deepcopy(optimizer.state_dict()))


def _lockstep_line(sched: np.ndarray) -> str:
    """The JAX loop's line on a lockstep schedule [n_steps, 2], word for word."""
    shapes = sorted({(int(t), int(m)) for t, m in sched})
    mel_frac = float(np.sum(sched[:, 1])) / (len(sched) * float(np.max(sched[:, 1])))
    return (f"lockstep bucket schedule (epoch 0): {len(shapes)} distinct shapes {shapes}; "
            f"scheduled mel frames = {100 * mel_frac:.1f}% of pad-to-global-max (the "
            f"round-2 behavior)")


def train(hp: HParams, data_dir: str, model_dir: str, log_dir: str,
          test_dir: Optional[str] = None, max_epochs: Optional[int] = None,
          steps_per_epoch: Optional[int] = None, log_every: int = 50,
          device="cuda", neural_vocoder_dir: Optional[str] = None,
          draw_plots: bool = True, probe: Optional[Callable] = None,
          probe_every: int = 0, probe_start: int = 0, dist=None) -> Dict[str, object]:
    """Run or resume training. ``max_epochs`` is inclusive ("run through
    epoch N"); without it the run ends before ``hp.train.epochs``.
    ``test_dir`` defaults to ``log_dir/test``. ``probe(epoch, model) -> dict
    or None`` runs after the checkpoint of every ``probe_every``-th epoch
    from ``probe_start`` on. ``dist``: a ``DistContext`` for multi-process
    training (its device replaces ``device``); one of a single process is
    the single-process run. Returns {"epoch": the last completed epoch,
    "initial": the priming step's metrics or None, "train", "dev", "probe",
    "test": {epoch: metrics}, "stopped": None, "sigterm" or "probe",
    "cache": whether the device data cache was on, "packer": the train
    loader's batch packer, "runner": the epoch runner's ``report()`` or
    None}."""
    checkpoint_epochs(model_dir)  # a foreign directory raises before any write
    if dist is not None and dist.process_count == 1:
        dist = None
    is_main = dist is None or dist.is_main
    dev = resolve_device(dist.device if dist is not None else device)
    train_loader, dev_loader, test_loader = make_loaders(hp, data_dir, dist)
    test_dir = test_dir or os.path.join(log_dir, "test")
    tester = (TestUtils(hp, test_dir, dev, neural_vocoder_dir=neural_vocoder_dir)
              if is_main else None)
    print(f"train batches/epoch: {len(train_loader)}, dev: {len(dev_loader)}, "
          f"test: {len(test_loader)}")
    print(f"shape census (text_max, mel_max) -> count: {train_loader.shape_census()}")
    print(f"batch packer: {train_loader.packer}")

    # lockstep: every process runs the same steps, step i at one shape
    steps_cap = dev_steps = None
    sched0 = dev_sched = None
    if dist is not None:
        steps_cap = dist.sync_min(len(train_loader))
        if steps_cap != len(train_loader):
            print(f"lockstep cap: {steps_cap} steps/epoch (local loader has "
                  f"{len(train_loader)})")
        n_dev_groups = -(-dev_loader.num_utterances // dev_loader.batch_size)
        dev_steps = -(-n_dev_groups // dist.process_count)
        # dev is not shuffled: one schedule serves every epoch
        dev_sched = dist.sync_elementwise_max(
            dev_loader.epoch_shape_schedule(0, n_steps=dev_steps))

    def train_schedule(epoch: int):
        """The epoch's lockstep bucket schedule (one collective), or None."""
        if dist is None:
            return None
        return dist.sync_elementwise_max(
            train_loader.epoch_shape_schedule(epoch, n_steps=steps_cap))

    if dist is not None:
        sched0 = train_schedule(0)
        print(_lockstep_line(sched0))
        if hp.train.device_data_cache_mb and hp.train.device_data_cache_mb > 0:
            print("device data cache OFF: multi-process training")
        if probe is not None:
            print("probe OFF: multi-process training")
        train_cache = dev_cache = None
    else:
        train_cache, dev_cache = device_cache(hp, train_loader, dev_loader, dev)

    seed = hp.train.random_seed
    model = init_model(hp, seed, dev)
    optimizer = make_optimizer(hp, model)
    ckpt = CheckpointManager(model_dir, hp.train.checkpoint_max_to_keep,
                             hp.train.checkpoint_keep_every_n_hours, dist=dist)
    start = ckpt.restore(model, optimizer)
    # written after the restore attempt, so that a resume that fails on a
    # mismatched architecture leaves the trained one's hparams.json alone
    if is_main:
        save_hparams(hp, model_dir)
    if dist is not None:
        dist.replicate(model)
    total_epochs = max_epochs + 1 if max_epochs is not None else hp.train.epochs
    if is_main and draw_plots and len(test_loader) and any(
            e % hp.train.test_interval == 0 for e in range((start or 0) + 1, total_epochs)):
        require_matplotlib()  # at once, not at the first test interval
    history: Dict[str, object] = {"initial": None, "train": {}, "dev": {}, "probe": {},
                                  "test": {}, "stopped": None,
                                  "cache": train_cache is not None,
                                  "packer": train_loader.packer, "runner": None}
    if start is not None:
        print(f"Restored from epoch {start}")
    else:
        print("Initializing from scratch (data-dependent flow init).")
        start = 0
        gen = epoch_generator(dev, seed, 0)
        texts, mels, t_lens, m_lens = to_device(
            next(iter(train_loader.epoch(0, shape_schedule=sched0))), dev)
        run_data_dependent_init(model, texts, t_lens, m_lens, max_mel_length=mels.shape[1],
                                generator=gen, dist=dist)
        ckpt.save(0, model, optimizer)
        initial = metric_floats(train_step(
            model, optimizer, hp, texts, mels, t_lens, m_lens,
            hp.train.kl_weight_init, hp.common.max_reduction_factor, gen, dist=dist))
        print("Initial step:", initial)
        history["initial"] = initial

    runner = (make_epoch_runner(model, optimizer, hp, train_cache)
              if train_cache is not None and hp.train.device_cache_epoch_scan else None)
    stop = {"sigterm": False}

    def on_sigterm(_sig, _frame):
        stop["sigterm"] = True
        print("SIGTERM received: will checkpoint and stop at the next step", flush=True)

    try:
        prev_handler = signal.signal(signal.SIGTERM, on_sigterm)
    except ValueError:  # not the main thread
        prev_handler = None
    suffix = "" if is_main else f"_p{dist.process_index}"
    metrics_train = MetricsWriter(os.path.join(log_dir, "train" + suffix))
    metrics_dev = MetricsWriter(os.path.join(log_dir, "dev" + suffix))
    try:
        # the last completed epoch's state when it is not on disk: a SIGTERM in
        # the next epoch saves it, without that epoch's partial steps
        last_saved, snapshot = start, None
        history["epoch"] = start
        for epoch in range(start + 1, total_epochs):
            gen = epoch_generator(dev, seed, epoch)
            kl_weight = hp.train.kl_weight_at(epoch)
            r = hp.train.reduction_factor_at(epoch)
            print(f"Epoch {epoch}: kl_weight={kl_weight}, reduction_factor={r}")
            epoch_start = time.time()
            sums: Dict[str, torch.Tensor] = {}
            n_steps = 0
            interrupted = False
            if runner is not None:
                if stop["sigterm"]:  # before the epoch: none of it runs
                    interrupted = True
                else:
                    order = train_loader.batch_order(epoch)[:steps_per_epoch or None]
                    sums, n_steps = runner(order, kl_weight, r, gen)
            else:
                if train_cache is not None:
                    order = train_loader.batch_order(epoch)[:steps_per_epoch or None]
                    batch_iter = (tuple(x[i] for x in train_cache) for i in order)
                else:
                    # in the main thread: under dist it is a collective
                    schedule = train_schedule(epoch)

                    def device_batches():
                        for i, b in enumerate(train_loader.epoch(epoch, shape_schedule=schedule)):
                            if steps_per_epoch and i >= steps_per_epoch:
                                return  # the prefetch worker drains and exits
                            yield to_device(b, dev)
                    batch_iter = prefetch(device_batches())
                with contextlib.closing(batch_iter):
                    for batch in batch_iter:
                        if stop["sigterm"] and dist is None:
                            interrupted = True
                            break
                        step_start = time.time()
                        m = train_step(model, optimizer, hp, *batch, kl_weight, r, gen,
                                       dist=dist)
                        n_steps += 1
                        if n_steps % log_every == 0 or n_steps == 1:
                            print(f"  step {n_steps}: " + ", ".join(
                                f"{k} {v:.6f}" for k, v in metric_floats(m).items())
                                + f", time {time.time() - step_start:.3f}s", flush=True)
                        sums = {k: sums[k] + v if k in sums else v for k, v in m.items()}
            if interrupted:
                if last_saved != epoch - 1:
                    ckpt.save_state(epoch - 1, *snapshot)
                print(f"preemption: stopped during epoch {epoch}; checkpoint at completed "
                      f"epoch {epoch - 1}", flush=True)
                history["stopped"] = "sigterm"
                break
            train_avg = {k: float(v) / max(n_steps, 1) for k, v in sums.items()}
            print(f"Epoch {epoch} train done in {time.time() - epoch_start:.1f}s: {train_avg}")
            metrics_train.scalars(epoch, train_avg)

            if dist is None:
                dev_avg = evaluate(model, hp, dev_loader, dev_cache, epoch, kl_weight, r, gen,
                                   dev)
            else:
                dev_avg = evaluate_lockstep(model, hp, dev_loader, dev_sched, dev_steps, epoch,
                                            kl_weight, r, gen, dist)
            print(f"Epoch {epoch} dev: {dev_avg}")
            history["train"][epoch], history["dev"][epoch] = train_avg, dev_avg
            history["epoch"] = epoch
            metrics_dev.scalars(epoch, dev_avg)

            if epoch % hp.train.checkpoint_every_n_epochs == 0 or epoch == total_epochs - 1:
                ckpt.save(epoch, model, optimizer)
                last_saved = epoch
            probe_stop = False
            if (probe is not None and dist is None and probe_every > 0
                    and epoch >= probe_start and epoch % probe_every == 0):
                if last_saved != epoch:  # a probed epoch is a checkpoint to select from
                    ckpt.save(epoch, model, optimizer)
                    last_saved = epoch
                try:
                    scalars = probe(epoch, model)
                    if scalars:
                        probe_stop = bool(scalars.pop("stop_training", False))
                        print(f"Epoch {epoch} probe: " + ", ".join(
                            f"{k} {v:.4f}" for k, v in scalars.items()))
                        history["probe"][epoch] = scalars
                        metrics_dev.scalars(epoch, scalars)
                except Exception as e:  # a probe never ends the run
                    print(f"probe failed at epoch {epoch}: {e!r}")
            if probe_stop:
                print(f"stopping after epoch {epoch}: probe requested early stop")
                history["stopped"] = "probe"
                break
            if epoch % hp.train.test_interval == 0 and len(test_loader):
                history["test"][epoch] = run_test_artifacts(
                    hp, model, test_loader, tester, epoch, r, gen, metrics_dev, draw_plots,
                    dist=dist)
            if dist is not None:
                # the fleet stops together: at this boundary if any process was
                # signalled during the epoch
                stop["sigterm"] = bool(dist.allsum([1.0 if stop["sigterm"] else 0.0])[0] > 0)
            if stop["sigterm"]:
                if last_saved != epoch:
                    ckpt.save(epoch, model, optimizer)
                print(f"stopping after epoch {epoch} (preemption); checkpoint at epoch {epoch}",
                      flush=True)
                history["stopped"] = "sigterm"
                break
            snapshot = (_snapshot(model, optimizer)
                        if dist is None and last_saved != epoch else None)
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
        metrics_train.close()
        metrics_dev.close()
    if runner is not None:
        history["runner"] = runner.report()
    if dist is not None:
        report = {"process_index": dist.process_index, "process_count": dist.process_count,
                  "backend": dist.backend, "device": str(dev), "packer": train_loader.packer,
                  "launch_counts": dict(launch_counts), "checkpoints_written": ckpt.written,
                  "epoch": history["epoch"], "stopped": history["stopped"]}
        with open(os.path.join(log_dir, f"process_{dist.process_index}.json"), "w") as f:
            json.dump(report, f)
    return history


def evaluate(model, hp: HParams, dev_loader: BucketedLoader, dev_cache, epoch: int,
             kl_weight: float, r: int, gen: torch.Generator, dev: torch.device
             ) -> Dict[str, float]:
    """The dev losses of one process's epoch: the dev steps' means weighted
    by their real rows."""
    dev_sums: Dict[str, float] = {}
    n_dev = 0
    dev_batches = dev_cache if dev_cache is not None else (
        (*to_device(b, dev), valid_mask(b, dev), b.n_valid) for b in dev_loader.epoch(epoch))
    for texts, mels, t_lens, m_lens, vmask, n_valid in dev_batches:
        m = dev_step(model, hp, texts, mels, t_lens, m_lens, kl_weight, vmask, r, gen)
        for k, v in metric_floats(m).items():
            dev_sums[k] = dev_sums.get(k, 0.0) + v * n_valid
        n_dev += n_valid
    return {k: v / max(n_dev, 1) for k, v in dev_sums.items()}


def evaluate_lockstep(model, hp: HParams, dev_loader: BucketedLoader, dev_sched: np.ndarray,
                      dev_steps: int, epoch: int, kl_weight: float, r: int,
                      gen: torch.Generator, dist) -> Dict[str, float]:
    """The dev losses of a fleet's epoch: every process steps ``dev_steps``
    times at the schedule's shapes (a process whose slice ran dry re-feeds
    its last batch, re-padded, with no real rows), and the sums over the
    real rows are added over the processes."""
    dev = dist.device
    it = iter(dev_loader.epoch(epoch, shape_schedule=dev_sched))
    batch, keys, total = None, None, None
    for s in range(dev_steps):
        n_valid = 0
        try:
            batch = next(it)
            n_valid = batch.n_valid
        except StopIteration:
            # make_loaders gives every process a dev batch, so batch is set
            batch = repad_batch(batch, int(dev_sched[s][0]), int(dev_sched[s][1]))
        vmask = torch.from_numpy((np.arange(batch.texts.shape[0]) < n_valid)
                                 .astype(np.float32)).to(dev)
        m = metric_floats(dev_step(model, hp, *to_device(batch, dev), kl_weight, vmask, r, gen,
                                   dist=dist))
        keys = keys or sorted(m)
        step = dist.allsum([m[k] for k in keys])
        total = step if total is None else total + step
    sums = dict(zip(keys, total))
    n = sums.pop("n_valid")
    return {k: float(v / max(n, 1.0)) for k, v in sums.items()}


def run_test_artifacts(hp: HParams, model, test_loader: BucketedLoader,
                       tester: Optional[TestUtils], epoch: int, r: int,
                       generator: torch.Generator,
                       metrics_writer: Optional[MetricsWriter] = None,
                       draw_plots: bool = True, dist=None) -> Optional[Dict[str, float]]:
    """Synthesize the test split's first batch at its mel lengths
    (``_run_test_artifacts``): its quality against the records (mel L1, L2
    and MCD over each utterance's valid frames) printed, written as
    ``test_mel_l1``, ``test_mel_l2`` and ``test_mcd_db`` and returned; its
    wavs through ``synthesize_and_save_wavs_auto`` (a vocoder failure is
    printed and does not end the run, as in the reference); and with
    ``draw_plots`` its mel plots and the decoder's alignment plots. With
    ``dist`` every process synthesizes its rows of the same batch, the
    results are gathered, and process 0 alone scores and writes them (the
    others return None)."""
    device = next(model.parameters()).device
    batch = next(iter(test_loader.epoch(epoch)))
    texts, _, t_lens, m_lens = to_device(batch, device)
    group = None
    if dist is not None:
        k = texts.shape[0] // dist.process_count
        rows = slice(dist.process_index * k, (dist.process_index + 1) * k)
        texts, t_lens, m_lens, group = texts[rows], t_lens[rows], m_lens[rows], dist.rows(k)
    with data_group(group):
        mels, alignments = test_step(model, texts, t_lens, m_lens, r, batch.mels.shape[1],
                                     generator=generator)
    if dist is not None:
        mels = dist.fetch(mels)
        alignments = {name: dist.fetch(a) for name, a in alignments.items()}
        if not dist.is_main:
            return None
    mels = mels.cpu().numpy()
    lens = batch.mel_lengths
    quality = batch_summary([(mels[i][: int(lens[i])], batch.mels[i][: int(lens[i])])
                             for i in range(batch.n_valid)])
    print(f"test quality @ epoch {epoch}: mel_l1 {quality['mel_l1']:.4f}, "
          f"mcd {quality['mcd_db']:.2f} dB over {quality['n']} utts")
    scalars = {"test_mel_l1": quality["mel_l1"], "test_mel_l2": quality["mel_l2"],
               "test_mcd_db": quality["mcd_db"]}
    if metrics_writer is not None:
        metrics_writer.scalars(epoch, scalars)
    try:
        tester.synthesize_and_save_wavs_auto(epoch, mels, lens, batch.fids, "test")
    except Exception as e:  # the reference swallows vocoder failures too
        print(f"Something wrong with the generated waveform: {e!r}")
    if draw_plots:
        tester.draw_melspectrograms(epoch, mels, lens, batch.fids, "test")
        for k, a in alignments.items():
            tester.multi_draw_attention_alignments(
                a.cpu().numpy(), batch.text_lengths, lens, epoch, batch.fids,
                prefix=f"test-{k}", reduction_factor=r)
    return scalars
