"""Training CLI (counterpart of ``vaenar_tts_tpu/cli/train.py``):

    python -m vaenar_tts_torch.cli.train --dataset ljspeech|databaker \\
        --data_dir RECORDS --model_dir CKPT --log_dir LOGS [--test_dir OUT] \\
        [--hparams artifacts/toyv2_q90/ckpt/hparams.json] \\
        [--max_epochs N] [--steps_per_epoch N] [--compute_dtype float32|bfloat16] \\
        [--override key.path=value] \\
        [--probe toy_ler|dev_mcd --probe_every N [--stop_probe X]] \\
        [--neural_vocoder VOCODER_DIR] [--no-draw_plots] [--distributed]

``--distributed`` joins the process group that the environment describes
(``VAENAR_COORDINATOR=host:port VAENAR_NUM_PROCESSES=N VAENAR_PROCESS_ID=i``,
or ``torchrun``'s variables) and trains data-parallel, each process on its
own train shards (``training/loop.py``); it prints ``distributed: process
i/N``, the backend (``nccl`` on CUDA, ``gloo`` on the CPU,
``VAENAR_DIST_BACKEND`` to choose) and the process's device. A group of one
process takes the single-process path. Process i > 0 tees its stdout into
``LOGS/train_p{i}.log``.

``RECORDS`` holds ``train-*.vrs`` and ``dev-*.vrs`` shards, and for the
test-interval artifacts ``test-*.vrs`` (``cli.preprocess``). Every
``train.test_interval`` epochs the loop writes one test batch's wavs,
quality metrics and, unless ``--no-draw_plots`` (a machine without
matplotlib needs it), mel and alignment plots to ``OUT`` (default
``LOGS/test``); ``--neural_vocoder`` vocodes them with a vocoder that
``cli.train_vocoder`` trained, in place of Griffin-Lim. Stdout is teed into
``LOGS/train.log``, and the per-epoch metrics go to
``LOGS/train/metrics.jsonl`` and ``LOGS/dev/metrics.jsonl``. SIGTERM
checkpoints the last completed epoch and ends the run with exit code 0.

When ``CKPT`` already holds a checkpoint, its ``hparams.json`` is the config and the run resumes; otherwise the config is
``--hparams`` or the dataset's preset, then ``--compute_dtype``, then the
overrides. A ``CKPT`` that holds another writer's numbered checkpoints (the
JAX package's Orbax ones) is refused before anything is written.

``--probe`` runs a product-metric probe (``training/probe.py``) every
``--probe_every`` epochs, writing its jsonl history and the best probed
weights (``export_best.npz``) to the directory above ``CKPT``: ``toy_ler``
transcribes held-out toy-v2 texts, ``dev_mcd`` scores the first dev
utterances by DTW-aligned MCD. ``--stop_probe X`` ends the run once the
probe's metric is at or under X. Runs on ``cuda`` unless ``--device cpu``.
``utils.export.export_model_dir`` turns the result into the ``export.npz``
that inference (the port's or the JAX package's) loads.
"""

from __future__ import annotations

import argparse
import json
import os
import random

import numpy as np
import torch

from ..configs.hparams import get_config
from ..configs.overrides import apply_overrides
from ..configs.serialize import hparams_from_dict, load_hparams
from ..training.loop import train
from ..utils.checkpoint import checkpoint_epochs
from ..utils.logging import Logger


def set_global_determinism(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators (reference
    train.py:17-32). The loop draws from its own seeded generators; this
    covers whatever draws from the global ones."""
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def main(argv=None):
    parser = argparse.ArgumentParser("Training (PyTorch)")
    parser.add_argument("--dataset", type=str, required=True, choices=["ljspeech", "databaker"])
    parser.add_argument("--data_dir", type=str, required=True,
                        help="record shard directory")
    parser.add_argument("--model_dir", type=str, required=True,
                        help="directory for checkpoints and hparams.json")
    parser.add_argument("--log_dir", type=str, required=True)
    parser.add_argument("--test_dir", type=str, default=None,
                        help="test-interval artifacts (default LOG_DIR/test)")
    parser.add_argument("--neural_vocoder", type=str, default=None,
                        help="directory of a trained ISTFT-head vocoder "
                             "(cli.train_vocoder): the test-interval wavs use it "
                             "instead of Griffin-Lim")
    parser.add_argument("--draw_plots", action=argparse.BooleanOptionalAction, default=True,
                        help="draw the test-interval mel and alignment plots (needs "
                             "matplotlib)")
    parser.add_argument("--hparams", type=str, default=None,
                        help="hparams.json to start a new run from, in place "
                             "of the dataset's preset")
    parser.add_argument("--max_epochs", type=int, default=None,
                        help="run through epoch N inclusive")
    parser.add_argument("--steps_per_epoch", type=int, default=None,
                        help="cut each epoch to N steps")
    parser.add_argument("--log_every", type=int, default=50,
                        help="print a train step's losses every N steps")
    parser.add_argument("--compute_dtype", type=str, default=None,
                        choices=["float32", "bfloat16"],
                        help="the transformer stacks' dtype (train.compute_dtype)")
    parser.add_argument("--override", action="append", default=[],
                        metavar="key.path=value",
                        help="config override, e.g. prior.n_blk=12 (repeatable)")
    parser.add_argument("--probe", type=str, default="none",
                        choices=["none", "dev_mcd", "toy_ler"],
                        help="in-training product-metric probe: 'toy_ler' transcribes "
                             "held-out toy-v2 free text (toy corpus only), 'dev_mcd' "
                             "scores dev utterances by DTW-MCD and decoder diagonality; "
                             "each improving probe also writes export_best.npz")
    parser.add_argument("--probe_every", type=int, default=50,
                        help="probe cadence in epochs (with --probe)")
    parser.add_argument("--stop_probe", type=float, default=0.0,
                        help="stop when the probe's metric (toy_ler: LER; dev_mcd: "
                             "MCD-DTW dB) is at or under this (0: never)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--distributed", action="store_true",
                        help="multi-process data-parallel training in the process group "
                             "the environment describes (VAENAR_COORDINATOR, "
                             "VAENAR_NUM_PROCESSES, VAENAR_PROCESS_ID, or torchrun's)")
    args = parser.parse_args(argv)

    dist = None
    if args.distributed:
        from ..parallel.distributed import initialize_from_env
        dist = initialize_from_env(args.device)

    # one check for the CLI and the loop: a foreign directory raises here
    epochs = checkpoint_epochs(args.model_dir)
    saved = load_hparams(args.model_dir) if os.path.isdir(args.model_dir) else None
    if saved is not None and epochs:
        hp = saved
        print(f"Resuming with persisted hparams.json from {args.model_dir}")
    elif args.hparams:
        with open(args.hparams) as f:
            hp = hparams_from_dict(json.load(f))
    else:
        hp = get_config(args.dataset)
    if args.compute_dtype:
        hp = apply_overrides(hp, [f"train.compute_dtype={args.compute_dtype}"])
    hp = apply_overrides(hp, args.override)
    set_global_determinism(hp.train.random_seed)

    probe = None
    if args.probe != "none":
        from ..training.probe import make_dev_mcd_probe, make_toy_ler_probe, with_early_stop
        probe_dir = os.path.dirname(os.path.abspath(args.model_dir))
        if args.probe == "dev_mcd":
            probe, metric = make_dev_mcd_probe(hp, args.data_dir, probe_dir), "probe_mcd_dtw"
        else:
            probe, metric = make_toy_ler_probe(hp, probe_dir), "probe_ler"
        if args.stop_probe > 0:
            probe = with_early_stop(probe, metric, args.stop_probe, probe_dir)

    os.makedirs(args.model_dir, exist_ok=True)
    logger = Logger(args.log_dir, "train.log" if dist is None or dist.is_main
                    else f"train_p{dist.process_index}.log").install()
    if dist is not None:
        print(f"distributed: process {dist.process_index}/{dist.process_count}, "
              f"backend {dist.backend}, device {dist.device}", flush=True)
    elif args.distributed:
        print("distributed: 1 process, the single-process path", flush=True)
    try:
        return train(hp, args.data_dir, args.model_dir, args.log_dir,
                     test_dir=args.test_dir, max_epochs=args.max_epochs,
                     steps_per_epoch=args.steps_per_epoch, log_every=args.log_every,
                     device=args.device, neural_vocoder_dir=args.neural_vocoder,
                     draw_plots=args.draw_plots, probe=probe, probe_every=args.probe_every,
                     dist=dist)
    finally:
        logger.uninstall()
        if dist is not None:
            dist.close()


if __name__ == "__main__":
    main()
