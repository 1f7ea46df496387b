"""Training CLI (counterpart of ``vaenar_tts_tpu/cli/train.py``,
single process):

    python -m vaenar_tts_torch.cli.train --dataset ljspeech \\
        --data_dir RECORDS --model_dir CKPT --log_dir LOGS \\
        [--hparams artifacts/toyv2_q90/ckpt/hparams.json] \\
        [--max_epochs N] [--steps_per_epoch N] [--override key.path=value]

``RECORDS`` holds ``train-*.vrs`` and ``dev-*.vrs`` shards
(``data/records.py``). When ``CKPT`` already holds a checkpoint, its
``hparams.json`` is the config and the run resumes; otherwise the config is
``--hparams`` or the dataset's defaults, then the overrides. Runs on
``cuda`` unless ``--device cpu``. ``utils.export.export_model_dir`` turns
the result into the ``export.npz`` that inference (the port's or the JAX
package's) loads.
"""

from __future__ import annotations

import argparse
import json
import os

from ..configs.hparams import HParams
from ..configs.overrides import apply_overrides
from ..configs.serialize import hparams_from_dict, load_hparams
from ..training.loop import train


def main(argv=None):
    parser = argparse.ArgumentParser("Training (PyTorch)")
    parser.add_argument("--dataset", type=str, required=True, choices=["ljspeech"])
    parser.add_argument("--data_dir", type=str, required=True,
                        help="record shard directory")
    parser.add_argument("--model_dir", type=str, required=True,
                        help="directory for checkpoints and hparams.json")
    parser.add_argument("--log_dir", type=str, required=True)
    parser.add_argument("--hparams", type=str, default=None,
                        help="hparams.json to start a new run from, in place "
                             "of the dataset's defaults")
    parser.add_argument("--max_epochs", type=int, default=None,
                        help="run through epoch N inclusive")
    parser.add_argument("--steps_per_epoch", type=int, default=None,
                        help="cut each epoch to N steps")
    parser.add_argument("--log_every", type=int, default=50,
                        help="print a train step's losses every N steps")
    parser.add_argument("--override", action="append", default=[],
                        metavar="key.path=value",
                        help="config override, e.g. prior.n_blk=12 (repeatable)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    saved = load_hparams(args.model_dir) if os.path.isdir(args.model_dir) else None
    has_ckpt = saved is not None and any(e.isdigit() for e in os.listdir(args.model_dir))
    if has_ckpt:
        hp = saved
        print(f"Resuming with persisted hparams.json from {args.model_dir}")
    elif args.hparams:
        with open(args.hparams) as f:
            hp = hparams_from_dict(json.load(f))
    else:
        hp = HParams()
    hp = apply_overrides(hp, args.override)
    os.makedirs(args.model_dir, exist_ok=True)
    return train(hp, args.data_dir, args.model_dir, args.log_dir,
                 max_epochs=args.max_epochs, steps_per_epoch=args.steps_per_epoch,
                 log_every=args.log_every, device=args.device)


if __name__ == "__main__":
    main()
