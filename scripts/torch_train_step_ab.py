#!/usr/bin/env python3
"""Time and profile train steps of the PyTorch port (vaenar_tts_torch) from
two checkouts in turns, on one CUDA card:

    python3 scripts/torch_train_step_ab.py ROOT_A ROOT_B [--compute_dtype float32]

ROOT_A and ROOT_B are directories that hold a `vaenar_tts_torch/` package
(a parent commit unpacked with `git archive`, and this checkout). The runs go
A, B, B, A, each in its own process that imports the package and builds its
kernels from its root.

    python3 scripts/torch_train_step_ab.py --adam ROOT [--compute_dtype float32]

compares Adam's two arithmetics on the eager step of one checkout instead:
`make_optimizer(capturable=False)` (bias corrections from host doubles) as
A and `capturable=True` (step counts and bias corrections on the card) as B,
in the same order. Each run loads the shipped model
(artifacts/toyv2_q90/ckpt of this checkout, at its compute dtype, bfloat16,
or at the one `--compute_dtype` names), makes
the training path's data from a seed with chip_smoke.py's `write_records`,
and at r = 2 and r = 5 on a batch of 32 prints one JSON line: the median
host-clock wall of 10 train steps and chip_smoke.py's torch.profiler pass
(kernel device time, kernel launches and the hand-written kernels' launches
per step). The last line is the card's name and power limit.

It loads chip_smoke.py by file path and calls its helpers `MODEL_DIR`,
`write_records`, `train_step_times` and `profile_train_steps`: a change to
their signatures or return values there must be made here too.
"""

import functools
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_one(root, compute_dtype=None, capturable=None):
    """One run from ``root`` at ``compute_dtype`` (None: the shipped
    config's) with Adam ``capturable`` (None: the package's own choice);
    prints a JSON line for each reduction factor."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from vaenar_tts_torch.data.loader import BucketedLoader
    from vaenar_tts_torch.data.records import list_shards
    from vaenar_tts_torch.models.vaenar import load_model
    from vaenar_tts_torch.ops import flash_attention as fa
    from vaenar_tts_torch.training import steps
    from vaenar_tts_torch.training.loop import to_device
    cs = _chip_smoke()
    if capturable is not None:  # chip_smoke's timers build their Adam through this name
        steps.make_optimizer = functools.partial(steps.make_optimizer, capturable=capturable)
    hp, model, _ = load_model(cs.MODEL_DIR, "cuda", compute_dtype)
    with tempfile.TemporaryDirectory(prefix="vaenar_ab_") as tmp:
        cs.write_records(tmp, seed=2026)
        big = next(iter(BucketedLoader(list_shards(tmp, "train"), hp.train.train_batch_size,
                                       hp.dataset.mel_bucket, hp.dataset.text_bucket,
                                       shuffle=False).epoch(0)))
    batch = to_device(big, "cuda")
    for r in (2, hp.common.max_reduction_factor):
        walls, attention = cs.train_step_times(torch, fa, steps, model, hp, batch, r)
        device_ms, launches, _ = cs.profile_train_steps(torch, steps, model, hp, batch, r)
        print(json.dumps({"root": root, "compute_dtype": hp.train.compute_dtype,
                          "adam_capturable": capturable,
                          "reduction_factor": r, "batch": list(big.mels.shape),
                          "wall_ms_median": 1e3 * statistics.median(walls),
                          "device_ms_per_step": device_ms,
                          "kernel_launches_per_step": launches,
                          "attention_launches_per_step": attention}), flush=True)


def main(argv):
    dtype = []
    if len(argv) >= 2 and argv[-2] == "--compute_dtype":
        dtype, argv = argv[-2:], argv[:-2]
    if len(argv) in (2, 3) and argv[0] == "--one":
        run_one(argv[1], dtype[1] if dtype else None,
                {"host": False, "capturable": True}.get(argv[2]) if len(argv) == 3 else None)
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if argv[0] == "--adam":
        arms = [(argv[1], "host"), (argv[1], "capturable")]
    else:
        arms = [(argv[0],), (argv[1],)]
    for arm in (arms[0], arms[1], arms[1], arms[0]):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", *arm, *dtype],
                       check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
