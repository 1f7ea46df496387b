#!/usr/bin/env python3
"""Is a train step reproducible on the card, and does a CUDA graph of it
(``training/steps.make_epoch_runner``) replay it exactly?

From one state (fresh weights at the shipped config, one priming step, so
that Adam has state) the script takes one eager train step twice and one
graphed step (the runner's capture, then one replay) on the same batch and
generator seed, and counts the gradient and parameter leaves that are not
bit-equal between the two eager steps and between the graphed and the
first eager one; in fp32 and bf16, with cuDNN's default algorithms and with
``torch.backends.cudnn.deterministic``. Batch 32 of seeded records in the
toy-v2 ranges, r = 2. One JSON line a case, with the card's name and power
limit first. Run from the root of a checkout on a machine with a card:

    python3 scripts/torch_graph_step_determinism.py
"""

import json
import os
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402
from vaenar_tts_torch.configs.overrides import apply_overrides  # noqa: E402
from vaenar_tts_torch.configs.serialize import load_hparams  # noqa: E402
from vaenar_tts_torch.ops import _build  # noqa: E402
from vaenar_tts_torch.training import loop, steps  # noqa: E402


def compare(a, b):
    """The leaves of (metrics, gradients, parameters) ``a`` that differ
    from ``b``'s, with each gradient's largest difference over its largest
    element."""
    grads = {n: (a[1][n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
             for n, g in b[1].items() if not torch.equal(a[1][n], g)}
    params = [n for n, p in b[2].items() if not torch.equal(a[2][n], p)]
    return {"metrics_equal": a[0] == b[0], "gradient_leaves_unequal": len(grads),
            "worst_gradients": sorted(grads.items(), key=lambda t: -t[1])[:6],
            "parameter_leaves_unequal": len(params), "leaves": len(b[1])}


def case(records, dtype, device):
    hp = apply_overrides(load_hparams(chip_smoke.MODEL_DIR),
                         [f"train.compute_dtype={dtype}", "train.device_data_cache_mb=64"])
    train_loader, dev_loader, _ = loop.make_loaders(hp, records)
    cache, _ = loop.device_cache(hp, train_loader, dev_loader, device)
    model = steps.init_model(hp, 7, device)
    optimizer = steps.make_optimizer(hp, model)
    steps.train_step(model, optimizer, hp, *(x[0] for x in cache), 1e-5, 2,
                     torch.Generator(device=device).manual_seed(1))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    adam = {p: {k: v.clone() for k, v in st.items()} for p, st in optimizer.state.items()}

    def restore():
        with torch.no_grad():
            for k, v in model.state_dict().items():
                v.copy_(state[k])
            for p, st in optimizer.state.items():
                for k, v in st.items():
                    v.copy_(adam[p][k])

    def result(metrics):
        return (metrics, {n: p.grad.clone() for n, p in model.named_parameters()},
                {n: p.detach().clone() for n, p in model.named_parameters()})

    def eager():
        restore()
        m = steps.train_step(model, optimizer, hp, *(x[1] for x in cache), 1e-5, 2,
                             torch.Generator(device=device).manual_seed(5))
        return result(steps.metric_floats(m))

    first, second = eager(), eager()
    restore()
    runner = steps.make_epoch_runner(model, optimizer, hp, cache)
    sums, _ = runner([1], 1e-5, 2, torch.Generator(device=device).manual_seed(5))
    graphed = result({k: float(v) for k, v in sums.items()})
    return {"eager_vs_eager": compare(second, first), "graphed_vs_eager": compare(graphed, first)}


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)
    _build.build()
    device = torch.device("cuda")
    with tempfile.TemporaryDirectory() as records:
        chip_smoke.write_records(records, seed=2032, splits=(("train", 128), ("dev", 32)))
        for dtype in ("float32", "bfloat16"):
            for deterministic in (False, True):
                torch.backends.cudnn.deterministic = deterministic
                print(json.dumps({"compute_dtype": dtype, "cudnn_deterministic": deterministic,
                                  **case(records, dtype, device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
