#!/usr/bin/env python3
"""The spread of chip_smoke.py's neural-vocoder card-against-CPU check over
repeated trainings, on one CUDA card:

    python3 scripts/torch_vocoder_card_cpu.py [--runs 4]

Each run trains the fp32 vocoder as chip_smoke.py's ``neural_vocoder``
phase does (``cli.train_vocoder --toy --toy_version 2``, the full
VocoderConfig, 32 utterances, 300 steps; the card's training is not
bit-reproducible, so each run ends at other weights), then runs its forward
on the card and on the CPU over the first 480 frames of the 4 shipped
lines' bf16 mels at temperature 0 and prints, per run, one JSON line:

* ``spec``: the check's quantity, max |card - CPU| / max |CPU| of the STFT
  frames mag · (re, im) / |(re, im)|;
* ``head``: the same of the head's output (log-magnitude, re, im) before
  the phasor;
* ``phasor_norm_at_worst``: |(re, im)| at the frame element whose spec
  error is largest, and ``magnitude_at_worst_share_of_max`` its mag / max mag: where
  |(re, im)| is near 0 the phasor's direction turns on rounding
  (``log_magnitude_at_worst`` too);
* the card's TF32 flags at the time of the forward.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--runs", type=int, default=4)
    args = parser.parse_args()
    sys.path.insert(0, HERE)
    import torch
    from chip_smoke import LINES, MODEL_DIR, VOC_CARD_CPU_FRAMES, VOC_STEPS, VOC_UTTS, run_cli
    from vaenar_tts_torch.cli import train_vocoder as cli_vocoder
    from vaenar_tts_torch.cli.inference import (encode_lines, resolve_length_source,
                                                synthesize_batch)
    from vaenar_tts_torch.models.vaenar import load_model
    from vaenar_tts_torch.models.vocoder import _same, load_vocoder

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    hp, model, _ = load_model(MODEL_DIR, "cuda")
    mels, _ = synthesize_batch(model, hp, encode_lines(hp, LINES), 0.0,
                               resolve_length_source("auto", hp))
    crop = mels[:, :VOC_CARD_CPU_FRAMES]

    def head(voc, x):
        """(head output [B, T, 3 · bins], STFT frames [B, T, 2 · bins])."""
        h = voc.embed_norm(_same(voc.embed, x.to(voc.cfg.dtype())))
        for name in voc.names:
            h = getattr(voc, name)(h)
        return voc.head(voc.head_norm(h).float()), voc(x).transpose(1, 2)

    for run in range(args.runs):
        with tempfile.TemporaryDirectory() as tmp:
            run_cli(cli_vocoder.main, [
                "--dataset", "ljspeech", "--toy", "--toy_version", "2",
                "--n_toy_utterances", str(VOC_UTTS), "--model_dir", tmp,
                "--steps", str(VOC_STEPS), "--log_every", str(VOC_STEPS),
                "--save_every", str(10 * VOC_STEPS), "--compute_dtype", "float32",
                "--device", "cuda"])
            card, _ = load_vocoder(tmp, "cuda")
            cpu, _ = load_vocoder(tmp, "cpu")
        with torch.no_grad():
            (h_card, s_card), (h_cpu, s_cpu) = head(card, crop), head(cpu, crop.cpu())
        h_card, s_card = h_card.cpu(), s_card.cpu()
        err = (s_card - s_cpu).abs()
        worst = int(err.argmax())
        b, t, f = (int(i) for i in torch.unravel_index(torch.tensor(worst), err.shape))
        bins = h_cpu.shape[-1] // 3
        fbin = f % bins
        log_mag, re, im = (h_cpu[b, t, k * bins + fbin].item() for k in range(3))
        mag = torch.exp(torch.clamp(h_cpu[..., :bins], -8.0, 8.0))
        print(json.dumps({
            "card": smi, "run": run,
            "spec": (err.max() / s_cpu.abs().max()).item(),
            "head": ((h_card - h_cpu).abs().max() / h_cpu.abs().max()).item(),
            "phasor_norm_at_worst": (re * re + im * im) ** 0.5,
            "log_magnitude_at_worst": min(8.0, max(-8.0, log_mag)),
            "magnitude_at_worst_share_of_max": (mag[b, t, fbin] / mag.max()).item(),
            "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                           "cudnn": torch.backends.cudnn.allow_tf32}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
