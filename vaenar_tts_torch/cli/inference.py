"""Free-text synthesis (counterpart of the free-text mode of
``vaenar_tts_tpu/cli/inference.py``, ``synthesize_from_text``):

    python -m vaenar_tts_torch.cli.inference --dataset ljspeech \\
        --text lines.txt --model_dir artifacts/toyv2_q90/ckpt --test_dir OUT

One mel per non-empty line is written to ``OUT/test-<epoch>-<line>.npy``,
trimmed to its predicted length. Runs on ``cuda`` unless ``--device cpu``.
Text and mel lengths are bucketed as the JAX CLI does them: the text to a
multiple of ``text_bucket``, the mel to ``text_max * ratio * 2 + 160``
rounded up to ``mel_bucket``. The model runs in the compute dtype of the
model directory's ``hparams.json`` (``train.compute_dtype``) unless
``--compute_dtype`` says otherwise; the mels are written as fp32. One take
per line; multi-take selection, alignment plots and wavs are not part of
this port yet.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.hparams import HParams
from ..models.vaenar import VAENAR, load_model, resolve_device
from ..text.tokenizer import CharTokenizer


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def resolve_length_source(source: str, hp: HParams) -> bool:
    """--length_source -> use the quantile head? 'auto' reads it whenever the
    model was trained with one."""
    has_q = float(hp.length_predictor.quantile) > 0.0
    if source == "quantile":
        if not has_q:
            raise SystemExit("--length_source quantile: this model was trained "
                             "without a quantile head")
        return True
    if source == "mean":
        return False
    if source != "auto":
        raise ValueError(f"unknown length source {source!r}")
    return has_q


def encode_lines(hp: HParams, lines: Sequence[str]) -> List[List[int]]:
    """English cleaners + BOS/EOS character ids, one list per line."""
    tokenizer = CharTokenizer(hp.text)
    return [tokenizer.encode_english(line) for line in lines]


def synthesize_batch(model: VAENAR, hp: HParams, token_ids: Sequence[Sequence[int]],
                     temperature: float, use_length_quantile: bool,
                     length_headroom: int = 0,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batch of lines -> (mels [B, max_mel, num_mels], predicted mel
    lengths [B]) on the model's device."""
    device = next(model.parameters()).device
    text_lens = [len(t) for t in token_ids]
    text_max = pad_to_multiple(max(text_lens), hp.dataset.text_bucket)
    batch = np.zeros((len(token_ids), text_max), np.int64)
    for i, t in enumerate(token_ids):
        batch[i, :len(t)] = t
    max_mel = pad_to_multiple(
        int(text_max * hp.common.mel_text_len_ratio * 2) + 160,
        hp.dataset.mel_bucket)
    return model.infer_with_length_prediction(
        torch.from_numpy(batch).to(device),
        torch.tensor(text_lens, dtype=torch.int32, device=device),
        max_mel_length=max_mel,
        reduction_factor=hp.common.final_reduction_factor,
        temperature=temperature, length_headroom=length_headroom,
        use_length_quantile=use_length_quantile, generator=generator)


def synthesize_from_text(args) -> List[str]:
    device = resolve_device(args.device)
    hp, model, epoch = load_model(args.model_dir, device, args.compute_dtype)
    use_q = resolve_length_source(args.length_source, hp)
    with open(args.text) as f:
        lines = [line.strip() for line in f if line.strip()]
    if not lines:
        raise SystemExit(f"no text lines in {args.text}")
    token_ids = encode_lines(hp, lines)
    generator = torch.Generator(device=device).manual_seed(args.sample_seed)
    os.makedirs(args.test_dir, exist_ok=True)
    paths = []
    start = time.perf_counter()
    for lo in range(0, len(token_ids), args.batch_size):
        mels, lens = synthesize_batch(
            model, hp, token_ids[lo:lo + args.batch_size], args.temperature,
            use_q, args.length_headroom, generator)
        mels, lens = mels.cpu().numpy(), lens.cpu().numpy()
        for i in range(len(lens)):
            path = os.path.join(args.test_dir, f"test-{epoch}-{lo + i}.npy")
            np.save(path, mels[i, :int(lens[i])])
            paths.append(path)
    print(f"synthesized {len(paths)} line(s) on {device} in "
          f"{time.perf_counter() - start:.3f} s -> {args.test_dir}")
    return paths


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("Free-text synthesis (PyTorch)")
    # the text frontend: English cleaners and the LJSpeech character set
    parser.add_argument("--dataset", type=str, required=True,
                        choices=["ljspeech"])
    parser.add_argument("--text", type=str, required=True,
                        help="file of lines to synthesize")
    parser.add_argument("--model_dir", type=str, required=True,
                        help="directory with hparams.json and export.npz")
    parser.add_argument("--test_dir", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"])
    parser.add_argument("--batch_size", type=int, default=16,
                        help="lines per synthesis batch")
    # same defaults as the JAX CLI: temperature 0.6, no extra length headroom
    parser.add_argument("--temperature", type=float, default=0.6)
    parser.add_argument("--length_headroom", type=int, default=0)
    parser.add_argument("--length_source", type=str, default="auto",
                        choices=["auto", "mean", "quantile"])
    parser.add_argument("--compute_dtype", type=str, default=None,
                        choices=["float32", "bfloat16"],
                        help="override the transformer compute dtype of the "
                             "model's hparams.json (parameters are fp32)")
    parser.add_argument("--sample_seed", type=int, default=0,
                        help="seed of the torch.Generator that draws the "
                             "prior noise")
    args = parser.parse_args(argv)
    if args.batch_size < 1:
        parser.error("--batch_size must be at least 1")
    synthesize_from_text(args)


if __name__ == "__main__":
    main()
