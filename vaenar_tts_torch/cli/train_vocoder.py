"""Neural vocoder training CLI (counterpart of
``vaenar_tts_tpu/cli/train_vocoder.py``), with its flags and
``--device cuda|cpu`` (default ``cuda``).

On the procedural toy corpus (``data/toy.py``; no corpus needed):

    python -m vaenar_tts_torch.cli.train_vocoder --dataset ljspeech \\
        --toy [--toy_version 2] --model_dir VOCODER_DIR --steps 5000

On a directory of wav files:

    python -m vaenar_tts_torch.cli.train_vocoder --dataset ljspeech \\
        --wav_dir LJSpeech-1.1/wavs --model_dir VOCODER_DIR

Exactly one of ``--toy`` and ``--wav_dir``. The run resumes from the newest
checkpoint in ``VOCODER_DIR``; the directory then serves synthesis
(``cli.inference --neural_vocoder VOCODER_DIR``) and the training loop's
test artifacts (``cli.train --neural_vocoder VOCODER_DIR``). At a tiny
width on the CPU: ``--device cpu --toy --n_toy_utterances 2 --steps 3
--batch_size 2 --segment_frames 24 --hidden 16 --n_blocks 1``.
"""

from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    parser = argparse.ArgumentParser("Vocoder training (PyTorch)")
    parser.add_argument("--dataset", type=str, default="ljspeech",
                        choices=["ljspeech", "databaker"],
                        help="supplies the audio config (sample rate, STFT geometry, mels)")
    parser.add_argument("--model_dir", type=str, required=True)
    parser.add_argument("--toy", action="store_true", default=False,
                        help="train on the procedural toy corpus")
    parser.add_argument("--wav_dir", type=str, default=None,
                        help="directory of training .wav files")
    parser.add_argument("--n_toy_utterances", type=int, default=64)
    parser.add_argument("--toy_version", type=int, default=1, choices=(1, 2),
                        help="1 = stationary tones; 2 = speech-like (random tempo, "
                             "coarticulation, declination, noise floor)")
    parser.add_argument("--wav_limit", type=int, default=None)
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--segment_frames", type=int, default=None)
    parser.add_argument("--hidden", type=int, default=None)
    parser.add_argument("--n_blocks", type=int, default=None)
    parser.add_argument("--learning_rate", type=float, default=None)
    parser.add_argument("--compute_dtype", type=str, default=None,
                        choices=["float32", "bfloat16"])
    parser.add_argument("--log_every", type=int, default=100)
    parser.add_argument("--save_every", type=int, default=2000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    if bool(args.toy) == bool(args.wav_dir):
        parser.error("exactly one of --toy / --wav_dir is required")

    from ..configs.hparams import get_config
    from ..models.vocoder import VocoderConfig
    from ..training.vocoder import (PairSampler, toy_utterances, train_vocoder,
                                    wav_dir_utterances)
    from ..utils.checkpoint import checkpoint_epochs

    checkpoint_epochs(args.model_dir)  # a foreign directory raises before any work
    audio = get_config(args.dataset).audio
    overrides = {k: getattr(args, k) for k in
                 ("steps", "batch_size", "segment_frames", "hidden", "n_blocks",
                  "learning_rate", "compute_dtype") if getattr(args, k) is not None}
    cfg = dataclasses.replace(VocoderConfig(), **overrides)
    if args.toy:
        utts = toy_utterances(audio, n=args.n_toy_utterances, seed=args.seed,
                              version=args.toy_version)
    else:
        utts = wav_dir_utterances(args.wav_dir, audio, limit=args.wav_limit)
    print(f"training on {len(utts)} utterances "
          f"({sum(len(u) for u in utts) / audio.sample_rate:.1f} s audio), config: {cfg}")
    sampler = PairSampler(utts, audio, cfg.segment_frames, seed=args.seed)
    _, result = train_vocoder(cfg, audio, sampler, args.model_dir, log_every=args.log_every,
                              save_every=args.save_every, seed=args.seed, device=args.device)
    print(f"done: final loss {result['last_loss']:.4f}; checkpoint in {args.model_dir}")
    return result


if __name__ == "__main__":
    main()
