"""Synthesis CLI (counterpart of ``vaenar_tts_tpu/cli/inference.py``), in
two modes.

Test-set synthesis with the real-time factor, over the ``test`` record
shards of a preprocessed directory (``inference_test``):

    python -m vaenar_tts_torch.cli.inference --dataset ljspeech \\
        --data_dir RECORDS --model_dir artifacts/toyv2_q90/ckpt \\
        --test_dir OUT --batch_size 16 [--write_wavs] [--stream_wavs]

writes ``prior-<epoch>-<fid>.npy`` mels (``--no-write_mels`` leaves them
out), with ``--write_wavs`` ``prior-<epoch>-<fid>.wav``, and with
``--draw_alignments`` the decoder's alignment plots; it prints the JAX
CLI's ``Total time consumed is ... Average RTF is ...`` line. The clock
runs over synthesis only, each batch ending in ``torch.cuda.synchronize()``;
one warm-up batch of each text shape runs before it, and the mel pull and
the vocoder are outside it, as in the JAX CLI.

Free-text synthesis, one line of a text file per utterance
(``synthesize_from_text``):

    python -m vaenar_tts_torch.cli.inference --dataset ljspeech \\
        --text lines.txt --model_dir artifacts/toyv2_q90/ckpt --test_dir OUT \\
        [--takes 4 --take_score medoid|coverage]

writes ``test-<epoch>-<line>.npy`` and ``.wav`` and, unless
``--no-draw_alignments``, ``prior-dec_<i>-<epoch>-<line>-ali.pdf``. With
``--takes N`` each line is synthesized N times, take t from a
``torch.Generator`` seeded from (``--sample_seed``, t), at the temperatures
``--takes_temperatures`` cycles through; per line the CLI keeps the medoid
take by DTW-MCD (``medoid``) or the take whose decoder alignment scores
best on diagonality minus missed text coverage (``coverage``).

Both modes run on ``cuda`` unless ``--device cpu``, restore the newest
checkpoint of ``--model_dir`` (or the ``--ckpt_epoch`` one) and fall back to
its ``export.npz`` only when it holds no checkpoint, and run the model in
the compute dtype of its ``hparams.json`` unless ``--compute_dtype`` says
otherwise. Wavs come from Griffin-Lim on the model's device, or from numpy
Griffin-Lim on host threads with ``--host_vocoder``; ``--stream_wavs``
vocodes in chunks on the same choice of backend and prints the time to
first audio. ``--device_vocoder`` names the default and changes nothing: it
stands for the JAX CLI's ``--jax_vocoder``, whose name would be false here,
so that the two CLIs take the same flags. ``--neural_vocoder DIR``
vocodes each batch in one pass of a vocoder that ``cli.train_vocoder``
trained, on the model's device, in either mode (the JAX CLI takes it in
test-set mode); it is loaded, and its audio config checked against the
model's, before any synthesis. Text and mel lengths
are bucketed as the JAX CLI does them. Free-text lines go through the
dataset's text frontend: English cleaners for ``ljspeech``, TONE3 pinyin
(``text.pinyin.text_to_pinyin``; hanzi need ``pypinyin``) for
``databaker``.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..audio.export import TestUtils, require_matplotlib
from ..configs.hparams import HParams
from ..data.corpus import CORPORA
from ..data.loader import BucketedLoader
from ..data.records import list_shards
from ..models.vaenar import VAENAR, load_model, resolve_device
from ..utils.metrics import alignment_diagonality, medoid_take

# one take: (mels [B, T, num_mels], lengths [B], {"dec_<i>": [B, H, T_r, T_text]})
Take = Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray]]


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


def encode_lines(hp: HParams, lines: Sequence[str], dataset: str = "ljspeech") -> List[List[int]]:
    """BOS + the dataset frontend's symbols + EOS as character ids, one list
    per line (``data.corpus``'s ``text_to_array``)."""
    corpus = CORPORA[dataset](None, None, hp)
    return [corpus.text_to_array(line) for line in lines]


def synthesize(model: VAENAR, hp: HParams, texts: np.ndarray, text_lens: np.ndarray,
               max_mel: int, temperature: float, use_length_quantile: bool,
               length_headroom: int = 0, generator: Optional[torch.Generator] = None,
               return_alignments: bool = False):
    """One padded batch of token ids [B, T_text] -> (mels [B, max_mel,
    num_mels], predicted lengths [B]) on the model's device, and with
    ``return_alignments`` the decoder's alignments as a third value."""
    device = next(model.parameters()).device
    return model.infer_with_length_prediction(
        torch.from_numpy(np.asarray(texts, np.int64)).to(device),
        torch.from_numpy(np.asarray(text_lens, np.int32)).to(device),
        max_mel_length=max_mel, reduction_factor=hp.common.final_reduction_factor,
        temperature=temperature, length_headroom=length_headroom,
        use_length_quantile=use_length_quantile, generator=generator,
        return_alignments=return_alignments)


def pad_lines(hp: HParams, token_ids: Sequence[Sequence[int]]) -> Tuple[np.ndarray, np.ndarray, int]:
    """(token ids [B, text_max], lengths [B], max_mel) of free-text lines:
    text_max a multiple of text_bucket, max_mel = text_max · ratio · 2 +
    160 rounded up to mel_bucket."""
    text_lens = np.asarray([len(t) for t in token_ids], np.int32)
    text_max = pad_to_multiple(int(text_lens.max()), hp.dataset.text_bucket)
    batch = np.zeros((len(token_ids), text_max), np.int64)
    for i, t in enumerate(token_ids):
        batch[i, :len(t)] = t
    max_mel = pad_to_multiple(int(text_max * hp.common.mel_text_len_ratio * 2) + 160,
                              hp.dataset.mel_bucket)
    return batch, text_lens, max_mel


def synthesize_batch(model: VAENAR, hp: HParams, token_ids: Sequence[Sequence[int]],
                     temperature: float, use_length_quantile: bool,
                     length_headroom: int = 0,
                     generator: Optional[torch.Generator] = None,
                     return_alignments: bool = False):
    """One batch of free-text lines -> ``synthesize``'s outputs."""
    batch, text_lens, max_mel = pad_lines(hp, token_ids)
    return synthesize(model, hp, batch, text_lens, max_mel, temperature, use_length_quantile,
                      length_headroom, generator, return_alignments)


def take_seed(sample_seed: int, take: int) -> int:
    """The seed of take ``take``'s generator."""
    return int(np.random.SeedSequence([sample_seed, take]).generate_state(1)[0])


def choose_takes_medoid(takes: Sequence[Take]) -> Tuple[np.ndarray, List[float]]:
    """Per line, the take closest by DTW-MCD to the others
    (``utils.metrics.medoid_take`` over the takes trimmed to their lengths),
    and the mean pairwise DTW-MCD of each line's takes."""
    chosen, spreads = [], []
    for b in range(len(takes[0][1])):
        cand = [mels[b][: max(int(lens[b]), 1)] for mels, lens, _ in takes]
        idx, dmat = medoid_take(cand)
        chosen.append(idx)
        spreads.append(float(dmat.sum() / max(dmat.size - len(cand), 1)))
    return np.asarray(chosen, np.int32), spreads


def coverage_scores(take: Take, text_lens: Sequence[int], reduction_factor: int) -> np.ndarray:
    """Per line, the best decoder block's alignment diagonality minus its
    missed text coverage (``utils.metrics.alignment_diagonality``) over the
    reduced frames of the take's length."""
    _, lens, alignments = take
    scores = np.full(len(lens), -3.0)
    for a in alignments.values():
        for b in range(len(lens)):
            m = alignment_diagonality(a[b], -(-int(lens[b]) // reduction_factor),
                                      int(text_lens[b]))
            scores[b] = max(scores[b], m["diagonality"] - (1.0 - m["coverage"]))
    return scores


def choose_takes_coverage(takes: Sequence[Take], text_lens: Sequence[int],
                          reduction_factor: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per line, the first take of the highest ``coverage_scores``, and that
    score."""
    best = coverage_scores(takes[0], text_lens, reduction_factor)
    chosen = np.zeros(len(best), np.int32)
    for t in range(1, len(takes)):
        s = coverage_scores(takes[t], text_lens, reduction_factor)
        better = s > best
        best[better], chosen[better] = s[better], t
    return chosen, best


def merge_takes(takes: Sequence[Take], chosen: Sequence[int]) -> Take:
    """The chosen take of every line, as one batch."""
    rows = range(len(chosen))
    mels = np.stack([takes[t][0][b] for b, t in zip(rows, chosen)])
    lens = np.asarray([takes[t][1][b] for b, t in zip(rows, chosen)])
    alignments = {k: np.stack([takes[t][2][k][b] for b, t in zip(rows, chosen)])
                  for k in takes[0][2]}
    return mels, lens, alignments


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def as_take(out) -> Take:
    """``synthesize``'s outputs as numpy arrays on the host."""
    mels, lens = out[0], out[1]
    alignments = out[2] if len(out) > 2 else {}
    return (mels.cpu().numpy(), lens.cpu().numpy(),
            {k: a.cpu().numpy() for k, a in alignments.items()})


def vocode_batch(args, tester: TestUtils, tag, mels: np.ndarray, lens: np.ndarray, ids,
               prefix: str) -> None:
    """Vocode one batch as the flags say; the streaming vocoder prints its
    time to first audio."""
    backend = "host" if args.host_vocoder else "device"
    if args.neural_vocoder:
        tester.synthesize_and_save_wavs_neural(tag, mels, lens, ids, prefix=prefix)
    elif args.stream_wavs:
        _, ttfas = tester.synthesize_and_save_wavs_streaming(tag, mels, lens, ids, prefix=prefix,
                                                             backend=backend)
        print(f"streaming vocoder ({backend}): time-to-first-audio mean {np.mean(ttfas):.3f}s "
              f"max {np.max(ttfas):.3f}s over {len(ttfas)} utterances", flush=True)
    elif backend == "device":
        tester.synthesize_and_save_wavs_device(tag, mels, lens, ids, prefix=prefix)
    else:
        tester.synthesize_and_save_wavs(tag, mels, lens, ids, prefix=prefix)


def _draw_alignments(tester: TestUtils, alignments, text_lens, lens, tag, ids, r: int) -> None:
    for k, a in alignments.items():
        tester.multi_draw_attention_alignments(a, text_lens, lens, tag, ids,
                                               prefix=f"prior-{k}", reduction_factor=r)


def inference_test(args) -> Dict[str, float]:
    """Test-set mode; returns the timed seconds, the seconds of audio and
    the real-time factor."""
    draw = bool(args.draw_alignments)
    if draw:
        require_matplotlib()
    device = resolve_device(args.device)
    hp, model, epoch = load_model(args.model_dir, device, args.compute_dtype, args.ckpt_epoch)
    tester = TestUtils(hp, args.test_dir, device, neural_vocoder_dir=args.neural_vocoder)
    r = hp.common.final_reduction_factor
    use_q = resolve_length_source(args.length_source, hp)
    shards = list_shards(args.data_dir, "test")
    if not shards:
        raise SystemExit(f"no test shards in {args.data_dir}")
    loader = BucketedLoader(shards, args.batch_size, mel_bucket=hp.dataset.mel_bucket,
                            text_bucket=hp.dataset.text_bucket, shuffle=False, seed=0)
    # static headroom: the longest test mel and the reference's +80, bucketed
    max_mel = pad_to_multiple(max(int(rr.mel_lens.max()) for rr in loader.readers) + 80,
                              hp.dataset.mel_bucket)

    def run(batch, generator):
        return synthesize(model, hp, batch.texts, batch.text_lengths, max_mel,
                          args.temperature, use_q, args.length_headroom, generator, draw)

    # one warm-up batch of each text shape, from a generator of its own
    unseen = {tm for (tm, _) in loader.shape_census()}
    warm_gen = torch.Generator(device=device).manual_seed(args.sample_seed)
    for batch in loader.epoch(0):
        if batch.texts.shape[1] in unseen:
            unseen.discard(batch.texts.shape[1])
            run(batch, warm_gen)
            _sync(device)
        if not unseen:
            break

    generator = torch.Generator(device=device).manual_seed(args.sample_seed)
    time_consumed = durations = 0.0
    for batch in loader.epoch(0):
        t0 = time.perf_counter()
        out = run(batch, generator)
        _sync(device)
        time_consumed += time.perf_counter() - t0
        mels, lens, alignments = as_take(out)
        n = batch.n_valid
        ids = batch.fids[:n]
        durations += float(lens[:n].sum()) * hp.audio.frame_shift_sample / hp.audio.sample_rate
        if args.write_mels:
            tester.write_mels(epoch, mels[:n], lens[:n], ids, prefix="prior")
        if args.write_wavs:
            vocode_batch(args, tester, epoch, mels[:n], lens[:n], ids, prefix="prior")
        if draw:
            _draw_alignments(tester, {k: a[:n] for k, a in alignments.items()},
                             batch.text_lengths, lens, epoch, ids, r)
    rtf = time_consumed / max(durations, 1e-9)
    print(f"Total time consumed is {time_consumed:.3f} Secs, total synthesis duration is "
          f"{durations:.3f} Secs, Average RTF is {rtf:.5f}.", flush=True)
    return {"seconds": time_consumed, "audio_seconds": durations, "rtf": rtf}


def synthesize_from_text(args) -> Dict[str, list]:
    """Free-text mode; returns the mel paths written and the chosen take of
    each line."""
    draw = args.draw_alignments is not False
    if draw:
        require_matplotlib()
    device = resolve_device(args.device)
    hp, model, epoch = load_model(args.model_dir, device, args.compute_dtype, args.ckpt_epoch)
    r = hp.common.final_reduction_factor
    use_q = resolve_length_source(args.length_source, hp)
    with open(args.text) as f:
        lines = [line.strip() for line in f if line.strip()]
    if not lines:
        raise SystemExit(f"no text lines in {args.text}")
    token_ids = encode_lines(hp, lines, args.dataset)
    tester = TestUtils(hp, args.test_dir, device, neural_vocoder_dir=args.neural_vocoder)
    takes = max(1, args.takes)
    temps = ([float(x) for x in args.takes_temperatures.split(",")]
             if args.takes_temperatures else [args.temperature])
    generators = [torch.Generator(device=device).manual_seed(take_seed(args.sample_seed, t))
                  for t in range(takes)]
    # alignments for the plots, or for the coverage score
    need_ali = draw or (takes > 1 and args.take_score == "coverage")
    paths, chosen_all = [], []
    start = time.perf_counter()
    for lo in range(0, len(token_ids), args.batch_size):
        texts, text_lens, max_mel = pad_lines(hp, token_ids[lo:lo + args.batch_size])
        runs = [as_take(synthesize(model, hp, texts, text_lens, max_mel, temps[t % len(temps)],
                                     use_q, args.length_headroom, generators[t], need_ali))
                for t in range(takes)]
        chosen = np.zeros(len(text_lens), np.int32)
        if takes > 1 and args.take_score == "medoid":
            chosen, spreads = choose_takes_medoid(runs)
            print(f"medoid take selection over {takes} z-samples, lines {lo}-"
                  f"{lo + len(chosen) - 1}: chosen takes {chosen.tolist()}, mean pairwise "
                  f"DTW-MCD (dB) {np.round(spreads, 2).tolist()}", flush=True)
        elif takes > 1:
            chosen, scores = choose_takes_coverage(runs, text_lens, r)
            print(f"take selection over {takes} z-samples, lines {lo}-{lo + len(chosen) - 1}: "
                  f"chosen takes {chosen.tolist()}, score (diagonality - coverage miss) "
                  f"{np.round(scores, 3).tolist()}", flush=True)
        mels, lens, alignments = merge_takes(runs, chosen)
        ids = [str(lo + i) for i in range(len(lens))]
        if args.write_mels:
            paths += tester.write_mels(epoch, mels, lens, ids, prefix="test")
        vocode_batch(args, tester, epoch, mels, lens, ids, prefix="test")
        if draw:
            _draw_alignments(tester, alignments, text_lens, lens, epoch, ids, r)
        chosen_all += chosen.tolist()
    print(f"synthesized {len(token_ids)} line(s) on {device} in "
          f"{time.perf_counter() - start:.3f} s -> {args.test_dir}", flush=True)
    return {"paths": paths, "chosen": chosen_all}


def main(argv=None):
    parser = argparse.ArgumentParser("Synthesis (PyTorch)")
    # the text frontend of free-text lines: English cleaners, or pinyin
    parser.add_argument("--dataset", type=str, required=True, choices=["ljspeech", "databaker"])
    parser.add_argument("--data_dir", type=str, default=None,
                        help="records directory: synthesize its test split (test-set mode)")
    parser.add_argument("--text", type=str, default=None,
                        help="file of lines to synthesize (free-text mode)")
    parser.add_argument("--model_dir", type=str, required=True,
                        help="directory with hparams.json and checkpoints or export.npz")
    parser.add_argument("--ckpt_epoch", type=int, default=None,
                        help="restore this epoch's checkpoint instead of the newest one")
    parser.add_argument("--test_dir", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--batch_size", type=int, default=16, help="utterances per batch")
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
                        help="seed of the torch.Generators that draw the prior noise")
    parser.add_argument("--takes", type=int, default=1,
                        help="free-text mode: synthesize this many takes a line and keep one")
    parser.add_argument("--take_score", type=str, default="coverage",
                        choices=["coverage", "medoid"],
                        help="how a take is chosen: decoder-alignment diagonality minus "
                             "missed text coverage, or the medoid by DTW-MCD")
    parser.add_argument("--takes_temperatures", type=str, default=None,
                        help="comma list of temperatures that the takes cycle through")
    parser.add_argument("--write_mels", action=argparse.BooleanOptionalAction, default=True)
    parser.add_argument("--write_wavs", action="store_true", default=False,
                        help="test-set mode: vocode the mels (free-text mode always does)")
    parser.add_argument("--draw_alignments", action=argparse.BooleanOptionalAction,
                        default=None,
                        help="plot the decoder's alignments (needs matplotlib); on by "
                             "default in free-text mode, off in test-set mode")
    vocoder = parser.add_mutually_exclusive_group()
    vocoder.add_argument("--device_vocoder", action="store_true", default=False,
                         help="batched Griffin-Lim on the model's device; this is the "
                              "default, and the flag changes nothing: it stands for the "
                              "JAX CLI's --jax_vocoder")
    vocoder.add_argument("--host_vocoder", action="store_true", default=False,
                         help="numpy Griffin-Lim on host threads")
    parser.add_argument("--stream_wavs", action="store_true", default=False,
                        help="vocode in chunks and print the time to first audio")
    parser.add_argument("--neural_vocoder", type=str, default=None,
                        help="directory of a trained ISTFT-head vocoder (cli.train_vocoder): "
                             "vocode each batch in one pass instead of Griffin-Lim")
    args = parser.parse_args(argv)
    if args.batch_size < 1:
        parser.error("--batch_size must be at least 1")
    os.makedirs(args.test_dir, exist_ok=True)
    if args.text:
        return synthesize_from_text(args)
    if not args.data_dir:
        parser.error("--data_dir (test-set mode) or --text (free-text mode) is required")
    return inference_test(args)


if __name__ == "__main__":
    main()
