"""Corpus preprocessing CLI (counterpart of
``vaenar_tts_tpu/cli/preprocess.py``):

    python -m vaenar_tts_torch.cli.preprocess --dataset ljspeech \\
        --data_dir /path/LJSpeech-1.1 --save_dir /path/features \\
        [--record_split 8] [--device_mels [--device cuda|cpu]]

Processes the text, writes the train/dev/test split, extracts the mels,
writes the sharded ``.vrs`` records and prints the shapes of one batch.
Mels are extracted with numpy on a pool of host processes, or with
``--device_mels`` in batches by torch on ``--device`` (``cuda`` unless
``cpu`` is asked for; without a card, ``cuda`` raises).

Several workers over one shared ``--save_dir`` (``--worker_index`` /
``--worker_count``) run in two phases: first every worker with
``--skip_records`` (worker 0 processes the text and the split, every worker
extracts its slice of the wavs), then the record phase, in which each
worker writes its slice of the train shards and worker 0 dev and test.
"""

from __future__ import annotations

import argparse
import os

from ..configs.hparams import get_config
from ..data.corpus import CORPORA
from ..data.loader import BucketedLoader
from ..data.records import RecordWriter, list_shards


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("Preprocessing (PyTorch)")
    parser.add_argument("--dataset", type=str, required=True, choices=["ljspeech", "databaker"])
    parser.add_argument("--data_dir", type=str, required=True, help="corpus root directory")
    parser.add_argument("--save_dir", type=str, required=True,
                        help="directory to save features and records")
    parser.add_argument("--record_split", type=int, default=8,
                        help="number of train record shards")
    parser.add_argument("--num_workers", type=int, default=None,
                        help="host extraction processes (0 or 1: serial)")
    parser.add_argument("--mel_dtype", type=str, default="float32",
                        choices=["float32", "float16"],
                        help="record storage dtype of the mels (the loader reads float32)")
    parser.add_argument("--device_mels", action="store_true", default=False,
                        help="extract the mels in batches with torch on --device, in place "
                             "of numpy on host processes")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="where --device_mels runs")
    parser.add_argument("--worker_index", type=int, default=0,
                        help="several workers: this worker's index")
    parser.add_argument("--worker_count", type=int, default=1,
                        help="several workers over a shared --save_dir: run every worker "
                             "with --skip_records first, then again without it to write "
                             "the records")
    parser.add_argument("--skip_records", action="store_true", default=False,
                        help="extraction only (the first phase of several workers)")
    args = parser.parse_args(argv)

    if args.device_mels:
        from ..models.vaenar import resolve_device
        resolve_device(args.device)  # raises before any file is written
    hps = get_config(args.dataset)
    corpus = CORPORA[args.dataset](args.data_dir, args.save_dir, hps)
    corpus.feature_extraction(num_workers=args.num_workers, use_device=args.device_mels,
                              worker_index=args.worker_index,
                              worker_count=args.worker_count, device=args.device)

    if args.skip_records:
        print("Skipping record writing (--skip_records).")
        return
    if args.worker_count > 1:
        # the shards draw fids from every worker's mels: refuse to write
        # them before every worker has finished its first phase
        missing = 0
        for list_f in (corpus.train_list_f, corpus.dev_list_f, corpus.test_list_f):
            with open(list_f) as f:
                for fid in f.read().split():
                    if not os.path.isfile(os.path.join(corpus.mel_dir, fid + ".npy")):
                        missing += 1
        if missing:
            raise SystemExit(
                f"{missing} mel files are not extracted yet (other workers "
                f"still in phase 1?). Run phase 1 on every worker with "
                f"--skip_records first, then re-run the record phase.")
    print("Writing sharded records...")
    writer = RecordWriter(args.save_dir, args.save_dir, train_split=args.record_split,
                          num_mels=hps.audio.num_mels, mel_dtype=args.mel_dtype)
    paths = writer.write_all(worker_index=args.worker_index, worker_count=args.worker_count)
    for mode, ps in paths.items():
        print(f"  {mode}: {len(ps)} shard(s)")
    if args.worker_count > 1:
        # peers may still be writing their shards: the batch below would
        # read a partial set
        print(f"worker {args.worker_index}/{args.worker_count} done; "
              f"skipping the cross-shard smoke test (peers may still be "
              f"writing). Re-run without --worker_count after all workers "
              f"finish to verify the full shard set.")
        return

    loader = BucketedLoader(list_shards(args.save_dir, "train"), hps.train.train_batch_size,
                            mel_bucket=hps.dataset.mel_bucket,
                            text_bucket=hps.dataset.text_bucket, seed=hps.train.random_seed)
    batch = next(iter(loader.epoch(0)))
    print("sample batch:", "texts", batch.texts.shape, "mels", batch.mels.shape,
          "text_lens", batch.text_lengths[:4], "mel_lens", batch.mel_lengths[:4])
    print("distinct static shapes:", loader.shape_census())


if __name__ == "__main__":
    main()
