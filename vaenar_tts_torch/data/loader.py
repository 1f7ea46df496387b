"""Bucketed, padded, seeded-shuffle batch loader (the port's numpy copy of
``vaenar_tts_tpu/data/loader.py``, single process, without the native
packer).

Utterances are sorted by mel length and cut into batches; each epoch
shuffles the ORDER of those batches with ``seed + epoch``. Every batch is
padded to mel time a multiple of ``mel_bucket`` (divisible by every
reduction factor) and text a multiple of ``text_bucket``; a short last batch
is filled by repeating its last utterance, and ``n_valid`` says how many
rows are real.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from .records import RecordShardReader


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclasses.dataclass
class Batch:
    fids: List[str]
    texts: np.ndarray  # int32 [batch, text_max]
    mels: np.ndarray  # float32 [batch, mel_max, num_mels]
    text_lengths: np.ndarray  # int32 [batch]
    mel_lengths: np.ndarray  # int32 [batch]
    n_valid: int  # rows past this one repeat the last real utterance


class BucketedLoader:
    def __init__(self, shard_paths: Sequence[str], batch_size: int,
                 mel_bucket: int = 120, text_bucket: int = 32,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False):
        self.readers = [RecordShardReader(p) for p in shard_paths]
        self.batch_size = batch_size
        self.mel_bucket = mel_bucket
        self.text_bucket = text_bucket
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        # (mel_len, text_len, reader, index), sorted by mel length
        self._entries = sorted(
            (int(r.mel_lens[i]), int(r.text_lens[i]), ri, i)
            for ri, r in enumerate(self.readers) for i in range(len(r)))
        self.num_mels = self.readers[0].num_mels if self.readers else 0

    def _groups(self) -> List[list]:
        groups = [self._entries[i:i + self.batch_size]
                  for i in range(0, len(self._entries), self.batch_size)]
        if self.drop_last and groups and len(groups[-1]) < self.batch_size:
            groups.pop()
        return groups

    def __len__(self) -> int:
        return len(self._groups())

    @property
    def num_utterances(self) -> int:
        return len(self._entries)

    def _make_batch(self, entries: Sequence[Tuple[int, int, int, int]]) -> Batch:
        n_valid = len(entries)
        entries = list(entries) + [entries[-1]] * (self.batch_size - n_valid)
        text_max = pad_to_multiple(max(t for (_, t, _, _) in entries), self.text_bucket)
        mel_max = pad_to_multiple(max(m for (m, _, _, _) in entries), self.mel_bucket)
        B = len(entries)
        texts = np.zeros((B, text_max), np.int32)
        mels = np.zeros((B, mel_max, self.num_mels), np.float32)
        t_lens = np.zeros((B,), np.int32)
        m_lens = np.zeros((B,), np.int32)
        fids = []
        for row, (_, _, ri, li) in enumerate(entries):
            u = self.readers[ri].get(li)
            texts[row, :u.text_len] = u.text
            mels[row, :u.mel_len] = u.mel
            t_lens[row], m_lens[row] = u.text_len, u.mel_len
            fids.append(u.fid)
        return Batch(fids, texts, mels, t_lens, m_lens, n_valid)

    def batch_order(self, epoch_index: int = 0) -> np.ndarray:
        """The epoch's shuffled order of the length-sorted batch groups."""
        order = np.arange(len(self))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch_index).shuffle(order)
        return order

    def all_batches(self) -> List[Batch]:
        """Every batch group in the base (length-sorted) order: index i here
        is the group that ``batch_order`` rows name i."""
        return [self._make_batch(g) for g in self._groups()]

    def epoch(self, epoch_index: int = 0) -> Iterator[Batch]:
        groups = self._groups()
        for gi in self.batch_order(epoch_index):
            yield self._make_batch(groups[gi])

    def shape_census(self) -> dict:
        """The distinct padded (text_max, mel_max) shapes and their counts."""
        shapes: dict = {}
        for g in self._groups():
            key = (pad_to_multiple(max(t for (_, t, _, _) in g), self.text_bucket),
                   pad_to_multiple(max(m for (m, _, _, _) in g), self.mel_bucket))
            shapes[key] = shapes.get(key, 0) + 1
        return shapes
