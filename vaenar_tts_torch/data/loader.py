"""Bucketed, padded, seeded-shuffle batch loader (the port's copy of
``vaenar_tts_tpu/data/loader.py``).

Utterances are sorted by mel length and cut into batches; each epoch
shuffles the ORDER of those batches with ``seed + epoch``. Every batch is
padded to mel time a multiple of ``mel_bucket`` (divisible by every
reduction factor) and text a multiple of ``text_bucket``; a short last batch
is filled by repeating its last utterance, and ``n_valid`` says how many
rows are real.

Multi-process training: ``shard_index``/``shard_count`` take a round-robin
slice of the batch list; ``epoch_shape_schedule`` gives a process's natural
padded shapes for an epoch, which the processes max element-wise into one
lockstep schedule that ``epoch(shape_schedule=)`` pads to (and stops at);
``repad_batch`` re-pads a batch to another shape.

Static shapes: ``mel_len_cap`` drops the utterances whose mel is longer;
``fixed_text_max`` / ``fixed_mel_max`` pin every batch to one padded shape
(the device data cache and its graphed epoch need one), and a batch that
needs more than a pin raises before it is packed (the native packer has no
bounds check). ``max_text_len`` and ``max_mel_len`` are the longest kept
utterance's lengths.

Batches are gathered out of the shards by the native packer
(``vaenar_tts_torch/native``, one C++ call a batch) when it builds and
every shard's mels are float32, else by numpy; both give the same bytes, and
``packer`` says which one runs.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

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

    @property
    def shape_key(self) -> Tuple[int, int]:
        return (self.texts.shape[1], self.mels.shape[1])


def repad_batch(batch: Batch, text_max: int, mel_max: int) -> Batch:
    """A copy of ``batch`` at another padded shape (zero padding or a crop),
    its lengths clamped to fit: a process whose dev slice ran dry re-feeds
    its last batch as an n_valid = 0 dummy at the step's scheduled shape."""
    B = batch.texts.shape[0]
    texts = np.zeros((B, text_max), batch.texts.dtype)
    mels = np.zeros((B, mel_max, batch.mels.shape[2]), batch.mels.dtype)
    ct, cm = min(text_max, batch.texts.shape[1]), min(mel_max, batch.mels.shape[1])
    texts[:, :ct] = batch.texts[:, :ct]
    mels[:, :cm] = batch.mels[:, :cm]
    return Batch(batch.fids, texts, mels,
                 np.minimum(batch.text_lengths, text_max).astype(np.int32),
                 np.minimum(batch.mel_lengths, mel_max).astype(np.int32),
                 batch.n_valid)


class BucketedLoader:
    def __init__(self, shard_paths: Sequence[str], batch_size: int,
                 mel_bucket: int = 120, text_bucket: int = 32,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False,
                 shard_index: int = 0, shard_count: int = 1, native: bool = True,
                 mel_len_cap: Optional[int] = None, fixed_text_max: Optional[int] = None,
                 fixed_mel_max: Optional[int] = None):
        """``native=False`` gathers with numpy even where the native packer
        builds. ``mel_len_cap``, ``fixed_text_max`` and ``fixed_mel_max``:
        see the module's docstring."""
        self.readers = [RecordShardReader(p) for p in shard_paths]
        self.batch_size = batch_size
        self.mel_bucket = mel_bucket
        self.text_bucket = text_bucket
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.fixed_text_max = fixed_text_max
        self.fixed_mel_max = fixed_mel_max
        # (mel_len, text_len, reader, index), sorted by mel length
        self._entries = sorted(
            (int(r.mel_lens[i]), int(r.text_lens[i]), ri, i)
            for ri, r in enumerate(self.readers) for i in range(len(r))
            if mel_len_cap is None or int(r.mel_lens[i]) <= mel_len_cap)
        self.num_mels = self.readers[0].num_mels if self.readers else 0
        self._pack = None
        if native and all(r._mel_blob.dtype == np.float32 for r in self.readers):
            from ..native import get_batchpack
            self._pack = get_batchpack()
        if self._pack is not None:
            # (text address, text length, mel address, mel length) of every
            # utterance, reader by reader; the readers keep the maps alive
            self._sources = np.concatenate([np.stack(
                [r._text_blob.ctypes.data + 4 * r.text_offsets, r.text_lens,
                 r._mel_blob.ctypes.data + 4 * self.num_mels * r.mel_offsets, r.mel_lens],
                axis=1) for r in self.readers] or [np.zeros((0, 4), np.int64)])
            self._first_row = np.cumsum([0] + [len(r) for r in self.readers])

    @property
    def packer(self) -> str:
        """"native" when the C++ packer gathers this loader's batches, else
        "numpy" (the library did not build, a shard's mels are not float32,
        or ``native=False``)."""
        return "native" if self._pack is not None else "numpy"

    def _groups(self) -> List[list]:
        groups = [self._entries[i:i + self.batch_size]
                  for i in range(0, len(self._entries), self.batch_size)]
        if self.drop_last and groups and len(groups[-1]) < self.batch_size:
            groups.pop()
        return groups

    def __len__(self) -> int:
        return len(range(self.shard_index, len(self._groups()), self.shard_count))

    @property
    def num_utterances(self) -> int:
        return len(self._entries)

    @property
    def max_text_len(self) -> int:
        return max((t for (_, t, _, _) in self._entries), default=0)

    @property
    def max_mel_len(self) -> int:
        return max((m for (m, _, _, _) in self._entries), default=0)

    def _natural_shape(self, entries) -> Tuple[int, int]:
        return (pad_to_multiple(max(t for (_, t, _, _) in entries), self.text_bucket),
                pad_to_multiple(max(m for (m, _, _, _) in entries), self.mel_bucket))

    def _make_batch(self, entries: Sequence[Tuple[int, int, int, int]],
                    target_shape: Optional[Tuple[int, int]] = None) -> Batch:
        n_valid = len(entries)
        entries = list(entries) + [entries[-1]] * (self.batch_size - n_valid)
        need_t = max(t for (_, t, _, _) in entries)
        need_m = max(m for (m, _, _, _) in entries)
        if target_shape is not None:
            text_max, mel_max = int(target_shape[0]), int(target_shape[1])
        else:
            natural = self._natural_shape(entries)
            text_max = self.fixed_text_max if self.fixed_text_max is not None else natural[0]
            mel_max = self.fixed_mel_max if self.fixed_mel_max is not None else natural[1]
        if need_t > text_max or need_m > mel_max:
            # before packing: the native memcpy has no bounds check
            raise ValueError(f"batch needs (text {need_t}, mel {need_m}) but the loader is "
                             f"pinned to ({text_max}, {mel_max}); re-sync "
                             f"fixed_text_max/fixed_mel_max with the data")
        B = len(entries)
        texts = np.zeros((B, text_max), np.int32)
        mels = np.zeros((B, mel_max, self.num_mels), np.float32)
        t_lens = np.zeros((B,), np.int32)
        m_lens = np.zeros((B,), np.int32)
        fids = [self.readers[ri].fids[li] for (_, _, ri, li) in entries]
        if self._pack is not None:
            self._pack_native(entries, texts, mels, t_lens, m_lens)
        else:
            for row, (_, _, ri, li) in enumerate(entries):
                u = self.readers[ri].get(li)
                texts[row, :u.text_len] = u.text
                mels[row, :u.mel_len] = u.mel
                t_lens[row], m_lens[row] = u.text_len, u.mel_len
        return Batch(fids, texts, mels, t_lens, m_lens, n_valid)

    def _pack_native(self, entries, texts, mels, t_lens, m_lens) -> None:
        """The whole batch in one ``pack_rows`` call."""
        e = np.asarray(entries, np.int64)
        src = np.ascontiguousarray(self._sources[self._first_row[e[:, 2]] + e[:, 3]])
        self._pack(src.ctypes.data, len(src), self.num_mels, texts.ctypes.data,
                   texts.shape[1], mels.ctypes.data, mels.shape[1], t_lens.ctypes.data,
                   m_lens.ctypes.data)

    def _epoch_order(self, epoch_index: int) -> Tuple[list, np.ndarray]:
        groups = self._groups()
        order = np.arange(len(groups))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch_index).shuffle(order)
        return groups, order[self.shard_index::self.shard_count]

    def batch_order(self, epoch_index: int = 0) -> np.ndarray:
        """This process's shuffled order of the length-sorted batch groups
        for the epoch: indices into ``all_batches()``."""
        return self._epoch_order(epoch_index)[1]

    def all_batches(self) -> List[Batch]:
        """Every batch group in the base (length-sorted) order: index i here
        is the group that ``batch_order`` rows name i."""
        return [self._make_batch(g) for g in self._groups()]

    def epoch(self, epoch_index: int = 0,
              shape_schedule: Optional[np.ndarray] = None) -> Iterator[Batch]:
        """This process's batches of the epoch. ``shape_schedule`` (int
        [n_steps, 2] of (text_max, mel_max)) pads batch i to row i's shape,
        and the epoch ends after its last row (the lockstep step cap)."""
        groups, order = self._epoch_order(epoch_index)
        for i, gi in enumerate(order):
            target = None
            if shape_schedule is not None:
                if i >= len(shape_schedule):
                    return
                target = (int(shape_schedule[i][0]), int(shape_schedule[i][1]))
            yield self._make_batch(groups[gi], target_shape=target)

    def epoch_shape_schedule(self, epoch_index: int = 0,
                             n_steps: Optional[int] = None) -> np.ndarray:
        """This process's natural padded shapes for the epoch in iteration
        order, int64 [n, 2] of (text_max, mel_max), whatever the pins.
        ``n_steps`` pads by repeating the last row (a process whose slice
        runs dry re-feeds its last batch) or truncates, so that every
        process's array has one shape for the element-wise max."""
        groups, order = self._epoch_order(epoch_index)
        shapes = [self._natural_shape(groups[gi]) for gi in order]
        if n_steps is not None:
            if not shapes:
                raise ValueError("empty epoch cannot satisfy a lockstep schedule")
            shapes = (shapes + [shapes[-1]] * (n_steps - len(shapes)))[:n_steps]
        return np.asarray(shapes, np.int64).reshape(-1, 2)

    def __iter__(self) -> Iterator[Batch]:
        return self.epoch(0)

    def shape_census(self) -> dict:
        """The distinct padded (text_max, mel_max) shapes and their counts (a
        pinned loader's one shape: each pin, or the bucketed longest
        utterance where only the other dimension is pinned)."""
        if self.fixed_text_max is not None or self.fixed_mel_max is not None:
            return {(self.fixed_text_max if self.fixed_text_max is not None
                     else pad_to_multiple(self.max_text_len, self.text_bucket),
                     self.fixed_mel_max if self.fixed_mel_max is not None
                     else pad_to_multiple(self.max_mel_len, self.mel_bucket)): len(self._groups())}
        shapes: dict = {}
        for g in self._groups():
            key = self._natural_shape(g)
            shapes[key] = shapes.get(key, 0) + 1
        return shapes
