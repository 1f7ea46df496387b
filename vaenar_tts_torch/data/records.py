"""The sharded record store of {fid, text, mel} that training reads: the
port's numpy copy of the ``.vrs`` format of
``vaenar_tts_tpu/data/records.py``.

    [8B magic 'VAENARS1'][8B u64 header_len][JSON header]
    [text blob int32][mel blob f32/f16]

The JSON header carries the fids and each utterance's offsets and lengths,
so a reader memory-maps the two blobs and slices an utterance in O(1).
Shards are ``{mode}-{i}.vrs`` and are listed by file-name prefix.
``RecordWriter`` writes a preprocessed directory's train, dev and test
shards from its per-utterance ``texts/`` and ``mels/`` files.
"""

from __future__ import annotations

import json
import os
import shutil
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

MAGIC = b"VAENARS1"


@dataclass
class Utterance:
    fid: str
    text: np.ndarray  # int32 [text_len]
    mel: np.ndarray  # float32 [mel_len, num_mels]

    @property
    def text_len(self) -> int:
        return len(self.text)

    @property
    def mel_len(self) -> int:
        return self.mel.shape[0]


class RecordShardWriter:
    """Streams a shard to disk: text and mel blobs spill to sibling temp
    files during ``add`` and are joined after the JSON header on ``close``,
    under a temporary name renamed into place, so no reader ever sees half a
    shard."""

    def __init__(self, path: str, num_mels: int, mel_dtype: str = "float32"):
        self.path = path
        self.num_mels = num_mels
        self.mel_dtype = mel_dtype
        self._fids: List[str] = []
        self._text_lens: List[int] = []
        self._mel_lens: List[int] = []
        self._text_tmp = open(path + ".text.tmp", "wb")
        self._mel_tmp = open(path + ".mel.tmp", "wb")

    def add(self, fid: str, text: np.ndarray, mel: np.ndarray) -> None:
        if mel.ndim != 2 or mel.shape[1] != self.num_mels:
            raise ValueError(f"{fid}: mel must be [frames, {self.num_mels}], "
                             f"got {mel.shape}")
        text = np.ascontiguousarray(text, np.int32)
        mel = np.ascontiguousarray(mel, self.mel_dtype)
        self._fids.append(fid)
        self._text_lens.append(len(text))
        self._mel_lens.append(mel.shape[0])
        self._text_tmp.write(text.tobytes())
        self._mel_tmp.write(mel.tobytes())

    def close(self) -> None:
        self._text_tmp.close()
        self._mel_tmp.close()
        text_offsets = np.concatenate([[0], np.cumsum(self._text_lens)])[:-1]
        mel_offsets = np.concatenate([[0], np.cumsum(self._mel_lens)])[:-1]
        header = {
            "version": 1,
            "num_mels": self.num_mels,
            "mel_dtype": self.mel_dtype,
            "fids": self._fids,
            "text_lens": [int(x) for x in self._text_lens],
            "mel_lens": [int(x) for x in self._mel_lens],
            "text_offsets": [int(x) for x in text_offsets],
            "mel_offsets": [int(x) for x in mel_offsets],
        }
        header_bytes = json.dumps(header).encode("utf-8")
        part = self.path + ".part"
        with open(part, "wb") as f:
            f.write(MAGIC)
            f.write(np.uint64(len(header_bytes)).tobytes())
            f.write(header_bytes)
            for tmp_path in (self.path + ".text.tmp", self.path + ".mel.tmp"):
                with open(tmp_path, "rb") as tmp:
                    shutil.copyfileobj(tmp, f, length=1 << 24)
                os.remove(tmp_path)
        os.replace(part, self.path)


class RecordShardReader:
    """Memory-mapped reader over one shard."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            magic = f.read(8)
            if magic != MAGIC:
                raise ValueError(f"{path}: bad magic {magic!r}")
            header_len = int(np.frombuffer(f.read(8), np.uint64)[0])
            self.header = json.loads(f.read(header_len).decode("utf-8"))
            data_start = 16 + header_len
        h = self.header
        self.fids: List[str] = h["fids"]
        self.text_lens = np.asarray(h["text_lens"], np.int64)
        self.mel_lens = np.asarray(h["mel_lens"], np.int64)
        self.text_offsets = np.asarray(h["text_offsets"], np.int64)
        self.mel_offsets = np.asarray(h["mel_offsets"], np.int64)
        self.num_mels = h["num_mels"]
        self.mel_dtype = np.dtype(h["mel_dtype"])
        total_text = int(self.text_lens.sum())
        total_mel = int(self.mel_lens.sum())
        if total_text == 0:  # memmap rejects zero-length maps
            self._text_blob = np.zeros((0,), np.int32)
            self._mel_blob = np.zeros((0, self.num_mels), self.mel_dtype)
            return
        self._text_blob = np.memmap(path, dtype=np.int32, mode="r",
                                    offset=data_start, shape=(total_text,))
        self._mel_blob = np.memmap(path, dtype=self.mel_dtype, mode="r",
                                   offset=data_start + total_text * 4,
                                   shape=(total_mel, self.num_mels))

    def __len__(self) -> int:
        return len(self.fids)

    def get(self, i: int) -> Utterance:
        to, tl = self.text_offsets[i], self.text_lens[i]
        mo, ml = self.mel_offsets[i], self.mel_lens[i]
        return Utterance(fid=self.fids[i],
                         text=np.asarray(self._text_blob[to:to + tl]),
                         mel=np.asarray(self._mel_blob[mo:mo + ml], np.float32))


class RecordWriter:
    """The train, dev and test shards of a preprocessed directory: the
    fids of ``data_dir/{mode}.txt``, their ``texts/<fid>.npy`` and
    ``mels/<fid>.npy``; train is dealt round-robin over ``train_split``
    shards, dev and test go to one shard each."""

    def __init__(self, data_dir: str, save_dir: str, train_split: int = 8,
                 num_mels: int = 80, mel_dtype: str = "float32"):
        self.data_dir = data_dir
        self.save_dir = save_dir
        self.train_split = train_split
        self.num_mels = num_mels
        self.mel_dtype = mel_dtype

    def _parse_fids(self, mode: str) -> List[str]:
        with open(os.path.join(self.data_dir, f"{mode}.txt")) as f:
            return [line.strip() for line in f if line.strip()]

    def _get_features(self, fid: str) -> Tuple[np.ndarray, np.ndarray]:
        text = np.load(os.path.join(self.data_dir, "texts", f"{fid}.npy"))
        mel = np.load(os.path.join(self.data_dir, "mels", f"{fid}.npy"))
        return text, mel

    def write(self, mode: str = "train", worker_index: int = 0,
              worker_count: int = 1) -> List[str]:
        """Write this mode's shards and return their paths. With
        ``worker_count`` > 1 this worker writes only the train shards
        ``worker_index::worker_count``; dev and test fall to worker 0."""
        os.makedirs(self.save_dir, exist_ok=True)
        fids = self._parse_fids(mode)
        if mode == "train":
            split_fids = list(enumerate(
                fids[i::self.train_split] for i in range(self.train_split)))
            if worker_count > 1:
                split_fids = split_fids[worker_index::worker_count]
        else:
            split_fids = [(0, fids)] if worker_index == 0 else []
        paths = []
        for i, ids in split_fids:
            path = os.path.join(self.save_dir, f"{mode}-{i}.vrs")
            w = RecordShardWriter(path, self.num_mels, self.mel_dtype)
            for fid in ids:
                w.add(fid, *self._get_features(fid))
            w.close()
            paths.append(path)
        return paths

    def write_all(self, worker_index: int = 0,
                  worker_count: int = 1) -> Dict[str, List[str]]:
        return {mode: self.write(mode, worker_index, worker_count)
                for mode in ("train", "dev", "test")}


def list_shards(save_dir: str, mode: str) -> List[str]:
    """The shards of one split (``train``, ``dev``, ``test``), sorted."""
    return sorted(os.path.join(save_dir, f) for f in os.listdir(save_dir)
                  if f.startswith(mode) and f.endswith(".vrs"))
