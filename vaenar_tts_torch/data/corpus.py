"""Corpus preprocessing: text analysis, the train/dev/test split and mel
extraction (the port's copy of ``vaenar_tts_tpu/data/corpus.py``, with the
same seeds and file formats).

* ``feature_extraction`` is idempotent: a directory whose lists and mels
  are complete is read back, not rebuilt;
* the split sorts the utterances by text length and draws one dev
  utterance from each run of ``len // dev_size`` of them, then the test
  utterances the same way, with ``numpy.random.default_rng(20260816)``;
* mels are ``mels/<fid>.npy`` of [frames, num_mels] float32, and the token
  ids ``texts/<fid>.npy``; ``texts.pkl`` maps fid to ids;
* host extraction runs ``audio.dsp`` on a pool of spawned processes (a
  fork of a process that holds threads or a CUDA context can deadlock);
  device extraction
  (``use_device``) runs ``ops.stft.batched_melspectrogram`` on a torch
  device, ``cuda`` unless the caller asks for the CPU, on batches of
  utterances that were pre-emphasized and reflect-padded one by one on the
  host, so that each frame sees its own signal and not the batch's padding.

``LJSpeechCorpus`` reads ``metadata.csv`` (fid|text|normalized text);
``DataBakerCorpus`` reads the alternating hanzi and pinyin lines of
``000001-010000.txt`` through ``text.pinyin.parse_cn_prosody_label``.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..audio.dsp import AudioProcessor
from ..configs.hparams import HParams
from ..text.pinyin import parse_cn_prosody_label
from ..text.tokenizer import CharTokenizer


def _extract_one(args) -> str:
    wav_f, mel_dir, cfg = args
    ap = AudioProcessor(cfg)
    wav_arr = ap.load_wav(wav_f)
    wav_arr = ap.preemphasize(wav_arr)
    mels = ap.melspectrogram(wav_arr)
    fid = os.path.basename(wav_f).rsplit(".", 1)[0]
    _atomic_save(os.path.join(mel_dir, fid + ".npy"), mels.T.astype(np.float32))
    return fid


def _atomic_save(path: str, arr: np.ndarray) -> None:
    """``np.save`` to a temporary name, renamed into place: a worker killed
    mid-write leaves no truncated file for the resume check to trust."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # a file object: np.save must not append .npy
        np.save(f, arr)
    os.replace(tmp, path)


def pad_ragged(ys, n_fft: int, bucket: int = 1) -> np.ndarray:
    """Signals as one batch for a ``center=False`` STFT: each reflect-padded
    by n_fft // 2 on both sides, as a centered STFT pads it alone, then
    zero-padded to the longest, rounded up to a multiple of ``bucket``:
    [B, T] float32. A signal of n samples keeps its 1 + n // hop frames."""
    padded = [np.pad(y, n_fft // 2, mode="reflect") for y in ys]
    width = -(-max(map(len, padded)) // bucket) * bucket
    out = np.zeros((len(ys), width), np.float32)
    for i, y in enumerate(padded):
        out[i, :len(y)] = y
    return out


class TextMelCorpus:
    """The dataset-independent preprocessing pipeline; subclasses supply
    ``text_process`` and ``text_to_array``."""

    def __init__(self, data_root: Optional[str], save_dir: Optional[str], hps: HParams,
                 split_seed: int = 20260816):
        self.data_root = data_root
        self.save_dir = save_dir
        self.hps = hps
        self.split_seed = split_seed
        self.text_dict_f = os.path.join(save_dir, "texts.pkl") if save_dir else None
        self.mel_dir = os.path.join(save_dir, "mels") if save_dir else None
        self.text_dir = os.path.join(save_dir, "texts") if save_dir else None
        self.train_list_f = os.path.join(save_dir, "train.txt") if save_dir else None
        self.dev_list_f = os.path.join(save_dir, "dev.txt") if save_dir else None
        self.test_list_f = os.path.join(save_dir, "test.txt") if save_dir else None
        self.tokenizer = CharTokenizer(hps.text)
        self.audio_processor = AudioProcessor(hps.audio)
        self.text_dict: Optional[Dict[str, List[int]]] = None

    def feature_extraction(self, num_workers: Optional[int] = None,
                           use_device: bool = False, worker_index: int = 0,
                           worker_count: int = 1, wait_timeout: float = 3600.0,
                           device="cuda") -> None:
        """Idempotent preprocessing, optionally split over workers that
        share ``save_dir``: worker 0 processes the text and writes the split,
        the others wait for its list files, then every worker extracts the
        mels of its round-robin slice of the sorted wav list (on ``device``
        with ``use_device``)."""
        if self.feats_extract_finish():
            print("Features already exist!")
            with open(self.text_dict_f, "rb") as f:
                self.text_dict = pickle.load(f)
            return
        self._validate_dir()
        if worker_index == 0:
            print("Processing text...")
            self.text_dict = self.text_process()
            print("Splitting into train/dev/test...")
            self.dataset_split()
        else:
            self._wait_for_lists(wait_timeout)
            with open(self.text_dict_f, "rb") as f:
                self.text_dict = pickle.load(f)
        print("Extracting mel-spectrograms...")
        self.extract_mels(num_workers=num_workers, use_device=use_device,
                          worker_index=worker_index, worker_count=worker_count,
                          device=device)

    def _list_files(self) -> List[str]:
        return [self.text_dict_f, self.train_list_f, self.dev_list_f, self.test_list_f]

    def _wait_for_lists(self, timeout: float) -> None:
        t0 = time.time()
        while any(not os.path.isfile(f) for f in self._list_files()):
            if time.time() - t0 > timeout:
                raise TimeoutError(f"worker waited {timeout}s for worker 0's split files")
            time.sleep(1.0)

    def _validate_dir(self) -> None:
        if not os.path.isdir(self.data_root):
            raise FileNotFoundError(f"no corpus directory {self.data_root}")
        for d in (self.save_dir, self.mel_dir, self.text_dir):
            os.makedirs(d, exist_ok=True)

    def feats_extract_finish(self) -> bool:
        """Whether the lists exist and every listed fid has its mel."""
        if (any(not os.path.isfile(f) for f in self._list_files())
                or not os.path.isdir(self.mel_dir) or not os.path.isdir(self.text_dir)):
            return False
        for f in (self.train_list_f, self.dev_list_f, self.test_list_f):
            with open(f) as rf:
                for line in rf:
                    utt_id = line.strip()
                    if not os.path.isfile(os.path.join(self.mel_dir, f"{utt_id}.npy")):
                        print(f"{utt_id}.npy missing, re-extracting")
                        return False
        return True

    def dataset_split(self) -> Tuple[int, int, int]:
        """Write ``train.txt``, ``dev.txt`` and ``test.txt``; return their
        sizes."""
        with open(self.text_dict_f, "rb") as f:
            text_dict = pickle.load(f)
        rng = np.random.default_rng(self.split_seed)
        dev_set, test_set = [], []
        utt_ids = [k for k, t in sorted(text_dict.items(), key=lambda x: len(x[1]))]
        data_size = len(utt_ids)
        dev_size = max(1, int(self.hps.dataset.dev_set_rate * data_size))
        test_size = max(1, int(self.hps.dataset.test_set_rate * data_size))
        dev_rate = data_size // dev_size
        for i in range(0, data_size, dev_rate):
            dev_set.append(rng.choice(utt_ids[i:i + dev_rate]))
        for item in dev_set:
            utt_ids.remove(item)
        data_size = len(utt_ids)
        test_rate = data_size // test_size
        for i in range(0, data_size, test_rate):
            test_set.append(rng.choice(utt_ids[i:i + test_rate]))
        for item in test_set:
            utt_ids.remove(item)
        train_set = utt_ids
        for path, ids in ((self.train_list_f, train_set), (self.dev_list_f, dev_set),
                          (self.test_list_f, test_set)):
            with open(path, "w") as f:
                for idx in ids:
                    f.write(f"{idx}\n")
        return len(train_set), len(dev_set), len(test_set)

    def get_wav_files(self, ext: str = ".wav") -> List[str]:
        wav_files = []
        for root, _dirs, files in os.walk(self.data_root, followlinks=True):
            for basename in files:
                if basename.endswith(ext):
                    wav_files.append(os.path.join(root, basename))
        return wav_files

    def extract_mels(self, num_workers: Optional[int] = None, use_device: bool = False,
                     worker_index: int = 0, worker_count: int = 1, device="cuda") -> None:
        wav_list = sorted(self.get_wav_files())
        if worker_count > 1:  # this worker's slice, in a fixed order
            wav_list = wav_list[worker_index::worker_count]
            print(f"  worker {worker_index}/{worker_count}: {len(wav_list)} wavs")
        if use_device:
            self._extract_mels_device(wav_list, device=device)
            return
        if num_workers is None:  # 0 means serial, not the default pool
            num_workers = min(32, os.cpu_count() or 1)
        tasks = [(w, self.mel_dir, self.hps.audio) for w in wav_list]
        if num_workers <= 1:
            for t in tasks:
                _extract_one(t)
        else:
            with ProcessPoolExecutor(max_workers=num_workers,
                                     mp_context=multiprocessing.get_context("spawn")) as ex:
                for i, _ in enumerate(ex.map(_extract_one, tasks, chunksize=16)):
                    if (i + 1) % 1000 == 0:
                        print(f"  extracted {i + 1}/{len(tasks)}")

    def _extract_mels_device(self, wav_list, batch_size: int = 32, device="cuda") -> None:
        """Batched mel extraction on a torch device: the wavs sorted by file
        size, each utterance pre-emphasized on the host and batched by
        ``pad_ragged`` to a multiple of hop · 64 samples (coarse buckets:
        few distinct shapes over a corpus), the mels taken with
        ``center=False``, and each row trimmed to its own frames. ``cuda``
        without a card raises."""
        import torch

        from ..models.vaenar import resolve_device
        from ..ops.stft import batched_melspectrogram
        dev = resolve_device(device)
        cfg = self.hps.audio
        hop, n_fft = cfg.frame_shift_sample, cfg.n_fft
        # file size is proportional to the PCM length: near-uniform batches
        # without loading every wav first (peak memory is one batch)
        wav_list = sorted(wav_list, key=os.path.getsize)
        for i in range(0, len(wav_list), batch_size):
            fids, ys = [], []
            for wav_f in wav_list[i:i + batch_size]:
                fids.append(os.path.basename(wav_f).rsplit(".", 1)[0])
                y = self.audio_processor.load_wav(wav_f)
                ys.append(self.audio_processor.preemphasize(y).astype(np.float32))
            batch = pad_ragged(ys, n_fft, bucket=hop * 64)
            with torch.no_grad():
                mels = batched_melspectrogram(torch.from_numpy(batch).to(dev), cfg,
                                              apply_preemphasis=False, center=False)
            mels = mels.cpu().numpy().astype(np.float32)
            for j, (fid, y) in enumerate(zip(fids, ys)):
                _atomic_save(os.path.join(self.mel_dir, fid + ".npy"),
                             np.ascontiguousarray(mels[j, :1 + len(y) // hop]))
            if (i // batch_size) % 20 == 0:
                print(f"  device-extracted {min(i + batch_size, len(wav_list))}/"
                      f"{len(wav_list)} on {dev}")

    def text_process(self) -> Dict[str, List[int]]:
        raise NotImplementedError

    def text_to_array(self, text: str) -> List[int]:
        raise NotImplementedError

    def _save_texts(self, text_dict: Dict[str, List[int]]) -> None:
        with open(self.text_dict_f, "wb") as f:
            pickle.dump(text_dict, f, protocol=pickle.HIGHEST_PROTOCOL)


class LJSpeechCorpus(TextMelCorpus):
    """LJSpeech: ``metadata.csv``, pipe-separated, the third column the
    normalized text."""

    def text_process(self) -> Dict[str, List[int]]:
        text_dict: Dict[str, List[int]] = {}
        with open(os.path.join(self.data_root, "metadata.csv"), encoding="utf-8") as rf:
            for line in rf:
                lst = line.strip().split("|")
                if len(lst) < 3:
                    continue
                seq = self.text_to_array(lst[2])
                text_dict[lst[0]] = seq
                np.save(os.path.join(self.text_dir, f"{lst[0]}.npy"), np.asarray(seq, np.int32))
        self._save_texts(text_dict)
        return text_dict

    def text_to_array(self, text: str) -> List[int]:
        return self.tokenizer.encode_english(text)


class DataBakerCorpus(TextMelCorpus):
    """DataBaker: alternating hanzi and pinyin lines in
    ``000001-010000.txt``."""

    def text_process(self) -> Dict[str, List[int]]:
        text_dict: Dict[str, List[int]] = {}
        fid, text = None, None
        with open(os.path.join(self.data_root, "000001-010000.txt"), encoding="utf-8") as f:
            for line in f:
                if line[0].isdigit():
                    fid = line[:6]
                    text = line
                else:
                    py_seq = parse_cn_prosody_label(text, line)
                    if py_seq is None:
                        continue
                    seq = self.tokenizer.encode(py_seq.lower())
                    text_dict[fid] = seq
                    np.save(os.path.join(self.text_dir, f"{fid}.npy"), np.asarray(seq, np.int32))
        self._save_texts(text_dict)
        return text_dict

    def text_to_array(self, text: str) -> List[int]:
        from ..text.pinyin import text_to_pinyin
        return self.tokenizer.encode(text_to_pinyin(text))


CORPORA = {
    "ljspeech": LJSpeechCorpus,
    "databaker": DataBakerCorpus,
}
