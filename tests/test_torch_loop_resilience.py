"""The training loop's SIGTERM handling, device data cache and prefetch
thread, on the CPU at tiny size:

* SIGTERM during epoch 2's first step (sent by that step itself): the step
  finishes, the rest of the epoch is discarded, epoch 1 (which the
  retention schedule had not saved) is checkpointed from its end-of-epoch
  copy, the run returns normally and the previous handler is back; the
  resumed run then ends exactly where an uninterrupted one does: the same
  train and dev losses and the same weights, bit for bit;
* the device data cache on gives the losses of the cache off, bit for bit;
* the cache's three gates, each with its exact message: one train batch
  shape (ON, with how the steps run over it), several shapes (OFF), and
  over the cap only once the dev split is counted (OFF);
* ``prefetch`` reaps its worker when the consumer abandons it.
"""

import dataclasses
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from vaenar_tts_torch.configs.hparams import HParams
from vaenar_tts_torch.configs.overrides import apply_overrides
from vaenar_tts_torch.data.records import RecordShardWriter
from vaenar_tts_torch.models.vaenar import VAENAR
from vaenar_tts_torch.training import loop
from vaenar_tts_torch.utils.checkpoint import CheckpointManager
from vaenar_tts_torch.utils.prefetch import prefetch

from test_torch_data import utterances
from test_torch_train_cli import TRAIN_OVERRIDES

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_split(path, mode, utts):
    w = RecordShardWriter(str(path / f"{mode}-0.vrs"), 80)
    for fid, text, mel in utts:
        w.add(fid, text, mel)
    w.close()


def one_shape_utts(n, seed):
    """Utterances whose mels all pad to 120 frames and texts to 32 tokens."""
    return [(fid, text[:28], mel[:100]) for fid, text, mel in utterances(n, seed)]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("records")
    write_split(out, "train", one_shape_utts(8, 1))
    write_split(out, "dev", one_shape_utts(3, 2))
    return out


def tiny(*extra):
    return apply_overrides(HParams(), TRAIN_OVERRIDES + ["train.checkpoint_every_n_epochs=5",
                                                         *extra])


def run(hp, records, model_dir, max_epochs, log_dir):
    return loop.train(hp, str(records), str(model_dir), str(log_dir), max_epochs=max_epochs,
                      device="cpu", draw_plots=False)


def test_sigterm_mid_epoch_checkpoints_and_resumes_exactly(records, tmp_path, monkeypatch):
    hp = tiny()
    whole = run(hp, records, tmp_path / "whole", 3, tmp_path / "logs_whole")
    real_step, calls = loop.train_step, []

    def step_then_signal(*args, **kwargs):
        out = real_step(*args, **kwargs)
        calls.append(1)
        if len(calls) == 4:  # the priming step, epoch 1's two, epoch 2's first
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    before = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(loop, "train_step", step_then_signal)
    cut = run(hp, records, tmp_path / "cut", 3, tmp_path / "logs_cut")
    monkeypatch.setattr(loop, "train_step", real_step)
    assert signal.getsignal(signal.SIGTERM) is before
    assert cut["stopped"] == "sigterm" and cut["epoch"] == 1 and list(cut["dev"]) == [1]
    assert len(calls) == 4
    assert sorted(os.listdir(tmp_path / "cut")) == ["0", "1", "hparams.json"]

    resumed = run(hp, records, tmp_path / "cut", 3, tmp_path / "logs_cut")
    assert resumed["initial"] is None and list(resumed["train"]) == [2, 3]
    for split in ("train", "dev"):
        for epoch in (2, 3):
            assert resumed[split][epoch] == whole[split][epoch], (split, epoch)
    models = []
    for name in ("whole", "cut"):
        model = VAENAR(hp)
        assert CheckpointManager(str(tmp_path / name)).restore(model) == 3
        models.append(model.state_dict())
    assert all(torch.equal(models[0][k], models[1][k]) for k in models[0])


def test_cache_on_equals_cache_off(records, tmp_path):
    off = run(tiny(), records, tmp_path / "off", 2, tmp_path / "logs_off")
    on = run(tiny("train.device_data_cache_mb=100"), records, tmp_path / "on", 2,
             tmp_path / "logs_on")
    assert on["cache"] and not off["cache"]
    assert on["initial"] == off["initial"]
    for split in ("train", "dev"):
        assert on[split] == off[split]


def _loaders(hp, path):
    train, dev, _ = loop.make_loaders(hp, str(path))
    return train, dev


def test_cache_gates_and_their_messages(records, tmp_path, capsys):
    hp = tiny("train.device_data_cache_mb=100")
    train, dev = _loaders(hp, records)
    train_mb, dev_mb = loop._split_mb(train), loop._split_mb(dev)
    # 2 train batches of 4 rows at (32, 120): 4 * (8 * 32 + 4 * 120 * 80 + 12)
    assert train_mb == 2 * 4 * (8 * 32 + 4 * 120 * 80 + 12) / 1e6
    assert dev_mb == 1 * 4 * (8 * 32 + 4 * 120 * 80 + 12) / 1e6
    train_cache, dev_cache = loop.device_cache(hp, train, dev, CPU)
    assert capsys.readouterr().out == (
        f"device data cache ON: 2 train batches ({train_mb:.3f} MB) + 1 dev batches "
        f"({dev_mb:.3f} MB), both counted against device_data_cache_mb=100, on cpu; "
        f"per-step dispatch over device gathers\n")
    assert [tuple(x.shape) for x in train_cache] == [(2, 4, 32), (2, 4, 120, 80), (2, 4), (2, 4)]
    assert len(dev_cache) == 1 and dev_cache[0][5] == 3

    # between the train split alone and train + dev: OFF, as the dev split counts
    cap = train_mb + dev_mb / 2
    hp_cap = dataclasses.replace(hp, train=dataclasses.replace(hp.train,
                                                               device_data_cache_mb=cap))
    assert train_mb < cap < train_mb + dev_mb
    assert loop.device_cache(hp_cap, train, dev, CPU) == (None, None)
    assert capsys.readouterr().out == (
        f"device data cache OFF: train {train_mb:.3f} MB + dev {dev_mb:.3f} MB "
        f"(the dev split counted) > device_data_cache_mb={cap}\n")

    mixed = tmp_path / "mixed"
    mixed.mkdir()
    write_split(mixed, "train", one_shape_utts(4, 3) + utterances(4, 4))
    write_split(mixed, "dev", one_shape_utts(2, 5))
    train_m, dev_m = _loaders(hp, mixed)
    n_shapes = len(train_m.shape_census())
    assert n_shapes > 1
    assert loop.device_cache(hp, train_m, dev_m, CPU) == (None, None)
    assert capsys.readouterr().out == (
        f"device data cache OFF: {n_shapes} static train batch shapes "
        f"(the cache needs exactly 1)\n")


def test_prefetch_reaps_an_abandoned_worker():
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    baseline = threading.active_count()
    it = prefetch(endless(), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    assert threading.active_count() == baseline + 1
    it.close()
    deadline = time.time() + 5.0
    while threading.active_count() > baseline and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == baseline
    n = len(produced)
    time.sleep(0.2)
    assert len(produced) == n  # nothing is assembled after the close
