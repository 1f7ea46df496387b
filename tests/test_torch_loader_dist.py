"""The port's loader in its multi-process and native forms, held against the
JAX package's numpy loader (``vaenar_tts_tpu/data/loader.py``) on the same
shards: the round-robin batch slice (``shard_index``/``shard_count``), the
lockstep shape schedule (padded and truncated), ``epoch(shape_schedule=)``
and its step cap, ``repad_batch``; the native packer's batches against the
numpy path's, to the byte, at natural and scheduled shapes, and
``packer``; ``partition_shards``. The static-shape pins (``mel_len_cap``,
``fixed_text_max``, ``fixed_mel_max``) against the JAX loader's, in one
process and in a round-robin slice: the kept utterances, ``max_text_len``,
``max_mel_len``, ``shape_census`` and every batch; a stale pin raises the
JAX loader's ``ValueError`` before packing.
"""

import os

import numpy as np
import pytest

from vaenar_tts_tpu.data.loader import BucketedLoader as JaxLoader
from vaenar_tts_tpu.data.loader import repad_batch as jax_repad
from vaenar_tts_tpu.parallel.distributed import partition_shards as jax_partition
from vaenar_tts_torch import native
from vaenar_tts_torch.data.loader import BucketedLoader, repad_batch
from vaenar_tts_torch.data.records import RecordShardWriter, list_shards
from vaenar_tts_torch.parallel.distributed import partition_shards

FIELDS = ("texts", "mels", "text_lengths", "mel_lengths")


def write_shard(path, n, seed, mel_dtype="float32"):
    rng = np.random.default_rng(seed)
    w = RecordShardWriter(str(path), 80, mel_dtype)
    for i in range(n):
        tl = int(rng.integers(6, 40))
        ml = int(round(9.0 * tl * rng.uniform(0.8, 1.2)))
        w.add(f"u{seed}-{i:02d}", rng.integers(3, 43, tl).astype(np.int32),
              rng.uniform(0, 1, (ml, 80)).astype(np.float32))
    w.close()


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("loader_dist")
    for i in range(3):
        write_shard(root / f"train-{i}.vrs", 9, 40 + i)
    write_shard(root / "dev-0.vrs", 5, 50, mel_dtype="float16")
    return root


def loaders(paths, **kw):
    args = dict(batch_size=3, mel_bucket=60, text_bucket=16, seed=3, **kw)
    return BucketedLoader(paths, **args), JaxLoader(paths, **args)


def assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.fids == b.fids and a.n_valid == b.n_valid and a.shape_key == b.shape_key
        for name in FIELDS:
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("shard_index", [0, 1, 2])
def test_round_robin_slices_and_schedules_match_jax(shards, shard_index):
    paths = list_shards(str(shards), "train")
    port, ref = loaders(paths, shard_index=shard_index, shard_count=3, drop_last=True)
    assert len(port) == len(ref) and port.num_utterances == ref.num_utterances
    for epoch in (0, 1):
        np.testing.assert_array_equal(port.batch_order(epoch), ref.batch_order(epoch))
        assert_batches_equal(list(port.epoch(epoch)), list(ref.epoch(epoch)))
        natural = port.epoch_shape_schedule(epoch)
        np.testing.assert_array_equal(natural, ref.epoch_shape_schedule(epoch))
        assert natural.dtype == np.int64 and natural.shape == (len(port), 2)
        for n_steps in (len(port) + 2, max(1, len(port) - 1)):  # padded, truncated
            sched = port.epoch_shape_schedule(epoch, n_steps=n_steps)
            np.testing.assert_array_equal(sched, ref.epoch_shape_schedule(epoch, n_steps=n_steps))
            assert len(sched) == n_steps
    # a lockstep schedule: larger shapes than the natural ones, cut a step short
    sched = port.epoch_shape_schedule(1) + np.array([16, 60])
    sched = sched[:len(sched) - 1]
    got, want = list(port.epoch(1, shape_schedule=sched)), list(ref.epoch(1, shape_schedule=sched))
    assert_batches_equal(got, want)
    assert [b.shape_key for b in got] == [tuple(s) for s in sched.tolist()]


def test_repad_batch_matches_jax(shards):
    port, ref = loaders(list_shards(str(shards), "train"), shuffle=False)
    a, b = next(iter(port.epoch(0))), next(iter(ref.epoch(0)))
    for text_max, mel_max in ((a.texts.shape[1] + 16, a.mels.shape[1] + 60),
                              (4, 30)):  # pad, and crop with the lengths clamped
        assert_batches_equal([repad_batch(a, text_max, mel_max)],
                             [jax_repad(b, text_max, mel_max)])


def test_a_schedule_below_a_batch_raises_before_packing(shards):
    paths = list_shards(str(shards), "train")
    port, ref = loaders(paths, shuffle=False)
    short = port.epoch_shape_schedule(0) - np.array([0, 60])
    for loader in (port, ref):
        with pytest.raises(ValueError):
            list(loader.epoch(0, shape_schedule=short))


def test_native_batches_equal_numpy_to_the_byte(shards):
    paths = list_shards(str(shards), "train")
    fast = BucketedLoader(paths, 4, 60, 16, seed=1)
    slow = BucketedLoader(paths, 4, 60, 16, seed=1, native=False)
    assert (fast.packer, slow.packer) == ("native", "numpy")
    lib = native.library_path()
    assert os.path.isfile(lib) and os.path.basename(os.path.dirname(lib)).startswith("native-")
    assert os.path.dirname(os.path.dirname(lib)).endswith(os.path.join("vaenar_tts_torch",
                                                                       "_build"))
    for epoch in (0, 1):
        got, want = list(fast.epoch(epoch)), list(slow.epoch(epoch))
        assert_batches_equal(got, want)
        sched = fast.epoch_shape_schedule(epoch) + np.array([16, 60])
        got += list(fast.epoch(epoch, shape_schedule=sched))
        want += list(slow.epoch(epoch, shape_schedule=sched))
        for a, b in zip(got, want):
            for name in FIELDS:
                assert getattr(a, name).tobytes() == getattr(b, name).tobytes()
    assert_batches_equal(fast.all_batches(), slow.all_batches())


def test_packer_says_which_path_runs(shards, monkeypatch):
    # float16 mels: the native memcpy gathers float32 only
    assert BucketedLoader(list_shards(str(shards), "dev"), 2).packer == "numpy"
    # no library (no compiler, a read-only tree): numpy, and it says so
    monkeypatch.setattr(native, "get_batchpack", lambda: None)
    assert BucketedLoader(list_shards(str(shards), "train"), 2).packer == "numpy"


def test_partition_shards_matches_jax():
    paths = [f"train-{i}.vrs" for i in (3, 0, 7, 1, 5, 2, 6, 4)]
    for count in (1, 2, 3, 8):
        parts = [partition_shards(paths, i, count) for i in range(count)]
        assert parts == [jax_partition(paths, index=i, count=count) for i in range(count)]
        assert sorted(sum(parts, [])) == sorted(paths)
        assert all(not set(a) & set(b) for i, a in enumerate(parts) for b in parts[i + 1:])
    for fn in (lambda: partition_shards(["x.vrs"], 1, 2),
               lambda: jax_partition(["x.vrs"], index=1, count=2)):
        with pytest.raises(ValueError, match="no record shards to own"):
            fn()


PINS = {"cap": dict(mel_len_cap=250),
        "pinned": dict(fixed_text_max=48, fixed_mel_max=480),
        "text_pin": dict(fixed_text_max=48),
        "cap_and_mel_pin": dict(mel_len_cap=200, fixed_mel_max=240)}


@pytest.mark.parametrize("shard_index", [None, 0, 1])
@pytest.mark.parametrize("pins", sorted(PINS))
def test_pins_match_jax(shards, pins, shard_index):
    paths = list_shards(str(shards), "train")
    kw = dict(PINS[pins])
    if shard_index is not None:
        kw.update(shard_index=shard_index, shard_count=2)
    port, ref = loaders(paths, **kw)
    assert (port.num_utterances, port.max_text_len, port.max_mel_len) == (
        ref.num_utterances, ref.max_text_len, ref.max_mel_len)
    assert len(port) == len(ref) and port.shape_census() == ref.shape_census()
    if "mel_len_cap" in kw:
        assert port.max_mel_len <= kw["mel_len_cap"] < loaders(paths)[0].max_mel_len
    if "fixed_mel_max" in kw:
        assert len(port.shape_census()) == 1
    for epoch in (0, 1):
        assert_batches_equal(list(port.epoch(epoch)), list(ref.epoch(epoch)))
    assert_batches_equal(port.all_batches(), ref.all_batches())


def test_a_stale_pin_raises_as_jax_does(shards):
    paths = list_shards(str(shards), "train")
    errors = []
    for loader in loaders(paths, fixed_text_max=16, fixed_mel_max=480):
        with pytest.raises(ValueError, match="re-sync fixed_text_max/fixed_mel_max") as e:
            list(loader.epoch(0))
        errors.append(str(e.value))
    assert errors[0] == errors[1]
