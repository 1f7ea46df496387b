"""The port's record shards, batch loader, weight export and checkpoints
against the JAX package's formats.

* A shard written by the JAX package's ``RecordShardWriter`` reads back
  through the port's reader, and one written by the port reads back through
  both readers, exactly.
* ``BucketedLoader`` yields the JAX loader's batches for one seed, in the
  same order, with the same padding and repeat-padded tail.
* The JAX package's ``load_npz`` reads the port's ``save_npz`` of the
  shipped weights leaf for leaf, dtypes included.
* Checkpoints restore the model, BatchNorm buffers and Adam's state, and
  keep the newest ``max_to_keep``.
"""

import os

import numpy as np
import pytest
import torch

from vaenar_tts_tpu.data.loader import BucketedLoader as JaxLoader
from vaenar_tts_tpu.data.records import RecordShardReader as JaxReader
from vaenar_tts_tpu.data.records import RecordShardWriter as JaxWriter
from vaenar_tts_tpu.utils.export import load_npz as jax_load_npz
from vaenar_tts_torch.configs.hparams import HParams
from vaenar_tts_torch.configs.overrides import apply_overrides
from vaenar_tts_torch.data.loader import BucketedLoader
from vaenar_tts_torch.data.records import RecordShardReader, RecordShardWriter, list_shards
from vaenar_tts_torch.interop.weights import flatten, torch_to_jax
from vaenar_tts_torch.models.vaenar import load_model
from vaenar_tts_torch.training.steps import init_model, make_optimizer
from vaenar_tts_torch.utils.checkpoint import CheckpointManager
from vaenar_tts_torch.utils.export import save_npz

from test_torch_model import TINY_OVERRIDES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(REPO, "artifacts", "toyv2_q90", "ckpt")


def utterances(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        tl = int(rng.integers(12, 33))
        ml = min(370, int(tl * rng.uniform(7.0, 11.0)))
        out.append((f"u{seed}-{i:03d}", rng.integers(3, 43, tl).astype(np.int32),
                    rng.uniform(0, 1, (ml, 80)).astype(np.float32)))
    return out


def write(writer_cls, path, utts, mel_dtype="float32"):
    w = writer_cls(path, 80, mel_dtype)
    for fid, text, mel in utts:
        w.add(fid, text, mel)
    w.close()


@pytest.mark.parametrize("mel_dtype", ["float32", "float16"])
def test_shards_read_across_packages(tmp_path, mel_dtype):
    utts = utterances(5, seed=1)
    for writer, readers in ((JaxWriter, (RecordShardReader,)),
                            (RecordShardWriter, (RecordShardReader, JaxReader))):
        path = str(tmp_path / f"{writer.__module__.split('.')[0]}-{mel_dtype}.vrs")
        write(writer, path, utts, mel_dtype)
        for reader in readers:
            r = reader(path)
            assert len(r) == len(utts)
            for i, (fid, text, mel) in enumerate(utts):
                u = r.get(i)
                assert u.fid == fid
                np.testing.assert_array_equal(u.text, text)
                np.testing.assert_array_equal(u.mel, mel.astype(mel_dtype).astype(np.float32))


def test_loader_matches_jax(tmp_path):
    for i in range(2):
        write(RecordShardWriter, str(tmp_path / f"train-{i}.vrs"), utterances(7, seed=10 + i))
    write(RecordShardWriter, str(tmp_path / "dev-0.vrs"), utterances(4, seed=20))
    for mode, kw in (("train", dict(shuffle=True, drop_last=True)),
                     ("dev", dict(shuffle=False))):
        paths = list_shards(str(tmp_path), mode)
        args = dict(batch_size=3, mel_bucket=60, text_bucket=8, seed=5, **kw)
        port, ref = BucketedLoader(paths, **args), JaxLoader(paths, **args)
        assert len(port) == len(ref) and port.shape_census() == ref.shape_census()
        for epoch in (0, 1):
            got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                assert a.fids == b.fids and a.n_valid == b.n_valid
                for name in ("texts", "mels", "text_lengths", "mel_lengths"):
                    np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert got[-1].n_valid == 1  # the dev tail is repeat-padded


def test_save_npz_reads_in_jax(tmp_path):
    _, model, epoch = load_model(SHIPPED, device="cpu")
    params, stats = torch_to_jax(model)
    path = save_npz(str(tmp_path / "export.npz"),
                    {"params": params, "batch_stats": stats, "epoch": epoch})
    got, want = jax_load_npz(path), jax_load_npz(os.path.join(SHIPPED, "export.npz"))
    assert got["epoch"] == want["epoch"] == 1700
    for name in ("params", "batch_stats"):
        g, w = flatten(got[name]), flatten(want[name])
        assert set(g) == set(w)
        for key in w:
            assert g[key].dtype == w[key].dtype and g[key].shape == w[key].shape, key
            # both stored as float16: the shipped leaves round-trip exactly
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_checkpoint_restores_and_keeps_the_newest(tmp_path):
    hp = apply_overrides(HParams(), [o for o in TINY_OVERRIDES
                                     if not o.startswith("train.")])
    model = init_model(hp, 0, "cpu")
    opt = make_optimizer(hp, model)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    with torch.no_grad():
        model.decoder.postnet.conv_0.batch_norm.running_var.fill_(3.0)
    ckpt = CheckpointManager(str(tmp_path), max_to_keep=2, keep_every_n_hours=1e6)
    for epoch in (0, 1, 2, 3):
        ckpt.save(epoch, model, opt)
    # the oldest stays as the time-kept anchor, 1 goes, the newest 2 stay
    assert ckpt.epochs() == [0, 2, 3]
    fresh = init_model(hp, 1, "cpu")
    fresh_opt = make_optimizer(hp, fresh)
    assert ckpt.restore(fresh, fresh_opt) == 3
    for (name, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), name
    assert fresh_opt.state_dict()["state"][0]["step"] == 1
