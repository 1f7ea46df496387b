"""The training loop's test-interval synthesis and its logs, on the CPU, on
the tiny model of tests/test_torch_inference_cli.py (a JAX-format export
with the small audio config):

* ``steps.test_step`` at temperature 0 against the JAX package's
  ``make_test_step`` on its plots variant, on a test shard at the records'
  mel lengths: mels within 1e-4 and the decoder's alignments within 1e-5
  (the bounds of the synthesis tests there);
* ``loop.run_test_artifacts``: the wavs (Griffin-Lim on host threads, as
  the caller asked for the CPU), mel plots and alignment plots it writes,
  and its ``test_mel_l1``, ``test_mel_l2`` and ``test_mcd_db``, which equal
  the JAX package's ``batch_summary`` of the same mels within 1e-9;
* ``cli.train`` with ``--test_dir`` and ``train.test_interval=1`` writes
  the JAX package's layout: stdout teed into ``log_dir/train.log``, one
  ``{"step", "time", ...}`` line an epoch in ``log_dir/train/metrics.jsonl``
  and in ``log_dir/dev/metrics.jsonl`` (the dev losses, then the test
  metrics), with the keys that the JAX package's ``MetricsWriter`` writes
  for the same values; and the test artifacts in ``--test_dir``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaenar_tts_tpu.models.vaenar import VAENAR as JaxVAENAR
from vaenar_tts_tpu.training.steps import make_test_step, plots_variant
from vaenar_tts_tpu.utils import metrics as jax_metrics
from vaenar_tts_tpu.utils.logging import MetricsWriter as JaxMetricsWriter
from vaenar_tts_torch.audio.export import TestUtils
from vaenar_tts_torch.cli import train as cli_train
from vaenar_tts_torch.data.loader import BucketedLoader
from vaenar_tts_torch.data.records import RecordShardWriter, list_shards
from vaenar_tts_torch.models.vaenar import load_model
from vaenar_tts_torch.training import loop, steps
from vaenar_tts_torch.utils.logging import MetricsWriter

from test_torch_data import utterances
from test_torch_inference_cli import AUDIO_OVERRIDES, _write_test_shard, tiny  # noqa: F401
from test_torch_model import SHIPPED
from test_torch_train_cli import TRAIN_OVERRIDES

R = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def test_batch(tmp_path_factory):
    records = tmp_path_factory.mktemp("test_records")
    _write_test_shard(str(records))
    return str(records)


def _loader(hp, records):
    return BucketedLoader(list_shards(records, "test"), hp.train.test_batch_size,
                          hp.dataset.mel_bucket, hp.dataset.text_bucket, shuffle=False)


def test_test_step_matches_jax(tiny, test_batch):
    jhp, variables, model_dir = tiny
    hp, model, _ = load_model(model_dir, "cpu")
    batch = next(iter(_loader(hp, test_batch).epoch(0)))
    jstep = make_test_step(jhp, JaxVAENAR(plots_variant(jhp)))
    jmels, jali = jstep(variables["params"], variables["batch_stats"],
                        jnp.asarray(batch.texts), jnp.asarray(batch.text_lengths),
                        jnp.asarray(batch.mel_lengths), jax.random.key(0), reduction_factor=R,
                        max_mel_length=batch.mels.shape[1])
    texts, _, t_lens, m_lens = loop.to_device(batch, torch.device("cpu"))
    mels, ali = steps.test_step(model, texts, t_lens, m_lens, R, batch.mels.shape[1],
                                generator=torch.Generator().manual_seed(0))
    assert mels.dtype == torch.float32 and tuple(mels.shape) == jmels.shape
    np.testing.assert_allclose(mels.numpy(), np.asarray(jmels), atol=1e-4)
    assert sorted(ali) == sorted(k for k, v in jali.items() if v is not None) == ["dec_0"]
    np.testing.assert_allclose(ali["dec_0"].numpy(), np.asarray(jali["dec_0"]), atol=1e-5)


def test_run_test_artifacts_files_and_metrics(tiny, test_batch, tmp_path):
    _, _, model_dir = tiny
    hp, model, _ = load_model(model_dir, "cpu")
    loader = _loader(hp, test_batch)
    out = tmp_path / "test_out"
    writer = MetricsWriter(str(tmp_path / "dev"))
    scalars = loop.run_test_artifacts(hp, model, loader, TestUtils(hp, str(out), "cpu"), 5, R,
                                      torch.Generator().manual_seed(0), writer)
    writer.close()
    fids = [f"utt-{i}" for i in range(4)]
    assert sorted(os.listdir(out)) == sorted(
        [f"test-5-{f}{s}" for f in fids for s in (".wav", "-mel.pdf")]
        + [f"test-dec_0-5-{f}-ali.pdf" for f in fids])
    # the JAX package's metrics of the same synthesis
    batch = next(iter(loader.epoch(5)))
    texts, _, t_lens, m_lens = loop.to_device(batch, torch.device("cpu"))
    mels = steps.test_step(model, texts, t_lens, m_lens, R, batch.mels.shape[1])[0].numpy()
    want = jax_metrics.batch_summary([(mels[i][:n], batch.mels[i][:n]) for i, n in
                                      enumerate(batch.mel_lengths[:batch.n_valid])])
    for name in ("mel_l1", "mel_l2", "mcd_db"):
        assert abs(scalars[f"test_{name}"] - want[name]) <= 1e-9 * abs(want[name])
    row = json.loads((tmp_path / "dev" / "metrics.jsonl").read_text())
    assert row["step"] == 5 and {k: row[k] for k in scalars} == scalars


def test_cli_train_writes_the_jax_layout(tmp_path):
    data = tmp_path / "records"
    data.mkdir()
    for mode, n in (("train", 4), ("dev", 2), ("test", 2)):
        w = RecordShardWriter(str(data / f"{mode}-0.vrs"), 80)
        for fid, text, mel in utterances(n, seed=len(mode) + 10):
            w.add(fid, text, mel)
        w.close()
    logs, out = tmp_path / "logs", tmp_path / "test_out"
    history = cli_train.main(
        ["--dataset", "ljspeech", "--data_dir", str(data), "--model_dir", str(tmp_path / "ckpt"),
         "--log_dir", str(logs), "--test_dir", str(out), "--device", "cpu",
         "--max_epochs", "1", "--steps_per_epoch", "1",
         "--hparams", os.path.join(SHIPPED, "hparams.json")]
        + [a for o in TRAIN_OVERRIDES + AUDIO_OVERRIDES + [
            "train.test_interval=1", "train.test_batch_size=2"] for a in ("--override", o)])
    log = (logs / "train.log").read_text()
    assert "Initializing from scratch" in log and "Epoch 1 dev:" in log
    assert "test quality @ epoch 1" in log
    rows = {split: [json.loads(line) for line in (logs / split / "metrics.jsonl").open()]
            for split in ("train", "dev")}
    assert not (logs / "metrics.jsonl").exists()
    assert [r["step"] for r in rows["train"]] == [1] and [r["step"] for r in rows["dev"]] == [1, 1]
    assert {k: rows["train"][0][k] for k in history["train"][1]} == history["train"][1]
    assert {k: rows["dev"][0][k] for k in history["dev"][1]} == history["dev"][1]
    assert np.isfinite([rows["dev"][1][k] for k in ("test_mel_l1", "test_mel_l2",
                                                    "test_mcd_db")]).all()
    # the JAX package's writer, given the same values, writes the same keys
    jax_writer = JaxMetricsWriter(str(tmp_path / "jax_dev"), use_tensorboard=False)
    for r in rows["dev"]:
        jax_writer.scalars(r["step"], {k: v for k, v in r.items() if k not in ("step", "time")})
    jax_writer.close()
    jax_rows = [json.loads(line) for line in (tmp_path / "jax_dev" / "metrics.jsonl").open()]
    assert [sorted(r) for r in jax_rows] == [sorted(r) for r in rows["dev"]]
    fids = history["test"][1] and sorted({n.split("-", 2)[2].rsplit(".", 1)[0]
                                          for n in os.listdir(out) if n.endswith(".wav")})
    assert len(fids) == 2
    assert sorted(os.listdir(out)) == sorted(
        [f"test-1-{f}{s}" for f in fids for s in (".wav", "-mel.pdf")]
        + [f"test-dec_0-1-{f}-ali.pdf" for f in fids])
