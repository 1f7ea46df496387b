"""The port's training CLI on the CPU at tiny size: a cold start (random
init, data-dependent flow init, epoch-0 checkpoint, priming step) and one
epoch of 2 steps, then a resume for one more epoch, then the export, which
the port's synthesis (from a directory that holds only the export) and the
JAX package's ``load_npz`` both load, with the weights of the epoch-2
checkpoint; ``--compute_dtype``; and a model directory of the JAX package
(numbered Orbax directories without ``state.pt``), which ``load_model`` and
the CLI refuse, naming it, without touching a file."""

import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from vaenar_tts_tpu.configs import get_config
from vaenar_tts_tpu.utils.export import load_npz as jax_load_npz
from vaenar_tts_torch.cli import train as cli_train
from vaenar_tts_torch.configs.hparams import HParams
from vaenar_tts_torch.data.records import RecordShardWriter
from vaenar_tts_torch.models.vaenar import load_model
from vaenar_tts_torch.utils.checkpoint import ForeignCheckpointError
from vaenar_tts_torch.utils.export import export_model_dir

from test_torch_data import utterances
from test_torch_model import SHIPPED, TINY_OVERRIDES
from torch_threads import one_thread  # noqa: F401

TRAIN_OVERRIDES = [o for o in TINY_OVERRIDES if not o.startswith("train.")] + [
    "train.train_batch_size=4"]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("records")
    for mode, n in (("train", 8), ("dev", 3)):
        w = RecordShardWriter(str(out / f"{mode}-0.vrs"), 80)
        for fid, text, mel in utterances(n, seed=len(mode)):
            w.add(fid, text, mel)
        w.close()
    return str(out)


def test_train_resume_export(data_dir, tmp_path):
    ckpt, logs = str(tmp_path / "ckpt"), str(tmp_path / "logs")
    base = ["--dataset", "ljspeech", "--data_dir", data_dir, "--model_dir", ckpt,
            "--log_dir", logs, "--device", "cpu", "--steps_per_epoch", "2"]
    first = cli_train.main(base + ["--max_epochs", "1", "--hparams",
                                   os.path.join(SHIPPED, "hparams.json")]
                           + [a for o in TRAIN_OVERRIDES for a in ("--override", o)])
    assert first["initial"] is not None and first["epoch"] == 1
    for split in ("train", "dev"):
        losses = first[split][1]
        assert set(losses) == {"total", "mel_l2", "kl", "len_l2", "len_pinball"}
        assert all(np.isfinite(v) for v in losses.values())
    assert sorted(os.listdir(ckpt)) == ["0", "1", "hparams.json"]
    with open(os.path.join(ckpt, "hparams.json")) as f:
        saved = json.load(f)
    # the shipped config under the overrides, as the JAX package reads it
    assert saved["common"]["mel_text_len_ratio"] == 9.0
    assert saved["encoder"]["pre_hidden"] == 32 and saved["train"]["train_batch_size"] == 4

    second = cli_train.main(base + ["--max_epochs", "2"])
    assert second["initial"] is None and list(second["train"]) == [2]
    assert sorted(os.listdir(ckpt)) == ["0", "1", "2", "hparams.json"]

    path = export_model_dir(ckpt)
    state = jax_load_npz(path)
    assert state["epoch"] == 2 and set(state["params"]) >= {"text_encoder", "prior"}
    # the export alone in a directory of its own: load_model would take the
    # training directory's newest checkpoint over it
    export_only = tmp_path / "export_only"
    export_only.mkdir()
    for name in (os.path.basename(path), "hparams.json"):
        shutil.copy(os.path.join(ckpt, name), export_only)
    hp, model, epoch = load_model(str(export_only), device="cpu")
    assert epoch == 2
    _, restored, ckpt_epoch = load_model(ckpt, device="cpu")
    assert ckpt_epoch == 2
    # the export stores floating leaves as float16 (integer buffers such as
    # num_batches_tracked are not exported)
    want = restored.state_dict()
    for name, a in model.state_dict().items():
        if a.is_floating_point():
            assert torch.equal(a, want[name].half().to(a.dtype)), name
    with torch.no_grad():
        mel, lens = model.infer_with_length_prediction(
            torch.randint(3, 43, (2, 16)), torch.tensor([16, 9]), max_mel_length=120)
    assert mel.shape == (2, 120, 80) and torch.isfinite(mel).all()


def test_schedules_match_jax():
    port, ref = HParams().train, get_config("ljspeech").train
    for epoch in (0, 1, 2, 199, 200, 401, 600, 1999):
        assert port.kl_weight_at(epoch) == ref.kl_weight_at(epoch)
        assert port.reduction_factor_at(epoch) == ref.reduction_factor_at(epoch)


def test_cuda_without_a_card_raises(data_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(["--dataset", "ljspeech", "--data_dir", data_dir,
                        "--model_dir", str(tmp_path / "c"), "--log_dir",
                        str(tmp_path / "l")])


def test_compute_dtype_flag(data_dir, tmp_path):
    ckpt = tmp_path / "ckpt"
    history = cli_train.main(
        ["--dataset", "ljspeech", "--data_dir", data_dir, "--model_dir", str(ckpt),
         "--log_dir", str(tmp_path / "logs"), "--device", "cpu", "--max_epochs", "0",
         "--hparams", os.path.join(SHIPPED, "hparams.json"), "--compute_dtype", "float32"]
        + [a for o in TRAIN_OVERRIDES for a in ("--override", o)])
    assert history["epoch"] == 0 and history["initial"] is not None
    with open(ckpt / "hparams.json") as f:
        assert json.load(f)["train"]["compute_dtype"] == "float32"


def _snapshot(root):
    return {os.path.relpath(os.path.join(d, n), root): (os.path.getmtime(os.path.join(d, n)),
                                                       open(os.path.join(d, n), "rb").read())
            for d, _, names in os.walk(root) for n in names}


def test_jax_model_dir_is_refused_untouched(data_dir, tmp_path):
    """A model directory as the JAX package's training leaves it: Orbax
    checkpoints ``0/`` and ``5/`` (no ``state.pt``) beside ``hparams.json``."""
    jax_dir = tmp_path / "jax_model"
    for epoch in ("0", "5"):
        (jax_dir / epoch / "default").mkdir(parents=True)
        (jax_dir / epoch / "_CHECKPOINT_METADATA").write_text("{}")
        (jax_dir / epoch / "default" / "array_metadatas").write_bytes(b"\0" * 16)
    shutil.copy(os.path.join(SHIPPED, "hparams.json"), jax_dir)
    before = _snapshot(jax_dir)
    named = re.escape(str(jax_dir))
    with pytest.raises(ForeignCheckpointError, match=named):
        load_model(str(jax_dir), device="cpu")
    with pytest.raises(ForeignCheckpointError, match=named):
        cli_train.main(["--dataset", "ljspeech", "--data_dir", data_dir, "--model_dir",
                        str(jax_dir), "--log_dir", str(tmp_path / "logs"), "--device", "cpu",
                        "--max_epochs", "1", "--steps_per_epoch", "1"])
    assert _snapshot(jax_dir) == before
    assert sorted(os.listdir(jax_dir)) == ["0", "5", "hparams.json"]
    assert not (tmp_path / "logs").exists()
