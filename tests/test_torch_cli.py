"""The port's free-text CLI on the CPU, on a tiny model exported by the JAX
package (``save_npz`` + ``save_hparams``, the shipped artifact's format)."""

import os

import numpy as np
import pytest
import torch

from vaenar_tts_tpu.configs import apply_overrides, get_config
from vaenar_tts_tpu.configs.serialize import save_hparams
from vaenar_tts_tpu.models.vaenar import VAENAR as JaxVAENAR
from vaenar_tts_tpu.training.steps import init_model
from vaenar_tts_tpu.utils.export import save_npz
from vaenar_tts_torch.cli import inference

from test_torch_model import TINY_OVERRIDES


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tiny_ckpt"))
    hp = apply_overrides(get_config("ljspeech"), TINY_OVERRIDES)
    params, stats = init_model(hp, JaxVAENAR(hp), 0, text_max=32, mel_max=120)
    save_hparams(hp, out)
    save_npz(os.path.join(out, "export.npz"),
             {"params": params, "batch_stats": stats, "epoch": 3})
    return out


def test_cli_writes_finite_mels(model_dir, tmp_path):
    text = tmp_path / "lines.txt"
    text.write_text("Hello world.\n\nThe 3rd line, with 42 numbers.\nShort.\n")
    out = tmp_path / "out"
    inference.main(["--dataset", "ljspeech", "--text", str(text),
                    "--model_dir", model_dir, "--test_dir", str(out),
                    "--device", "cpu", "--batch_size", "2",
                    "--temperature", "0.667", "--sample_seed", "5"])
    names = sorted(os.listdir(out))
    assert names == ["test-3-0.npy", "test-3-1.npy", "test-3-2.npy"]
    for name in names:
        mel = np.load(out / name)
        assert mel.ndim == 2 and mel.shape[1] == 80 and mel.shape[0] >= 1
        assert np.isfinite(mel).all()


def test_cli_is_seeded(model_dir, tmp_path):
    text = tmp_path / "lines.txt"
    text.write_text("Same seed, same mel.\n")
    mels = []
    for run in ("a", "b"):
        inference.main(["--dataset", "ljspeech", "--text", str(text),
                        "--model_dir", model_dir, "--test_dir",
                        str(tmp_path / run), "--device", "cpu",
                        "--sample_seed", "11"])
        mels.append(np.load(tmp_path / run / "test-3-0.npy"))
    np.testing.assert_array_equal(mels[0], mels[1])


def test_cuda_without_a_card_raises(model_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    text = tmp_path / "lines.txt"
    text.write_text("No card here.\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.main(["--dataset", "ljspeech", "--text", str(text),
                        "--model_dir", model_dir, "--test_dir",
                        str(tmp_path / "out")])
