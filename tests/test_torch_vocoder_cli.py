"""The port's vocoder CLI and the synthesis CLI's ``--neural_vocoder``, on
the CPU at tiny width:

* ``cli.train_vocoder --toy`` (``--hidden 16 --n_blocks 1
  --segment_frames 24``) writes ``vocoder_config.json`` in the JAX format
  and the final step's checkpoint, with finite losses at its logged steps;
* ``--wav_dir`` trains on wavs that the test writes;
* exactly one of ``--toy`` and ``--wav_dir``, else a usage error;
* ``cli.inference --neural_vocoder`` in test-set and free-text modes on the
  tiny model of tests/test_torch_inference_cli.py, with a vocoder trained
  under that model's audio config: one wav an utterance, of max(mel
  length - 1, 1) · hop samples, whose samples before the last 16 frames
  correlate at 0.999 with the vocoder's own output for that mel alone after
  the inverse preemphasis (the CLI vocodes the padded batch, which the last
  frames see).
"""

import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from vaenar_tts_torch.audio.dsp import AudioProcessor
from vaenar_tts_torch.cli import inference
from vaenar_tts_torch.cli import train_vocoder as cli_vocoder
from vaenar_tts_torch.models import vocoder as voc
from vaenar_tts_torch.models.vaenar import load_model
from vaenar_tts_torch.training import vocoder as train_voc

from test_torch_inference_cli import EPOCH, _write_test_shard, tiny  # noqa: F401

EDGE = 16  # frames at the end that see the batch's padding
TINY_FLAGS = ["--device", "cpu", "--steps", "3", "--batch_size", "2", "--segment_frames", "24",
              "--hidden", "16", "--n_blocks", "1", "--log_every", "1"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_toy_cli(tmp_path):
    out = tmp_path / "voc"
    result = cli_vocoder.main(["--toy", "--n_toy_utterances", "2", "--toy_version", "2",
                               "--model_dir", str(out)] + TINY_FLAGS)
    assert sorted(result["losses"]) == [1, 2, 3]
    assert np.isfinite(list(result["losses"].values())).all()
    assert sorted(os.listdir(out)) == ["3", "vocoder_config.json"]
    raw = json.loads((out / "vocoder_config.json").read_text())
    assert sorted(raw) == ["audio", "vocoder"]
    assert raw["vocoder"]["hidden"] == 16 and raw["audio"]["sample_rate"] == 22050
    model, step = voc.load_vocoder(str(out), "cpu")
    assert step == 3 and model.cfg.n_blocks == 1


def test_wav_dir_cli(tmp_path):
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        t = np.arange(int(0.4 * 22050)) / 22050
        y = 0.3 * np.sin(2 * np.pi * (200 + 100 * i) * t) + 0.01 * rng.standard_normal(len(t))
        wavfile.write(wavs / f"w{i}.wav", 22050, (y * 32767).astype(np.int16))
    result = cli_vocoder.main(["--wav_dir", str(wavs), "--model_dir", str(tmp_path / "voc")]
                              + TINY_FLAGS)
    assert np.isfinite(result["last_loss"])
    assert voc.load_vocoder(str(tmp_path / "voc"), "cpu")[1] == 3


@pytest.mark.parametrize("flags", [[], ["--toy", "--wav_dir", "x"]])
def test_exactly_one_source(flags, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        cli_vocoder.main(flags + ["--model_dir", str(tmp_path / "voc")] + TINY_FLAGS)
    assert e.value.code == 2
    assert "exactly one of --toy / --wav_dir" in capsys.readouterr().err
    assert not (tmp_path / "voc").exists()


@pytest.fixture(scope="module")
def matching_vocoder(tiny, tmp_path_factory):  # noqa: F811
    """A vocoder trained for one step under the tiny model's audio config."""
    hp = load_model(tiny[2], "cpu")[0]
    out = str(tmp_path_factory.mktemp("matching_vocoder"))
    cfg = voc.VocoderConfig(hidden=16, n_blocks=1, segment_frames=24, batch_size=2, steps=1,
                            stft_loss_scales=((128, 32, 128),))
    sampler = train_voc.PairSampler(train_voc.toy_utterances(hp.audio, n=2, seed=1),
                                    hp.audio, 24, seed=0)
    train_voc.train_vocoder(cfg, hp.audio, sampler, out, log_every=1, device="cpu")
    return out


def _check_wavs(out, names, model_dir, vocoder_dir, hp):
    model, _ = voc.load_vocoder(vocoder_dir, "cpu")
    ap, hop = AudioProcessor(hp.audio), hp.audio.frame_shift_sample
    for stem in names:
        mel = np.load(out / f"{stem}.npy")
        _, wav = wavfile.read(out / f"{stem}.wav")
        n = max(mel.shape[0] - 1, 1) * hop
        assert len(wav) == n
        # the CLI vocodes the padded batch, so the last frames also see the
        # padding (the convolutions' and the overlap-add's reach): compare
        # the samples before them, up to the file's scaling
        want = voc.vocode(model, torch.from_numpy(mel[None]))[0].numpy()
        want = ap.inv_preemphasize(want[:n])[: n - EDGE * hop]
        got = wav[: n - EDGE * hop].astype(np.float64)
        assert np.corrcoef(got, want)[0, 1] >= 0.999


def test_inference_neural_vocoder_both_modes(tiny, matching_vocoder, tmp_path):  # noqa: F811
    _, _, model_dir = tiny
    hp = load_model(model_dir, "cpu")[0]
    records = tmp_path / "records"
    records.mkdir()
    _write_test_shard(str(records), n=2)
    out = tmp_path / "test_set"
    inference.main(["--dataset", "ljspeech", "--data_dir", str(records), "--model_dir",
                    model_dir, "--test_dir", str(out), "--device", "cpu", "--write_wavs",
                    "--neural_vocoder", matching_vocoder])
    _check_wavs(out, [f"prior-{EPOCH}-utt-{i}" for i in range(2)], model_dir,
                matching_vocoder, hp)
    lines = tmp_path / "lines.txt"
    lines.write_text("a short line.\nanother one.\n")
    out = tmp_path / "free"
    inference.main(["--dataset", "ljspeech", "--text", str(lines), "--model_dir", model_dir,
                    "--test_dir", str(out), "--device", "cpu", "--no-draw_alignments",
                    "--neural_vocoder", matching_vocoder])
    _check_wavs(out, [f"test-{EPOCH}-{i}" for i in range(2)], model_dir, matching_vocoder, hp)
