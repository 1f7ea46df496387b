"""The port's synthesis CLI beyond free-text mels, on the CPU, on a tiny
model in the JAX package's export format (its ``save_npz`` and
``save_hparams``, as tests/test_torch_cli.py writes it, with the length
heads of tests/test_torch_model.py and the small audio config of
tests/test_griffin_lim.py):

* the decoder's alignments at temperature 0, fp32, against the JAX plots
  variant's ``dec_<i>`` (``make_inference_step(hp, VAENAR(plots_variant(
  hp)))``), atol 1e-5 (a softmax of fp32 logits of order 1), and the mels
  with them equal to the mels without;
* test-set mode over a 4-utterance shard: file names, the RTF line, wav
  lengths of mel length · hop, the streaming vocoder's TTFA line, and a mel
  plot;
* free-text ``--takes 3`` for both scores choosing the takes that the JAX
  CLI's selection code chooses on the same takes;
* checkpoints before the export, and ``--ckpt_epoch``;
* ``--dataset databaker`` on a tiny DataBaker model: free-text lines go
  through the pinyin frontend, as the JAX CLI's ``DataBakerCorpus``
  encodes them, and hanzi without ``pypinyin`` raise;
* a plot asked for without matplotlib, and ``cuda`` without a card, raise.
"""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from vaenar_tts_tpu.configs import apply_overrides, get_config
from vaenar_tts_tpu.configs.serialize import hparams_to_dict, save_hparams
from vaenar_tts_tpu.data.corpus import DataBakerCorpus as JaxDataBakerCorpus
from vaenar_tts_tpu.models.vaenar import VAENAR as JaxVAENAR
from vaenar_tts_tpu.training.steps import make_inference_step, plots_variant
from vaenar_tts_tpu.utils import metrics as jax_metrics
from vaenar_tts_tpu.utils.export import load_npz, save_npz
from vaenar_tts_torch.audio.export import TestUtils
from vaenar_tts_torch.cli import inference
from vaenar_tts_torch.configs.serialize import hparams_from_dict
from vaenar_tts_torch.data.records import RecordShardWriter
from vaenar_tts_torch.interop.weights import torch_to_jax
from vaenar_tts_torch.models.vaenar import VAENAR, load_model
from vaenar_tts_torch.utils.checkpoint import CheckpointManager

from test_torch_model import LINES, TINY_OVERRIDES, randomize, randomize_model
from torch_threads import one_thread  # noqa: F401

EPOCH = 3
# the small audio config of tests/test_griffin_lim.py, so that the CLI's
# vocoder runs in a fraction of the shipped config's time
AUDIO_OVERRIDES = ["audio.num_freq=129", "audio.frame_length_sample=128",
                   "audio.frame_shift_sample=32", "audio.griffin_lim_iters=16"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(JAX hparams, the export's variables, the export's model directory).
    The variables' tree is the port's model's in flax form
    (``torch_to_jax``), randomized from a numpy seed and exported with the
    JAX package's writer: the tree of ``init_model``, without its compile."""
    out = str(tmp_path_factory.mktemp("tiny_export"))
    hp = apply_overrides(get_config("ljspeech"), TINY_OVERRIDES + AUDIO_OVERRIDES)
    params, stats = torch_to_jax(VAENAR(hparams_from_dict(hparams_to_dict(hp))))
    rng = np.random.default_rng(11)
    params, stats = randomize_model(params, rng), randomize(stats, rng)
    save_hparams(hp, out)
    save_npz(os.path.join(out, "export.npz"),
             {"params": params, "batch_stats": stats, "epoch": EPOCH})
    # the export stores float16: both sides take its weights
    state = load_npz(os.path.join(out, "export.npz"))
    return hp, {"params": state["params"], "batch_stats": state["batch_stats"]}, out


def _run(argv, capsys):
    result = inference.main(argv)
    return result, capsys.readouterr().out


def test_alignments_match_jax_plots_variant(tiny):
    hp, variables, model_dir = tiny
    _, port, _ = load_model(model_dir, "cpu")
    batch, text_lens, max_mel = inference.pad_lines(port.hp, inference.encode_lines(port.hp,
                                                                                    LINES))
    step = make_inference_step(hp, JaxVAENAR(plots_variant(hp)))
    mels, lens, ali = step(variables["params"], variables["batch_stats"],
                           jnp.asarray(batch, jnp.int32), jnp.asarray(text_lens),
                           jax.random.key(0), reduction_factor=2, max_mel_length=max_mel,
                           temperature=0.0, length_headroom=0, use_length_quantile=True)
    t_mels, t_lens, t_ali = inference.synthesize(port, port.hp, batch, text_lens, max_mel, 0.0,
                                                 True, return_alignments=True)
    assert t_lens.tolist() == np.asarray(lens).tolist()
    np.testing.assert_allclose(t_mels.numpy(), np.asarray(mels), atol=1e-4)
    assert sorted(t_ali) == sorted(ali) == ["dec_0"]
    assert t_ali["dec_0"].dtype == torch.float32
    np.testing.assert_allclose(t_ali["dec_0"].numpy(), np.asarray(ali["dec_0"]), atol=1e-5)
    plain_mels, _ = inference.synthesize(port, port.hp, batch, text_lens, max_mel, 0.0, True)
    assert torch.equal(plain_mels, t_mels)


def _write_test_shard(path, n=4):
    rng = np.random.default_rng(5)
    writer = RecordShardWriter(os.path.join(path, "test-0.vrs"), 80)
    for i in range(n):
        text_len = int(rng.integers(12, 30))
        writer.add(f"utt-{i}", rng.integers(3, 40, text_len),
                   rng.uniform(0.0, 1.0, (3 * text_len, 80)).astype(np.float32))
    writer.close()


def test_test_set_mode_writes_mels_wavs_plots_and_rtf(tiny, tmp_path, capsys):
    _, _, model_dir = tiny
    records = tmp_path / "records"
    records.mkdir()
    _write_test_shard(str(records))
    out = tmp_path / "out"
    common = ["--dataset", "ljspeech", "--data_dir", str(records), "--model_dir", model_dir,
              "--device", "cpu", "--batch_size", "3"]
    result, text = _run(common + ["--test_dir", str(out), "--write_wavs",
                                  "--draw_alignments"], capsys)
    assert re.search(r"Total time consumed is [0-9.]+ Secs, total synthesis duration is "
                     r"[0-9.]+ Secs, Average RTF is [0-9.]+\.", text)
    assert result["rtf"] > 0 and result["audio_seconds"] > 0
    fids = [f"utt-{i}" for i in range(4)]
    assert sorted(os.listdir(out)) == sorted(
        [f"prior-{EPOCH}-{f}{s}" for f in fids for s in (".npy", ".wav")]
        + [f"prior-dec_0-{EPOCH}-{f}-ali.pdf" for f in fids])
    hop = tiny[0].audio.frame_shift_sample
    for f in fids:
        mel = np.load(out / f"prior-{EPOCH}-{f}.npy")
        _, wav = wavfile.read(out / f"prior-{EPOCH}-{f}.wav")
        assert np.isfinite(mel).all() and len(wav) == mel.shape[0] * hop and np.abs(wav).max() > 0
    tester = TestUtils(load_model(model_dir, "cpu")[0], str(tmp_path / "plots"), "cpu")
    assert [os.path.basename(p) for p in tester.draw_melspectrograms(
        EPOCH, mel[None], [mel.shape[0]], [f], prefix="prior")] == [f"prior-{EPOCH}-{f}-mel.pdf"]
    _, text = _run(common + ["--test_dir", str(tmp_path / "stream"), "--write_wavs",
                             "--stream_wavs", "--no-draw_alignments", "--no-write_mels"],
                   capsys)
    assert "streaming vocoder (device): time-to-first-audio" in text
    assert len(os.listdir(tmp_path / "stream")) == 4


def _jax_choice(takes, text_lens, score):
    """The JAX CLI's selection loops (vaenar_tts_tpu/cli/inference.py
    synthesize_from_text) over the same takes, with its metrics."""
    n = len(text_lens)
    if score == "medoid":
        return [jax_metrics.medoid_take([tk[0][b][:max(int(tk[1][b]), 1)] for tk in takes])[0]
                for b in range(n)]

    def scores_of(lens_t, ali_t):
        s = np.full(n, -3.0)
        for a in ali_t.values():
            for b in range(n):
                m = jax_metrics.alignment_diagonality(a[b], -(-int(lens_t[b]) // 2),
                                                      int(text_lens[b]))
                s[b] = max(s[b], m["diagonality"] - (1.0 - m["coverage"]))
        return s

    best, chosen = scores_of(takes[0][1], takes[0][2]), np.zeros(n, np.int32)
    for t in range(1, len(takes)):
        s_t = scores_of(takes[t][1], takes[t][2])
        for b in np.nonzero(s_t > best)[0]:
            best[b], chosen[b] = s_t[b], t
    return list(chosen)


@pytest.mark.parametrize("score", ["medoid", "coverage"])
def test_takes_choose_as_jax_does(tiny, tmp_path, capsys, score):
    _, _, model_dir = tiny
    text = tmp_path / "lines.txt"
    text.write_text("\n".join(LINES) + "\n")
    result, out = _run(["--dataset", "ljspeech", "--text", str(text), "--model_dir", model_dir,
                        "--test_dir", str(tmp_path / "out"), "--device", "cpu", "--takes", "3",
                        "--take_score", score, "--temperature", "0.8", "--sample_seed", "4",
                        "--no-draw_alignments"], capsys)
    assert "chosen takes" in out and len(result["chosen"]) == len(LINES)
    _, port, _ = load_model(model_dir, "cpu")
    batch, text_lens, max_mel = inference.pad_lines(port.hp, inference.encode_lines(port.hp,
                                                                                    LINES))
    takes = []
    for t in range(3):
        gen = torch.Generator().manual_seed(inference.take_seed(4, t))
        takes.append(inference.as_take(inference.synthesize(
            port, port.hp, batch, text_lens, max_mel, 0.8, True, generator=gen,
            return_alignments=True)))
    want = _jax_choice(takes, text_lens, score)
    assert result["chosen"] == want
    if score == "medoid":
        assert inference.choose_takes_medoid(takes)[0].tolist() == want
    else:
        assert inference.choose_takes_coverage(takes, text_lens, 2)[0].tolist() == want


def test_checkpoint_comes_before_export(tiny, tmp_path, capsys):
    """A directory with the export (epoch 3) and checkpoints of epochs 5
    and 7 holding other weights synthesizes from the newest checkpoint, or
    from the one ``--ckpt_epoch`` names; an epoch without a checkpoint
    raises."""
    _, _, export_dir = tiny
    model_dir = tmp_path / "ckpt"
    model_dir.mkdir()
    for name in ("hparams.json", "export.npz"):
        (model_dir / name).write_bytes((open(os.path.join(export_dir, name), "rb").read()))
    hp, model, epoch = load_model(str(model_dir), "cpu")
    assert epoch == EPOCH
    ckpt = CheckpointManager(str(model_dir))
    states = {}
    for e, scale in ((5, 1.1), (7, 0.9)):
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(scale)
        ckpt.save(e, model)
        states[e] = {k: v.clone() for k, v in model.state_dict().items()}
    for want, pinned in ((7, None), (5, 5)):
        _, restored, got = load_model(str(model_dir), "cpu", epoch=pinned)
        assert got == want
        for k, v in restored.state_dict().items():
            assert torch.equal(v, states[want][k]), k
    with pytest.raises(FileNotFoundError, match="no epoch-6 checkpoint"):
        load_model(str(model_dir), "cpu", epoch=6)
    with pytest.raises(FileNotFoundError, match="no epoch-6 checkpoint"):
        load_model(export_dir, "cpu", epoch=6)

    text = tmp_path / "lines.txt"
    text.write_text(LINES[0] + "\n")
    out = tmp_path / "out"
    _run(["--dataset", "ljspeech", "--text", str(text), "--model_dir", str(model_dir),
          "--test_dir", str(out), "--device", "cpu", "--temperature", "0",
          "--no-draw_alignments"], capsys)
    _, export_model, _ = inference.load_model(export_dir, "cpu")
    _, ckpt_model, _ = inference.load_model(str(model_dir), "cpu", epoch=7)
    ids = inference.encode_lines(hp, LINES[:1])
    from_ckpt = inference.synthesize_batch(ckpt_model, hp, ids, 0.0, True)
    from_export = inference.synthesize_batch(export_model, hp, ids, 0.0, True)
    mel = np.load(out / "test-7-0.npy")
    np.testing.assert_array_equal(mel, from_ckpt[0][0, :int(from_ckpt[1][0])].numpy())
    assert not np.array_equal(mel[:10], from_export[0][0, :10].numpy())


def test_plots_without_matplotlib_raise(tiny, tmp_path, monkeypatch):
    """A plot asked for without matplotlib raises before any synthesis."""
    _, _, model_dir = tiny
    text = tmp_path / "lines.txt"
    text.write_text(LINES[0] + "\n")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        inference.main(["--dataset", "ljspeech", "--text", str(text), "--model_dir", model_dir,
                        "--test_dir", str(tmp_path / "out"), "--device", "cpu"])
    assert not (tmp_path / "out").exists() or not os.listdir(tmp_path / "out")


def test_test_set_mode_without_a_card_raises(tiny, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, _, model_dir = tiny
    records = tmp_path / "records"
    records.mkdir()
    _write_test_shard(str(records), n=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.main(["--dataset", "ljspeech", "--data_dir", str(records), "--model_dir",
                        model_dir, "--test_dir", str(tmp_path / "out"), "--write_wavs"])


def test_databaker_free_text(tmp_path, capsys):
    hp = apply_overrides(get_config("databaker"), TINY_OVERRIDES + AUDIO_OVERRIDES)
    model_dir = str(tmp_path / "model")
    params, stats = torch_to_jax(VAENAR(hparams_from_dict(hparams_to_dict(hp))))
    rng = np.random.default_rng(12)
    save_hparams(hp, model_dir)
    save_npz(os.path.join(model_dir, "export.npz"),
             {"params": randomize_model(params, rng), "batch_stats": randomize(stats, rng),
              "epoch": EPOCH})
    lines = ["ni3 hao3 shi4 jie4", "Ma1 MA1"]
    port_hp = hparams_from_dict(hparams_to_dict(hp))
    want = [JaxDataBakerCorpus(None, None, hp).text_to_array(line) for line in lines]
    assert inference.encode_lines(port_hp, lines, "databaker") == want
    # the English frontend would spell the tone digits out
    assert inference.encode_lines(port_hp, lines) != want
    text = tmp_path / "lines.txt"
    text.write_text("\n".join(lines) + "\n")
    argv = ["--dataset", "databaker", "--text", str(text), "--model_dir", model_dir,
            "--test_dir", str(tmp_path / "out"), "--device", "cpu", "--no-draw_alignments"]
    result, out = _run(argv, capsys)
    assert "synthesized 2 line(s) on cpu" in out
    assert [os.path.basename(p) for p in result["paths"]] == [f"test-{EPOCH}-0.npy",
                                                             f"test-{EPOCH}-1.npy"]
    for path in result["paths"]:
        mel = np.load(path)
        assert mel.shape[1] == 80 and mel.shape[0] >= 1 and np.isfinite(mel).all()
        sr, wav = wavfile.read(path[:-4] + ".wav")
        assert sr == 16000 and len(wav) == mel.shape[0] * hp.audio.frame_shift_sample
    try:
        import pypinyin  # noqa: F401
    except ImportError:
        text.write_text("你好\n")
        with pytest.raises(ImportError, match="pypinyin"):
            inference.main(argv)
