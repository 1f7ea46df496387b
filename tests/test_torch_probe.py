"""The port's in-training probes (``training/probe.py``) against the JAX
package's, on the CPU, on a tiny model at the shipped config with the
small audio config of tests/test_griffin_lim.py:

* ``_BestExporter`` resumes the best value as the JAX package's does, and
  ``with_early_stop`` flags the stop and writes ``PROBE_STOP``;
* the toy LER probe at temperature 0 gives the LER that the JAX package's
  ``ToyLetterDecoder`` reads from the probe's own mels, within 1e-12, on
  the texts of the JAX package's eval (``random_text(default_rng(4242))``);
  the weights' mel outputs are steered between two letter templates so
  that the transcripts hold letters (the synthesis itself is held to the
  JAX package's by tests/test_torch_model.py);
* the dev-MCD probe records a line whose values are the JAX package's
  ``mcd_dtw`` and ``alignment_diagonality`` of the same synthesis, within
  1e-9;
* ``cli.train --probe toy_ler --probe_every 1`` on a toy corpus writes
  ``ler_probe.jsonl`` and an ``export_best.npz`` that the JAX package's
  ``load_npz`` reads leaf for leaf as the probed checkpoint's weights in
  float16 and the probe's scalars in ``log_dir/dev/metrics.jsonl`` (the
  JAX package's layout), and ``--stop_probe`` ends the run after the
  first probe.
"""

import json
import os

import numpy as np
import pytest
import torch

from vaenar_tts_tpu.configs import apply_overrides as jax_apply_overrides
from vaenar_tts_tpu.configs.serialize import hparams_from_dict as jax_hparams_from_dict
from vaenar_tts_tpu.data import toy as jax_toy
from vaenar_tts_tpu.training import probe as jax_probe
from vaenar_tts_tpu.utils import metrics as jax_metrics
from vaenar_tts_tpu.utils.export import load_npz as jax_load_npz
from vaenar_tts_torch.cli import train as cli_train
from vaenar_tts_torch.configs.overrides import apply_overrides
from vaenar_tts_torch.configs.serialize import hparams_from_dict
from vaenar_tts_torch.data import toy
from vaenar_tts_torch.data.toy import generate_corpus
from vaenar_tts_torch.interop.weights import flatten, torch_to_jax
from vaenar_tts_torch.models.vaenar import VAENAR, build_model
from vaenar_tts_torch.training import probe
from vaenar_tts_torch.utils.checkpoint import CheckpointManager

from test_torch_inference_cli import AUDIO_OVERRIDES
from test_torch_model import SHIPPED, randomize, randomize_model
from test_torch_train_cli import TRAIN_OVERRIDES

# the probe's mel budget (text bucket · ratio · 2 + 160, bucketed) cut from
# 960 frames to 480
OVERRIDES = TRAIN_OVERRIDES + AUDIO_OVERRIDES + ["dataset.mel_bucket=120",
                                                 "common.mel_text_len_ratio=4.5"]
EXACT = 1e-12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny models gain nothing from torch's CPU threads, and under the
    suite's parallel workers those threads contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _shipped_dict():
    with open(os.path.join(SHIPPED, "hparams.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def tiny():
    """(port hparams, JAX hparams, the port's model on the CPU): the shipped
    config under the tiny overrides, weights randomized from a numpy seed."""
    hp = apply_overrides(hparams_from_dict(_shipped_dict()), OVERRIDES)
    jax_hp = jax_apply_overrides(jax_hparams_from_dict(_shipped_dict()),
                                 OVERRIDES + ["train.compute_dtype=float32"])
    hp = apply_overrides(hp, ["train.compute_dtype=float32"])
    params, stats = torch_to_jax(VAENAR(hp))
    rng = np.random.default_rng(21)
    params, stats = randomize_model(params, rng), randomize(stats, rng)
    # mel outputs between two of the letter decoder's templates, steered by
    # the decoder's state, with the PostNet's residual off: the probe's
    # transcripts hold letters, and its LER is not the 1.0 of empty ones
    tm = toy.ToyLetterDecoder(hp).letter_templates[:, 0]  # [26, num_mels]
    out = params["decoder"]["linear_outputs"]
    r = out["kernel"].shape[1] // tm.shape[1]
    steer = rng.standard_normal(out["kernel"].shape[0]) / 4.0
    out["kernel"] = np.tile(np.outer(steer, tm[18] - tm[3]), (1, r)).astype(np.float32)
    out["bias"] = np.tile(0.5 + 0.5 * (tm[3] + tm[18]), r).astype(np.float32)
    for leaf in params["decoder"]["residual_outputs"].values():
        leaf[...] = 0.0
    return hp, jax_hp, build_model(hp, params, stats, "cpu")


def test_best_exporter_resumes_as_jax(tiny, tmp_path):
    model = tiny[2]
    out = str(tmp_path)
    hist = tmp_path / "ler_probe.jsonl"

    def best():
        port = probe._BestExporter(out, "probe_ler", "ler_probe.jsonl").best
        assert port == jax_probe._BestExporter(out, "probe_ler", "ler_probe.jsonl").best
        return port

    assert best() == float("inf")
    hist.write_text("".join(json.dumps({"epoch": e, "probe_ler": v}) + "\n"
                            for e, v in ((1, 0.5), (2, 0.3))))
    assert best() == float("inf")  # a history without its export is not trusted
    ex = probe._BestExporter(out, "probe_ler", "ler_probe.jsonl")
    assert ex.maybe_export(4, model, 0.4)
    assert json.loads((tmp_path / "export_best.json").read_text()) == {"epoch": 4,
                                                                      "probe_ler": 0.4}
    assert not ex.maybe_export(5, model, 0.45) and not ex.maybe_export(5, model, float("nan"))
    assert best() == 0.4  # the sidecar comes first
    os.remove(tmp_path / "export_best.json")
    assert best() == 0.3  # then the history
    assert jax_load_npz(str(tmp_path / "export_best.npz"))["epoch"] == 4


def test_with_early_stop(tmp_path):
    def fake(epoch, model):
        return {"probe_ler": 0.125}
    wrapped = probe.with_early_stop(fake, "probe_ler", 0.1, str(tmp_path))
    assert wrapped(3, None) == {"probe_ler": 0.125}
    assert not (tmp_path / "PROBE_STOP").exists()
    wrapped = probe.with_early_stop(fake, "probe_ler", 0.125, str(tmp_path))
    assert wrapped(4, None) == {"probe_ler": 0.125, "stop_training": True}
    assert (tmp_path / "PROBE_STOP").read_text() == "4 probe_ler=0.1250\n"


def test_toy_ler_probe_matches_jax(tiny, tmp_path):
    hp, jax_hp, model = tiny
    port = probe.make_toy_ler_probe(hp, str(tmp_path / "port"), temperature=0.0)
    scalars = port(7, model)
    line = json.loads((tmp_path / "port" / "ler_probe.jsonl").read_text())
    assert line == {"epoch": 7, "probe_ler": round(scalars["probe_ler"], 4), "n_texts": 8,
                    "sample_seeds": 2, "temperature": 0.0}
    assert (tmp_path / "port" / "export_best.npz").exists()
    # the JAX package's decoder on the probe's own mels
    decoder = jax_toy.ToyLetterDecoder(jax_hp)
    draws = port.synthesize(model)
    assert len(draws) == 2 and all(len(d) == 8 for d in draws)
    lers = [jax_toy.letter_error_rate(decoder.decode(mel).replace(" ", ""), text.replace(" ", ""))
            for mels in draws for mel, text in zip(mels, port.texts)]
    assert abs(scalars["probe_ler"] - np.mean(lers)) <= EXACT
    assert scalars["probe_ler"] < 1.0  # transcripts with letters in them
    rng = np.random.default_rng(4242)
    assert port.texts == [jax_toy.random_text(rng) for _ in range(8)]


def test_dev_mcd_probe_records_a_line(tiny, tmp_path):
    hp, _, model = tiny
    data = str(tmp_path / "toy")
    generate_corpus(data, hp, n_train=1, n_dev=3, n_test=1, seed=3, train_split=1, version=2)
    p = probe.make_dev_mcd_probe(hp, data, str(tmp_path / "out"), n_utts=2)
    scalars = p(2, model)
    line = json.loads((tmp_path / "out" / "mcd_probe.jsonl").read_text())
    assert line == {"epoch": 2, "n_utts": 2, "sample_seeds": 1, "temperature": 0.6,
                    **{k: round(v, 4) for k, v in scalars.items()}}
    assert np.isfinite(list(scalars.values())).all()
    # the same synthesis scored by the JAX package's metrics
    batch, max_mel = p.dev_batch
    mels, lens, ali = probe._synthesize(model, batch.texts, batch.text_lengths, max_mel, 2, 0.6,
                                        0, return_alignments=True)
    mcds, diags = [], []
    for b in range(batch.n_valid):
        pl = max(int(lens[b]), 2)
        mcds.append(jax_metrics.mcd_dtw(mels[b, :pl:2],
                                        batch.mels[b][:int(batch.mel_lengths[b])][::2]))
        diags.append(max(jax_metrics.alignment_diagonality(
            a[b], -(-pl // 2), int(batch.text_lengths[b]))["diagonality"] for a in ali.values()))
    assert abs(scalars["probe_mcd_dtw"] - np.mean(mcds)) <= 1e-9
    assert abs(scalars["probe_diag"] - np.mean(diags)) <= 1e-9


@pytest.fixture(scope="module")
def toy_records(tiny, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("toy_records"))
    generate_corpus(out, tiny[0], n_train=8, n_dev=2, n_test=1, seed=0, train_split=1,
                    version=2)
    return out


def _train(records, work, *flags):
    return cli_train.main(
        ["--dataset", "ljspeech", "--data_dir", records, "--model_dir", str(work / "ckpt"),
         "--log_dir", str(work / "logs"), "--device", "cpu", "--steps_per_epoch", "1",
         "--hparams", os.path.join(SHIPPED, "hparams.json"), "--compute_dtype", "float32",
         "--probe", "toy_ler", "--probe_every", "1", *flags]
        + [a for o in OVERRIDES for a in ("--override", o)])


def test_train_cli_probe_writes_history_and_best_export(toy_records, tmp_path):
    history = _train(toy_records, tmp_path, "--max_epochs", "2")
    assert history["epoch"] == 2 and sorted(history["probe"]) == [1, 2]
    rows = [json.loads(line) for line in (tmp_path / "ler_probe.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [1, 2]
    assert all(r["probe_ler"] == round(history["probe"][r["epoch"]]["probe_ler"], 4)
               and np.isfinite(r["probe_ler"]) for r in rows)
    best = json.loads((tmp_path / "export_best.json").read_text())
    assert best["epoch"] == min(rows, key=lambda r: r["probe_ler"])["epoch"]
    # the export is the probed epoch's checkpoint in float16, leaf for leaf
    model = VAENAR(hparams_from_dict(json.loads((tmp_path / "ckpt" / "hparams.json")
                                                .read_text())))
    assert CheckpointManager(str(tmp_path / "ckpt")).restore(model, epoch=best["epoch"]) \
        == best["epoch"]
    params, stats = torch_to_jax(model)
    state = jax_load_npz(str(tmp_path / "export_best.npz"))
    assert state["epoch"] == best["epoch"]
    for name, want in (("params", params), ("batch_stats", stats)):
        got, want = flatten(state[name]), flatten(want)
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            assert got[key].dtype == np.float32, key
            np.testing.assert_array_equal(got[key], value.astype(np.float16).astype(np.float32))
    # the JAX package's layout: the probe's scalars are dev metrics
    with open(tmp_path / "logs" / "dev" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows if "probe_ler" in r] == [1, 2]


def test_stop_probe_ends_the_run(toy_records, tmp_path):
    history = _train(toy_records, tmp_path, "--max_epochs", "3", "--stop_probe", "1000")
    assert history["epoch"] == 1 and list(history["probe"]) == [1]
    assert (tmp_path / "PROBE_STOP").read_text().startswith("1 probe_ler=")
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["0", "1", "hparams.json"]
