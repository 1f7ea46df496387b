"""The port's preprocessing against the JAX package's, on the CPU.

A synthetic LJSpeech-layout corpus of 12 short wavs (``make_lj_corpus`` of
tests/test_corpus.py) goes through the port's ``cli.preprocess`` and the
JAX package's: ``texts.pkl``, the split lists and the record shards' fids
and texts are equal, and the mels agree within 1e-5 (both are numpy float64
DSP cast to float32; the copies are the same code, so the bound is loose).
The port's batched torch path (``--device_mels --device cpu``) is held to
its host path at atol 5e-4, the JAX package's own tolerance for its device
path (tests/test_corpus.py); two workers over one directory write the
shards of one worker byte for byte; ``RecordWriter``'s worker slicing, the
DataBaker label parser and the pinyin frontend equal the JAX package's.
"""

import filecmp
import os
import pickle

import numpy as np
import pytest
import torch

from vaenar_tts_tpu.cli import preprocess as jax_preprocess
from vaenar_tts_tpu.configs import get_config as jax_get_config
from vaenar_tts_tpu.data.corpus import DataBakerCorpus as JaxDataBakerCorpus
from vaenar_tts_tpu.data.records import RecordWriter as JaxRecordWriter
from vaenar_tts_tpu.text import pinyin as jax_pinyin
from vaenar_tts_torch.cli import preprocess
from vaenar_tts_torch.configs.hparams import get_config
from vaenar_tts_torch.data.corpus import DataBakerCorpus
from vaenar_tts_torch.data.records import RecordShardReader, RecordWriter, list_shards
from vaenar_tts_torch.text import pinyin

from test_corpus import make_lj_corpus
from test_data import make_corpus_dir

MEL_ATOL_JAX = 1e-5
MEL_ATOL_DEVICE = 5e-4
LABELS = (
    "000001\t妈妈#1当时#1表示#3，儿子#1开心得#2像花儿#1一样#4。\n"
    "\tma1 ma1 dang1 shi2 biao3 shi4 er2 zi5 kai1 xin1 de5 xiang4 huar1 yi2 yang4\n"
    "000002\t你好#4。\n"
    "\tni3 hao3\n"
    "000003\t那儿#2有#1一个#1小孩儿#3在#1玩儿#4。\n"
    "\tnar4 you3 yi2 ge4 xiao3 hair2 zai4 war2\n"
)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("LJSpeech")
    make_lj_corpus(root, n=12)
    return str(root)


def _preprocess(corpus, out, *flags):
    preprocess.main(["--dataset", "ljspeech", "--data_dir", corpus, "--save_dir", str(out),
                     "--record_split", "2", *flags])
    return str(out)


@pytest.fixture(scope="module")
def port_host(corpus, tmp_path_factory):
    return _preprocess(corpus, tmp_path_factory.mktemp("port_host"), "--num_workers", "0")


@pytest.fixture(scope="module")
def jax_host(corpus, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_host"))
    with pytest.MonkeyPatch.context() as mp:
        # the JAX CLI points JAX's compile cache at the home directory
        mp.setattr("vaenar_tts_tpu.utils.compile_cache.setup_compile_cache", lambda: None)
        jax_preprocess.main(["--dataset", "ljspeech", "--data_dir", corpus, "--save_dir", out,
                             "--record_split", "2", "--num_workers", "1"])
    return out


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _shards(save_dir):
    """{shard name: [(fid, text, mel)]}."""
    out = {}
    for mode in ("train", "dev", "test"):
        for path in list_shards(save_dir, mode):
            r = RecordShardReader(path)
            out[os.path.basename(path)] = [(u.fid, u.text.tolist(), u.mel)
                                           for u in map(r.get, range(len(r)))]
    return out


def _assert_same_corpus(a, b, atol):
    with open(os.path.join(a, "texts.pkl"), "rb") as fa, \
            open(os.path.join(b, "texts.pkl"), "rb") as fb:
        assert pickle.load(fa) == pickle.load(fb)
    for name in ("train.txt", "dev.txt", "test.txt"):
        assert _read(os.path.join(a, name)) == _read(os.path.join(b, name)), name
    mels = sorted(os.listdir(os.path.join(a, "mels")))
    assert mels == sorted(os.listdir(os.path.join(b, "mels"))) and len(mels) == 12
    for name in mels:
        ma, mb = (np.load(os.path.join(d, "mels", name)) for d in (a, b))
        assert ma.dtype == mb.dtype == np.float32 and ma.shape == mb.shape, name
        np.testing.assert_allclose(ma, mb, atol=atol, rtol=0, err_msg=name)
    sa, sb = _shards(a), _shards(b)
    assert sorted(sa) == sorted(sb) == ["dev-0.vrs", "test-0.vrs", "train-0.vrs", "train-1.vrs"]
    for name in sa:
        assert [(f, t) for f, t, _ in sa[name]] == [(f, t) for f, t, _ in sb[name]], name
        for (_, _, x), (_, _, y) in zip(sa[name], sb[name]):
            np.testing.assert_allclose(x, y, atol=atol, rtol=0)


def test_preprocess_cli_matches_jax(port_host, jax_host, capsys):
    _assert_same_corpus(port_host, jax_host, MEL_ATOL_JAX)


def test_device_mels_match_host_path(corpus, port_host, tmp_path, capsys):
    out = _preprocess(corpus, tmp_path / "dev", "--device_mels", "--device", "cpu")
    assert "device-extracted 12/12 on cpu" in capsys.readouterr().out
    _assert_same_corpus(out, port_host, MEL_ATOL_DEVICE)


def test_device_mels_without_a_card_raise(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _preprocess(corpus, tmp_path / "none", "--device_mels")
    assert not (tmp_path / "none").exists()


def test_two_workers_equal_one(corpus, port_host, tmp_path, capsys):
    out = tmp_path / "multi"
    two = ["--worker_count", "2", "--num_workers", "0"]
    with pytest.raises(SystemExit, match="not extracted yet"):
        _preprocess(corpus, out, "--worker_index", "0", *two)
    _preprocess(corpus, out, "--worker_index", "1", "--skip_records", *two)
    for w in ("0", "1"):
        _preprocess(corpus, out, "--worker_index", w, *two)
    for mode in ("train", "dev", "test"):
        names = [os.path.basename(p) for p in list_shards(port_host, mode)]
        assert names == [os.path.basename(p) for p in list_shards(str(out), mode)]
        for name in names:
            assert filecmp.cmp(os.path.join(port_host, name), str(out / name), shallow=False)


@pytest.mark.parametrize("workers", [1, 2, 3])
def test_record_writer_slicing_matches_jax(tmp_path, workers):
    root = tmp_path / "feats"
    root.mkdir()
    make_corpus_dir(root, n=20, num_mels=16)
    port, ref = tmp_path / "port", tmp_path / "jax"
    for w in range(workers):
        got = RecordWriter(str(root), str(port), 4, 16).write_all(w, workers)
        want = JaxRecordWriter(str(root), str(ref), 4, 16).write_all(w, workers)
        assert {m: [os.path.basename(p) for p in ps] for m, ps in got.items()} == \
            {m: [os.path.basename(p) for p in ps] for m, ps in want.items()}
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(ref)) and len(names) == 6
    for name in names:
        assert filecmp.cmp(str(port / name), str(ref / name), shallow=False), name


def test_databaker_text_dict_matches_jax(tmp_path):
    data = tmp_path / "databaker"
    data.mkdir()
    (data / "000001-010000.txt").write_text(LABELS, encoding="utf-8")
    dicts = []
    for cls, hp, name in ((DataBakerCorpus, get_config("databaker"), "port"),
                          (JaxDataBakerCorpus, jax_get_config("databaker"), "jax")):
        c = cls(str(data), str(tmp_path / name), hp)
        os.makedirs(c.text_dir)
        dicts.append(c.text_process())
        assert sorted(os.listdir(c.text_dir)) == ["000001.npy", "000002.npy", "000003.npy"]
    assert dicts[0] == dicts[1] and len(dicts[0]) == 3
    tok = DataBakerCorpus(None, None, get_config("databaker")).tokenizer
    assert "".join(tok.symbols[i] for i in dicts[0]["000003"]) == \
        "^nar4 you3 yi2-ge4 xiao3-hair2, zai4 war2.~"


@pytest.mark.parametrize("text,py", [
    ("000001 妈妈#1当时#1表示#3，儿子#1开心得#2像花儿#1一样#4。",
     "ma1 ma1 dang1 shi2 biao3 shi4 er2 zi5 kai1 xin1 de5 xiang4 huar1 yi2 yang4"),
    ("000002 你好#4。", "ni3 hao3"),
    ("000003 儿子#4。", "er2 zi5"),
    ("", "ni3"),
])
def test_parse_cn_prosody_label_matches_jax(text, py):
    for use_prosody in (False, True):
        assert (pinyin.parse_cn_prosody_label(text, py, use_prosody)
                == jax_pinyin.parse_cn_prosody_label(text, py, use_prosody))
    if text.startswith("000001"):
        assert pinyin.parse_cn_prosody_label(text, py) == (
            "ma1-ma1 dang1-shi2 biao3-shi4, er2-zi5 kai1-xin1-de5 xiang4-huar1 yi2-yang4.")


def test_text_to_pinyin():
    for line in ("ni3 hao3 shi4 jie4", "  Ni3   HAO3 ", "ma"):
        assert pinyin.text_to_pinyin(line) == jax_pinyin.text_to_pinyin(line)
    assert pinyin.text_to_pinyin("  Ni3   HAO3 ") == "ni3 hao3"
    assert [pinyin.is_erhua(s) for s in ("huar", "er", "r", "ma")] == [True, False, False, False]
    try:
        import pypinyin  # noqa: F401
    except ImportError:
        for fn in (pinyin.text_to_pinyin, jax_pinyin.text_to_pinyin):
            with pytest.raises(ImportError, match="pypinyin"):
                fn("你好")
    else:
        assert pinyin.text_to_pinyin("你好") == jax_pinyin.text_to_pinyin("你好")
