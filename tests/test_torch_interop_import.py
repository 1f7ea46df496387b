"""The port's reference-checkpoint importer (``vaenar_tts_torch/interop/
{tensorbundle,weight_map,importer}.py``) against the JAX package's, numpy
only (no JAX computation):

* a TensorBundle that the JAX package's ``export_reference_checkpoint``
  writes from the tiny model's weights is read by the port's
  ``load_reference_checkpoint`` into the same ``VAENAR`` state, bit for
  bit; the port's export writes the same bytes, and the JAX importer reads
  them back into the same trees;
* ``crc32c`` on the iSCSI test vectors and against the JAX package's on
  buffers on both sides of the lane-parallel path's threshold;
* a reference variable missing from the bundle, or a model variable the
  map does not know, raises and names it; a leaf of another shape makes
  ``check_tree_match`` name its path; the quantile length head, which the
  reference does not have, is refused at export;
* the mu/logvar swap of the reference's posterior crosses as in the JAX
  package's map (``tests/test_interop.py:208``), and the map of the
  LJSpeech preset has the reference's 501 variables.
"""

import numpy as np
import pytest
import torch

from vaenar_tts_tpu.configs import apply_overrides as jax_overrides
from vaenar_tts_tpu.configs import get_config
from vaenar_tts_tpu.interop import importer as jax_importer
from vaenar_tts_tpu.interop import tensorbundle as jax_bundle
from vaenar_tts_torch.configs.hparams import HParams
from vaenar_tts_torch.configs.serialize import hparams_from_dict
from vaenar_tts_tpu.configs.serialize import hparams_to_dict
from vaenar_tts_torch.interop import importer, tensorbundle, weight_map
from vaenar_tts_torch.interop.weights import load_jax_weights, torch_to_jax
from vaenar_tts_torch.models.vaenar import VAENAR
from vaenar_tts_torch.training.steps import init_parameters

from test_torch_model import TINY_OVERRIDES
from torch_threads import one_thread  # noqa: F401

ATTR = weight_map.ATTR


@pytest.fixture(scope="module")
def tiny():
    """(JAX hparams, port hparams, a port model with random weights, its
    flax trees)."""
    # the reference has no quantile length head
    jax_hp = jax_overrides(get_config("ljspeech"),
                           TINY_OVERRIDES + ["length_predictor.quantile=0"])
    hp = hparams_from_dict(hparams_to_dict(jax_hp))
    model = init_parameters(VAENAR(hp), 3)
    with torch.no_grad():  # every leaf nonzero and distinct
        g = torch.Generator().manual_seed(4)
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
        for name, b in model.named_buffers():
            if not name.endswith("num_batches_tracked"):
                b.add_(torch.rand(b.shape, generator=g))
    params, stats = torch_to_jax(model)
    return jax_hp, hp, model, params, stats


def test_jax_bundle_loads_into_the_same_state(tiny, tmp_path):
    jax_hp, hp, model, params, stats = tiny
    prefix = str(tmp_path / "ckpt-1")
    jax_importer.export_reference_checkpoint(prefix, jax_hp, params, stats)
    got_params, got_stats = importer.load_reference_checkpoint(prefix, hp, verify_crc=True)
    importer.check_tree_match(got_params, params, "params")
    importer.check_tree_match(got_stats, stats, "batch_stats")
    port = VAENAR(hp)
    load_jax_weights(port, got_params, got_stats)
    want = model.state_dict()
    assert set(port.state_dict()) == set(want)
    for name, value in port.state_dict().items():
        assert torch.equal(value, want[name]), name


def test_port_bundle_is_the_jax_bundle(tiny, tmp_path):
    jax_hp, hp, _, params, stats = tiny
    ours, theirs = str(tmp_path / "port" / "ckpt-1"), str(tmp_path / "jax" / "ckpt-1")
    importer.export_reference_checkpoint(ours, hp, params, stats)
    jax_importer.export_reference_checkpoint(theirs, jax_hp, params, stats)
    for suffix in (".index", ".data-00000-of-00001"):
        with open(ours + suffix, "rb") as a, open(theirs + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    back_params, back_stats = jax_importer.load_reference_checkpoint(ours, jax_hp,
                                                                     verify_crc=True)
    for got, want in ((back_params, params), (back_stats, stats)):
        paths = jax_importer._tree_paths(want)
        assert sorted(jax_importer._tree_paths(got)) == sorted(paths)
        for path in paths:
            np.testing.assert_array_equal(jax_importer._get_path(got, path),
                                          jax_importer._get_path(want, path))
    reader = tensorbundle.BundleReader(ours)
    assert len(reader.get("_CHECKPOINTABLE_OBJECT_GRAPH", verify_crc=True)) == 1


@pytest.mark.parametrize("n", [0, 1, 9, 2047, 2048, 2049, 65537, 300001])
def test_crc32c_matches_the_jax_copy(n):
    if n == 9:  # the iSCSI check value of "123456789"
        assert tensorbundle.crc32c(b"123456789") == 0xE3069283
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    for start in (0, 0x1234ABCD):
        assert tensorbundle.crc32c(data, start) == jax_bundle.crc32c(data, start)
    assert tensorbundle.crc32c_masked(data) == jax_bundle.crc32c_masked(data)


def test_crc32c_known_vectors():
    # RFC 3720 B.4 (iSCSI): 32 zero bytes, 32 0xFF bytes, 0..31, 31..0
    assert tensorbundle.crc32c(bytes(32)) == 0x8A9136AA
    assert tensorbundle.crc32c(b"\xff" * 32) == 0x62A8AB43
    assert tensorbundle.crc32c(bytes(range(32))) == 0x46DD794E
    assert tensorbundle.crc32c(bytes(range(31, -1, -1))) == 0x113FDB5C


def _write(prefix, hp, params, stats, skip=None, extra=None):
    w = tensorbundle.BundleWriter(prefix)
    trees = {"params": params, "batch_stats": stats}
    for ref, (coll, path) in weight_map.build_weight_map(hp).items():
        if ref != skip:
            w.add(ref, np.asarray(importer._get_path(trees[coll], path), np.float32))
    for ref, value in (extra or {}).items():
        w.add(ref, value)
    w.close()


def test_missing_or_extra_variable_is_named(tiny, tmp_path):
    _, hp, _, params, stats = tiny
    skipped = sorted(weight_map.build_weight_map(hp))[3]
    _write(str(tmp_path / "partial"), hp, params, stats, skip=skipped)
    with pytest.raises(ValueError, match="lacks") as err:
        importer.load_reference_checkpoint(str(tmp_path / "partial"), hp)
    assert skipped in str(err.value)
    orphan = f"model/decoder/extra_projection/kernel{ATTR}"
    _write(str(tmp_path / "extra"), hp, params, stats,
           extra={orphan: np.zeros((2, 2), np.float32),
                  # optimizer slots and bookkeeping are not model variables
                  f"model/decoder/pre_projection/bias/.OPTIMIZER_SLOT/optimizer/m{ATTR}":
                  np.zeros(2, np.float32), f"step{ATTR}": np.asarray(3, np.int64)})
    with pytest.raises(ValueError, match="not covered") as err:
        importer.load_reference_checkpoint(str(tmp_path / "extra"), hp)
    assert orphan in str(err.value)


def test_shape_mismatch_and_quantile_head_are_refused(tiny, tmp_path):
    _, hp, _, params, stats = tiny
    prefix = str(tmp_path / "ckpt")
    importer.export_reference_checkpoint(prefix, hp, params, stats)
    got, _ = importer.load_reference_checkpoint(prefix, hp)
    got["decoder"]["pre_projection"]["kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="decoder.*pre_projection.*kernel"):
        importer.check_tree_match(got, params, "params")
    quantile = dict(params, length_predictor=dict(
        params["length_predictor"], q_projection=params["length_predictor"]["projection"]))
    with pytest.raises(ValueError, match="q_projection"):
        importer.export_reference_checkpoint(str(tmp_path / "q"), hp, quantile, stats)


def test_mu_logvar_swap_and_map_size():
    hp = HParams()
    table = weight_map.build_weight_map(hp)
    assert table[f"model/posterior/mu_projection/kernel{ATTR}"] == (
        "params", ("posterior", "logvar_projection", "kernel"))
    assert table[f"model/posterior/logvar_projection/kernel{ATTR}"] == (
        "params", ("posterior", "mu_projection", "kernel"))
    assert len(table) == 501
    from vaenar_tts_tpu.interop.weight_map import build_weight_map
    assert table == build_weight_map(get_config("ljspeech"))
