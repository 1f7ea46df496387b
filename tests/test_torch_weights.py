"""The weight mapping from the JAX package's export onto the port's model."""

import copy
import os

import numpy as np
import pytest
import torch

from vaenar_tts_torch.configs.serialize import load_hparams
from vaenar_tts_torch.interop.weights import flatten, jax_to_torch, load_jax_weights
from vaenar_tts_torch.models.vaenar import VAENAR
from vaenar_tts_torch.utils.export import load_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(REPO, "artifacts", "toyv2_q90", "ckpt")


@pytest.fixture(scope="module")
def shipped():
    state = load_npz(os.path.join(SHIPPED, "export.npz"))
    return load_hparams(SHIPPED), state


def test_every_key_of_the_shipped_export_is_consumed(shipped):
    hp, state = shipped
    with np.load(os.path.join(SHIPPED, "export.npz")) as z:
        archive_keys = set(z.files)
    assert len(archive_keys) == 505  # 503 leaves + epoch + __meta__
    leaves = {"params/" + k for k in flatten(state["params"])}
    leaves |= {"batch_stats/" + k for k in flatten(state["batch_stats"])}
    assert leaves == archive_keys - {"epoch", "__meta__"}
    assert state["epoch"] == 1700

    model = VAENAR(hp)
    load_jax_weights(model, state["params"], state["batch_stats"])
    sd = model.state_dict()
    n_bn = len(flatten(state["batch_stats"])) // 2
    assert len(sd) == len(leaves) + n_bn  # + one num_batches_tracked per BN

    p, bs = state["params"], state["batch_stats"]
    enc = p["text_encoder"]
    np.testing.assert_array_equal(
        sd["text_encoder.self_attention0.attention.query_layer.weight"].numpy(),
        enc["self_attention0"]["attention"]["query_layer"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["text_encoder.EncoderPrenet.PreNetConv0.conv1d.weight"].numpy(),
        enc["EncoderPrenet"]["PreNetConv0"]["conv1d"]["kernel"].transpose(2, 1, 0))
    np.testing.assert_array_equal(
        sd["text_encoder.text_init_encoding.weight"].numpy(),
        enc["text_init_encoding"]["embedding"])
    np.testing.assert_array_equal(
        sd["decoder.postnet.conv_3.batch_norm.running_var"].numpy(),
        bs["decoder"]["postnet"]["conv_3"]["batch_norm"]["var"])
    np.testing.assert_array_equal(
        sd["prior.invertible_linear_2.weight"].numpy(),
        p["prior"]["invertible_linear_2"]["weight"])
    assert sd["text_encoder.pos_weight"].shape == ()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm1d):
            assert m.eps == 1e-3 and m.momentum == 0.01
        if isinstance(m, torch.nn.LayerNorm):
            assert m.eps == 1e-3


def _pop(tree, path):
    node = tree
    for part in path[:-1]:
        node = node[part]
    return node.pop(path[-1])


def test_strict_mapping_raises(shipped):
    hp, state = shipped
    model = VAENAR(hp)

    missing = copy.deepcopy(state["params"])
    _pop(missing, ["decoder", "residual_outputs", "bias"])
    with pytest.raises(KeyError, match="left unset"):
        load_jax_weights(model, missing, state["batch_stats"])

    extra = copy.deepcopy(state["params"])
    extra["decoder"]["extra_layer"] = {"kernel": np.zeros((2, 3), np.float32)}
    with pytest.raises(KeyError, match="does not have"):
        load_jax_weights(model, extra, state["batch_stats"])

    unknown = copy.deepcopy(state["params"])
    unknown["decoder"]["pre_projection"]["gamma"] = np.zeros((3,), np.float32)
    with pytest.raises(KeyError, match="no torch counterpart"):
        jax_to_torch(unknown, state["batch_stats"])

    wrong = copy.deepcopy(state["params"])
    wrong["decoder"]["residual_outputs"]["bias"] = np.zeros((81,), np.float32)
    with pytest.raises(ValueError, match="residual_outputs.bias"):
        load_jax_weights(model, wrong, state["batch_stats"])
