"""The mesh's model axis in the port (``parallel/mesh.shard_params``,
``parallel/ring_attention.py``, ``VAENAR(seq_mesh=)``) on four gloo
processes on the CPU, spawned once (this file run as a script is the
worker), with one torch thread each.

The model is the tiny override set with the encoder's, decoder's and
posterior's FFN widened to 512, so that the tensor-parallel rules pick
their first FFN layers (the tiny widths alone are all below 512), and
``train.ring_min_seq = 0``, so that every self-attention whose length
divides the axis rings. Its weights are random flax trees (no JAX init
run) written with the JAX package's ``save_npz``; the processes read them
with the port's ``load_npz``.

* The ring at ``model = 4`` (mesh data 1 x model 4), causal and not, random
  lengths with one item of length 0: the output against the JAX package's
  ``ring_self_attention`` on a 4-device mesh of the 8 CPU devices, atol
  2e-5 (``tests/test_ring_attention.py``), and the gradients of q, k and v
  against the port's plain masked attention's, atol 5e-4 (the same file's).
* A ``(data=2, model=2)`` fp32 train step with the wide FFN layers sharded
  and every self-attention on the ring, dropout on, against one process
  on the global batch from the same generator: the losses within 1e-4
  relative, the unsharded gradients within rtol 5e-3 and atol 5e-5 (JAX's
  ``tests/test_parallel.py:111-119``); every replicated gradient equal to
  the last bit across each model group; once with ``remat = "on"``.
* ``ShardedSynthesizer`` on ``(data=2, model=2)`` at temperature 0 and
  0.667 against one process: the lengths equal, the mels within 1e-5.
* The JAX model as a whole: the per-example forward losses (dropout off,
  BatchNorm on its running statistics, injected posterior noise) of the
  JAX package's ``VAENAR(ring_hp, seq_mesh=make_mesh(data=4, model=2))``,
  computed by this process while the four run, against the port's ringed
  and sharded forward at ``(data=2, model=2)`` on the same weights and
  inputs, within 1e-4 relative.

``tests/test_torch_parallel.py`` holds the sharding rule against JAX's and
``shard_params`` on a one-process stub of the model group.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, REPO)

from vaenar_tts_torch.parallel.mesh import (make_mesh, shard_params,  # noqa: E402
                                            sharded_parameters, unshard_params)

WIDE = ["encoder.ffn_hidden=512", "decoder.ffn_hidden=512", "posterior.ffn_hidden=512",
        "train.ring_min_seq=0", "prior.n_blk=2", "length_predictor.quantile=0.9",
        "train.compute_dtype=float32"]
B, TEXT, MEL, R = 4, 32, 120, 2
RING_SHAPE = (3, 2, 32, 8)  # B, H, T, D of the ring op at model = 4
RING_LENGTHS = [32, 19, 0]  # whole, ragged, and one item with every row masked
TOL_RING, TOL_RING_GRAD = 2e-5, 5e-4
TOL_LOSS = 1e-4
GRAD_RTOL, GRAD_ATOL = 5e-3, 5e-5
TOL_MEL = 1e-5
TIMEOUT_S = 300


def ring_inputs():
    """q, k, v [B, H, T, D], the upstream gradient and the lengths."""
    rng = np.random.default_rng(31)
    q, k, v, do = (rng.standard_normal(RING_SHAPE).astype(np.float32) for _ in range(4))
    return q, k, v, do, np.asarray(RING_LENGTHS, np.int32)


def port_ring(dist, causal):
    """The ring's output and the gradients of q, k and v under ``do``."""
    from vaenar_tts_torch.parallel.ring_attention import ring_self_attention
    q, k, v, do, lengths = (torch.from_numpy(a) for a in ring_inputs())
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    o = ring_self_attention(q, k, v, lengths, dist, scale=RING_SHAPE[3] ** -0.5,
                            causal=causal)
    (o * do).sum().backward()
    return o.detach(), q.grad, k.grad, v.grad


def plain_ring_reference(causal):
    """The same through the port's plain masked attention, one process."""
    from vaenar_tts_torch.ops.flash_attention import MaskedFlashAttention
    q, k, v, do, lengths = (torch.from_numpy(a) for a in ring_inputs())
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    o = MaskedFlashAttention.apply(q, k, v, lengths, lengths, RING_SHAPE[3] ** -0.5, causal)
    (o * do).sum().backward()
    return o.detach(), q.grad, k.grad, v.grad


def load_inputs(path):
    from vaenar_tts_torch.configs.serialize import hparams_from_dict
    deadline = time.time() + TIMEOUT_S
    while not os.path.exists(path):  # the test process renames it into place
        assert time.time() < deadline, "no inputs"
        time.sleep(0.05)
    inputs = torch.load(path, weights_only=False)
    return hparams_from_dict(inputs["hp"]), inputs


def build(hp, inputs, dist=None, **kw):
    """The port's model on the inputs' weights, ringed over ``dist`` and
    sharded over its mesh when given."""
    import dataclasses
    from vaenar_tts_torch.interop.weights import load_jax_weights
    from vaenar_tts_torch.models.vaenar import VAENAR
    from vaenar_tts_torch.utils.export import load_npz
    if kw:
        hp = dataclasses.replace(hp, train=dataclasses.replace(hp.train, **kw))
    state = load_npz(inputs["npz"])
    model = VAENAR(hp, seq_mesh=dist)
    load_jax_weights(model, state["params"], state["batch_stats"])
    if dist is not None:
        shard_params(model, dist.mesh, dist)
    return hp, model


def step_case(hp, inputs, dist, rows, **kw):
    """One train step (dropout on, generator seeded 5): metrics, the whole
    gradients, this process's own gradients, and the sharded names."""
    from vaenar_tts_torch.training import steps
    hp, model = build(hp, inputs, dist, **kw)
    opt = steps.make_optimizer(hp, model)
    batch = [torch.from_numpy(a[rows]) for a in inputs["batch"]]
    batch[0] = batch[0].long()
    gen = torch.Generator().manual_seed(5)
    m = steps.train_step(model, opt, hp, *batch, 0.5, R, gen, dist=dist)
    grads = {n: p.grad for n, p in model.named_parameters()}
    whole = grads if dist is None else unshard_params(model, dist.mesh, dist, grads)
    return (steps.metric_floats(m), whole, {n: g.clone() for n, g in grads.items()},
            sorted(sharded_parameters(model)))


def synthesis_case(hp, inputs, dist, temperature):
    from vaenar_tts_torch.parallel.synthesis import ShardedSynthesizer
    hp, model = build(hp, inputs, dist)
    texts, _, t_lens, _ = inputs["batch"]
    gen = torch.Generator().manual_seed(21)
    return ShardedSynthesizer(hp, model.eval(), dist).synthesize(texts, t_lens, 2 * MEL,
                                                                 temperature, gen)


def forward_case(hp, inputs, dist, rows):
    """The per-example forward losses (train=False, injected noise)."""
    hp, model = build(hp, inputs, dist)
    texts, mels, t_lens, m_lens = (torch.from_numpy(a[rows]) for a in inputs["batch"])
    with torch.no_grad():
        _, mel_l2, kl, length_loss, _ = model(
            texts.long(), mels, m_lens, t_lens, reduction_factor=R, train=False,
            reduce_loss=False, epsilon=torch.from_numpy(inputs["eps"][rows]))
    out = {"mel_l2": mel_l2, "kl": kl, "length": length_loss}
    return {k: v if dist is None else dist.fetch(v) for k, v in out.items()}


def worker(rank, port, out_dir):
    """One of the four processes: the fleet's results to
    ``out_dir/rank<r>.pt``, and each process one of the one-process
    references once the fleet's collectives are done."""
    import torch.distributed as tdist

    from vaenar_tts_torch.parallel.distributed import DistContext
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=4,
                             rank=rank)
    ring4 = DistContext("cpu", make_mesh(data=1, model=4, processes=4))
    mesh = make_mesh(data=2, model=2, processes=4)
    dist = DistContext("cpu", mesh)
    out = {"ring": {c: port_ring(ring4, c) for c in (False, True)},
           "indices": (dist.data_index, dist.model_index, ring4.model_index)}
    hp, inputs = load_inputs(os.path.join(out_dir, "inputs.pt"))
    mine = slice(2 * dist.data_index, 2 * dist.data_index + 2)
    out["step"] = step_case(hp, inputs, dist, mine)
    out["step_remat"] = step_case(hp, inputs, dist, mine, remat="on")
    for temp in (0.0, 0.667):
        out[f"synth{temp}"] = synthesis_case(hp, inputs, dist, temp)
    out["forward"] = forward_case(hp, inputs, dist, mine)
    dist.close()
    every = slice(None)
    if rank == 0:
        out["ref_step"] = step_case(hp, inputs, None, every)
    elif rank == 1:
        out["ref_ring"] = {c: plain_ring_reference(c) for c in (False, True)}
        out["ref_forward"] = forward_case(hp, inputs, None, every)
    else:
        temp = (0.0, 0.667)[rank - 2]
        out[f"ref_synth{temp}"] = synthesis_case(hp, inputs, None, temp)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def jax_inputs(out_dir):
    """The JAX hparams, and the workers' inputs: random flax weights written
    with the JAX package's ``save_npz``, a batch and posterior noise."""
    from vaenar_tts_tpu.configs import apply_overrides, get_config
    from vaenar_tts_tpu.configs.serialize import hparams_to_dict
    from vaenar_tts_tpu.utils.export import save_npz

    import test_torch_train_step as one
    from test_torch_parallel import TINY, global_batch
    hp = apply_overrides(get_config("ljspeech"), TINY + WIDE)
    params, stats = one.random_variables(hp, seed=23)
    npz = os.path.join(out_dir, "weights.npz")
    save_npz(npz, {"params": params, "batch_stats": stats, "epoch": 0}, store_dtype=None)
    eps = np.random.default_rng(6).standard_normal(
        (B, 1, MEL // R, hp.common.latent_dim)).astype(np.float32)
    return hp, params, stats, {"hp": hparams_to_dict(hp), "npz": npz,
                               "batch": global_batch(), "eps": eps}


def jax_results(hp, params, stats, inputs):
    """The JAX ring at model = 4 and the JAX model's ringed forward losses."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    import test_torch_train_step as one
    from vaenar_tts_tpu.models import vaenar as jvaenar
    from vaenar_tts_tpu.parallel import make_mesh as jax_make_mesh
    from vaenar_tts_tpu.parallel.ring_attention import ring_self_attention
    mesh4 = Mesh(np.asarray(jax.devices()[:4]), ("model",))
    q, k, v, _, lengths = ring_inputs()
    ring = {c: np.asarray(ring_self_attention(q, k, v, lengths, mesh4,
                                              scale=RING_SHAPE[3] ** -0.5, causal=c))
            for c in (False, True)}
    ring_hp = hp.replace(train=dataclasses.replace(hp.train, ring_min_seq=0))
    model = jvaenar.VAENAR(ring_hp, seq_mesh=jax_make_mesh(data=4, model=2))
    texts, mels, t_lens, m_lens = inputs["batch"]
    with pytest.MonkeyPatch.context() as mp:
        one.inject(mp, inputs["eps"])
        _, mel_l2, kl, length, _ = jax.jit(
            lambda p, bs: model.apply({"params": p, "batch_stats": bs}, jnp.asarray(texts),
                                      mels, m_lens, t_lens, reduction_factor=R, train=False,
                                      reduce_loss=False, rngs={"sample": jax.random.key(1)}))(
            params, stats)
    return ring, {"mel_l2": np.asarray(mel_l2), "kl": np.asarray(kl),
                  "length": np.asarray(length)}


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    out = tmp_path_factory.mktemp("model_axis")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    logs = [out / f"rank{r}.txt" for r in range(4)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(port),
                               str(out)], cwd=REPO, env=env, stdout=open(logs[r], "w"),
                              stderr=subprocess.STDOUT) for r in range(4)]
    try:
        # while the four processes run
        hp, params, stats, inputs = jax_inputs(str(out))
        torch.save(inputs, out / "inputs.pt.tmp")
        os.replace(out / "inputs.pt.tmp", out / "inputs.pt")
        jax_ring, jax_forward = jax_results(hp, params, stats, inputs)
        for p in procs:
            p.wait(timeout=TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"process {r}:\n{logs[r].read_text()[-4000:]}"
    results = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(4)]
    return results, {"ring": jax_ring, "forward": jax_forward}


def test_mesh_indices(fleet):
    results, _ = fleet
    # process-major: a model group is two consecutive ranks
    assert [r["indices"] for r in results] == [(0, 0, 0), (0, 1, 1), (1, 0, 2), (1, 1, 3)]


@pytest.mark.parametrize("causal", [False, True])
def test_ring_at_model_4_matches_jax_and_plain_gradients(fleet, causal):
    results, jax_ref = fleet
    plain = results[1]["ref_ring"][causal]
    for res in results:
        o, dq, dk, dv = res["ring"][causal]
        np.testing.assert_allclose(o.numpy(), jax_ref["ring"][causal], atol=TOL_RING, rtol=0)
        np.testing.assert_allclose(o.numpy(), plain[0].numpy(), atol=TOL_RING, rtol=0)
        for got, want in zip((dq, dk, dv), plain[1:]):
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL_RING_GRAD, rtol=0)
    # the item of length 0: every row is the mean of v over all T keys
    v = torch.from_numpy(ring_inputs()[2])
    uniform = v[2].mean(dim=1, keepdim=True).expand_as(v[2])
    assert torch.allclose(results[0]["ring"][causal][0][2], uniform, atol=TOL_RING)


@pytest.mark.parametrize("case", ["step", "step_remat"])
def test_tp_ring_train_step_equals_one_process(fleet, case):
    results, _ = fleet
    ref_m, ref_g, _, ref_sharded = results[0]["ref_step"]
    assert ref_sharded == []
    for res in results:
        m, whole, _, sharded = res[case]
        assert sharded == ["decoder.decoder_attention_0.ffn.dense1.weight",
                           "posterior.attention_0.ffn.dense1.weight",
                           "text_encoder.self_attention0.ffn.dense1.weight"]
        for name, want in ref_m.items():
            assert m[name] == pytest.approx(want, rel=TOL_LOSS), name
        assert set(whole) == set(ref_g)
        for name, want in ref_g.items():
            assert whole[name].shape == want.shape, name
            np.testing.assert_allclose(whole[name].numpy(), want.numpy(), rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=name)
    # every process of a model group holds the same replicated gradients
    for a, b in ((0, 1), (2, 3)):
        own_a, own_b = results[a][case][2], results[b][case][2]
        sharded = set(results[a][case][3])
        for name in own_a:
            if name not in sharded:
                assert torch.equal(own_a[name], own_b[name]), (a, b, name)
        for name in sharded:
            assert torch.equal(results[a][case][1][name], results[b][case][1][name])


@pytest.mark.parametrize("temperature", [0.0, 0.667])
def test_tp_ring_sharded_synthesis_equals_one_process(fleet, temperature):
    results, _ = fleet
    ref_mels, ref_lens = results[2 + (temperature > 0)][f"ref_synth{temperature}"]
    for res in results:
        mels, lens = res[f"synth{temperature}"]
        assert torch.equal(lens, ref_lens)
        assert (mels - ref_mels).abs().max().item() <= TOL_MEL


def test_ringed_forward_matches_the_jax_ring_model(fleet):
    results, jax_ref = fleet
    for res in results:
        for name, want in jax_ref["forward"].items():
            np.testing.assert_allclose(res["forward"][name].numpy(), want, rtol=TOL_LOSS,
                                       atol=0, err_msg=name)
            np.testing.assert_allclose(res["forward"][name].numpy(),
                                       results[1]["ref_forward"][name].numpy(), rtol=TOL_LOSS,
                                       atol=0, err_msg=name)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
