"""The port's data parallelism (``vaenar_tts_torch/parallel``) on two gloo
processes on the CPU, spawned once (this file run as a script is the
worker), against one process on the concatenated global batch:

* ``DistContext``'s collectives give the expected values;
* BatchNorm in training (output, input and parameter gradients, running
  statistics) and the ActNorm data init over two processes equal one
  process on the global batch within 1e-6 relative;
* one fp32 train step of the tiny model (dropout on, noise and masks drawn
  for the global batch) gives every gradient and every updated parameter of
  the single-process step within 1e-5 relative, with ``grad_accum`` 1 and
  2 (micro-batches of the GLOBAL batch) at r = 2, and at r = 5. A
  gradient's error is relative to the largest of its leaf's reference and
  of the processes' parts that the average sums, (|p0| + |p1|) / 2: a sum
  that cancels (``pos_weight``) is exact only to the rounding of its terms.
  The bias of a conv that feeds BatchNorm has a gradient of 0 in exact
  arithmetic (the batch mean takes it out): both sides are held under 1e-5
  of the conv weight's largest gradient. A parameter's error is 1e-5 of its
  leaf's largest value plus what the gradient's measured error moves
  Adam's first step, lr · g / (|g| + eps), by: lr · eps · |dg| /
  (min|g| + eps)², min|g| the least |g| between the two (0 across a sign
  change), which is large only where |g| is near eps (the
  zero-initialised heads at r = 5, the BatchNorm-fed biases);
* the kl clamp max(kl, 0) acts on the global batch's kl: with one
  process's mean kl negative and the global one positive, the fleet's
  gradient is the global step's;
* ``ShardedSynthesizer`` equals the unsharded synthesis at temperature 0
  and 0.667 (lengths exactly, mels within 1e-5), and so does its
  ``run_dataset`` over a test shard;
* the step of ``test_torch_train_step.py`` (its random flax weights, batch
  of 2 at r = 2, posterior noise, no dropout, grad_accum 1), taken by the
  two processes on a row each, against the JAX package's single-process
  step on the whole batch, which this process computes while the two run
  (attention through JAX's plain reference; the two take the inputs from
  a file this process writes once JAX has made them): the losses within 1e-5
  relative, every averaged gradient within 1e-4 + 1e-3 max|g_jax| of its
  leaf, and the BatchNorm running statistics within 1e-5, the tolerances
  of the one-process test. This ties the fleet to JAX directly, not only
  through the port's own single-process step.

* the same two processes as one model group (mesh data 1 x model 2), the
  wide tiny model's FFN layers sharded, one train step with process 1's
  gradient of a replicated leaf moved by 1e-6 (as a gradient that is not
  reproducible moves, cuDNN's on the card): every replicated parameter is
  bit-equal across the two after Adam's step, and is not once the group's
  average of the replicated gradients (``DistContext.average_replicas``)
  is switched off.

Outside the spawn: ``param_sharding_rules`` picks the parameters that the
JAX rule picks on the shipped export's shapes (names mapped through
``interop.weights``); ``shard_params`` at ``model = 2`` on a one-process
stub of the model group cuts exactly those to the process's columns and
``unshard_params`` puts the rest back bit for bit; ``train.ring_min_seq``
loads from a JAX ``hparams.json``. The model axis on a real group is
``tests/test_torch_model_axis.py``.
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

from vaenar_tts_torch.configs.hparams import HParams  # noqa: E402
from vaenar_tts_torch.configs.overrides import apply_overrides  # noqa: E402
from vaenar_tts_torch.models.flow import actnorm_init_stats  # noqa: E402
from vaenar_tts_torch.models.layers import BatchNorm  # noqa: E402
from vaenar_tts_torch.parallel.data_group import data_group  # noqa: E402
from vaenar_tts_torch.parallel.mesh import (make_mesh, param_sharding_rules,  # noqa: E402
                                            shard_params, sharded_parameters,
                                            unshard_params)
from vaenar_tts_torch.training import steps  # noqa: E402

# the tiny override set (tests/test_torch_model.py) with dropout left on
TINY = [
    "encoder.embd_dim=32", "encoder.pre_hidden=32", "encoder.n_conv=1", "encoder.n_blk=1",
    "encoder.attention_dim=16", "encoder.attention_heads=2", "encoder.ffn_hidden=32",
    "decoder.nblk=1", "decoder.attention_dim=16", "decoder.attention_heads=2",
    "decoder.ffn_hidden=32", "decoder.post_n_conv=1", "decoder.post_conv_filters=16",
    "posterior.pre_hidden=16", "posterior.nblk=1", "posterior.attention_dim=16",
    "posterior.attention_heads=2", "posterior.ffn_hidden=32", "prior.n_blk=2",
    "prior.n_transformer_blk=1", "prior.attention_dim=16", "prior.attention_heads=2",
    "prior.ffn_hidden=32", "common.latent_dim=8", "length_predictor.quantile=0.9",
    "train.compute_dtype=float32", "train.train_batch_size=4",
]
# the tiny set with the FFNs widened to 512, which the sharding rule picks
WIDE = ["encoder.ffn_hidden=512", "decoder.ffn_hidden=512", "posterior.ffn_hidden=512"]
GLOBAL_B, TEXT, MEL, R = 4, 32, 120, 2
TOL_STATS = 1e-6
TOL_STEP = 1e-5
TOL_MEL = 1e-5


def tiny_hp(*extra):
    return apply_overrides(HParams(), TINY + list(extra))


def global_batch(seed=7):
    rng = np.random.default_rng(seed)
    t_lens = rng.integers(12, TEXT + 1, GLOBAL_B).astype(np.int32)
    m_lens = rng.integers(60, MEL + 1, GLOBAL_B).astype(np.int32)
    texts = np.zeros((GLOBAL_B, TEXT), np.int64)
    for i, n in enumerate(t_lens):
        texts[i, :n] = rng.integers(3, 43, n)
    mels = rng.uniform(0, 1, (GLOBAL_B, MEL, 80)).astype(np.float32)
    return texts, mels, t_lens, m_lens


def batchnorm_case(group, rows):
    """BatchNorm in training on rows of a seeded global [4, 6, 10] input: the
    output, the input's and parameters' gradients, the running stats."""
    torch.manual_seed(0)
    bn = BatchNorm(6)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
    x_all = torch.from_numpy(np.random.default_rng(1).normal(1.0, 2.0, (4, 6, 10))
                             .astype(np.float32))
    w_all = torch.from_numpy(np.random.default_rng(2).normal(size=(4, 6, 10)).astype(np.float32))
    x = x_all[rows].clone().requires_grad_(True)
    with data_group(group):
        y = bn(x, train=True)
    (y * w_all[rows]).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
            "mean": bn.running_mean, "var": bn.running_var}


def actnorm_case(group, rows):
    z = torch.from_numpy(np.random.default_rng(3).normal(0.5, 3.0, (4, 7, 8)).astype(np.float32))
    with data_group(group):
        return actnorm_init_stats(z[rows])


STEP_CASES = [(1, 2), (2, 2), (1, 5)]  # (grad_accum, reduction factor)


def train_case(dist, accum, rows, r=R):
    """One train step from the same init on ``rows`` of the global batch:
    (metrics, gradients, updated parameters, this process's gradients
    before the average)."""
    hp = tiny_hp(f"train.grad_accum={accum}")
    model = steps.init_model(hp, 11, "cpu")
    opt = steps.make_optimizer(hp, model)
    gen = torch.Generator().manual_seed(5)
    batch = [torch.from_numpy(a[rows]) for a in global_batch()]
    parts = {}
    if dist is not None:
        average = dist.average_gradients

        def keep_parts(params, extra=None):
            parts.update({n: p.grad.clone() for n, p in model.named_parameters()})
            return average(params, extra)
        dist.average_gradients = keep_parts
    m = steps.train_step(model, opt, hp, *batch, 1e-3, r, gen, dist=dist)
    if dist is not None:
        dist.average_gradients = average
    return (steps.metric_floats(m), {n: p.grad.clone() for n, p in model.named_parameters()},
            {n: p.detach().clone() for n, p in model.named_parameters()}, parts)


class KlModel(torch.nn.Module):
    """A stand-in for VAENAR whose kl is w times the rows' mels[:, 0, 0]
    (3, 1, -2, -1: process 0's mean 2, process 1's -1.5, the global 0.25),
    mel_l2 and the length loss 0."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))

    def forward(self, texts, mels, m_lens, t_lens, **kw):
        zero = self.w * 0.0
        return None, zero, self.w * mels[:, 0, 0].mean(), zero, None


def kl_clamp_case(dist, rows):
    model = KlModel()
    hp = tiny_hp()
    mels = torch.zeros(GLOBAL_B, 4, 80)
    mels[:, 0, 0] = torch.tensor([3.0, 1.0, -2.0, -1.0])
    ids = torch.zeros(GLOBAL_B, 4, dtype=torch.int64)
    lens = torch.full((GLOBAL_B,), 4, dtype=torch.int32)
    m = steps.train_step(model, steps.make_optimizer(hp, model), hp, ids[rows], mels[rows],
                         lens[rows], lens[rows], 0.5, R, dist=dist)
    return model.w.grad.item(), steps.metric_floats(m)


def synthesis_case(dist, temperature):
    from vaenar_tts_torch.parallel.synthesis import ShardedSynthesizer
    hp = tiny_hp()
    model = steps.init_model(hp, 13, "cpu")
    texts, _, t_lens, _ = global_batch(9)
    gen = torch.Generator().manual_seed(21)
    return ShardedSynthesizer(hp, model, dist).synthesize(texts, t_lens, 240, temperature, gen)


def run_dataset_case(dist, records):
    """``run_dataset`` over a test shard of 6 utterances in batches of 4:
    [(fids, mels, lengths, seconds)]."""
    from vaenar_tts_torch.data.loader import BucketedLoader
    from vaenar_tts_torch.parallel.synthesis import ShardedSynthesizer
    hp = tiny_hp()
    synth = ShardedSynthesizer(hp, steps.init_model(hp, 13, "cpu"), dist)
    loader = BucketedLoader([records], 4, 120, 32, shuffle=False)
    return [(b.fids, mels, lens, s) for b, mels, lens, s
            in synth.run_dataset(loader, 240, temperature=0.5, seed=3)]


# a replicated leaf whose gradient is 0 at the first step (the posterior's
# heads start at 0), so that a perturbation of it shows through Adam
PERTURBED_LEAF = "posterior.decoder_prenet.dense_1.bias"


def replica_case(dist, averaged):
    """One train step of the sharded wide model on the global batch, with
    ``1e-6 * rank`` added to PERTURBED_LEAF's gradient: this process's
    replicated parameters after the step, and the sharded names."""
    hp = tiny_hp(*WIDE)
    model = shard_params(steps.init_model(hp, 11, "cpu"), dist.mesh, dist)
    opt = steps.make_optimizer(hp, model)
    rank = dist.model_index
    dict(model.named_parameters())[PERTURBED_LEAF].register_hook(lambda g: g + 1e-6 * rank)
    if not averaged:
        dist.average_replicas = lambda model: None
    batch = [torch.from_numpy(a) for a in global_batch()]
    steps.train_step(model, opt, hp, *batch, 1e-3, R, torch.Generator().manual_seed(5),
                     dist=dist)
    if not averaged:
        del dist.average_replicas
    sharded = sorted(sharded_parameters(model))
    return ({n: p.detach().clone() for n, p in model.named_parameters() if n not in sharded},
            sharded)


def jax_step_inputs():
    """(the JAX package's hparams, the workers' inputs) of the step of
    ``test_torch_train_step.py``, with JAX's plain reference attention."""
    import test_torch_train_step as one
    from vaenar_tts_tpu.configs import apply_overrides as jax_overrides
    from vaenar_tts_tpu.configs import get_config
    from vaenar_tts_tpu.configs.serialize import hparams_to_dict
    from vaenar_tts_torch.interop.weights import flatten
    hp = jax_overrides(get_config("ljspeech"), one.TINY_OVERRIDES + one.NO_DROPOUT
                       + ["train.use_pallas_attention=false"])
    params, stats = one.random_variables(hp, seed=21)
    eps = np.random.default_rng(4).standard_normal(
        (one.B, 1, one.MEL // one.R, hp.common.latent_dim)).astype(np.float32)
    def host(tree):
        return {k: np.asarray(v) for k, v in flatten(tree).items()}
    return hp, {"hp": hparams_to_dict(hp), "params": host(params), "stats": host(stats),
                "batch": one.batch(), "eps": eps, "kl_weight": one.KL_WEIGHT, "r": one.R}


def jax_step(hp, inputs):
    """The JAX train step's losses, gradients and BatchNorm statistics
    after it, as flat {path: array}."""
    import jax
    import test_torch_train_step as one
    from vaenar_tts_tpu.models import vaenar as jvaenar
    from vaenar_tts_torch.interop.weights import flatten
    params, stats = unflatten(inputs["params"]), unflatten(inputs["stats"])
    with pytest.MonkeyPatch.context() as mp:
        one.inject(mp, inputs["eps"])
        loss_fn = one.jax_loss_fn(jvaenar.VAENAR(hp), hp, inputs["eps"], inputs["r"],
                                  train=True)
        (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params, stats, *inputs["batch"])
    mel_l2, kl, len_l2, pinball, new_stats = aux
    metrics = {"mel_l2": mel_l2, "kl": kl, "len_l2": len_l2, "len_pinball": pinball,
               "total": loss}
    return ({k: float(v) for k, v in metrics.items()},
            {k: np.asarray(v) for k, v in flatten(grads).items()},
            {k: np.asarray(v) for k, v in flatten(new_stats).items()})


def unflatten(flat):
    """{'a/b/leaf': array} -> nested dicts."""
    tree: dict = {}
    for path, leaf in flat.items():
        *heads, last = path.split("/")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return tree


def jax_inputs_case(dist, rows, inputs):
    """The fleet's step on ``inputs`` (``jax_step_inputs``), this process
    on ``rows``: (metrics, averaged gradients, BatchNorm statistics after
    the step), flat under the flax paths."""
    from vaenar_tts_torch.configs.serialize import hparams_from_dict
    from vaenar_tts_torch.interop.weights import flatten, load_jax_weights, torch_to_jax
    from vaenar_tts_torch.models.vaenar import VAENAR
    hp = hparams_from_dict(inputs["hp"])
    model = VAENAR(hp)
    load_jax_weights(model, unflatten(inputs["params"]), unflatten(inputs["stats"]))
    texts, mels, t_lens, m_lens = (torch.from_numpy(a[rows]) for a in inputs["batch"])
    m = steps.train_step(model, steps.make_optimizer(hp, model), hp, texts.long(), mels,
                         t_lens, m_lens, inputs["kl_weight"], inputs["r"],
                         epsilon=torch.from_numpy(inputs["eps"]), dist=dist)
    grads, _ = torch_to_jax(model, {n: p.grad for n, p in model.named_parameters()})
    _, stats = torch_to_jax(model)
    return steps.metric_floats(m), flatten(grads), flatten(stats)


def worker(rank, port, out_dir):
    """One of the two processes: the fleet's results, and on process 0 the
    single-process ones, to ``out_dir/rank<r>.pt``."""
    import torch.distributed as tdist

    from vaenar_tts_torch.parallel.distributed import DistContext, is_multiprocess
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                             rank=rank)
    dist = DistContext("cpu")
    mine = slice(rank * 2, rank * 2 + 2)
    out = {"collectives": {
        "sum": dist.all_reduce_sum(torch.tensor([1.0, rank + 1.0])),
        "fetch": dist.fetch(torch.full((2, 3), float(rank))),
        "min": dist.sync_min(5 + rank), "max": dist.sync_max(5 + rank),
        "emax": dist.sync_elementwise_max(np.array([[rank, 3 - rank], [7, rank * 9]])),
        "allsum": dist.allsum([0.5, rank]),
        "rows": (dist.rows(3).start, dist.rows(3).stop, dist.rows(3).total),
        "multiprocess": is_multiprocess(),
        "global_batch": dist.global_batch(np.ones((2, 3), np.int32), np.ones(2, np.int32),
                                          np.ones((2, 3, 4), np.float32)),
        "to_host": dist.to_host({"a": [torch.ones(2)], "b": 3})}}
    lin = torch.nn.Linear(2, 2)
    with torch.no_grad():
        lin.weight.fill_(float(rank))
    dist.replicate(lin)
    out["collectives"]["replicated"] = lin.weight.detach().clone()
    p = torch.nn.Parameter(torch.zeros(3))
    p.grad = torch.full((3,), float(rank + 1))
    avg = dist.average_gradients([p], {"loss": torch.tensor(float(rank * 4))})
    out["collectives"]["avg_grad"], out["collectives"]["avg_loss"] = p.grad, avg["loss"]
    dist.barrier()

    out["bn"] = batchnorm_case(dist.rows(2), mine)
    out["actnorm"] = actnorm_case(dist.rows(2), mine)
    for accum, r in STEP_CASES:
        out[f"step{accum}_{r}"] = train_case(dist, accum, mine, r)
    out["kl_clamp"] = kl_clamp_case(dist, mine)
    for temp in (0.0, 0.667):
        out[f"synth{temp}"] = synthesis_case(dist, temp)
    from vaenar_tts_torch.data.records import RecordShardWriter
    records = os.path.join(out_dir, f"test-{rank}.vrs")
    rng = np.random.default_rng(17)
    w = RecordShardWriter(records, 80)
    for i in range(6):
        n = int(rng.integers(8, 30))
        w.add(f"t{i}", rng.integers(3, 43, n).astype(np.int32),
              rng.uniform(0, 1, (int(rng.integers(40, 120)), 80)).astype(np.float32))
    w.close()
    out["dataset"] = run_dataset_case(dist, records)
    group = DistContext("cpu", make_mesh(data=1, model=2, processes=2))
    out["replicas"] = {averaged: replica_case(group, averaged) for averaged in (True, False)}
    inputs = os.path.join(out_dir, "jax_step_inputs.pt")
    deadline = time.time() + 300
    while not os.path.exists(inputs):  # the test process renames it into place
        assert time.time() < deadline, "no JAX step inputs"
        time.sleep(0.05)
    out["jax_inputs"] = jax_inputs_case(dist, slice(rank, rank + 1),
                                        torch.load(inputs, weights_only=False))
    if rank == 0:
        every = slice(None)
        out["ref"] = {"bn": batchnorm_case(None, every), "actnorm": actnorm_case(None, every),
                      "kl_clamp": kl_clamp_case(None, every),
                      **{f"step{a}_{r}": train_case(None, a, every, r) for a, r in STEP_CASES},
                      **{f"synth{t}": synthesis_case(None, t) for t in (0.0, 0.667)},
                      "dataset": run_dataset_case(None, records)}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.close()


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    logs = [out / f"rank{r}.txt" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(port),
                               str(out)], cwd=REPO, env=env, stdout=open(logs[r], "w"),
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        # while the two processes run
        hp, inputs = jax_step_inputs()
        torch.save(inputs, out / "jax_step_inputs.pt.tmp")
        os.replace(out / "jax_step_inputs.pt.tmp", out / "jax_step_inputs.pt")
        jax_ref = jax_step(hp, inputs)
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"process {r}:\n{logs[r].read_text()[-4000:]}"
    results = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]
    results[0]["ref"]["jax_inputs"] = jax_ref
    return results


def rel_err(got, want):
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)


def test_collectives(fleet):
    for r, res in enumerate(fleet):
        c = res["collectives"]
        assert torch.equal(c["sum"], torch.tensor([2.0, 3.0]))
        assert torch.equal(c["fetch"], torch.tensor([[0.0] * 3] * 2 + [[1.0] * 3] * 2))
        assert (c["min"], c["max"]) == (5, 6)
        np.testing.assert_array_equal(c["emax"], [[1, 3], [7, 9]])
        np.testing.assert_array_equal(c["allsum"], [1.0, 1.0])
        assert c["rows"] == (3 * r, 3 * r + 3, 6) and c["multiprocess"]
        assert [(t.dtype, tuple(t.shape)) for t in c["global_batch"]] == [
            (torch.int64, (2, 3)), (torch.int32, (2,)), (torch.float32, (2, 3, 4))]
        assert isinstance(c["to_host"]["a"][0], np.ndarray) and c["to_host"]["b"] == 3
        assert torch.equal(c["replicated"], torch.zeros(2, 2))  # process 0's weights
        assert torch.equal(c["avg_grad"], torch.full((3,), 1.5))
        assert c["avg_loss"].item() == 2.0


def test_batchnorm_and_actnorm_take_global_statistics(fleet):
    ref = fleet[0]["ref"]
    for key in ("y", "dx"):
        got = torch.cat([fleet[r]["bn"][key] for r in range(2)])
        assert rel_err(got, ref["bn"][key]) <= TOL_STATS, key
    for r in range(2):
        # parameter gradients: each process's part, summed over the processes
        for key in ("dw", "db"):
            got = fleet[0]["bn"][key] + fleet[1]["bn"][key]
            assert rel_err(got, ref["bn"][key]) <= TOL_STATS, key
        for key in ("mean", "var"):
            assert rel_err(fleet[r]["bn"][key], ref["bn"][key]) <= TOL_STATS, key
        for got, want in zip(fleet[r]["actnorm"], ref["actnorm"]):
            assert rel_err(got, want) <= TOL_STATS


@pytest.mark.parametrize("accum,r", STEP_CASES)
def test_train_step_equals_the_global_batch_step(fleet, accum, r):
    import chip_smoke
    hp = tiny_hp()
    lr, eps = hp.train.learning_rate, hp.train.adam_eps
    zero_grad = chip_smoke.bn_fed_conv_biases(torch, steps.init_model(hp, 11, "cpu"))
    ref_m, ref_g, ref_p, _ = fleet[0]["ref"][f"step{accum}_{r}"]
    parts = [fleet[rank][f"step{accum}_{r}"][3] for rank in range(2)]
    assert zero_grad and set(parts[0]) == set(ref_g)
    for rank in range(2):
        m, g, p, _ = fleet[rank][f"step{accum}_{r}"]
        assert m == pytest.approx(ref_m, rel=TOL_STEP)
        share = {}
        for n, want in ref_g.items():
            if n in zero_grad:
                scale = ref_g[zero_grad[n]].abs().max().item()
                share[n] = max(g[n].abs().max().item(), want.abs().max().item()) / scale
                continue
            scale = max(want.abs().max().item(),
                        ((parts[0][n].abs() + parts[1][n].abs()) / 2).max().item())
            err = (g[n] - want).abs().max().item()
            share[n] = err / scale if scale else (0.0 if err == 0 else float("inf"))
        bad = {n: s for n, s in share.items() if s > TOL_STEP}
        assert not bad, bad
        for n, want in ref_p.items():
            # the least |g| between the two gradients (0 where they differ in sign)
            gmin = torch.minimum(g[n].abs(), ref_g[n].abs()) * (g[n] * ref_g[n] > 0)
            adam = lr * eps * (g[n] - ref_g[n]).abs() / (gmin + eps) ** 2
            tol = TOL_STEP * want.abs().max() + adam
            share[n] = ((p[n] - want).abs() / tol).max().item()
        bad = {n: s for n, s in share.items() if s > 1.0}
        assert not bad, bad


def test_kl_clamp_acts_on_the_global_kl(fleet):
    want_grad, want_m = fleet[0]["ref"]["kl_clamp"]
    assert want_grad == pytest.approx(0.5 * 0.25)
    for rank in range(2):
        grad, m = fleet[rank]["kl_clamp"]
        assert grad == pytest.approx(want_grad, rel=1e-6)
        assert m == pytest.approx(want_m, rel=1e-6)


@pytest.mark.parametrize("temperature", [0.0, 0.667])
def test_sharded_synthesis_equals_one_process(fleet, temperature):
    ref_mels, ref_lens = fleet[0]["ref"][f"synth{temperature}"]
    for r in range(2):
        mels, lens = fleet[r][f"synth{temperature}"]
        assert torch.equal(lens, ref_lens)
        assert (mels - ref_mels).abs().max().item() <= TOL_MEL


def test_sharded_run_dataset_equals_one_process(fleet):
    want = fleet[0]["ref"]["dataset"]
    assert [len(f) for f, _, _, _ in want] == [4, 4]  # 6 utterances, the last batch padded
    for rank in range(2):
        got = fleet[rank]["dataset"]
        assert len(got) == len(want)
        for (fids, mels, lens, s), (wfids, wmels, wlens, _) in zip(got, want):
            assert fids == wfids and np.array_equal(lens, wlens) and s > 0
            assert isinstance(mels, np.ndarray) and np.abs(mels - wmels).max() <= TOL_MEL


def test_fleet_step_equals_the_jax_step(fleet):
    want_m, want_g, want_stats = fleet[0]["ref"]["jax_inputs"]
    for rank in range(2):
        m, g, stats = fleet[rank]["jax_inputs"]
        for name, want in want_m.items():
            assert m[name] == pytest.approx(want, rel=1e-5), name
        assert set(g) == set(want_g)
        for key, want in want_g.items():
            np.testing.assert_allclose(g[key], want, rtol=0, err_msg=key,
                                       atol=1e-4 + 1e-3 * np.abs(want).max())
        assert sum(np.abs(w).max() > 0 for w in want_g.values()) > 0.9 * len(want_g)
        assert set(stats) == set(want_stats) and len(stats) > 0
        for key, want in want_stats.items():
            np.testing.assert_allclose(stats[key], want, rtol=1e-5, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("averaged", [True, False])
def test_model_group_replicas_stay_bit_equal(fleet, averaged):
    (params0, sharded), (params1, _) = (res["replicas"][averaged] for res in fleet)
    assert len(sharded) == 3 and PERTURBED_LEAF in params0
    unequal = sorted(n for n in params0 if not torch.equal(params0[n], params1[n]))
    if averaged:
        assert unequal == []
    else:  # without the group's average, the perturbed replica steps apart
        assert unequal == [PERTURBED_LEAF]


def test_param_sharding_rules_match_jax():
    import jax
    from vaenar_tts_tpu.parallel import mesh as jax_mesh
    from vaenar_tts_torch.configs.serialize import load_hparams
    from vaenar_tts_torch.interop.weights import flatten, torch_to_jax
    from vaenar_tts_torch.models.vaenar import VAENAR
    from vaenar_tts_torch.utils.export import load_npz

    shipped = os.path.join(REPO, "artifacts", "toyv2_q90", "ckpt")
    params = load_npz(os.path.join(shipped, "export.npz"))["params"]
    specs, _ = jax.tree_util.tree_flatten_with_path(
        jax_mesh.param_sharding_rules(params, jax_mesh.make_mesh(data=4, model=2)))
    jax_sharded = {"/".join(k.key for k in path) for path, s in specs if "model" in s.spec}

    model = VAENAR(load_hparams(shipped))  # the export's shapes (load_jax_weights holds them)
    names = [n for n, _ in model.named_parameters()]
    # each parameter filled with its index, carried through the weight map
    tagged, _ = torch_to_jax(model, {n: torch.full(p.shape, float(i)) for i, (n, p)
                                     in enumerate(model.named_parameters())})
    path_of = {names[int(np.asarray(a).flat[0])]: path for path, a in flatten(tagged).items()}
    rules = param_sharding_rules(model, make_mesh(data=4, model=2, processes=8))
    port_sharded = {path_of[n] for n, d in rules.items() if d is not None}
    assert port_sharded == jax_sharded and len(port_sharded) > 0
    # the dimension is the flax layout's last one
    for n, d in rules.items():
        if d is not None:
            p = dict(model.named_parameters())[n]
            assert p.shape[d] >= 512 and np.asarray(
                flatten(params)[path_of[n]]).shape[-1] == p.shape[d]
    assert all(d is None for d in param_sharding_rules(model, make_mesh(processes=8)).values())


def test_mesh_data_axis_orders_processes():
    mesh = make_mesh(data=2, processes=2)
    assert mesh.shape == {"data": 2, "model": 1}
    assert [mesh.data_index(p) for p in range(2)] == [0, 1]
    assert make_mesh(data=2, model=2, processes=4).data_index(3) == 1  # process-major
    assert make_mesh() == make_mesh(data=1, processes=1)  # no process group: one process


class _GroupOfOne:
    """The model group as one process sees it, stubbed: its partner's
    columns are taken to equal this process's (a gather repeats the local
    block), which is all a one-process test can hold ``shard_params``'s
    cutting and ``unshard_params``' layout against."""

    def __init__(self, mesh, model_index):
        self.mesh, self.model_index, self.model_count = mesh, model_index, mesh.model

    def model_gather(self, x, dim):
        return torch.cat([x] * self.model_count, dim=dim)

    def model_sum(self, x):
        return x * self.model_count


def test_model_axis_shards_on_a_stub():
    from vaenar_tts_torch.models.vaenar import VAENAR
    hp = tiny_hp(*WIDE)
    mesh = make_mesh(data=1, model=2, processes=2)
    whole = VAENAR(hp)
    rules = {n: d for n, d in param_sharding_rules(whole, mesh).items() if d is not None}
    assert len(rules) == 3
    for index in range(2):
        model = VAENAR(hp)
        model.load_state_dict(whole.state_dict())
        stub = _GroupOfOne(mesh, index)
        assert shard_params(model, mesh, stub) is model
        assert sharded_parameters(model) == rules
        params = dict(model.named_parameters())
        for name, dim in rules.items():
            want = whole.state_dict()[name]
            size = want.shape[dim] // 2
            assert torch.equal(params[name], want.narrow(dim, index * size, size))
        state = unshard_params(model, mesh, stub)
        assert set(state) == set(whole.state_dict())
        for name, want in whole.state_dict().items():
            if name not in rules:
                assert torch.equal(state[name], want)
            else:  # the stub's gather repeats this process's block
                assert torch.equal(state[name].narrow(rules[name], index * want.shape[
                    rules[name]] // 2, want.shape[rules[name]] // 2), params[name])
    with pytest.raises(ValueError, match="DistContext"):
        shard_params(VAENAR(hp), mesh)
    assert shard_params(whole, make_mesh(processes=1)) is whole  # model = 1: whole
    with pytest.raises(ValueError):
        make_mesh(data=3, model=2, processes=8)


@pytest.mark.parametrize("source", ["shipped", "jax_zero"])
def test_ring_min_seq_loads_from_hparams_json(tmp_path, source):
    """``train.ring_min_seq`` is read from a JAX ``hparams.json``, not
    dropped: the shipped file's 1024, and 0 from a file the JAX package
    writes with it set to 0; and written back."""
    import dataclasses
    from vaenar_tts_torch.configs.serialize import load_hparams, save_hparams
    if source == "shipped":
        model_dir, want = os.path.join(REPO, "artifacts", "toyv2_q90", "ckpt"), 1024
    else:
        from vaenar_tts_tpu.configs import get_config
        from vaenar_tts_tpu.configs.serialize import save_hparams as jax_save
        jax_hp = get_config("ljspeech")
        jax_save(jax_hp.replace(train=dataclasses.replace(jax_hp.train, ring_min_seq=0)),
                 str(tmp_path))
        model_dir, want = str(tmp_path), 0
    hp = load_hparams(model_dir)
    assert hp.train.ring_min_seq == want
    save_hparams(hp, str(tmp_path / "again"))
    assert load_hparams(str(tmp_path / "again")).train.ring_min_seq == want


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
