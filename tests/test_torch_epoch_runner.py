"""``train.device_cache_epoch_scan`` in the port: the epoch runner
(``training/steps.make_epoch_runner``) and its place in the training loop,
on the CPU at tiny size, where the runner takes the eager steps (a CUDA
graph needs the card; ``chip_smoke.py``'s ``epoch_graph`` phase holds the
graphed epoch against the eager one there):

* the runner over two epochs of orders, the second at another reduction
  factor, gives the eager steps' metric sums, parameters, Adam state and
  generator state, bit for bit;
* ``loop.train`` with the flag gives the flag's absence (the cache on in
  both) bit for bit over 2 epochs cut by ``steps_per_epoch`` across a change
  of reduction factor, and prints the cache line with the runner's mode;
* a run stopped after epoch 1 and resumed with the flag the other way ends
  where an uninterrupted run ends, bit for bit, both ways;
* a SIGTERM that arrives before a runner epoch stops the run there, with
  the last completed epoch checkpointed, and the resumed run ends where an
  uninterrupted one does;
* ``loop.train`` with the flag and ``train.remat`` "on" or "dots" gives the
  flag's absence under the same remat bit for bit, the runner's steps
  going through the checkpoint;
* a checkpoint keeps the restoring optimizer's ``capturable`` flag and
  puts Adam's step counts where torch keeps them for it.
"""

import os
import signal

import numpy as np
import pytest
import torch

from vaenar_tts_torch.training import loop, steps
from vaenar_tts_torch.utils.checkpoint import CheckpointManager

from test_torch_loop_resilience import one_shape_utts, tiny, write_split
from torch_threads import one_thread  # noqa: F401

# epoch 1 at r = 5, epoch 2 at r = 4
SCHEDULE = "train.reduce_interval=(0,2,480,720)"
CACHE = "train.device_data_cache_mb=100"
SCAN = "train.device_cache_epoch_scan=true"


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("runner_records")
    write_split(out, "train", one_shape_utts(12, 11))  # 3 batches of 4, one shape
    write_split(out, "dev", one_shape_utts(3, 12))
    return out


def run(hp, records, model_dir, max_epochs, steps_per_epoch=2):
    return loop.train(hp, str(records), str(model_dir), str(model_dir) + "_logs",
                      max_epochs=max_epochs, steps_per_epoch=steps_per_epoch, device="cpu",
                      draw_plots=False)


def weights(hp, model_dir, epoch):
    from vaenar_tts_torch.models.vaenar import VAENAR
    model = VAENAR(hp)
    assert CheckpointManager(str(model_dir)).restore(model) == epoch
    return model.state_dict()


def assert_same_runs(a, b):
    assert a["initial"] == b["initial"]
    for split in ("train", "dev"):
        assert a[split] == b[split], split


def test_runner_equals_the_eager_steps(records):
    hp = tiny(CACHE)
    train, dev, _ = loop.make_loaders(hp, str(records))
    cache, _ = loop.device_cache(hp, train, dev, torch.device("cpu"))
    twins = []
    for _ in range(2):
        model = steps.init_model(hp, 7, "cpu")
        twins.append((model, steps.make_optimizer(hp, model)))
    runner = steps.make_epoch_runner(*twins[0], hp, cache)
    gens = [torch.Generator().manual_seed(3) for _ in range(2)]
    for order, r in (([2, 0], 5), ([1, 2, 0], 2)):
        got, n = runner(np.asarray(order), 1e-3, r, gens[0])
        want = {}
        for i in order:
            m = steps.train_step(*twins[1], hp, *(x[i] for x in cache), 1e-3, r, gens[1])
            want = {k: want[k] + v if k in want else v for k, v in m.items()}
        assert n == len(order) and set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    (ma, oa), (mb, ob) = twins
    assert all(torch.equal(x, y) for x, y in zip(ma.state_dict().values(),
                                                 mb.state_dict().values()))
    for pa, pb in zip(ma.parameters(), mb.parameters()):
        for k, v in oa.state[pa].items():
            assert torch.equal(v, ob.state[pb][k]), k
    assert runner.report()["graphed"] is False and runner.replays == 0
    with pytest.raises(ValueError, match="outside the cache"):
        runner([3], 1e-3, 2, gens[0])


def test_flag_equals_the_eager_cache_loop(records, tmp_path, capsys):
    off = run(tiny(CACHE, SCHEDULE), records, tmp_path / "off", 2, steps_per_epoch=1)
    off_line = [l for l in capsys.readouterr().out.splitlines() if "cache ON" in l]
    on = run(tiny(CACHE, SCHEDULE, SCAN), records, tmp_path / "on", 2, steps_per_epoch=1)
    on_line = [l for l in capsys.readouterr().out.splitlines() if "cache ON" in l]
    assert off_line[0].endswith("on cpu; per-step dispatch over device gathers")
    assert on_line[0].endswith("on cpu; the epoch runner's eager steps (no CUDA graph off "
                               "the card)")
    assert on["cache"] and off["cache"] and off["runner"] is None
    assert on["runner"]["graphed"] is False
    assert_same_runs(on, off)
    schedule = tiny(SCHEDULE).train
    assert schedule.reduction_factor_at(1) != schedule.reduction_factor_at(2)
    hp = tiny()
    a, b = weights(hp, tmp_path / "on", 2), weights(hp, tmp_path / "off", 2)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("first,then", [(SCAN, "train.device_cache_epoch_scan=false"),
                                        ("train.device_cache_epoch_scan=false", SCAN)])
def test_resume_across_the_flag(records, tmp_path, first, then):
    whole = run(tiny(CACHE, SCHEDULE, SCAN), records, tmp_path / "whole", 2)
    run(tiny(CACHE, SCHEDULE, first), records, tmp_path / "cut", 1)
    resumed = run(tiny(CACHE, SCHEDULE, then), records, tmp_path / "cut", 2)
    assert resumed["initial"] is None and list(resumed["train"]) == [2]
    for split in ("train", "dev"):
        assert resumed[split][2] == whole[split][2], split
    hp = tiny()
    a, b = weights(hp, tmp_path / "whole", 2), weights(hp, tmp_path / "cut", 2)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_sigterm_before_a_runner_epoch(records, tmp_path, monkeypatch):
    hp = tiny(CACHE, SCAN, "train.checkpoint_every_n_epochs=5")
    whole = run(hp, records, tmp_path / "whole", 3)
    real = loop.epoch_generator

    def signal_at_epoch_2(device, seed, epoch):
        if epoch == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(device, seed, epoch)

    monkeypatch.setattr(loop, "epoch_generator", signal_at_epoch_2)
    cut = run(hp, records, tmp_path / "cut", 3)
    monkeypatch.setattr(loop, "epoch_generator", real)
    assert cut["stopped"] == "sigterm" and cut["epoch"] == 1 and list(cut["train"]) == [1]
    assert sorted(os.listdir(tmp_path / "cut")) == ["0", "1", "hparams.json"]
    resumed = run(hp, records, tmp_path / "cut", 3)
    assert list(resumed["train"]) == [2, 3]
    for split in ("train", "dev"):
        for epoch in (2, 3):
            assert resumed[split][epoch] == whole[split][epoch], (split, epoch)


@pytest.mark.parametrize("mode", ["on", "dots"])
def test_flag_with_remat_matches_eager(records, tmp_path, monkeypatch, mode):
    real, calls = torch.utils.checkpoint.checkpoint, []

    def counted(*args, **kwargs):
        calls.append(kwargs.get("context_fn") is torch.utils.checkpoint.noop_context_fn)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counted)
    remat = f"train.remat={mode}"
    off = run(tiny(CACHE, SCHEDULE, remat), records, tmp_path / "off", 2, steps_per_epoch=1)
    n_off = len(calls)
    on = run(tiny(CACHE, SCHEDULE, remat, SCAN), records, tmp_path / "on", 2, steps_per_epoch=1)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", real)
    # the runner's steps checkpoint the blocks as often as the eager ones
    assert n_off > 0 and len(calls) == 2 * n_off
    assert all(noop == (mode == "on") for noop in calls)
    assert on["runner"]["graphed"] is False and off["runner"] is None
    assert_same_runs(on, off)
    hp = tiny()
    a, b = weights(hp, tmp_path / "on", 2), weights(hp, tmp_path / "off", 2)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_checkpoint_keeps_the_restoring_optimizers_capturable(tmp_path):
    hp = tiny()
    model = steps.init_model(hp, 7, "cpu")
    plain = steps.make_optimizer(hp, model)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    plain.step()
    CheckpointManager(str(tmp_path)).save(1, model, plain)
    graphable = steps.make_optimizer(hp, model, capturable=True)  # as on the card
    assert CheckpointManager(str(tmp_path)).restore(model, graphable) == 1
    assert all(g["capturable"] for g in graphable.param_groups)
    for p in model.parameters():
        step = graphable.state[p]["step"]
        assert step.dtype == torch.float32 and step.device == p.device and step.item() == 1.0
        assert torch.equal(graphable.state[p]["exp_avg"], plain.state[p]["exp_avg"])
    CheckpointManager(str(tmp_path)).save(2, model, graphable)
    again = steps.make_optimizer(hp, model)
    assert CheckpointManager(str(tmp_path)).restore(model, again) == 2
    assert not any(g["capturable"] for g in again.param_groups)
    assert all(again.state[p]["step"].device.type == "cpu" for p in model.parameters())
    again.step()  # a non-capturable Adam steps from the restored state
    assert all(again.state[p]["step"].item() == 2.0 for p in model.parameters())
