"""``cli.train --distributed`` fleets of the port on the CPU (gloo), as
``tests/test_distributed.py`` runs the JAX package's, at the tiny override
set with one torch thread in every process:

1. two processes, three epochs of two steps, at fp32: every logged step
   loss of epoch 1 and the epoch-1 dev losses of process 0 match an
   in-process single-process mirror of the same global batches
   (``chip_smoke.fleet_mirror``: the same shard partition, loaders,
   schedule and generators) within the JAX test's 2e-3 relative;
   both processes log the same losses; the lockstep schedule has 2 or more
   shapes and under 100 % of pad-to-global-max; process 0 alone writes
   checkpoints;
2. SIGTERM to both processes of a fleet once both have started epoch 1:
   both stop at the same epoch boundary (1 or 2) and exit 0; then
3. that fleet resumed to epoch 3 logs epoch 3's step and dev losses equal to
   fleet 1's, to the last bit;
4. four processes over uneven shard sets (2/2/1/1 of 6 train shards) and a
   dev split of 7 batches of 1: the step cap engages, every process
   finishes the dev loop (the dry one re-feeds a dummy) and all log the same
   dev losses.

Beside the fleets, ``--distributed`` in a group of one process (in this
process) takes the single-process path.

The chain to the JAX package is the single-process port step, which
``test_torch_train_step.py`` holds against JAX.
"""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import chip_smoke
from vaenar_tts_torch.configs.overrides import apply_overrides
from vaenar_tts_torch.configs.serialize import load_hparams
from vaenar_tts_torch.data.records import RecordShardWriter

from test_torch_data import SHIPPED
from test_torch_train_cli import TRAIN_OVERRIDES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# fp32 (the shipped file says bfloat16, whose roundings alone move the
# losses by ~5e-3); mel buckets of 120 frames, so that the schedule has
# several shapes; epoch 3 writes the test-interval artifacts (gathered,
# process 0 writes), vocoded at the small audio config of
# tests/test_griffin_lim.py
FLEET_OVERRIDES = TRAIN_OVERRIDES + [
    "train.compute_dtype=float32", "dataset.mel_bucket=120", "train.test_interval=3",
    "train.test_batch_size=4", "audio.num_freq=129", "audio.frame_length_sample=128",
    "audio.frame_shift_sample=32", "audio.griffin_lim_iters=16"]
STEP_RE = re.compile(r"step (\d+): (kl [^,]+, len_l2 [^,]+, len_pinball [^,]+, mel_l2 [^,]+, "
                     r"total [^,]+),")
REL = 2e-3
# cli.train in a process where torch.utils.tensorboard does not import, as on
# a machine without the tensorboard package: the metrics go to JSON lines
# only, and no process spends ~10 s importing TensorFlow
CLI_WITHOUT_TENSORBOARD = ("import sys; sys.modules['torch.utils.tensorboard'] = None; "
                           "from vaenar_tts_torch.cli.train import main; main(sys.argv[1:])")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_shard(path, n, seed):
    """n utterances of 8-32 ids and ~9 frames an id: mel buckets 120-480."""
    rng = np.random.default_rng(seed)
    w = RecordShardWriter(str(path), 80)
    for i in range(n):
        tl = int(rng.integers(8, 33))
        ml = min(370, int(round(9.0 * tl * rng.uniform(0.85, 1.15))))
        w.add(f"s{seed}-{i:02d}", rng.integers(3, 43, tl).astype(np.int32),
              rng.uniform(0, 1, (ml, 80)).astype(np.float32))
    w.close()


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet")
    records = root / "records"
    records.mkdir()
    for i in range(6):  # 3 + 3 for two processes, 2/2/1/1 for four
        write_shard(records / f"train-{i}.vrs", 4 if i < 4 else 2, 100 + i)
    write_shard(records / "dev-0.vrs", 7, 200)
    write_shard(records / "test-0.vrs", 4, 300)
    return root


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_fleet(workspace, tag, nprocs, max_epochs, steps_per_epoch=2, extra=(), ckpt=None):
    """Start ``nprocs`` ``cli.train --distributed`` processes on
    ``ckpt_<ckpt or tag>``; their output goes to files (a full pipe would
    block a process that the test does not read yet)."""
    port = _free_port()
    procs, logs = [], []
    for pid in range(nprocs):
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1",
                   VAENAR_COORDINATOR=f"localhost:{port}",
                   VAENAR_NUM_PROCESSES=str(nprocs), VAENAR_PROCESS_ID=str(pid))
        env.pop("VAENAR_DIST_BACKEND", None)
        cmd = [sys.executable, "-c", CLI_WITHOUT_TENSORBOARD, "--dataset", "ljspeech",
               "--data_dir", str(workspace / "records"),
               "--model_dir", str(workspace / f"ckpt_{ckpt or tag}"),
               "--log_dir", str(workspace / f"logs_{tag}_p{pid}"),
               "--device", "cpu", "--distributed", "--no-draw_plots",
               "--max_epochs", str(max_epochs), "--steps_per_epoch", str(steps_per_epoch),
               "--log_every", "1", "--hparams", os.path.join(SHIPPED, "hparams.json")]
        for o in list(FLEET_OVERRIDES) + list(extra):
            cmd += ["--override", o]
        log = workspace / f"out_{tag}_p{pid}.txt"
        logs.append(log)
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, stdout=open(log, "w"),
                                      stderr=subprocess.STDOUT))
    return procs, logs


def wait_fleet(procs, logs, timeout=300):
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outs = [log.read_text() for log in logs]
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} exited {p.returncode}:\n{out[-4000:]}"
    return outs


def run_fleet(workspace, tag, nprocs, max_epochs, **kw):
    return wait_fleet(*spawn_fleet(workspace, tag, nprocs, max_epochs, **kw))


def steps_by_epoch(out):
    """{epoch: [the step lines' loss fields]} and {epoch: dev dict}."""
    steps_, devs, cur = {}, {}, None
    for line in out.splitlines():
        m = re.match(r"Epoch (\d+): kl_weight", line)
        if m:
            cur = int(m.group(1))
            steps_[cur] = []
            continue
        s = STEP_RE.search(line)
        if cur is not None and s:
            steps_[cur].append(s.group(2))
        d = re.match(r"Epoch (\d+) dev: (\{.*\})", line)
        if d:
            devs[int(d.group(1))] = json.loads(d.group(2).replace("'", '"'))
    return steps_, devs


def parse_losses(fields):
    return {k: float(v) for k, v in (p.split(" ") for p in fields.split(", "))}


def fleet_hparams():
    hp = load_hparams(SHIPPED)
    return apply_overrides(hp, FLEET_OVERRIDES)


@pytest.fixture(scope="module")
def fleet1(workspace):
    return run_fleet(workspace, "full", 2, 3)


def test_two_processes_match_one_on_the_global_batch(workspace, fleet1):
    outs = fleet1
    for pid, out in enumerate(outs):
        assert f"distributed: process {pid}/2, backend gloo, device cpu" in out
        assert "batch packer: native" in out
    logged = [steps_by_epoch(o) for o in outs]
    assert logged[0] == logged[1]  # every step and dev line, both processes
    sched = re.search(r"lockstep bucket schedule \(epoch 0\): (\d+) distinct shapes.*?= "
                      r"([\d.]+)% of pad-to-global-max", outs[0])
    assert sched and int(sched.group(1)) >= 2 and float(sched.group(2)) < 100.0, outs[0][-3000:]

    ref_steps, ref_dev, _, _ = chip_smoke.fleet_mirror(
        fleet_hparams(), str(workspace / "records"), 2, 2, CPU)
    got_steps, got_dev = logged[0]
    got = [parse_losses(f) for f in got_steps[1]]
    assert len(got) == len(ref_steps) == 2
    for ref, g in zip(ref_steps, got):
        for k in ref:
            assert g[k] == pytest.approx(ref[k], rel=REL, abs=1e-5), (k, ref, g)
    for k, v in ref_dev.items():
        assert got_dev[1][k] == pytest.approx(v, rel=REL, abs=1e-5), (k, ref_dev, got_dev[1])

    reports = [json.loads((workspace / f"logs_full_p{p}" / f"process_{p}.json").read_text())
               for p in range(2)]
    assert reports[0]["checkpoints_written"] == [0, 3] and reports[1]["checkpoints_written"] == []
    assert {r["packer"] for r in reports} == {"native"}
    assert sorted(os.listdir(workspace / "ckpt_full")) == ["0", "3", "hparams.json"]
    # the test-interval artifacts of epoch 3: gathered, written by process 0
    assert len(list((workspace / "logs_full_p0" / "test").glob("test-3-*.wav"))) == 4
    assert not (workspace / "logs_full_p1" / "test").exists()
    assert (workspace / "logs_full_p1" / "train_p1" / "metrics.jsonl").is_file()


def test_sigterm_stops_the_fleet_at_one_boundary_and_resumes_exactly(workspace, fleet1):
    procs, logs = spawn_fleet(workspace, "sig", 2, 30)
    try:
        deadline = time.time() + 240
        # both processes past their cold start, their SIGTERM handlers in place
        while not all("Epoch 1: kl_weight" in log.read_text() for log in logs):
            assert time.time() < deadline, logs[0].read_text()[-3000:]
            assert all(p.poll() is None for p in procs), logs[0].read_text()[-3000:]
            time.sleep(0.05)
        for p in procs:
            p.send_signal(signal.SIGTERM)
    finally:
        outs = wait_fleet(procs, logs)
    stops = [re.search(r"stopping after epoch (\d+) \(preemption\)", o) for o in outs]
    assert all(stops), [o[-1500:] for o in outs]
    stopped = {int(m.group(1)) for m in stops}
    assert len(stopped) == 1 and stopped <= {1, 2}, stopped
    at = stopped.pop()
    assert (workspace / "ckpt_sig" / str(at)).is_dir()

    resumed = run_fleet(workspace, "resumed", 2, 3, ckpt="sig")
    assert f"Restored from epoch {at}" in resumed[0]
    full_steps, full_dev = steps_by_epoch(fleet1[0])
    res_steps, res_dev = steps_by_epoch(resumed[0])
    assert sorted(res_steps) == list(range(at + 1, 4))
    assert res_steps[3] and res_steps[3] == full_steps[3]
    assert res_dev[3] == full_dev[3]


def test_one_process_takes_the_single_process_path(workspace, tmp_path, monkeypatch):
    from vaenar_tts_torch.cli import train as cli_train
    monkeypatch.setenv("VAENAR_COORDINATOR", f"localhost:{_free_port()}")
    monkeypatch.setenv("VAENAR_NUM_PROCESSES", "1")
    monkeypatch.setenv("VAENAR_PROCESS_ID", "0")
    monkeypatch.delenv("VAENAR_DIST_BACKEND", raising=False)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # as in the fleets
    argv = ["--dataset", "ljspeech", "--data_dir", str(workspace / "records"),
            "--model_dir", str(tmp_path / "ckpt"), "--log_dir", str(tmp_path / "logs"),
            "--device", "cpu", "--distributed", "--no-draw_plots",
            "--max_epochs", "1", "--steps_per_epoch", "1",
            "--hparams", os.path.join(SHIPPED, "hparams.json")]
    history = cli_train.main(argv + [a for o in FLEET_OVERRIDES for a in ("--override", o)])
    import torch.distributed as tdist
    assert not tdist.is_initialized()  # the group of one was left again
    assert history["epoch"] == 1 and history["packer"] == "native"
    log = (tmp_path / "logs" / "train.log").read_text()
    assert "distributed: 1 process, the single-process path" in log
    assert "lockstep" not in log and not list((tmp_path / "logs").glob("process_*.json"))


def test_four_processes_uneven_shards(workspace):
    outs = run_fleet(workspace, "p4", 4, 1, steps_per_epoch=1,
                     extra=("train.train_batch_size=4", "train.test_batch_size=4"))
    logged = [steps_by_epoch(o) for o in outs]
    assert logged[0][0][1] and all(lg[0] == logged[0][0] for lg in logged)
    assert any("lockstep cap:" in o for o in outs), outs[0][-2000:]
    devs = [lg[1].get(1) for lg in logged]
    assert all(devs) and all(d == devs[0] for d in devs)
