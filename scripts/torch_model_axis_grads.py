#!/usr/bin/env python3
"""How far the model axis's fp32 gradients sit from one process's, beside
how far one process's own gradients move when only the summation order
changes, on one CUDA card:

    python3 scripts/torch_model_axis_grads.py

One fp32 train step of the shipped model (its export's weights, dropout on
from one generator seed, ring_min_seq 0, a seeded batch of 8 at 64 text ids
and 240 mel frames, r = 2), each gradient leaf compared with the step of
one process through the attention kernels ("kernel"):

* ``plain``: one process with the attention kernels replaced by their
  plain PyTorch versions (the same math, another summation order);
* ``fleet``: two processes sharing the card over gloo as one model group
  (mesh data 1 x model 2), the wide kernels sharded (``shard_params``) and
  every self-attention on the ring (``VAENAR(seq_mesh=)``), its gradients
  gathered whole (``unshard_params``); the two processes against each
  other as well.

For each: the four leaves with the largest error relative to the leaf's
largest gradient, as (that share, leaf, error over the largest gradient
of all leaves, share of the JAX package's elementwise tolerance atol 5e-5
+ rtol 5e-3, leaf's largest over all leaves' largest); the largest error
over all leaves' largest; and the worst share of the JAX tolerance. With
``RANK PORT DIR`` the script is one of the two processes.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def batch(torch, device):
    """A seeded batch of 8: texts [8, 64] (item 0 whole), mels [8, 240, 80]."""
    import numpy as np
    rng = np.random.default_rng(3)
    B, T, M = 8, 64, 240
    t_lens = rng.integers(20, T + 1, B).astype(np.int32)
    m_lens = rng.integers(120, M + 1, B).astype(np.int32)
    t_lens[0], m_lens[0] = T, M
    texts = np.zeros((B, T), np.int64)
    for i, n in enumerate(t_lens):
        texts[i, :n] = rng.integers(3, 43, n)
    mels = rng.uniform(0, 1, (B, M, 80)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (texts, mels, t_lens, m_lens)]


def step_grads(torch, state, device, dist=None):
    """One train step's whole gradients on the host; ``dist``: the model
    group, with sharded weights and the ring."""
    from chip_smoke import shipped_model
    from vaenar_tts_torch.parallel.mesh import shard_params, unshard_params
    from vaenar_tts_torch.training import steps
    hp, model = shipped_model(torch, state, device, "float32", seq_mesh=dist, ring_min_seq=0)
    if dist is not None:
        shard_params(model, dist.mesh, dist)
    gen = torch.Generator(device=device).manual_seed(5)
    steps.train_step(model, steps.make_optimizer(hp, model), hp, *batch(torch, device), 1e-5, 2,
                     gen)
    grads = {n: p.grad for n, p in model.named_parameters()}
    if dist is not None:
        grads = unshard_params(model, dist.mesh, dist, grads)
    return {n: g.detach().cpu() for n, g in grads.items()}


def worker(rank, port, out_dir):
    import torch
    import torch.distributed as tdist
    from chip_smoke import MODEL_DIR
    from vaenar_tts_torch.parallel.distributed import DistContext
    from vaenar_tts_torch.parallel.mesh import make_mesh
    from vaenar_tts_torch.utils.export import load_npz
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                             rank=rank)
    dist = DistContext(device, make_mesh(data=1, model=2, processes=2))
    grads = step_grads(torch, load_npz(os.path.join(MODEL_DIR, "export.npz")), device, dist)
    torch.save(grads, os.path.join(out_dir, f"fleet_{rank}.pt"))
    dist.close()


def compare(got, want):
    atol, rtol = 5e-5, 5e-3
    gmax = max(g.abs().max().item() for g in want.values())
    rows = []
    for n, g in want.items():
        d = (got[n] - g).abs()
        leaf = g.abs().max().item()
        rows.append((d.max().item() / max(leaf, 1e-30), n, d.max().item() / gmax,
                     (d / (atol + rtol * g.abs())).max().item(), leaf / gmax))
    rows.sort()
    return {"worst_leaf_relative": rows[-4:], "max_abs_err_over_max_grad": max(r[2] for r in rows),
            "worst_share_of_jax_tol": max(r[3] for r in rows)}


def main():
    sys.path.insert(0, HERE)
    import torch
    from chip_smoke import MODEL_DIR
    from vaenar_tts_torch.ops import _build
    from vaenar_tts_torch.ops import flash_attention as fa
    from vaenar_tts_torch.utils.export import load_npz
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    _build.build()
    with tempfile.TemporaryDirectory() as out, socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
        sock.close()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(port),
                                   out]) for r in range(2)]
        try:
            for p in procs:
                p.wait(timeout=600)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if any(p.returncode for p in procs):
            print(f"fleet exited {[p.returncode for p in procs]}", file=sys.stderr)
            return 1
        fleet = [torch.load(os.path.join(out, f"fleet_{r}.pt")) for r in range(2)]
    state = load_npz(os.path.join(MODEL_DIR, "export.npz"))
    device = torch.device("cuda")
    kernel = step_grads(torch, state, device)
    forward, backward = fa.masked_flash_attention, fa.masked_flash_attention_backward
    fa.masked_flash_attention = fa.masked_attention_reference
    fa.masked_flash_attention_backward = fa.masked_attention_backward_reference
    try:
        plain = step_grads(torch, state, device)
    finally:
        fa.masked_flash_attention, fa.masked_flash_attention_backward = forward, backward
    print(json.dumps({"card": smi, "plain_vs_kernel": compare(plain, kernel),
                      "fleet_vs_kernel": compare(fleet[0], kernel),
                      "fleet_process_1_vs_0": compare(fleet[1], fleet[0])}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4:
        sys.path.insert(0, HERE)
        worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
    else:
        sys.exit(main())
