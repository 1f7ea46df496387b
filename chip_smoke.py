#!/usr/bin/env python3
"""Drive the PyTorch port (vaenar_tts_torch) on one CUDA card, from the root
of a checkout:

    python3 chip_smoke.py

1. device: the card's name, count, and `nvidia-smi` name and power limit;
2. build: every csrc/*.cu with nvcc for sm_90a, and ptxas's register and
   shared-memory report;
3. kernels against their plain PyTorch versions on the card, at the main
   path's shapes, on ragged shapes, fully masked rows and Tk > 4096;
4. main path: the shipped LJSpeech model (artifacts/toyv2_q90/ckpt) at full
   width synthesizes 4 fixed lines through the CLI's synthesize_batch, at
   temperature 0 and at 0.667 with a seeded generator, with the kernels'
   launch counts reset before and read after; then the same lines at
   temperature 0 through the port on the CPU, which must predict the same
   lengths and agree on the mels;
5. times on the card: each kernel at the main path's shapes beside its bound,
   its plain version and one PyTorch library call, and synthesis wall time.

Each phase prints a JSON line {"phase": ..., "seconds": ...} first. A failed
check raises; the script then exits non-zero without printing the final
line. Without a CUDA device, or without the rest of the repository beside
it, it exits non-zero at once. It writes only the kernel build directory
(vaenar_tts_torch/_build/, ignored by git).
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MODEL_DIR = os.path.join(HERE, "artifacts", "toyv2_q90", "ckpt")
DEVICE = "cuda"
LINES = [
    "Printing, in the only sense with which we are at present concerned, "
    "differs from most if not from all the arts and crafts in the exhibition.",
    "The earliest book printed with movable types, the Gutenberg Bible, was "
    "printed in Latin at Mainz in the middle of the fifteenth century.",
    "In being comparatively modern, the art of printing differs from most of "
    "the other arts and crafts that are represented in the exhibition.",
    "Nobody could have predicted that a small change in the weather would "
    "keep the whole village indoors for nearly three long weeks.",
]
# H100 SXM data-sheet peaks (dense): fp32 outside the tensor cores, bf16
# tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
# tolerances of kernel against plain version on the card, per element as
# atol + rtol * |o_plain|: fp32 sums run in another order (atol 1e-4); in
# bf16 both sum in fp32 and round o once to bf16, so they may differ by one
# bf16 ulp, at most 2**-7 * |o| (rtol), plus the fp32 order (atol 1e-3)
TOL_O = {"float32": (1e-4, 0.0), "bfloat16": (1e-3, 2.0 ** -7)}
TOL_M = 1e-4
TOL_S_REL = 1e-4
# card against CPU, whole model at temperature 0: an fp32 chain of ~50
# layers whose sums run in another order on the card; mels are of order 1,
# as the JAX-against-port tolerance on the CPU (tests/test_torch_model.py)
TOL_MEL_CARD_CPU = 1e-4
T0 = time.perf_counter()


def phase(name):
    print(json.dumps({"phase": name, "seconds": round(time.perf_counter() - T0, 3)}),
          flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def random_qkv(torch, device, dtype, B, H, tq, tk, D, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn((B, H, t, D), generator=g).to(device=device, dtype=dtype)
            for t in (tq, tk, tk)]


def check_cases(torch, device):
    """(name, Tq, Tk, causal, q_len, m_len): the main path's shapes (text
    160, reduced mel 1680), a ragged pair and a Tk > 4096 case, with random
    lengths that leave rows fully masked, and one case with full lengths."""
    B = 4
    rnd = torch.Generator(device="cpu").manual_seed(7)

    def rand_len(t, low, fix=None):
        """Random lengths in [low, t]; ``fix`` = (item, length) pins one."""
        lens = torch.randint(low, t + 1, (B,), generator=rnd, dtype=torch.int32)
        if fix is not None:
            lens[fix[0]] = fix[1]
        return lens.to(device)

    return [
        ("self_160", 160, 160, False, rand_len(160, 20, (0, 160)), rand_len(160, 20, (0, 160))),
        ("causal_1680", 1680, 1680, True, rand_len(1680, 300, (1, 700)),
         rand_len(1680, 300, (1, 700))),
        ("cross_1680x160", 1680, 160, False, rand_len(1680, 300, (2, 1680)), rand_len(160, 20)),
        ("full_lengths_160", 160, 160, True, None, None),
        ("ragged_1681x157", 1681, 157, False, rand_len(1681, 1, (0, 400)), rand_len(157, 1)),
        # Tk > 4096 (the TPU's blocked kernel); item 1 has no key at all
        ("long_1024x4104", 1024, 4104, False, rand_len(1024, 1), rand_len(4104, 4097, (1, 0))),
    ]


def check_kernels(torch, fa, device):
    """Kernel against plain version; returns the largest |o| error in fp32."""
    worst = 0.0
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for i, (name, tq, tk, causal, ql, ml) in enumerate(check_cases(torch, device)):
            q, k, v = random_qkv(torch, device, dtype, 4, 4, tq, tk, 64, seed=i)
            o, m, s = fa.masked_flash_attention(q, k, v, ql, ml, 0.125, causal)
            o_ref, m_ref, s_ref = fa.masked_attention_reference(q, k, v, ql, ml, 0.125, causal)
            torch.cuda.synchronize()
            atol, rtol = TOL_O[dtype_name]
            diff_o = (o.float() - o_ref.float()).abs()
            err_o = diff_o.max().item()
            tol_share_o = (diff_o / (atol + rtol * o_ref.float().abs())).max().item()
            err_m = (m - m_ref).abs().max().item()
            err_s = ((s - s_ref).abs() / s_ref).max().item()
            masked_rows = 0 if ql is None else int((tq - ql.clamp(max=tq)).sum().item())
            print(json.dumps({"check": name, "dtype": dtype_name, "max_abs_err_o": err_o,
                              "max_share_of_tol_o": tol_share_o,
                              "max_abs_err_m": err_m, "max_rel_err_s": err_s,
                              "fully_masked_rows_per_head": masked_rows}), flush=True)
            check(torch.isfinite(o.float()).all().item(), f"{name}/{dtype_name}: non-finite o")
            check(tol_share_o <= 1.0, f"{name}/{dtype_name}: |o| error {err_o} "
                  f"({tol_share_o} of atol {atol} + rtol {rtol} * |o|)")
            check(err_m <= TOL_M, f"{name}/{dtype_name}: |m| error {err_m}")
            check(err_s <= TOL_S_REL, f"{name}/{dtype_name}: s rel error {err_s}")
            if dtype_name == "float32":
                worst = max(worst, err_o)
    return worst


def attention_work(torch, tq, tk, causal, ql, ml, D, B, H):
    """Operations and bytes that these lengths need. Operations: 2*D per q.k
    and per p.v term of each unmasked (row, col), and D adds per key for a
    (b, h) with rows at or past q_len, whose o is mean(v) whatever q is.
    Elements read, each once: the q rows below q_len, the k rows that such a
    row can see (below m_len, and below q_len on a causal site), and the v
    rows they see, or all of v where padding rows need its mean. Elements
    written: o whole; m and s (fp32) whole; the lengths are int32."""
    ql = torch.full((B,), tq) if ql is None else ql.cpu().clamp(0, tq)
    ml = torch.full((B,), tk) if ml is None else ml.cpu().clamp(0, tk)
    flops = elems_in = 0
    for b in range(B):
        qn, mn = int(ql[b]), int(ml[b])
        if mn == 0:
            qn = 0
        if causal:
            terms = sum(min(mn, r + 1) for r in range(qn))
            kn = min(mn, qn)
        else:
            terms = qn * mn
            kn = mn if qn else 0
        vn = tk if qn < tq else kn
        flops += H * 4 * D * terms
        if qn < tq:
            flops += H * D * tk
        elems_in += H * D * (qn + kn + vn)
    elems_out = B * H * tq * D
    return flops, elems_in, elems_out, B * H * tq * 2 * 4 + 2 * B * 4


def time_ms(torch, fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_kernels(torch, fa, device, sites):
    """Kernel, plain and SDPA times and the bound at each attention site of
    the main path, with the main path's lengths; returns the sums over one
    synthesis call. ``sites``: (name, calls, Tq, Tk, causal, q_len, m_len)."""
    import torch.nn.functional as F
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
              "flop_ms": 0.0, "byte_ms": 0.0}
    for i, (name, calls, tq, tk, causal, ql, ml) in enumerate(sites):
        q, k, v = random_qkv(torch, device, torch.float32, len(ql), 4, tq, tk, 64, seed=100 + i)
        mask = fa.attention_mask(ql, ml, len(ql), tq, tk, causal, device)
        ms = time_ms(torch, lambda: fa.masked_flash_attention(q, k, v, ql, ml, 0.125, causal))
        plain_ms = time_ms(torch, lambda: fa.masked_attention_reference(q, k, v, ql, ml, 0.125, causal))
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=0.125))
        flops, e_in, e_out, other_bytes = attention_work(torch, tq, tk, causal, ql, ml, 64, len(ql), 4)
        n_bytes = (e_in + e_out) * 4 + other_bytes
        flop_ms = 1e3 * flops / PEAK_FLOPS["float32"]
        byte_ms = 1e3 * n_bytes / PEAK_BYTES
        row = {"site": name, "shape": [len(ql), 4, tq, tk, 64], "causal": causal,
               "calls_per_synthesis": calls, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": max(flop_ms, byte_ms),
               "flop_ms": flop_ms, "byte_ms": byte_ms, "gflop": flops / 1e9,
               "mbytes": n_bytes / 1e6, "tflops_achieved": flops / (ms * 1e-3) / 1e12}
        print(json.dumps(row), flush=True)
        for key in totals:
            totals[key] += calls * row[key]
    return totals


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "vaenar_tts_torch")) or not os.path.isdir(MODEL_DIR):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from vaenar_tts_torch.cli.inference import (encode_lines, resolve_length_source,
                                                synthesize_batch)
    from vaenar_tts_torch.models.vaenar import load_model
    from vaenar_tts_torch.ops import _build
    from vaenar_tts_torch.ops import flash_attention as fa

    phase("device")
    device = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"device": kind, "count": count, "torch": torch.__version__,
                      "cuda": torch.version.cuda, "nvidia_smi": smi}), flush=True)

    phase("build")
    t = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t
    lib = _build.load_library()
    report = [line.strip() for line in (_build.ptxas_report() or "").splitlines()
              if "registers" in line or "bytes stack" in line or "Compiling entry" in line]
    print(json.dumps({"build_seconds": build_s, "ptxas": report,
                      "dynamic_shared_bytes_per_block": lib.masked_attention_fwd_shared_bytes()}),
          flush=True)

    phase("kernel_checks")
    worst = check_kernels(torch, fa, device)

    phase("load")
    hp, model, epoch = load_model(MODEL_DIR, device)
    use_q = resolve_length_source("auto", hp)
    check(all(100 <= len(line) <= 150 for line in LINES), "lines must be 100-150 characters")
    token_ids = encode_lines(hp, LINES)

    phase("main_path")
    fa.launch_counts.clear()
    mels0, lens0 = synthesize_batch(model, hp, token_ids, 0.0, use_q)
    torch.cuda.synchronize()
    per_call = fa.launch_counts["masked_attention_fwd"]
    gen = torch.Generator(device=device).manual_seed(1234)
    mels1, lens1 = synthesize_batch(model, hp, token_ids, 0.667, use_q, generator=gen)
    torch.cuda.synchronize()
    launches = fa.launch_counts["masked_attention_fwd"]
    flow_attn = 2 * hp.prior.n_blk * hp.prior.n_transformer_blk
    n_attn = hp.encoder.n_blk + flow_attn + 2 * hp.decoder.nblk
    print(json.dumps({"epoch": epoch, "mel_shape": list(mels0.shape),
                      "lengths_t0": lens0.tolist(), "lengths_t0667": lens1.tolist(),
                      "launches_first_call": per_call, "launches_main_path": launches}),
          flush=True)
    check(per_call == n_attn == 32, f"{per_call} kernel launches in one synthesis, expected 32")
    check(launches == 2 * n_attn, f"{launches} launches in two synthesis calls, expected 64")
    max_mel = mels0.shape[1]
    for mels, lens in ((mels0, lens0), (mels1, lens1)):
        check(bool(torch.isfinite(mels).all()), "non-finite mel")
        check(bool(((lens >= 1) & (lens <= max_mel)).all()), f"lengths out of range {lens}")
    check(torch.equal(lens0, lens1), "predicted lengths changed with the temperature")
    check(not torch.equal(mels0, mels1), "temperature 0.667 gave the temperature-0 mel")

    phase("card_vs_cpu")
    _, cpu_model, _ = load_model(MODEL_DIR, "cpu")
    mels_cpu, lens_cpu = synthesize_batch(cpu_model, hp, token_ids, 0.0, use_q)
    diff = (mels0.cpu() - mels_cpu).abs()
    print(json.dumps({"lengths_cpu": lens_cpu.tolist(), "max_abs_err_mel": diff.max().item(),
                      "max_abs_mel": mels_cpu.abs().max().item()}), flush=True)
    check(torch.equal(lens_cpu, lens0.cpu()), f"card lengths {lens0} != CPU lengths {lens_cpu}")
    check(diff.max().item() <= TOL_MEL_CARD_CPU, f"card vs CPU mel error {diff.max().item()}")

    phase("times")
    r = hp.common.final_reduction_factor
    text_max, z_max = max(map(len, token_ids)), max_mel // r
    text_max = -(-text_max // hp.dataset.text_bucket) * hp.dataset.text_bucket
    text_lens = torch.tensor([len(t) for t in token_ids], dtype=torch.int32, device=device)
    z_lens = ((lens0 + r - 1) // r).to(torch.int32)
    flow_and_dec = flow_attn // 2 + hp.decoder.nblk
    sites = [("encoder_self", hp.encoder.n_blk, text_max, text_max, False, text_lens, text_lens),
             ("causal_self", flow_and_dec, z_max, z_max, True, z_lens, z_lens),
             ("cross", flow_and_dec, z_max, text_max, False, z_lens, text_lens)]
    totals = time_kernels(torch, fa, device, sites)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        synthesize_batch(model, hp, token_ids, 0.0, use_q)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    print(json.dumps({"synthesis_wall_s": walls, "batch": len(LINES),
                      "attention_ms_per_synthesis": totals["ms"],
                      "bound_ms_per_synthesis": totals["bound_ms"]}), flush=True)

    phase("done")
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "masked_attention_fwd", "route": "cuda",
        "source": "vaenar_tts_torch/csrc/masked_attention_fwd.cu",
        "replaces": "vaenar_tts_tpu/ops/flash_attention.py:104",
        "also_replaces": "vaenar_tts_tpu/ops/flash_attention.py:142",
        "launches": launches, "max_abs_err": worst,
        "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "operations" if totals["flop_ms"] >= totals["byte_ms"] else "bytes",
        "library_ms": totals["library_ms"],
        "per": "one synthesis call: its 32 launches at the main path's shapes and lengths"}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
