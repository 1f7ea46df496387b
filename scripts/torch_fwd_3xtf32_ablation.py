#!/usr/bin/env python3
"""Where the time of the fp32 forward at D >= 128 goes
(`vaenar_tts_torch/csrc/masked_attention_fwd_3xtf32.cu`: 3xTF32 on the
tensor cores), on one CUDA card, from the root of a checkout:

    python3 scripts/torch_fwd_3xtf32_ablation.py [--rate] [ABLATION ...]

Each ablation (all of them unless some are named) is a copy of this
checkout's `vaenar_tts_torch/` in a temporary directory whose kernel source
has one part taken out (a string patch, asserted to apply: an edit of the
kernel's text can make a patch stale, and it then raises), built and timed
in a process of its own: the fp32 forward's device ms at chip_smoke.py's
1024 x 4104 check case and summed over the main path's train-step and
synthesis sites (the lengths of scripts/torch_attention_sites.py) of the
shipped attention width (256) in heads of D, at D = 128 (two heads), 256
and 384 (one head), and each site's ms beside the ranks the unpatched
kernel splits its key tiles over (`key_ranks`; under `no_key_split` every
site runs at 1). Every ablation but `none`, `no_key_split` and the `d128_`
alternatives computes wrong outputs: it times work, not attention.

- `none`: the kernel as it is;
- `three_products_no_split`: the three TF32 products of unsplit operands
  (the split's instructions gone, the products kept);
- `one_product_no_split`: one TF32 product of unsplit operands;
- `no_copies`: the ring's global-to-shared copies gone (Q still loaded);
- `no_pv`: O += P.V gone; `no_s`: S = Q.K^T gone;
- `no_step_barrier`: the block barrier of each ring step gone;
- `no_key_split`: every q-block's key tiles in one block (`MAX_RANKS` = 1,
  no cluster merge); outputs stay right;
- alternatives to D = 128's choices, outputs right:
  `d128_4_stages_1_block` and `d128_3_stages_1_block` (a deeper ring, one
  block an SM, in place of two stages and two blocks an SM), and
  `d128_waves_of_1_block` (`key_ranks` counting a wave as one block an SM,
  as at D >= 256, in place of two).

`--rate` also builds and runs a microbenchmark of mma.sync's issue rate
(TF32 m16n8k8 and m16n8k4, BF16 m16n8k16; 8 independent accumulators a
warp, 4, 8 and 16 warps a block, one block a streaming multiprocessor):
products an SM completes a clock at the card's nominal clock, and TFLOP/s.
Prints JSON lines; the last line is the card's name and power limit.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL = os.path.join("vaenar_tts_torch", "csrc", "masked_attention_fwd_3xtf32.cu")
WIDTHS = (128, 256, 384)

NO_SPLIT = [("  big = x & 0xffffe000u;\n  small = small_part(x);", "  big = x;\n  small = x;"),
            ("  return __float_as_uint(__uint_as_float(x) - __uint_as_float(x & 0xffffe000u)) + "
             "0x1000u;", "  return x;")]
ABLATIONS = {
    "none": [],
    "three_products_no_split": NO_SPLIT,
    "one_product_no_split": NO_SPLIT + [
        ("  for (int j = 0; j < 4; ++j) mma_tf32(c[j], as, bb[j][0], bb[j][1]);", "  {}"),
        ("  for (int j = 0; j < 4; ++j) mma_tf32(c[j], ab, bs[j][0], bs[j][1]);", "  {}"),
        ("for (int nt = 0; nt < 2; ++nt) mma_tf32(part[mt][nt], as[mt], bb[2 * nt], "
         "bb[2 * nt + 1]);", "for (int nt = 0; nt < 2; ++nt) {}"),
        ("for (int nt = 0; nt < 2; ++nt) mma_tf32(part[mt][nt], ab[mt], bs[2 * nt], "
         "bs[2 * nt + 1]);", "for (int nt = 0; nt < 2; ++nt) {}")],
    "no_copies": [("      cpa::cp_async16(stage + 16 * u * ld, in ? src + u * rows16 : k, in);",
                   "      (void)in;")],
    "no_pv": [("        if (n_keys > 32)\n          pv_panel<BK>",
               "        if (n_keys > (1 << 30))\n          pv_panel<BK>"),
              ("        else\n          pv_panel<BK / 2>",
               "        else if (n_keys > (1 << 30))\n          pv_panel<BK / 2>")],
    "no_s": [("      if (has_keys) {", "      if (has_keys && n_keys > (1 << 30)) {")],
    "no_step_barrier": [("    cpa::cp_async_wait<STAGES - 2>();\n    __syncthreads();\n",
                         "    cpa::cp_async_wait<STAGES - 2>();\n")],
    "no_key_split": [("constexpr int MAX_RANKS = 4;", "constexpr int MAX_RANKS = 1;")],
    "d128_4_stages_1_block": [("return W == 128 ? 2 : QRES", "return W == 128 ? 4 : QRES"),
                              ("return W == 128 ? 2 : 1;", "return 1;")],
    "d128_3_stages_1_block": [("return W == 128 ? 2 : QRES", "return W == 128 ? 3 : QRES"),
                              ("return W == 128 ? 2 : 1;", "return 1;")],
    "d128_waves_of_1_block": [("MIN_TILES_A_RANK, blocks_an_sm<W>());", "MIN_TILES_A_RANK, 1);")],
}


def model_heads(D):
    """Heads of the shipped attention width (256) at head width D: two at
    128, one at 256 and above (384 is the one-head-of-384 model's)."""
    return max(1, 256 // D)

RATE_SOURCE = r"""
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>
template <int KIND>
__global__ void rate(float* out, int iters) {
  float acc[8][4] = {};
  const uint32_t a0 = threadIdx.x * 0x3f800001u, a1 = a0 ^ 0x1234u, a2 = a0 ^ 0x4321u,
                 a3 = a0 ^ 0x5555u, b0 = a0 ^ 0x7777u, b1 = a0 ^ 0x1111u, m = 0x3f003f00u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (KIND == 0)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else if (KIND == 1)
        asm volatile("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
                     : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
                     : "r"(a0), "r"(a1), "r"(b0));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
                     : "r"(a0 & m), "r"(a1 & m), "r"(a2 & m), "r"(a3 & m), "r"(b0 & m),
                       "r"(b1 & m));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int KIND>
void run(const char* name, double macs, int threads) {
  int sms, khz;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  const int iters = 4096;
  float* out;
  cudaMalloc(&out, sizeof(float) * sms * threads);
  rate<KIND><<<sms, threads>>>(out, 16);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  rate<KIND><<<sms, threads>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double mmas = (double)sms * threads / 32 * iters * 8;
  printf("{\"mma\": \"%s\", \"warps_a_block\": %d, \"ms\": %.4f, \"tflops\": %.1f, "
         "\"products_a_clock_an_sm\": %.3f, \"nominal_mhz\": %d, \"error\": \"%s\"}\n",
         name, threads / 32, ms, 2 * mmas * macs / (ms * 1e-3) / 1e12,
         mmas / (ms * 1e-3) / sms / (khz * 1e3), khz / 1000, cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}
int main() {
  for (int threads : {128, 256, 512}) {
    run<0>("tf32.m16n8k8", 1024, threads);
    run<1>("tf32.m16n8k4", 512, threads);
    run<2>("bf16.m16n8k16", 2048, threads);
  }
  return 0;
}
"""


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def patched_copy(dst, patches):
    """This checkout's package under ``dst`` (no build directory), its
    kernel source patched; raises if a patch does not apply."""
    shutil.copytree(os.path.join(HERE, "vaenar_tts_torch"), os.path.join(dst, "vaenar_tts_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(dst, KERNEL)
    with open(path) as f:
        src = f.read()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"patch does not apply once to {KERNEL}: {old[:60]!r}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)


def key_ranks(B, H, Tq, Tk, D, sms):
    """The ranks the kernel's ``key_ranks`` splits a q-block's key tiles
    over at this shape, on ``sms`` SMs (its rule, mirrored: a change to it
    must be made here too). The same rule serves the bf16 forward of
    ``masked_attention_wide_tc.cu`` at D > 256 (slices of 384 columns at
    D = 384, of 512 above), one block an SM."""
    blocks = B * H * -(-Tq // 64) * (1 if D <= 512 else -(-D // 512))
    blocks_an_sm = 2 if D == 128 else 1
    ranks = 1
    while (2 * ranks <= 4 and blocks * 2 * ranks <= 2 * sms * blocks_an_sm
           and -(-Tk // 64) >= 8 * 2 * ranks):
        ranks *= 2
    return ranks


def time_one(root, name):
    """fp32 forward device ms of the package under ``root``; prints a line."""
    sys.path.insert(0, root)
    import torch
    from vaenar_tts_torch.ops import _build
    from vaenar_tts_torch.ops import flash_attention as fa
    cs = _load("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    sites = _load("torch_attention_sites", os.path.join(HERE, "scripts",
                                                         "torch_attention_sites.py"))
    _build.build()
    device = torch.device("cuda")
    synthesis, long_case, step = sites.main_path_sites(torch, cs, device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    row = {"ablation": name}
    for D in WIDTHS:
        for tag, site_list in (("tk_4104", [(long_case[0], 1, *long_case[1:])]),
                               ("train_step", step), ("synthesis", synthesis)):
            total, per_site = 0.0, []
            H = model_heads(D)
            for i, (site, calls, tq, tk, causal, ql, ml) in enumerate(site_list):
                q, k, v = cs.random_qkv(torch, device, torch.float32, len(ql), H, tq, tk, D,
                                        seed=100 + i)
                ms = cs.time_ms(torch, lambda: fa.masked_flash_attention(
                    q, k, v, ql, ml, D ** -0.5, causal))
                total += calls * ms
                per_site.append({"site": site, "shape": [len(ql), H, tq, tk, D], "calls": calls,
                                 "key_ranks": key_ranks(len(ql), H, tq, tk, D, sms), "ms": ms})
            row[f"{tag}_ms_d{D}"] = total
            row[f"{tag}_sites_d{D}"] = per_site
    print(json.dumps(row), flush=True)


def mma_rate(tmp):
    from vaenar_tts_torch.ops import _build
    src, exe = os.path.join(tmp, "mma_rate.cu"), os.path.join(tmp, "mma_rate")
    with open(src, "w") as f:
        f.write(RATE_SOURCE)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS[:4], "-o", exe, src], check=True)
    print(subprocess.run([exe], capture_output=True, text=True, check=True).stdout, end="",
          flush=True)


def main(argv):
    if argv[:1] == ["--one"]:
        time_one(argv[1], argv[2])
        return 0
    unknown = [a for a in argv if a != "--rate" and a not in ABLATIONS]
    if unknown:
        print(f"unknown ablation {unknown}; one of {list(ABLATIONS)}", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    with tempfile.TemporaryDirectory(prefix="vaenar_ablation_") as tmp:
        if "--rate" in argv:
            mma_rate(tmp)
        names = [a for a in argv if a in ABLATIONS] or list(ABLATIONS)
        for name in names:
            patches = ABLATIONS[name]
            root = os.path.join(tmp, name)
            patched_copy(root, patches)
            subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root, name],
                           check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
