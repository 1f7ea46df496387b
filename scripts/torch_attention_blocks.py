#!/usr/bin/env python3
"""Where a bf16 attention kernel's launch spends its time, block by block,
for one or more checkouts of the PyTorch port, on one CUDA card:

    python3 scripts/torch_attention_blocks.py ROOT [ROOT ...] [--batch N]

For each ROOT (a directory that holds `vaenar_tts_torch/`, as for
scripts/torch_attention_sites.py) and each bf16 kernel (the forward, the dQ
and the dK/dV kernel), it copies the package's `csrc/` to a temporary
directory, patches the copy of the kernel so that thread 0 of each block
records the card's %globaltimer (ns) when the block starts and when it
ends, its clock64() cycles in between and its SM, builds that copy alone
with nvcc, and launches it once, after warm-up launches, at the main path's
sites (chip_smoke.py's, as scripts/torch_attention_sites.py builds them:
the forward at the synthesis and the train-step sites, dQ and dK/dV at the
train-step sites; `--batch N`: the N items of the training batch with the
longest mels). The package's own sources and build are not touched: the
kernels the program runs carry no timers.

One JSON line per (root, kernel, site): the launch's span (first block
start to last block end), the heaviest block (its (b*H+h, y) block index,
ns, cycles and start offset), the four heaviest ((b*H+h, y, us)), the
median block, the blocks that end within 2 us of their start (those with
no work), the latest block start, and the timer's resolution (the smallest
non-zero step seen). The last line is the
card's name and power limit. It loads chip_smoke.py and
scripts/torch_attention_sites.py by file path (`random_qkv`,
`main_path_sites`).
"""

import ctypes
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = (("masked_attention_fwd_tc.cu", "masked_attention_fwd_tc_kernel"),
           ("masked_attention_bwd_dq_tc.cu", "masked_attention_bwd_dq_tc_kernel"),
           ("masked_attention_bwd_dkv_tc.cu", "masked_attention_bwd_dkv_tc_kernel"))
MAX_BLOCKS = 1 << 16

PRELUDE = r"""
__device__ unsigned long long vaenar_stamps[4 * %d];
#define VAENAR_NOW(t) asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t))
#define VAENAR_STAMP() do { if (threadIdx.x == 0) { \
    unsigned long long vaenar_g1; VAENAR_NOW(vaenar_g1); unsigned int vaenar_sm; \
    asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(vaenar_sm)); \
    unsigned long long* vaenar_r = \
        vaenar_stamps + 4ull * (blockIdx.y * gridDim.x + blockIdx.x); \
    vaenar_r[0] = vaenar_g0; vaenar_r[1] = vaenar_g1; \
    vaenar_r[2] = (unsigned long long)(clock64() - vaenar_c0); vaenar_r[3] = vaenar_sm; \
  } } while (0)
""" % MAX_BLOCKS

READER = r"""
extern "C" int vaenar_read_stamps(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, vaenar_stamps, (size_t)n * 32);
}
"""


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def patch(source, kernel):
    """``source`` with the timers in ``kernel``'s body: the start stamp at its
    top, the end stamp before each ``return;`` and before its closing brace."""
    m = re.search(r"\b%s\(" % kernel, source)
    if m is None:
        raise RuntimeError(f"{kernel} not found")
    open_brace = source.index("{", m.end())
    depth, i = 0, open_brace
    while True:
        if source[i] == "{":
            depth += 1
        elif source[i] == "}":
            depth -= 1
            if depth == 0:
                break
        i += 1
    body = source[open_brace + 1:i].replace("return;", "{ VAENAR_STAMP(); return; }")
    start = ("\n  unsigned long long vaenar_g0; VAENAR_NOW(vaenar_g0);"
             " const long long vaenar_c0 = clock64();")
    head = source[:open_brace + 1]
    first_include = head.index("#include")
    line_end = head.index("\n", first_include)
    head = head[:line_end + 1] + PRELUDE + head[line_end + 1:]
    return head + start + body + "  VAENAR_STAMP();\n}" + source[i + 1:] + READER


def build_patched(root, src_name, kernel, out_dir):
    """The shared library of ``root``'s ``src_name`` with timers in
    ``kernel``."""
    from vaenar_tts_torch.ops import _build
    csrc = os.path.join(os.path.abspath(root), "vaenar_tts_torch", "csrc")
    work = os.path.join(out_dir, src_name.replace(".cu", ""))
    shutil.copytree(csrc, work)
    path = os.path.join(work, src_name)
    with open(path) as f:
        patched = patch(f.read(), kernel)
    with open(path, "w") as f:
        f.write(patched)
    lib = os.path.join(work, "lib.so")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build.find_nvcc(), *flags, "-shared", "-o", lib, path], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(lib)


def launch_args(torch, fa, cs, kind, case, device):
    """(pointer tensors, B, H, Tq, Tk) of one launch of ``kind`` at ``case``
    = (name, calls, Tq, Tk, causal, q_len, m_len), inputs made with
    chip_smoke.py's (``cs``) random_qkv."""
    _, _, tq, tk, causal, ql, ml = case
    B = len(ql)
    q, k, v = cs.random_qkv(torch, device, torch.bfloat16, B, 4, tq, tk, 64, seed=400)
    if kind == "fwd":
        o = torch.empty_like(q)
        m = torch.empty((B, 4, tq), dtype=torch.float32, device=device)
        s = torch.empty_like(m)
        return (q, k, v, ql, ml, o, m, s), (B, 4, tq, tk)
    do = cs.random_qkv(torch, device, torch.bfloat16, B, 4, tq, tq, 64, seed=500)[0]
    o, m, s = fa.masked_attention_reference(q, k, v, ql, ml, 0.125, causal)
    o = o.contiguous()
    delta = fa.attention_delta(o, do).contiguous()
    if kind == "dq":
        return (q, k, v, do, o, ql, ml, m, s, delta, torch.empty_like(q)), (B, 4, tq, tk)
    return ((q, k, v, do, ql, ml, m, s, delta, torch.empty_like(k), torch.empty_like(v)),
            (B, 4, tq, tk))


def block_times(torch, lib, entry, tensors, shape, causal, grid_blocks):
    """Stamps of every block of one launch after 3 warm-up launches:
    int64 [blocks, 4] (start ns, end ns, cycles, SM)."""
    import numpy as np
    from vaenar_tts_torch.ops import _build
    fn = getattr(lib, entry)
    fn.argtypes = _build.argtypes(len(tensors))
    fn.restype = ctypes.c_int
    read = lib.vaenar_read_stamps
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(4):
        err = fn(*ptrs, *shape, 64, 0.125, int(causal), stream)
        if err:
            raise RuntimeError(f"{entry}: CUDA error {err}")
    torch.cuda.synchronize()
    out = np.zeros((grid_blocks, 4), dtype=np.uint64)
    err = read(out.ctypes.data, grid_blocks)
    if err:
        raise RuntimeError(f"reading the stamps: CUDA error {err}")
    return out.astype(np.int64)


def summary(stamps, grid_x):
    import numpy as np
    start, end, cycles = stamps[:, 0], stamps[:, 1], stamps[:, 2]
    t0 = start.min()
    dur = end - start
    heavy = int(np.argmax(dur))
    top = np.argsort(-dur, kind="stable")[:4]
    steps = np.diff(np.unique(np.concatenate([start, end])))
    return {"blocks": int(len(stamps)), "span_us": float((end.max() - t0) / 1e3),
            "heaviest_block": [heavy % grid_x, heavy // grid_x],
            "heaviest_us": float(dur[heavy] / 1e3), "heaviest_cycles": int(cycles[heavy]),
            "heaviest_start_us": float((start[heavy] - t0) / 1e3),
            "top_blocks": [[int(b % grid_x), int(b // grid_x), float(dur[b] / 1e3)] for b in top],
            "median_block_us": float(np.median(dur) / 1e3),
            "blocks_under_2us": int((dur < 2000).sum()),
            "latest_start_us": float((start.max() - t0) / 1e3),
            "timer_step_ns": int(steps[steps > 0].min()) if (steps > 0).any() else None,
            "sms_used": int(len(np.unique(stamps[:, 3])))}


def run_one(root, batch):
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from vaenar_tts_torch.ops import flash_attention as fa
    cs = _load("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    sites_mod = _load("torch_attention_sites", os.path.join(HERE, "scripts",
                                                            "torch_attention_sites.py"))
    device = torch.device("cuda")
    synthesis, _, step = sites_mod.main_path_sites(torch, cs, device, batch)
    with tempfile.TemporaryDirectory(prefix="vaenar_blocks_") as tmp:
        for src_name, kernel in KERNELS:
            lib = build_patched(root, src_name, kernel, tmp)
            kind = "fwd" if "fwd" in kernel else ("dq" if "_dq_" in kernel else "dkv")
            entry = kernel[:-len("_kernel")]
            runs = ([("synthesis", c) for c in synthesis] if kind == "fwd" else []) + \
                [("train_step", c) for c in step]
            for path, case in runs:
                tensors, shape = launch_args(torch, fa, cs, kind, case, device)
                B, H, tq, tk = shape
                grid_x = B * H
                grid_y = -(-(tq if kind != "dkv" else tk) // 64)
                stamps = block_times(torch, lib, entry, tensors, shape, case[4], grid_x * grid_y)
                row = {"root": root, "kernel": entry, "path": path, "site": case[0],
                       "shape": [B, H, tq, tk, 64], "causal": case[4], "grid": [grid_x, grid_y]}
                row.update(summary(stamps, grid_x))
                print(json.dumps(row), flush=True)


def main(argv):
    if len(argv) >= 2 and argv[0] == "--one":
        run_one(argv[1], int(argv[argv.index("--batch") + 1]) if "--batch" in argv else None)
        return 0
    flags = argv[argv.index("--batch"):][:2] if "--batch" in argv else []
    roots = [a for a in argv if a not in flags]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    for root in roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root, *flags],
                       check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
