#!/usr/bin/env python3
"""Time the attention kernels of one or more checkouts of the PyTorch port
(vaenar_tts_torch) at the main path's sites, on one CUDA card, without the
model:

    python3 scripts/torch_attention_sites.py ROOT [ROOT ...] [--checks] [--dtype float32]
        [--batch N] [--heads N] [--attention-dim N]

Each ROOT is a directory that holds a `vaenar_tts_torch/` package (this
checkout, or another tree unpacked with `git archive`); each runs in its own
process, in the order given, which imports the package and builds its
kernels from its root. A run prints its ptxas report (registers, spills,
warnings), each kernel's count of tensor-core product instructions in the
built library's SASS (`HGMMA` for wgmma, `HMMA` for mma.sync), with `--checks`
chip_smoke.py's kernel checks, and then, in each dtype (both unless
`--dtype` names one), chip_smoke.py's rows for the forward at the synthesis
sites and at 1024 x 4104 and for the forward, dQ and dK/dV at the train-step
sites: device time, bound, plain and library times, and the dQ and dK/dV
kernels back to back (`pair_ms`). The site lengths are the
ones chip_smoke.py's times phase uses: the shipped model's bf16 synthesis
lengths of its four lines (1093, 1000, 1166 and 919 mel frames) and the
seeded training batch at r = 2, or with `--batch N` its N items with the
longest mels (N = 1: the latency of one item's blocks, the card otherwise
idle). `--heads N` splits the shipped attention width (256) into N heads
of 256 / N at every site (default 4 heads of 64; 2 heads run the D = 128
kernels, 1 head the D = 256 ones, 8 heads the zero-padded D = 32 route),
with the checks at that width too; `--attention-dim N` takes N in place of
256 (`--attention-dim 384 --heads 1`: the wide kernels at D = 384). A tree
from before the kernels took other widths runs only the default. The last
line is the card's name and power limit.

It loads chip_smoke.py by file path and calls its helpers `MODEL_DIR`,
`LINES`, `check_cases`, `check_kernels`, `check_backward`, `write_records`,
`synthesis_sites`, `train_sites`, `time_kernels` and `time_backward`: a
change to their signatures or return values there must be made here too.
"""

import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import types

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# mel frames the shipped model predicts for chip_smoke.py's LINES at bf16
SYNTHESIS_MEL_LENGTHS = (1093, 1000, 1166, 919)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tensor_core_counts(build):
    """{kernel function: {instruction: count}} of the tensor-core product
    instructions in the built library's SASS (``cuobjdump -sass``): HGMMA
    (wgmma) and HMMA (mma.sync), for the functions whose mangled name holds
    a C entry point's name. Without cuobjdump, the counts of
    ``wgmma.mma_async`` and ``mma.sync`` in each source's ``nvcc -ptx``."""
    nvcc = build.find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    names = [name for name, _ in build.KERNELS]
    counts = {}
    if os.path.isfile(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", build.build()], capture_output=True,
                              text=True, check=True).stdout
        func = None
        for line in sass.splitlines():
            if "Function :" in line:
                mangled = line.split("Function :")[1].strip()
                func = next((n for n in sorted(names, key=len, reverse=True)
                             if f"{n}_kernel" in mangled), mangled)
                func = f"{func} ({mangled})"
                counts[func] = {"HGMMA": 0, "HMMA": 0}
            elif func is not None:
                for op in ("HGMMA", "HMMA"):
                    if f" {op}." in line:
                        counts[func][op] += 1
        return {"source": "cuobjdump -sass", "counts": counts}
    with tempfile.TemporaryDirectory(prefix="vaenar_ptx_") as tmp:
        for src in build.sources():
            out = os.path.join(tmp, os.path.basename(src) + ".ptx")
            subprocess.run([nvcc, *build.NVCC_FLAGS[:4], "-ptx", "-o", out, src], check=True)
            with open(out) as f:
                ptx = f.read()
            counts[os.path.basename(src)] = {"wgmma.mma_async": ptx.count("wgmma.mma_async"),
                                             "mma.sync": ptx.count("mma.sync")}
    return {"source": "nvcc -ptx", "counts": counts}


def main_path_sites(torch, cs, device, batch=None):
    """(synthesis sites, the 1024 x 4104 check case, train-step sites) as
    chip_smoke.py's ``synthesis_sites``, ``check_cases`` and ``train_sites``
    give them, at the lengths the module docstring names; the package of
    the root being run must be importable."""
    from vaenar_tts_torch.cli.inference import encode_lines
    from vaenar_tts_torch.configs.serialize import load_hparams
    from vaenar_tts_torch.data.loader import BucketedLoader, pad_to_multiple
    from vaenar_tts_torch.data.records import list_shards
    hp = load_hparams(cs.MODEL_DIR)
    ids = encode_lines(hp, cs.LINES)
    # the mel bucket of cli.inference.synthesize_batch
    text_max = pad_to_multiple(max(map(len, ids)), hp.dataset.text_bucket)
    max_mel = pad_to_multiple(int(text_max * hp.common.mel_text_len_ratio * 2) + 160,
                              hp.dataset.mel_bucket)
    sites = cs.synthesis_sites(torch, hp, ids, torch.tensor(SYNTHESIS_MEL_LENGTHS), max_mel,
                               device)
    long_case = [c for c in cs.check_cases(torch, device) if c[0] == "long_1024x4104"][0]
    with tempfile.TemporaryDirectory(prefix="vaenar_sites_") as tmp:
        cs.write_records(tmp, seed=2026)
        big = next(iter(BucketedLoader(list_shards(tmp, "train"), hp.train.train_batch_size,
                                       hp.dataset.mel_bucket, hp.dataset.text_bucket,
                                       shuffle=False).epoch(0)))
    if batch:
        keep = np.argsort(-big.mel_lengths, kind="stable")[:batch]
        big = types.SimpleNamespace(texts=big.texts[keep], mels=big.mels[keep],
                                    text_lengths=big.text_lengths[keep],
                                    mel_lengths=big.mel_lengths[keep])
    return sites, long_case, cs.train_sites(torch, hp, big, device)


ATTENTION_DIM = 256  # the shipped model's attention width in every stack


def run_one(root, checks, dtypes, batch=None, heads=4, attention_dim=ATTENTION_DIM):
    """One run from ``root`` (train-step sites on the ``batch`` longest items
    of the seeded batch, or all of them), at ``heads`` heads of
    attention_dim / heads; prints JSON lines."""
    width = attention_dim // heads
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from vaenar_tts_torch.ops import _build
    from vaenar_tts_torch.ops import flash_attention as fa
    cs = _chip_smoke()
    device = torch.device("cuda")
    _build.build()
    lib = _build.load_library()
    print(json.dumps({"root": root, "ptxas": [
        line.strip() for line in (_build.ptxas_report() or "").splitlines()
        if "registers" in line or "bytes stack" in line or "Compiling entry" in line
        or "arning" in line],
        "dynamic_shared_bytes_per_block": {
            name: getattr(lib, f"{name}_shared_bytes")() for name, _ in _build.KERNELS},
        "tensor_core_instructions": tensor_core_counts(_build)}), flush=True)
    if checks:
        print(json.dumps({"root": root, "head_dim": width,
                          "forward_checks": cs.check_kernels(torch, fa, device, width)}),
              flush=True)
        print(json.dumps({"root": root, "head_dim": width,
                          "backward_checks": cs.check_backward(torch, fa, device, width)}),
              flush=True)

    sites, long_case, step_sites = main_path_sites(torch, cs, device, batch)
    for dtype_name in dtypes:
        print(json.dumps({"root": root, "dtype": dtype_name, "heads": heads,
                          "head_dim": width,
                          "forward_per_synthesis": cs.time_kernels(torch, fa, device, sites,
                                                                   dtype_name, heads, width),
                          "tk_4104": cs.time_kernels(torch, fa, device,
                                                     [(long_case[0], 1, *long_case[1:])],
                                                     dtype_name, heads, width),
                          "per_train_step_r2": cs.time_backward(torch, fa, device, step_sites,
                                                                dtype_name, heads, width)}),
              flush=True)


def main(argv):
    if len(argv) >= 2 and argv[0] == "--one":
        run_one(argv[1], "--checks" in argv, argv[argv.index("--dtype") + 1:][:1]
                if "--dtype" in argv else ["float32", "bfloat16"],
                int(argv[argv.index("--batch") + 1]) if "--batch" in argv else None,
                int(argv[argv.index("--heads") + 1]) if "--heads" in argv else 4,
                int(argv[argv.index("--attention-dim") + 1]) if "--attention-dim" in argv
                else ATTENTION_DIM)
        return 0
    flags = [a for a in argv if a == "--checks"]
    for option in ("--dtype", "--batch", "--heads", "--attention-dim"):
        if option in argv:
            flags += argv[argv.index(option):][:2]
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
