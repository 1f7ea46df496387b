#!/usr/bin/env python3
"""Drive the PyTorch port (vaenar_tts_torch) on one CUDA card, from the root
of a checkout:

    python3 chip_smoke.py

The main path is the shipped configuration, whose compute dtype is
bfloat16: bf16 attention goes through the tensor-core forward, dQ and dK/dV
kernels (masked_attention_fwd_tc, masked_attention_bwd_dq_tc and
masked_attention_bwd_dkv_tc). The strict card-against-CPU gates run the
same model at compute dtype float32, through the fp32 kernels
(masked_attention_fwd, masked_attention_bwd_dq and masked_attention_bwd_dkv).
In both dtypes the dQ kernel also forms delta = rowsum(dO * O), which the
dK/dV kernel reads: a backward launches those two kernels and nothing else.

1. device: the card's name, count, and `nvidia-smi` name and power limit;
2. build: every csrc/*.cu with nvcc for sm_90a (one nvcc for each source,
   all started together), and ptxas's register and shared-memory report;
3. kernels against their plain PyTorch versions on the card, in fp32 and
   bf16, at head widths 64, 128 and 256 (the kernels' three
   instantiations) on every case and at 8, 32, 96 and 160 (zero-padded to
   the next of those) on a subset (PADDED_FWD_CASES, PADDED_BWD_CASES),
   all under one tolerance a
   dtype, each check asserting which kernel it launched: the forward at the
   synthesis path's shapes, on ragged shapes, fully masked rows, Tk > 4096
   and logits of standard deviation 8 (|S| up to a few tens, at every
   width); the dQ and dK/dV backward kernels at the training path's
   shapes (r = 2 and r = 5), with fully masked rows, an item with no key, a
   ragged pair and a long causal site, and each dQ kernel alone with its
   delta; both at the edges of the kernels' tiles (padding rows over many
   q-blocks with two warp groups, 32 and 33 keys or rows in a tile); and a
   profile of one backward in each dtype, which must launch the dQ and the
   dK/dV kernel and no other kernel;
4. synthesis path (bf16): the shipped LJSpeech model (artifacts/toyv2_q90/
   ckpt) at full width synthesizes 4 fixed lines through the CLI's
   synthesize_batch, at temperature 0 and at 0.667 with a seeded generator,
   with the kernels' launch counts reset before and read after;
5. synthesis at fp32, card against CPU: the same model at compute dtype
   float32 on the card and on the CPU at temperature 0 must predict the same
   lengths and agree on the mels; the decoder's alignments asked of the
   bf16 synthesis (the same 32 forward launches, the same mels bit for bit,
   rows summing to 1) and of the fp32 one (card against CPU); then the bf16
   lengths of 4. against the fp32 ones, within a stated bound;
   audio: the STFT, mel and iSTFT on the card against audio/dsp.py at the
   shipped audio config on a ragged batch of 4 seeded 2-3 s signals;
   Griffin-Lim from one phase against an fp64 numpy run of the JAX
   package's iteration, its 60-iteration convergence against the numpy
   gl_core's, mel_to_wav of 4.'s mels, and the device streaming backend
   against the host one;
6. training path (bf16): a record set made from a seed (64 train and 32 dev
   utterances in the toy-v2 corpus's ranges) in a temporary directory, and
   `vaenar_tts_torch.cli.train` with the shipped hparams.json at full width
   on the card, 2 epochs of 2 steps, from cold start (data-dependent flow
   init, priming step) through the dev loss and checkpoints, with the launch
   counts reset before and read after; the checkpoint restores;
7. card against CPU at fp32: one train step from the trained state (dropout
   off, injected posterior noise, r = 2, a batch of 4, ReLU inputs that
   round to the other side of 0 on the CPU put on the card's side): loss,
   every gradient element and the BatchNorm statistics agree;
8. bf16 against fp32 on the card: the dev step's losses from the trained
   state, within the JAX package's own bf16 thresholds;
9. export and synthesis: the trained directory exported to export.npz,
   which is copied with hparams.json into a directory of its own, loaded
   from there, held to the epoch-2 checkpoint's weights in float16 and synthesized
   from; the synthesis CLI (cli.inference.main, bf16) over a
   test split of 16 generated utterances with --write_wavs (the RTF line,
   16 mels and 16 wavs of mel length * hop samples, forward launches only),
   again with --stream_wavs (time to first audio), and in free-text mode
   with 4 takes a line by each score, with the launch counts reset before
   and read after each run; then the vocoders' times: Griffin-Lim on the
   card per batch of 4 synthesized lines in both DFT forms, the host's
   numpy Griffin-Lim on the same batch, the test-set RTF and the time to
   first audio on each streaming backend;
10. times on the card, in bf16 and in fp32: each kernel at its path's shapes
   beside its bound, its plain version and one PyTorch library call (device
   time); synthesis wall time; train step wall time at r = 2 and r = 5 and
   launches per train step; a torch.profiler pass over train steps in both
   dtypes for the device busy share and the kernels that take the most
   device time;
11. preprocessing: a toy-v2 corpus of 96 utterances from a seed in
   LJSpeech's layout (metadata.csv, 22.05 kHz wavs) and 6 DataBaker
   utterances (label file, 16 kHz wavs) through `vaenar_tts_torch.cli.
   preprocess`, with the mels on the card (--device_mels) and on the host:
   the same splits and shards, the mels within 5e-4, a smoke batch; the
   extraction times on each side;
12. probed training: `cli.train` on the toy records at the shipped
   hparams.json (bf16, full width), 2 epochs of 2 steps with `--probe
   toy_ler --probe_every 1`: a probe line an epoch with a finite LER in
   [0, 1], the forward kernel launched inside each probe, the backward
   kernels in the steps; the best probed weights (export_best.npz) loaded
   from a directory of their own synthesize a line;
13. the shipped model's letter error rate: the 16 texts of
   random_text(default_rng(4242)) through the free-text CLI at 1 take
   (coverage score) and 4 (medoid), mean length head, temperature 0.6, over
   4 sample seeds, transcribed by the port's ToyLetterDecoder, beside the
   JAX package's 0.257 and 0.236 at epoch 1700; the decoder's floor on
   procedural renders must read 0.077 and the 1-take mean stay at or below
   0.40;
14. the rest of the training loop (bf16, shipped config, the toy-v2
   ranges' records with a test split of 8): `cli.train` with
   `--test_dir`, `train.test_interval=1` and `--no-draw_plots`, the device
   data cache on and then off: test wavs from the card's Griffin-Lim of
   mel length * hop samples, finite test_mel_l1/l2/mcd_db in
   logs/dev/metrics.jsonl, train.log, the predicted launches, and the two
   runs' losses against each other; each run resumed for 1 epoch under
   torch.profiler, for its host-to-device copies; then SIGTERM: cli.train
   in a subprocess, signalled after epoch 2's first step line, must exit
   0 with the checkpoints of epochs 0 and 1 only, and resumed to epoch 3
   match an uninterrupted run's dev losses;
15. remat "on" and "dots" against "off" at fp32 (batch 4, r = 2, dropout
   on, one generator state: loss and every gradient within the card-vs-CPU
   step's tolerances, twice the forward launches) and at bf16, batch 32
   (peak memory, step time, launches); prior.batched_lu on against off
   (the prior's fp32 log-probability, and the bf16 step's time);
16. the neural vocoder: `cli.train_vocoder --toy --toy_version 2` at the
   full VocoderConfig in fp32 and bf16 (the loss must fall), its fp32
   head's raw output card against CPU, and the frame math and iSTFT on the
   card from the CPU head's output (vocoder_card_cpu_shares), `vocode` of
   the 4 synthesized lines beside
   Griffin-Lim on the same mels (device ms), `cli.inference
   --neural_vocoder` over the test split (wavs of max(length - 1, 1) * hop
   samples) and `cli.train --neural_vocoder` (its test wavs);
17. a torch.profiler trace (utils/profiling.profile_trace) of one bf16
   synthesis call: device busy share, launches, top device operations
   (run after the times of 10.);
18. the native batch packer over 11.'s toy records and over 2048
   utterances at LJSpeech's lengths: the loader says "native", an epoch
   of its batches equals the numpy path's to the byte, and 5 epochs'
   assembly timed each way;
19. multi-process training: `cli.train --distributed` in two processes
   sharing the card over gloo, the shipped config at full width, on
   records in 4 train shards whose shapes span two buckets: at fp32 every
   logged step loss and the epoch-1 dev losses against one process on the
   same global batches (write_fleet_records, fleet_mirror), both processes'
   losses equal, the lockstep schedule with 2 or more shapes, checkpoints
   from process 0 only, each process's launches as counted; at bf16 3
   epochs, finite and equal losses, its step wall beside one process's on
   the same global batches; then SIGTERM to both processes of a bf16 fleet
   once both are in epoch 1: one stop epoch, exit 0, and the fleet resumed
   from there logs epoch 3 equal to the 3-epoch fleet's to the last bit;
20. sharded synthesis: two processes (`chip_smoke.py --synthesis-worker`)
   run parallel/synthesis.ShardedSynthesizer over the 4 shipped lines at
   fp32, temperature 0 and 0.667: lengths equal to one process's call,
   mels within TOL_SHARDED_MEL; and which gloo collectives take CUDA
   tensors. The fleets' launches, read from each process's
   logs/process_<i>.json, join the kernels' counts;
21. the mesh's model axis: two processes (`--model-axis-worker`) on the
   card as one model group (data 1 x model 2, gloo), with a pair that
   probes gloo's point-to-point ops on CUDA tensors beside them
   (`--p2p-probe`): ring_attention, the ring against the fp32 forward
   kernel at the synthesis path's self-attention shapes (ms a call both
   ways); tensor_parallel_synthesis, the shipped model with its wide
   kernels sharded and VAENAR(seq_mesh=) in fp32 and bf16 over the 4
   lines against one process, with 18 forward launches a call; and
   tensor_parallel_training, an fp32 step (ring_min_seq 0, batch 32, r = 2)
   against one process's losses and gradients, every gradient and every
   parameter after the step bit-equal across the two processes (the
   group's average of the replicated gradients, timed alone), then bf16
   steps, the walls beside one process's and the launches of each process;
22. reference_checkpoint_import: the shipped export written as a
   reference TensorBundle by interop/importer.py, read back (checksums
   verified) and synthesized from: the mels equal the export's bit for bit;
23. epoch_graph (run after 14.): `cli.train` with the device data cache
   and train.device_cache_epoch_scan (a CUDA graph of the train step per
   reduction factor, replayed once a step) at the shipped config with the
   curriculum cut to r = 5 then 2, in fp32 and bf16, 3 epochs of 2 steps
   at batch 32 from a cold start against 2 epochs without the flag (the
   losses of every epoch), each run resumed for epoch 3 with the flag the
   other way (against the uninterrupted run), the fp32 runs under
   deterministic cuDNN; at fp32 with cuDNN's defaults, 2 epochs with the
   flag against 2 without it, beside a second run without it (each run's
   launches a path of its own); the kernels each captured
   step launched and the replays; the epoch runner alone from the trained
   state: wall an epoch and ms a step graphed and eager, the device busy
   share of each under torch.profiler, the capture's seconds and its pool's
   peak bytes; train.remat inside the graph (bf16 "on" and "dots", fp32
   "on" under deterministic cuDNN): 2 epochs with the flag against 2
   without it under the same remat, losses and weights equal to the bit,
   the forward kernel launched twice for each attention of the captured
   step, each run a path of its own, then ms a step graphed and eager, the
   capture's seconds and its pool's peak beside the no-remat run's; and in
   a process of its own (`--graph-failure-worker`) a capture that fails
   raises with no step run eagerly;
24. head_widths (run after 10.): the shipped config's attention width
   in 2 heads (D = 128), in 1 (D = 256) and in 8 (D = 32, zero padded to
   the D = 64 kernels) in every stack, fresh weights from `cli.train`'s
   seeded cold start at batch 32, r = 2 (head_widths_phase): at D = 128
   and at D = 256 a bf16 epoch eager and graphed, equal to the bit, bf16
   synthesis, fp32 synthesis and an fp32 step against the CPU, synthesis
   and train-step walls beside the shipped model's, and that width's
   kernels timed at this model's sites; at D = 32 a bf16 epoch eager and
   graphed, equal to the bit, bf16 synthesis and fp32 synthesis against
   the CPU; every run's kernel launches, by instantiation.

Each phase prints a JSON line {"phase": ..., "seconds": ...} first. A failed
check raises; the script then exits non-zero without printing the final
line. With `--synthesis-worker RANK PORT OUT` it is one process of 20, with
`--model-axis-worker` or `--p2p-probe` one of 21, with
`--graph-failure-worker` the process of 23. Without a CUDA device, or
without the rest of the repository beside it, it exits non-zero at once. It writes the kernel build directory
(vaenar_tts_torch/_build/, ignored by git) and a temporary directory that it
deletes.
"""

import contextlib
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# the fp32 forward at D >= 128 runs on the tensor cores in 3xTF32, three
# TF32 products for each fp32 one (masked_attention_fwd_3xtf32.cu): a third
# of the 495 TFLOP/s dense TF32 rate, beside the SIMT fp32 bound
PEAK_3XTF32 = 495e12 / 3
# the fp32 forward kernels (launch_counts keys) that run 3xTF32: their
# bound_ms and bound_by are at PEAK_3XTF32, their SIMT flop_ms only beside
TF32X3_KERNELS = ("masked_attention_fwd_d128", "masked_attention_fwd_d256",
                  "masked_attention_fwd_wide")
# bytes of an element of q, k, v, o and the gradients; the row statistics,
# delta and the lengths are 4-byte in both dtypes
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}
# tolerances of kernel against plain version on the card, per element as
# atol + rtol * |o_plain|: fp32 sums run in another order (atol 1e-4); in
# bf16 both sum in fp32 and round o once to bf16, so they may differ by one
# bf16 ulp, at most 2**-7 * |o| (rtol), plus the fp32 order (atol 1e-3)
TOL_O = {"float32": (1e-4, 0.0), "bfloat16": (1e-3, 2.0 ** -7)}
TOL_M = 1e-4
TOL_S_REL = 1e-4
# the check cases whose q and k are scaled by sqrt(std), so that the scaled
# logits have this standard deviation (|S| up to a few tens) in place of 1
LARGE_LOGIT_STD = {"large_logits_130": 8.0}
# card against CPU, whole model at temperature 0: an fp32 chain of ~50
# layers whose sums run in another order on the card; mels are of order 1,
# as the JAX-against-port tolerance on the CPU (tests/test_torch_model.py)
TOL_MEL_CARD_CPU = 1e-4
# backward kernels against the plain backward, per element atol + rtol *
# |g_plain|: fp32 sums run in another order (dV sums up to 1680 rows); in
# bf16 both sum in fp32 and round the gradient once, so they may differ by
# one bf16 ulp, at most 2**-7 * |g|, plus the fp32 order (atol 1e-3)
TOL_GRAD = {"float32": (1e-4, 1e-5), "bfloat16": (1e-3, 2.0 ** -7)}
# the dQ kernels' delta = rowsum(dO * O) against the plain one, per element
# atol + rtol * |delta_plain|: both sum 64 fp32 products (exact ones of bf16
# inputs) in fp32, in another order
TOL_DELTA = (1e-5, 1e-5)
# card against CPU, one full-width train step (the parity test against JAX,
# tests/test_torch_train_step.py, holds losses to 1e-5 relative, gradients
# to 1e-4 + 1e-3 * max|g| of each leaf, BatchNorm statistics to 1e-5 + 1e-6):
# * mel_l2, len_l2, the pinball term and the total to 1e-5 relative; the kl
#   to 1e-4 relative: it is the difference of two log-prob sums of size ~7e3
#   (about 40 at full width), and two fp32 ulps of those sums are 3e-5 of it;
# * every gradient element within 1e-3 * max|g| of its leaf on the CPU: the
#   parity test's relative term, without its fixed 1e-4, which would hide
#   every leaf whose gradients are smaller than that (the prior couplings'
#   attention and FFN, behind output heads that start at 0);
# * but for the bias of a conv whose output goes straight into BatchNorm:
#   its gradient is 0 in exact arithmetic (the batch mean takes it out), so
#   both sides are held below 1e-4 of the largest gradient of that conv's
#   weight instead;
# * a ReLU input that comes out at the other side of 0 on the card and on
#   the CPU takes the card's side on the CPU (hooks; the gradient passes as
#   through the input), so that both differentiate the same branch; such an
#   input must lie within 1e-4 of its tensor's RMS of 0, a tie of rounding;
# * BatchNorm statistics to 1e-5 relative + 1e-6.
TOL_LOSS_REL = 1e-5
TOL_KL_REL = 1e-4
TOL_GRAD_LEAF = 1e-3
TOL_ZERO_GRAD = 1e-4
TOL_RELU_TIE = 1e-4
TOL_BN = (1e-5, 1e-6)
# bf16 against fp32 on the card, from the same trained state: the dev
# step's mel_l2, len_l2 and total within 8 % relative and the kl within 60
# absolute, the JAX package's own thresholds for its bf16 run
# (tests/test_round2_fixes.py:73-77); the shipped model's predicted lengths
# at temperature 0 within 3 % + 1 frame of the fp32 ones (the bound stated
# in PERF.md before the first run: bf16 logits of the length head, one bf16
# ulp = 2^-8 relative, summed over ~120 tokens)
TOL_BF16_FP32_REL = 0.08
TOL_BF16_FP32_KL = 60.0
TOL_LEN_BF16 = (0.03, 1.0)
# audio on the card against the numpy DSP (audio/dsp.py), at the shipped
# audio config: magnitudes and normalized mels to atol 2e-4 and the torch
# preemphasis to 1e-5, the tolerances of the JAX package's own DSP tests
# (tests/test_jax_dsp.py); the iSTFT of the STFT back to the signal to 1e-4
# (tests/test_griffin_lim.py); Griffin-Lim's 4 fp32 iterations from one
# phase against an fp64 numpy run of the same iteration to 5e-5 of the
# reference's peak (an fp32 sum of 2048 terms is off by ~45 ulps, ~3e-6,
# and the chain has 10 transforms; torch's fp32 run on the CPU lands within
# 7e-6 of it on these signals); 60 iterations' spectral convergence
# within the numpy gl_core's * 1.1 + 0.02 on the same mel; the device
# streaming backend against the host one at the same seed, correlation
# above 0.95 (tests/test_streaming.py); decoder alignments' rows sum to 1
# within 1e-5, and the fp32 card's match the CPU's to 1e-4
TOL_MAG = 2e-4
TOL_MEL_NORM = 2e-4
TOL_PREEMPHASIS = 1e-5
TOL_ISTFT = 1e-4
TOL_GL_F64_REL = 5e-5
TOL_GL_CONVERGENCE = (1.1, 0.02)
TOL_STREAM_CORR = 0.95
TOL_ALI_ROWSUM = 1e-5
TOL_ALI_CARD_CPU = 1e-4
N_TEST = 16
NO_DROPOUT = ["encoder.pre_drop_rate=0", "encoder.pos_drop_rate=0",
              "decoder.post_drop_rate=0", "posterior.pre_drop_rate=0",
              "posterior.pos_drop_rate=0"]
# the toy-v2 corpus's ranges (artifacts/toyv2_q90/corpus_stats.json): text
# 12-32 ids, mel about 9 frames a token, at most 370 frames
N_TRAIN, N_DEV = 64, 32
# preprocessing: a toy-v2 corpus of N_TOY utterances in LJSpeech's layout
# and N_DATABAKER DataBaker utterances; card mels against the host's numpy
# mels within 5e-4, the JAX package's own bound for its device mels
# (tests/test_corpus.py)
N_TOY = 96
TOL_MEL_DEVICE_HOST = 5e-4
DATABAKER_LABELS = [
    ("妈妈#1当时#1表示#3，儿子#1开心得#2像花儿#1一样#4。",
     "ma1 ma1 dang1 shi2 biao3 shi4 er2 zi5 kai1 xin1 de5 xiang4 huar1 yi2 yang4"),
    ("你好#4。", "ni3 hao3"),
    ("那儿#2有#1一个#1小孩儿#3在#1玩儿#4。", "nar4 you3 yi2 ge4 xiao3 hair2 zai4 war2"),
    ("今天#1天气#2很好#4。", "jin1 tian1 tian1 qi4 hen3 hao3"),
    ("我们#1一起#1去#2公园#4。", "wo3 men5 yi4 qi3 qu4 gong1 yuan2"),
    ("谢谢#4。", "xie4 xie5"),
]
# the shipped model's letter error rate: the 16 texts of
# random_text(default_rng(4242)) through the free-text CLI at the settings
# of scripts/freetext_toyv2_eval.py, over LER_SEEDS sample seeds; the
# decoder's floor on procedural renders (default_rng(4243)) is numpy and
# must read 0.077 as in artifacts/toyv2_q90/freetext_eval.json; the 1-take
# mean must stay at or below 0.40 (an untrained model reads near 1)
LER_TEXTS, LER_SEEDS = 16, (0, 1, 2, 3)
LER_FLOOR = 0.077
LER_CEILING = 0.40
# the training loop's phases: a test split of N_LOOP_TEST (one test batch
# at the shipped test_batch_size); a cache cap above the ~15 MB that the
# train and dev splits take on the card; the cache's losses against the
# uncached run's, and a resumed run's dev losses against an uninterrupted
# one's, within TOL_CACHE_REL (3 steps) and TOL_RESUME_REL (9 steps)
# relative: the same ops on the same inputs, so exact unless a library
# reduction's order changes between runs (cuDNN may pick an algorithm that
# sums with atomics); a changed order flips bf16 roundings of 2^-8, which
# Adam carries into the next steps
N_LOOP_TEST = 8
LOOP_CACHE_MB = 64
TOL_CACHE_REL = 1e-3
TOL_RESUME_REL = 1e-2
# SIGTERM: 4 train batches of 32, so that epoch 2 has steps after the one
# whose line triggers the signal; the child is killed after this long
N_SIGTERM_TRAIN = 128
SIGTERM_TIMEOUT_S = 400
# the graphed epoch (train.device_cache_epoch_scan with the device data
# cache): GRAPH_TRAIN train utterances of one padded shape, so 2 steps of
# 32 an epoch; the curriculum cut to r = 5 for epoch 1 and r = 2 from epoch
# 2 (GRAPH_SCHEDULE: each factor's graph captured, the first freed), the
# shipped config otherwise. The flag's per-epoch losses against the eager
# cached loop's, and a resumed epoch against the uninterrupted one, within
# TOL_GRAPH_FP32_REL at fp32 and TOL_CACHE_REL at bf16: the graph replays
# the kernels that the eager step launches, on the same inputs, with the
# same Adam (capturable on the card with the flag or without), so the two
# agree exactly where the eager step is reproducible. At bf16 it is; at
# fp32 cuDNN's default convolution algorithms are not (176 of the 487
# gradient leaves differ between two eager steps from one state, PERF.md
# §6, scripts/torch_graph_step_determinism.py), and Adam carries such a
# difference over the steps to 1e-3 of the length losses: the fp32 runs
# take cuDNN's deterministic algorithms (cudnn.deterministic, restored
# after them), under which one eager and one graphed step agree to the
# bit. At fp32 the phase also trains as users do, with cuDNN's default
# algorithms, two epochs three times: the flag on, and off twice. The two
# eager runs witness how far eager drifts from eager there (printed), and
# the graphed run is held to the first eager one within
# TOL_GRAPH_FP32_DEFAULT_REL: ten times the 1.0e-3 that a graphed run read
# against an eager one over three epochs at these settings, and 16 times
# the 6.4e-4 that two eager runs read apart over these two (PERF.md §6),
# wide enough for that drift, and a bound still on a graph that replayed
# the wrong batch, factor or weights. GRAPH_REPS timed epochs each way, at
# the default settings.
GRAPH_TRAIN, GRAPH_REPS = 64, 2
GRAPH_SCHEDULE = ["train.reduction_factors=(5,2)", "train.reduce_interval=(0,2)"]
# train.remat inside the graphed epoch: per dtype, the modes run 2 epochs
# with the flag against 2 without it (both under the same remat; fp32 under
# deterministic cuDNN), losses and epoch-2 weights equal to the bit, the
# captured step launching the forward kernel twice for each attention; then
# GRAPH_REMAT_REPS epochs each way from the trained state (one: an eager
# remat epoch takes 1-3 s of host time)
GRAPH_REMAT_MODES = {"float32": ("on",), "bfloat16": ("on", "dots")}
GRAPH_REMAT_REPS = 1
TOL_GRAPH_FP32_REL = 1e-5
TOL_GRAPH_FP32_DEFAULT_REL = 1e-2
# remat and batched_lu: timed steps per mode; the prior's log-probability
# with one batched LU against per-layer slogdet and inverse, fp32, relative
REMAT_REPS = 5
TOL_LU_REL = 1e-5
# the neural vocoder: toy-v2 utterances and steps of each training run, the
# last logged loss at most VOC_LOSS_DROP of the first (the PERF.md
# prediction), and the fp32 forward on the card against the CPU's over the
# first VOC_CARD_CPU_FRAMES frames of the shipped lines' mels: the head's
# raw output (log magnitude, re, im) within TOL_VOC_CARD_CPU of its largest
# element (fp32 convolutions and GEMMs summed in another order; TF32 is
# off), and the frame math and iSTFT run on the card from the CPU head's
# output within it of the CPU's. The frames and wavs of the card's own head
# are printed, not gated: a frame is mag * (re, im) / |(re, im)|, whose
# direction turns with any rounding where |(re, im)| is near 0
# (vocoder_card_cpu_shares)
VOC_UTTS, VOC_STEPS, VOC_LOG_EVERY = 32, 300, 50
VOC_LOSS_DROP = 0.9
VOC_CARD_CPU_FRAMES = 480
TOL_VOC_CARD_CPU = 1e-4
# multi-process data parallelism: two processes share the one card over
# gloo (NCCL refuses two processes on one device). The fleets train the
# shipped config at full width on FLEET_SHARDS train shards of
# FLEET_PER_SHARD utterances whose texts span two text buckets and whose
# mels span two mel buckets (so that the lockstep schedule has several
# shapes), FLEET_STEPS steps an epoch. fp32: every logged step loss and
# the epoch-1 dev losses within TOL_FLEET_REL relative of one process on
# the same global batches (the JAX package's tests/test_distributed.py
# tolerance); the sharded synthesis's fp32 mels within TOL_SHARDED_MEL of
# one process's call (the card-vs-CPU mel tolerance: rows of a batch of 2
# against a batch of 4, GEMMs that may sum in another order), its lengths
# exactly. A fleet is killed after FLEET_TIMEOUT_S.
FLEET_SHARDS, FLEET_PER_SHARD, FLEET_STEPS = 4, 40, 2
TOL_FLEET_REL = 2e-3
TOL_SHARDED_MEL = 1e-4
FLEET_TIMEOUT_S = 300
# the mesh's model axis: two processes share the card over gloo as one
# model group (data 1 x model 2). The ring (parallel/ring_attention.py) at
# the synthesis path's self-attention shapes, B 4, H 4, D 64, causal at
# 1680 and not at 3360, random lengths with item 3 of length 0 (every row
# masked), against the fp32 forward kernel on the same inputs within
# TOL_O["float32"] (its own tolerance against its plain version: the ring
# sums in another order), RING_REPS timed calls. Tensor-parallel synthesis
# with the ring (VAENAR(seq_mesh=)): fp32 within TOL_SHARDED_MEL of one
# process with equal lengths; bf16 lengths within TOL_LEN_BF16 of one bf16
# process and the mean |mel difference| over the frames both keep within
# TOL_TP_BF16_MEL (the ring and the kernel round differently: about three
# times the measured bf16-against-fp32 gap of 0.003, two bf16 runs that
# round differently each being that far from exact). The train step (fp32,
# ring_min_seq 0, batch 32, r = 2, dropout on from one generator seed):
# the losses within TOL_TP_LOSS_REL relative and every gradient element
# within TOL_TP_GRAD (atol, rtol) of one process's, and the two processes'
# gradients within it of each other: the JAX package's tolerance for its
# ring step (tests/test_parallel.py:117-119). Not relative to a leaf's
# largest gradient: at the shipped weights some leaves' gradients are
# 1e-14-1e-9 of the largest, rounding noise that moves by 1-5 % of the leaf
# between the attention kernels and their plain versions in one process on
# the card (PERF.md §6). Then TP_BF16_STEPS bf16 steps with finite
# losses.
# traces of one backward taken at most, where the profiler's device trace
# comes back without both marker kernels (check_backward_launches)
PROFILE_TRIES = 3
RING_CASES = (("causal_1680", 1680, True), ("self_3360", 3360, False))
RING_REPS = 5
TOL_TP_BF16_MEL = 0.01
# head widths: the kernels are compiled for D = 64 (the shipped model's 4
# heads of 64), D = 128 and D = 256, and the wide kernels take every
# multiple of 128 above 256 at run time; every other width is padded with
# zero columns to the next of those. The kernel checks run every case at
# D = 128, 256 and at WIDE_WIDTHS, these subsets at the padded widths, and
# one small case at UNCAPPED_WIDTH (the width has no cap), under the
# D = 64 tolerances; the head_widths phase runs the shipped attention
# width (256) in 2 heads (D = 128), in 1 (D = 256) and in 8 (D = 32, the
# padded route), and one head of WIDE_MODEL_DIM (D = 384, the wide
# kernels at three slices), in every stack
HEAD_STACKS = ("encoder", "decoder", "posterior", "prior")
PADDED_WIDTHS = (8, 32, 96, 160, 320)
WIDE_WIDTHS = (384, 512)
UNCAPPED_WIDTH = 1024
UNCAPPED_CASES = ("row_edges_causal_130", "large_logits_130", "split_keys_64x2100")
WIDE_MODEL_DIM = 384
PADDED_FWD_CASES = ("self_160", "causal_1680", "tile_edges_97", "row_edges_causal_130",
                    "no_key_causal_700", "large_logits_130", "split_keys_64x2100")
PADDED_BWD_CASES = ("encoder_self_32", "causal_self_240", "cross_240x32", "tile_edges_causal_97",
                    "row_edges_causal_130", "key_edges_bwd_130x81")
TOL_TP_LOSS_REL = 1e-4
TOL_TP_GRAD = (5e-5, 5e-3)
TP_BF16_STEPS = 3
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


def length_sampler(torch, device, seed, B=4):
    """``rand_len(t, low, fix=None)``: B random lengths in [low, t] on
    ``device``, drawn in turn from one generator seeded with ``seed``;
    ``fix`` = (item, length) pins one item's length."""
    rnd = torch.Generator(device="cpu").manual_seed(seed)

    def rand_len(t, low, fix=None):
        lens = torch.randint(low, t + 1, (B,), generator=rnd, dtype=torch.int32)
        if fix is not None:
            lens[fix[0]] = fix[1]
        return lens.to(device)

    return rand_len


def fixed_len(torch, device, *lens):
    """Lengths ``lens`` as int32 on ``device``."""
    return torch.tensor(lens, dtype=torch.int32, device=device)


def check_cases(torch, device):
    """(name, Tq, Tk, causal, q_len, m_len): the main path's shapes (text
    160, reduced mel 1680), a ragged pair and a Tk > 4096 case, with random
    lengths that leave rows fully masked, one case with full lengths, the
    tiles' edges, one case of large logits (LARGE_LOGIT_STD) and, last, two
    of few q-blocks and many keys."""
    rand_len = length_sampler(torch, device, 7)
    return [
        ("self_160", 160, 160, False, rand_len(160, 20, (0, 160)), rand_len(160, 20, (0, 160))),
        ("causal_1680", 1680, 1680, True, rand_len(1680, 300, (1, 700)),
         rand_len(1680, 300, (1, 700))),
        ("cross_1680x160", 1680, 160, False, rand_len(1680, 300, (2, 1680)), rand_len(160, 20)),
        ("full_lengths_160", 160, 160, True, None, None),
        ("ragged_1681x157", 1681, 157, False, rand_len(1681, 1, (0, 400)), rand_len(157, 1)),
        # Tk > 4096 (the TPU's blocked kernel); item 1 has no key at all
        ("long_1024x4104", 1024, 4104, False, rand_len(1024, 1), rand_len(4104, 4097, (1, 0))),
        # edges of the kernels' tiles: padding rows of item 0 spanning ten
        # q-blocks of 64 with Tk > 512 (the fp32 kernel's two warp groups
        # merge); an item with no key where one warp group serves; key and
        # row counts of 32 and 33 in a tile
        ("padding_blocks_700x1100", 700, 1100, False, rand_len(700, 1, (0, 60)),
         rand_len(1100, 513)),
        ("empty_memory_300x200", 300, 200, False, rand_len(300, 1), rand_len(200, 1, (2, 0))),
        ("tile_edges_97", 97, 97, True, fixed_len(torch, device, 32, 33, 97, 65),
         fixed_len(torch, device, 33, 32, 97, 64)),
        # edges of the bf16 kernel's narrowed key tiles (16, 32, 48 or 64
        # keys) and of its q-tiles: 1, 15, 16, 17, 48, 63, 64, 65 and 97
        # valid rows or keys, in one and in two warp groups (Tk > 512), and
        # an item with no key on a long causal site
        ("row_edges_97", 97, 97, False, fixed_len(torch, device, 1, 15, 16, 17),
         fixed_len(torch, device, 48, 63, 64, 65)),
        ("row_edges_causal_130", 130, 130, True, fixed_len(torch, device, 48, 63, 64, 65),
         fixed_len(torch, device, 97, 1, 17, 16)),
        ("key_edges_100x97", 100, 97, False, fixed_len(torch, device, 97, 65, 1, 100),
         fixed_len(torch, device, 1, 15, 16, 17)),
        ("key_edges_600", 600, 600, False, fixed_len(torch, device, 97, 17, 600, 15),
         fixed_len(torch, device, 63, 64, 65, 48)),
        ("no_key_causal_700", 700, 700, True, fixed_len(torch, device, 700, 650, 97, 1),
         fixed_len(torch, device, 700, 0, 97, 600)),
        # large logits (q and k scaled in check_kernels, LARGE_LOGIT_STD):
        # the 3xTF32 split's error grows with |S|; a last tile of 2 keys
        ("large_logits_130", 130, 130, False, fixed_len(torch, device, 130, 97, 64, 1),
         fixed_len(torch, device, 130, 120, 33, 130)),
        # few q-blocks and many key tiles: the fp32 forward at D >= 128 and
        # the bf16 one at D > 256 split a q-block's keys over a cluster of 4
        # (2 when causal) blocks; an item with no key, a rank left without a
        # tile
        ("split_keys_64x2100", 64, 2100, False, fixed_len(torch, device, 64, 40, 1, 64),
         fixed_len(torch, device, 2100, 1500, 2100, 0)),
        ("split_keys_causal_128x1100", 128, 1100, True, fixed_len(torch, device, 128, 100, 65, 128),
         fixed_len(torch, device, 1100, 64, 1100, 30)),
    ]


def kernel_key(fa, kind, dtype, D=64):
    """fa.kernel_name of ``kind`` at head width D; at D = 64 without the
    width argument, so that scripts/torch_attention_sites.py can time a
    tree from before the kernels took other widths with these helpers."""
    return fa.kernel_name(kind, dtype) if D == 64 else fa.kernel_name(kind, dtype, D)


def is_native(fa, D):
    """Whether a kernel runs at head width D itself, unpadded (a tree from
    before the wide kernels, timed by scripts/torch_attention_sites.py, has
    no ``fa.is_native_width``)."""
    native = getattr(fa, "is_native_width", None)
    return native(D) if native else D in fa.KERNEL_HEAD_DIMS


def check_kernels(torch, fa, device, D=64, names=None):
    """Forward kernel against plain version, fp32 (masked_attention_fwd) and
    bf16 (masked_attention_fwd_tc), at head width D (128, 256 or a multiple
    of 128 above: the kernel of that width; a width that is not native goes
    through the wrapper's zero padding to the kernel of fa.kernel_width(D)), on the
    check_cases named in ``names`` (all when None), at scale D^-1/2;
    returns {kernel: {dtype: largest |o| error}} and {kernel: {key: the
    worst share of the o tolerance}}, key ``max_share_of_tol`` at a native
    width and ``max_share_of_tol_padded`` at a padded one."""
    worst, worst_share = {}, {}
    key = "max_share_of_tol" if is_native(fa, D) else "max_share_of_tol_padded"
    scale = D ** -0.5
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        kernel = kernel_key(fa, "fwd", dtype, D)
        for i, (name, tq, tk, causal, ql, ml) in enumerate(check_cases(torch, device)):
            if names is not None and name not in names:
                continue
            q, k, v = random_qkv(torch, device, dtype, 4, 4, tq, tk, D, seed=i)
            if name in LARGE_LOGIT_STD:
                gain = LARGE_LOGIT_STD[name] ** 0.5
                q, k = q * gain, k * gain
            fa.launch_counts.clear()
            o, m, s = fa.masked_flash_attention(q, k, v, ql, ml, scale, causal)
            check(dict(fa.launch_counts) == {kernel: 1}, f"{name}/{dtype_name}/D={D}: launched "
                  f"{dict(fa.launch_counts)}, expected {kernel}")
            check(o.shape == q.shape, f"{name}/{dtype_name}/D={D}: o {tuple(o.shape)}")
            o_ref, m_ref, s_ref = fa.masked_attention_reference(q, k, v, ql, ml, scale, causal)
            torch.cuda.synchronize()
            atol, rtol = TOL_O[dtype_name]
            diff_o = (o.float() - o_ref.float()).abs()
            err_o = diff_o.max().item()
            tol_share_o = (diff_o / (atol + rtol * o_ref.float().abs())).max().item()
            err_m = (m - m_ref).abs().max().item()
            err_s = ((s - s_ref).abs() / s_ref).max().item()
            masked_rows = 0 if ql is None else int((tq - ql.clamp(max=tq)).sum().item())
            print(json.dumps({"check": name, "dtype": dtype_name, "kernel": kernel,
                              "head_dim": D, "max_abs_err_o": err_o,
                              "max_share_of_tol_o": tol_share_o,
                              "max_abs_err_m": err_m, "max_rel_err_s": err_s,
                              "fully_masked_rows_per_head": masked_rows}), flush=True)
            tag = f"{name}/{dtype_name}/D={D}"
            check(torch.isfinite(o.float()).all().item(), f"{tag}: non-finite o")
            check(tol_share_o <= 1.0, f"{tag}: |o| error {err_o} "
                  f"({tol_share_o} of atol {atol} + rtol {rtol} * |o|)")
            check(err_m <= TOL_M, f"{tag}: |m| error {err_m}")
            check(err_s <= TOL_S_REL, f"{tag}: s rel error {err_s}")
            by_dtype = worst.setdefault(kernel, {})
            by_dtype[dtype_name] = max(by_dtype.get(dtype_name, 0.0), err_o)
            by_key = worst_share.setdefault(kernel, {})
            by_key[key] = max(by_key.get(key, 0.0), tol_share_o)
    return worst, worst_share


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
    """Device milliseconds per call of ``fn``: CUDA events around ``reps``
    calls, queued behind a ~50 ms sleep kernel so that the host has queued
    them all before the first runs, and host time (Python, checks, launch)
    does not count."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def forward_bound(torch, tq, tk, causal, ql, ml, B, dtype_name, H=4, D=64):
    """(flop_ms, byte_ms, gflop, mbytes) of ``attention_work`` at the
    dtype's element size and peak: the bound is the larger of the two ms."""
    flops, e_in, e_out, other_bytes = attention_work(torch, tq, tk, causal, ql, ml, D, B, H)
    n_bytes = (e_in + e_out) * ELEMENT_BYTES[dtype_name] + other_bytes
    return (1e3 * flops / PEAK_FLOPS[dtype_name], 1e3 * n_bytes / PEAK_BYTES,
            flops / 1e9, n_bytes / 1e6)


def bound_flop_ms(kernel, flop_ms, tf32x3):
    """The operations' ms that bound ``kernel``: at PEAK_3XTF32
    (``tf32x3["flop_ms_3xtf32"]``) for the 3xTF32 kernels, else the SIMT or
    bf16 ``flop_ms``."""
    return tf32x3["flop_ms_3xtf32"] if kernel in TF32X3_KERNELS else flop_ms


def bound_by(kernel, t, prefix=""):
    """"operations" or "bytes": which of ``t``'s summed operation and byte
    times (keys after ``prefix``) bounds ``kernel``."""
    flops = t[f"{prefix}flop_ms_3xtf32"] if kernel in TF32X3_KERNELS else t[f"{prefix}flop_ms"]
    return "operations" if flops >= t[f"{prefix}byte_ms"] else "bytes"


def sdpa_backend(torch, q, k, v, mask, scale):
    """The backend (a ``torch.nn.attention.SDPBackend`` name) that torch's
    dispatcher picks for scaled_dot_product_attention on these inputs, or
    None where this torch does not say."""
    try:
        from torch.nn.attention import SDPBackend
        return SDPBackend(torch._fused_sdp_choice(q, k, v, mask, 0.0, False, scale=scale)).name
    except (AttributeError, ImportError, RuntimeError, TypeError, ValueError):
        return None


def time_kernels(torch, fa, device, sites, dtype_name, H=4, D=64):
    """Kernel, plain and SDPA times and the bound at each attention site of
    the main path, with the main path's lengths, in ``dtype_name``, at H
    heads of width D (the shipped model: 4 of 64); returns the sums over one
    synthesis call. ``sites``: (name, calls, Tq, Tk, causal, q_len,
    m_len)."""
    import torch.nn.functional as F
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
              "flop_ms": 0.0, "byte_ms": 0.0}
    if dtype_name == "float32":
        totals["flop_ms_3xtf32"] = 0.0
    dtype = getattr(torch, dtype_name)
    kernel = kernel_key(fa, "fwd", dtype, D)
    for i, (name, calls, tq, tk, causal, ql, ml) in enumerate(sites):
        q, k, v = random_qkv(torch, device, dtype, len(ql), H, tq, tk, D, seed=100 + i)
        mask = fa.attention_mask(ql, ml, len(ql), tq, tk, causal, device)
        scale = D ** -0.5
        ms = time_ms(torch, lambda: fa.masked_flash_attention(q, k, v, ql, ml, scale, causal))
        plain_ms = time_ms(torch, lambda: fa.masked_attention_reference(q, k, v, ql, ml, scale, causal))
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale))
        flop_ms, byte_ms, gflop, mbytes = forward_bound(torch, tq, tk, causal, ql, ml, len(ql),
                                                        dtype_name, H, D)
        tf32x3 = {"flop_ms_3xtf32": 1e12 * gflop / PEAK_3XTF32} if dtype_name == "float32" else {}
        row = {"site": name, "dtype": dtype_name, "kernel": kernel,
               "shape": [len(ql), H, tq, tk, D], "causal": causal,
               "calls_per_synthesis": calls, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "library_backend": sdpa_backend(torch, q, k, v, mask, scale),
               "bound_ms": max(bound_flop_ms(kernel, flop_ms, tf32x3), byte_ms),
               "flop_ms": flop_ms, **tf32x3, "byte_ms": byte_ms, "gflop": gflop,
               "mbytes": mbytes, "tflops_achieved": gflop / ms}
        print(json.dumps(row), flush=True)
        for key in totals:
            totals[key] += calls * row[key]
    return totals


def synthesis_sites(torch, hp, token_ids, mel_lengths, max_mel, device):
    """(name, calls per synthesis call, Tq, Tk, causal, q_len, m_len) of the
    synthesis path's attention sites: the encoder's self-attention, and the
    causal self- and the cross-attention of the flow's couplings and of the
    decoder, at the reduced lengths of ``mel_lengths`` (predicted mel
    frames) in a mel bucket of ``max_mel`` frames."""
    r = hp.common.final_reduction_factor
    text_max = -(-max(map(len, token_ids)) // hp.dataset.text_bucket) * hp.dataset.text_bucket
    text_lens = torch.tensor([len(t) for t in token_ids], dtype=torch.int32, device=device)
    z_lens = ((mel_lengths + r - 1) // r).to(device=device, dtype=torch.int32)
    z_max = max_mel // r
    calls = hp.prior.n_blk * hp.prior.n_transformer_blk + hp.decoder.nblk
    return [("encoder_self", hp.encoder.n_blk, text_max, text_max, False, text_lens, text_lens),
            ("causal_self", calls, z_max, z_max, True, z_lens, z_lens),
            ("cross", calls, z_max, text_max, False, z_lens, text_lens)]


def train_sites(torch, hp, big, device):
    """The same for a train step at r = 2 on the loader batch ``big``: the
    encoder's self-attention and the causal self- and cross-attention of
    every CrossAttentionBlock (posterior, decoder, prior couplings)."""
    text_lens = torch.from_numpy(big.text_lengths).to(device=device, dtype=torch.int32)
    z_lens = ((torch.from_numpy(big.mel_lengths).to(device) + 1) // 2).to(torch.int32)
    tmax, zmax = big.texts.shape[1], big.mels.shape[1] // 2
    blocks = hp.posterior.nblk + hp.decoder.nblk + hp.prior.n_blk * hp.prior.n_transformer_blk
    return [("encoder_self", hp.encoder.n_blk, tmax, tmax, False, text_lens, text_lens),
            ("causal_self", blocks, zmax, zmax, True, z_lens, z_lens),
            ("cross", blocks, zmax, tmax, False, z_lens, text_lens)]


def backward_cases(torch, device):
    """(name, Tq, Tk, causal, q_len, m_len) of the backward checks: the
    training sites at r = 2 (text 32, reduced mel 240) with ragged lengths
    that leave rows fully masked, an item with no key, a ragged pair, a
    long causal site, and the sites at r = 5 (reduced mel 96), the shapes of
    the training path's run through cli.train."""
    rand_len = length_sampler(torch, device, 11)
    return [
        ("encoder_self_32", 32, 32, False, rand_len(32, 12, (0, 32)), rand_len(32, 12, (0, 32))),
        ("causal_self_240", 240, 240, True, rand_len(240, 60, (1, 240)), rand_len(240, 60, (1, 240))),
        ("cross_240x32", 240, 32, False, rand_len(240, 60), rand_len(32, 12)),
        ("empty_memory_240x32", 240, 32, False, rand_len(240, 60), rand_len(32, 12, (2, 0))),
        ("ragged_241x33", 241, 33, False, rand_len(241, 1, (0, 241)), rand_len(33, 1)),
        ("causal_self_1680", 1680, 1680, True, rand_len(1680, 300, (3, 1680)),
         rand_len(1680, 300)),
        ("causal_self_96", 96, 96, True, rand_len(96, 24, (0, 96)), rand_len(96, 24, (0, 96))),
        ("cross_96x32", 96, 32, False, rand_len(96, 24), rand_len(32, 12)),
        # edges of the dK/dV kernels' tiles: blocks with 31, 32 and 33 keys
        # below m_len and q-tiles with 1, 32, 33 and 64 valid rows, at Tk = 32
        # and 33, and an item with no key
        ("tile_edges_100x32", 100, 32, False, fixed_len(torch, device, 32, 33, 100, 1),
         fixed_len(torch, device, 32, 31, 1, 32)),
        ("tile_edges_100x33", 100, 33, False, fixed_len(torch, device, 32, 33, 100, 70),
         fixed_len(torch, device, 33, 32, 1, 0)),
        ("tile_edges_causal_97", 97, 97, True, fixed_len(torch, device, 32, 33, 97, 65),
         fixed_len(torch, device, 33, 32, 97, 64)),
        # edges of the bf16 dK/dV kernel's narrowed q-tiles (16, 32, 48 or 64
        # rows): 1, 15, 16, 17, 48, 63, 64, 65 and 97 valid rows, key counts
        # at the same edges, and an item with no key
        ("row_edges_130x97", 130, 97, False, fixed_len(torch, device, 1, 15, 16, 17),
         fixed_len(torch, device, 97, 48, 63, 64)),
        ("row_edges_causal_130", 130, 130, True, fixed_len(torch, device, 48, 63, 64, 65),
         fixed_len(torch, device, 130, 97, 17, 1)),
        ("row_edges_97x130", 97, 130, False, fixed_len(torch, device, 97, 65, 63, 48),
         fixed_len(torch, device, 65, 0, 16, 15)),
        # edges of the bf16 dQ kernel's narrowed key tiles (16, 32, 48 or 64
        # keys): 15, 16, 49 and 81 keys below m_len (a last tile of 17), at
        # q lengths that fill two q-tiles, one, part of one and one row
        ("key_edges_bwd_130x81", 130, 81, False, fixed_len(torch, device, 130, 64, 17, 1),
         fixed_len(torch, device, 15, 16, 49, 81)),
    ]


def check_backward(torch, fa, device, D=64, names=None):
    """dQ and dK/dV kernels against the plain backward, fp32
    (masked_attention_bwd_dq, masked_attention_bwd_dkv) and bf16
    (masked_attention_bwd_dq_tc, masked_attention_bwd_dkv_tc), at head width
    D as check_kernels takes it, on the backward_cases named in ``names``
    (all when None), and each dQ kernel of the package's
    DELTA_FORMING_KERNELS alone, dq and delta, against
    masked_attention_dq_reference (at a padded width on inputs padded as
    the wrapper pads them, dq's first D columns and delta at the true
    width, dq's padded columns zero); returns {kernel: {dtype: largest
    error}} and each kernel's worst shares of its tolerances {kernel:
    {key: share}}, keys ``max_share_of_tol`` (the gradients it wrote, and
    dq alone) and ``max_share_of_tol_delta`` (a dQ kernel that forms delta),
    each ending in ``_padded`` at a padded width."""
    worst, worst_share = {}, {}
    native = is_native(fa, D)
    suffix = "" if native else "_padded"

    def fold(kernel, kind, share):
        by_key = worst_share.setdefault(kernel, {})
        key = f"max_share_of_tol{kind}{suffix}"
        by_key[key] = max(by_key.get(key, 0.0), share)

    scale = D ** -0.5
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        atol, rtol = TOL_GRAD[dtype_name]
        kernels = {"dq": kernel_key(fa, "dq", dtype, D), "dkv": kernel_key(fa, "dkv", dtype, D)}
        for i, (name, tq, tk, causal, ql, ml) in enumerate(backward_cases(torch, device)):
            if names is not None and name not in names:
                continue
            q, k, v = random_qkv(torch, device, dtype, 4, 4, tq, tk, D, seed=200 + i)
            do = random_qkv(torch, device, dtype, 4, 4, tq, tq, D, seed=300 + i)[0]
            o, m, s = fa.masked_flash_attention(q, k, v, ql, ml, scale, causal)
            fa.launch_counts.clear()
            got = fa.masked_flash_attention_backward(q, k, v, ql, ml, o, m, s, do, scale, causal)
            check(dict(fa.launch_counts) == {kernels["dq"]: 1, kernels["dkv"]: 1},
                  f"{name}/{dtype_name}/D={D}: launched {dict(fa.launch_counts)}")
            check(all(g.shape == t.shape for g, t in zip(got, (q, k, v))),
                  f"{name}/{dtype_name}/D={D}: gradient shapes {[tuple(g.shape) for g in got]}")
            want = fa.masked_attention_backward_reference(q, k, v, ql, ml, o, m, s, do,
                                                          scale, causal)
            torch.cuda.synchronize()
            row = {"check": name, "dtype": dtype_name, "kernels": list(kernels.values()),
                   "head_dim": D, "atol": atol, "rtol": rtol,
                   "fully_masked_rows": int((tq - ql.clamp(max=tq)).sum().item())
                   + tq * int((ml == 0).sum().item())}
            for g_name, a, b in zip(("dq", "dk", "dv"), got, want):
                diff = (a.float() - b.float()).abs()
                share = (diff / (atol + rtol * b.float().abs())).max().item()
                row[f"max_abs_err_{g_name}"] = diff.max().item()
                row[f"max_share_of_tol_{g_name}"] = share
                check(torch.isfinite(a.float()).all().item(),
                      f"{name}/{dtype_name}/D={D}: non-finite {g_name}")
                check(share <= 1.0, f"{name}/{dtype_name}/D={D}: {g_name} error "
                      f"{diff.max().item()} ({share} of atol {atol} + rtol {rtol} * |g|)")
                kern = "dq" if g_name == "dq" else "dkv"
                by_dtype = worst.setdefault(kernels[kern], {})
                by_dtype[dtype_name] = max(by_dtype.get(dtype_name, 0.0), diff.max().item())
                fold(kernels[kern], "", share)
            if kernels["dq"] in fa.DELTA_FORMING_KERNELS:
                # the dQ kernel alone, into a delta of NaNs: every element
                # must be written, zeros on the rows without a key; a padded
                # width launches on zero columns, as the wrapper does
                padded = (q, k, v, do, o) if native else fa.pad_head_width(
                    fa.kernel_width(D), q, k, v, do, o)
                delta = torch.full_like(m, float("nan"))
                dq_full = torch.empty_like(padded[0])
                fa.launch_backward_kernel("dq", *padded[:4], ql, ml, m, s, delta, (dq_full,),
                                          scale, causal, o=padded[4])
                dq = dq_full[..., :D]
                dq_want, delta_want = fa.masked_attention_dq_reference(
                    q, k, v, do, o, ql, ml, m, s, scale, causal)
                torch.cuda.synchronize()
                check(bool((dq_full[..., D:] == 0).all()),
                      f"{name}/{dtype_name}/D={D}: dq alone, a padded column is not zero")
                diff = (dq.float() - dq_want.float()).abs()
                share = (diff / (atol + rtol * dq_want.float().abs())).max().item()
                row["max_share_of_tol_dq_alone"] = share
                check(share <= 1.0, f"{name}/{dtype_name}/D={D}: dq alone, {share} of the "
                      f"tolerance")
                fold(kernels["dq"], "", share)
                diff = (delta - delta_want).abs()
                share = (diff / (TOL_DELTA[0] + TOL_DELTA[1] * delta_want.abs())).max().item()
                row.update({"max_abs_err_delta": diff.max().item(),
                            "max_share_of_tol_delta": share,
                            "delta_tol": list(TOL_DELTA)})
                check(share <= 1.0, f"{name}/{dtype_name}/D={D}: delta error "
                      f"{diff.max().item()} ({share} of atol {TOL_DELTA[0]} + rtol "
                      f"{TOL_DELTA[1]} * |delta|)")
                fold(kernels["dq"], "_delta", share)
            print(json.dumps(row), flush=True)
    return worst, worst_share


def check_backward_launches(torch, fa, device):
    """The kernels that one backward runs on the card, at the train step's
    causal site (r = 2, batch 4), in each dtype, by torch.profiler: the
    dtype's dQ and dK/dV kernel once each and nothing else (no delta pass).

    The profiler's device trace can come back empty (it did once on an
    H100 under torch 2.11, for a backward that ran), or without the first
    kernels of the session (a trace of the fp32 backward held its dK/dV
    kernel and not the dQ kernel launched just before it). So a marker
    kernel (bitwise_not, which no backward runs) is launched on the same
    stream before the backward and again after it: a trace that holds both
    has recorded every kernel between them and is held to the check; one
    without both traced nothing trustworthy and is taken again, at most
    PROFILE_TRIES times in all. Returns {dtype: {"kernels": [[kernel,
    launches], ...], "traces": n}}."""
    from torch.profiler import ProfilerActivity, profile
    ql = length_sampler(torch, device, 13)(240, 60, (0, 240))
    marker = torch.zeros(1, dtype=torch.int32, device=device)
    found = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        q, k, v = random_qkv(torch, device, dtype, 4, 4, 240, 240, 64, seed=600)
        do = random_qkv(torch, device, dtype, 4, 4, 240, 240, 64, seed=601)[0]
        o, m, s = fa.masked_flash_attention(q, k, v, ql, ql, 0.125, True)
        torch.cuda.synchronize()
        for traces in range(1, PROFILE_TRIES + 1):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                torch.bitwise_not(marker)
                torch.cuda.synchronize()
                fa.masked_flash_attention_backward(q, k, v, ql, ql, o, m, s, do, 0.125, True)
                torch.bitwise_not(marker)
                torch.cuda.synchronize()
            device_rows = [[e.key, e.count] for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA
                           and e.self_device_time_total > 0 and not e.is_user_annotation]
            marked = [n for key, n in device_rows if "bitwise_not" in key]
            if marked == [2]:
                break
            print(json.dumps({"backward_trace_without_marker": dtype_name, "trace": traces,
                              "device_rows": device_rows}), flush=True)
        check(marked == [2], f"{dtype_name}: the profiler traced the two marker kernels in "
              f"none of {PROFILE_TRIES} tries ({device_rows}): it records no whole trace here")
        ran = sorted(row for row in device_rows if "bitwise_not" not in row[0])
        found[dtype_name] = {"kernels": ran, "traces": traces}
        want = [f"{fa.kernel_name(kind, dtype)}_kernel" for kind in ("dq", "dkv")]
        check(len(ran) == 2 and all(n == 1 for _, n in ran)
              and all(any(w in key for key, _ in ran) for w in want),
              f"a {dtype_name} backward ran {ran} on the card, expected {want} once each")
    return found


def backward_work(torch, tq, tk, causal, ql, ml, D, B, H, dq_forms_delta):
    """{"dq": (flops, elements, fp32 elements), "dkv": (...)} that these
    lengths need; elements are of q, k, v, dO, O and the gradients (the
    dtype's size), fp32 elements of m, s and delta. A row below q_len of an
    item with a key is valid; an unmasked (row, key) pair of valid rows
    costs 2*D per product: dQ needs q.k, dO.v and dS.k (6*D), dK/dV needs
    q.k, dO.v, P.dO and dS.q (8*D). The other rows are uniform over the Tk
    keys: dK/dV sums their dO / s (D a row) and adds the sum to every dV row
    (D a key). Elements read once: q and dO of the valid rows, the k and v
    rows they see, their m, s and delta, and for dK/dV the dO and s of the
    uniform rows; written: dq, or dk and dv, whole. Where the dQ kernel
    forms delta (``dq_forms_delta``: it is one of the port's
    ``DELTA_FORMING_KERNELS``), it reads O of the valid rows in place of
    their delta (2*D operations a row) and writes delta whole."""
    ql = torch.full((B,), tq) if ql is None else ql.cpu().clamp(0, tq)
    ml = torch.full((B,), tk) if ml is None else ml.cpu().clamp(0, tk)
    dq_flops = dkv_flops = dq_in = dkv_in = dq_stats = dkv_stats = 0
    for b in range(B):
        mn = int(ml[b])
        qn = int(ql[b]) if mn > 0 else 0
        if causal:
            pairs = sum(min(mn, r + 1) for r in range(qn))
            kn = min(mn, qn)
        else:
            pairs, kn = qn * mn, (mn if qn else 0)
        pad = tq - qn
        dq_flops += H * 6 * D * pairs
        dkv_flops += H * (8 * D * pairs + D * pad + (D * tk if pad else 0))
        dq_in += H * (2 * qn * D + 2 * kn * D)
        dkv_in += H * (2 * qn * D + 2 * kn * D + pad * D)
        dq_stats += H * (2 * qn + tq if dq_forms_delta else 3 * qn)
        dkv_stats += H * (3 * qn + pad)
        if dq_forms_delta:
            dq_flops += H * 2 * D * qn
            dq_in += H * qn * D
    return {"dq": (dq_flops, dq_in + B * H * tq * D, dq_stats),
            "dkv": (dkv_flops, dkv_in + 2 * B * H * tk * D, dkv_stats)}


def time_backward(torch, fa, device, sites, dtype_name, H=4, D=64):
    """Per attention site of a train step, in ``dtype_name``: the forward
    kernel, the dQ and the dK/dV kernel each alone and back to back (the
    pair, as a backward launches them), the whole plain backward
    and scaled_dot_product_attention's backward with a boolean mask (times
    for one call), each kernel's bound, and a separate delta pass
    (``attention_delta``, the pass that a dQ kernel of the package's
    DELTA_FORMING_KERNELS makes needless; a tree whose dQ kernel forms no
    delta runs it before that kernel); returns the sums over one train
    step, at H heads of width D as time_kernels takes them. ``sites``:
    (name, calls, Tq, Tk, causal, q_len, m_len)."""
    import torch.nn.functional as F
    totals = {k: 0.0 for k in ("fwd_ms", "dq_ms", "dkv_ms", "pair_ms", "delta_pass_ms",
                               "plain_ms", "library_ms", "fwd_plain_ms", "fwd_library_ms", "fwd_bound_ms",
                               "fwd_flop_ms", "fwd_byte_ms",
                               "dq_bound_ms", "dkv_bound_ms", "dq_flop_ms", "dq_byte_ms",
                               "dkv_flop_ms", "dkv_byte_ms")}
    if dtype_name == "float32":
        totals["fwd_flop_ms_3xtf32"] = 0.0
    dtype = getattr(torch, dtype_name)
    fwd_kernel = kernel_key(fa, "fwd", dtype, D)
    atol, rtol = TOL_GRAD[dtype_name]
    for i, (name, calls, tq, tk, causal, ql, ml) in enumerate(sites):
        B = len(ql)
        q, k, v = random_qkv(torch, device, dtype, B, H, tq, tk, D, seed=400 + i)
        do = random_qkv(torch, device, dtype, B, H, tq, tq, D, seed=500 + i)[0]
        scale = D ** -0.5
        o, m, s = fa.masked_flash_attention(q, k, v, ql, ml, scale, causal)
        # a dQ kernel that forms delta overwrites this one with its own (the
        # same values on the rows the dK/dV kernel reads)
        delta = fa.attention_delta(o, do).contiguous()

        # one kernel alone takes a native width: others pad as the wrapper does
        native = (q, k, v, do, o) if is_native(fa, D) else fa.pad_head_width(
            fa.kernel_width(D), q, k, v, do, o)
        outs_native = {"dq": (torch.empty_like(native[0]),),
                       "dkv": (torch.empty_like(native[1]), torch.empty_like(native[2]))}

        def launch(kernel):
            reads_o = kernel_key(fa, kernel, dtype, D) in fa.DELTA_FORMING_KERNELS
            fa.launch_backward_kernel(kernel, *native[:4], ql, ml, m, s, delta,
                                      outs_native[kernel], scale, causal,
                                      o=native[4] if reads_o else None)

        mask = fa.attention_mask(ql, ml, B, tq, tk, causal, device)
        fwd_flop_ms, fwd_byte_ms, fwd_gflop, _ = forward_bound(torch, tq, tk, causal, ql, ml, B,
                                                               dtype_name, H, D)
        tf32x3 = ({"flop_ms_3xtf32": 1e12 * fwd_gflop / PEAK_3XTF32}
                  if dtype_name == "float32" else {})
        row = {"site": name, "dtype": dtype_name, "shape": [B, H, tq, tk, D], "causal": causal,
               "kernels": [kernel_key(fa, kind, dtype, D) for kind in ("fwd", "dq", "dkv")],
               "calls_per_train_step": calls,
               "fwd_ms": time_ms(torch, lambda: fa.masked_flash_attention(
                   q, k, v, ql, ml, scale, causal)),
               "fwd_plain_ms": time_ms(torch, lambda: fa.masked_attention_reference(
                   q, k, v, ql, ml, scale, causal)),
               "fwd_library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=mask, scale=scale)),
               "fwd_flop_ms": fwd_flop_ms, "fwd_byte_ms": fwd_byte_ms,
               **{f"fwd_{k}": x for k, x in tf32x3.items()},
               "fwd_bound_ms": max(bound_flop_ms(fwd_kernel, fwd_flop_ms, tf32x3), fwd_byte_ms),
               "dq_ms": time_ms(torch, lambda: launch("dq")),
               "dkv_ms": time_ms(torch, lambda: launch("dkv")),
               "pair_ms": time_ms(torch, lambda: (launch("dq"), launch("dkv"))),
               "delta_pass_ms": time_ms(torch, lambda: fa.attention_delta(o, do)),
               "plain_ms": time_ms(torch, lambda: fa.masked_attention_backward_reference(
                   q, k, v, ql, ml, o, m, s, do, scale, causal))}
        got = fa.masked_flash_attention_backward(q, k, v, ql, ml, o, m, s, do, scale, causal)
        want = fa.masked_attention_backward_reference(q, k, v, ql, ml, o, m, s, do, scale, causal)
        for g_name, a, b in zip(("dq", "dk", "dv"), got, want):
            diff = (a.float() - b.float()).abs()
            share = (diff / (atol + rtol * b.float().abs())).max().item()
            check(share <= 1.0, f"{name}/{dtype_name}: {g_name} error at the timed shape, "
                  f"{share} of tolerance")
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, scale=scale)
        row["library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True))
        work = backward_work(torch, tq, tk, causal, ql, ml, D, B, H,
                             kernel_key(fa, "dq", dtype, D) in fa.DELTA_FORMING_KERNELS)
        for kern, (flops, elems, stats) in work.items():
            flop_ms = 1e3 * flops / PEAK_FLOPS[dtype_name]
            n_bytes = elems * ELEMENT_BYTES[dtype_name] + stats * 4 + 2 * B * 4
            byte_ms = 1e3 * n_bytes / PEAK_BYTES
            row.update({f"{kern}_flop_ms": flop_ms, f"{kern}_byte_ms": byte_ms,
                        f"{kern}_bound_ms": max(flop_ms, byte_ms), f"{kern}_gflop": flops / 1e9,
                        f"{kern}_tflops_achieved": flops / (row[f"{kern}_ms"] * 1e-3) / 1e12})
        print(json.dumps(row), flush=True)
        for key in totals:
            totals[key] += calls * row[key]
    return totals


def relu_inputs(torch, model):
    """(name, module) of each module whose output goes straight into a
    ReLU: the first dense of every FFN, both denses of a ReLU PreNet, and
    the conv (or the BatchNorm after it) of a ReLU Conv1D."""
    from vaenar_tts_torch.models.layers import FFN, Conv1D, PreNet
    for name, mod in model.named_modules():
        if isinstance(mod, FFN):
            yield f"{name}.dense1", mod.dense1
        elif isinstance(mod, PreNet) and mod.act is torch.relu:
            yield f"{name}.dense_1", mod.dense_1
            yield f"{name}.dense_2", mod.dense_2
        elif isinstance(mod, Conv1D) and mod.act is torch.relu:
            yield ((f"{name}.batch_norm", mod.batch_norm) if mod.bn_before_act
                   else (f"{name}.conv1d", mod.conv1d))


def relu_sign_hooks(torch, model, signs, ties=None):
    """Forward hooks on every ReLU input of ``model``; returns the handles.
    With ``ties`` None, each call's sign pattern (input > 0) is recorded in
    ``signs[name]``. Otherwise each call takes the pattern that ``signs``
    recorded (another run's): an input on the other side of 0 is replaced
    by its mirror image (gradient passing as through the input), and
    (name, count, largest such |input| over the input's RMS) goes into
    ``ties``."""
    handles = []
    for name, mod in relu_inputs(torch, model):
        replay = None if ties is None else iter(signs[name])

        def hook(module, args, out, name=name, replay=replay):
            x = out.detach()
            if replay is None:
                signs.setdefault(name, []).append((x > 0).cpu())
                return None
            want = next(replay).to(x.device)
            flip = (x > 0) != want
            if not bool(flip.any()):
                return None
            ties.append((name, int(flip.sum()),
                         (x[flip].abs().max() / x.pow(2).mean().sqrt()).item()))
            mirror = torch.where(want, x.abs().clamp_min(torch.finfo(x.dtype).tiny), -x.abs())
            return out + (torch.where(flip, mirror, x) - x)

        handles.append(mod.register_forward_hook(hook))
    return handles


def bn_fed_conv_biases(torch, model):
    """{bias name: weight name} of each conv whose output goes straight into
    BatchNorm (BatchNorm before the activation, or no activation)."""
    from vaenar_tts_torch.models.layers import Conv1D, get_activation
    linear = (get_activation("identity"), get_activation(None))
    return {f"{name}.conv1d.bias": f"{name}.conv1d.weight"
            for name, mod in model.named_modules()
            if isinstance(mod, Conv1D) and (mod.bn_before_act or mod.act in linear)}


def write_records(data_dir, seed, splits=(("train", N_TRAIN), ("dev", N_DEV))):
    """Utterances from a seed, in the toy-v2 corpus's ranges, as shards of
    the port's record format: ``splits`` (mode, count), by default 64 train
    and 32 dev."""
    import numpy as np
    from vaenar_tts_torch.data.records import RecordShardWriter
    rng = np.random.default_rng(seed)
    for mode, n in splits:
        writer = RecordShardWriter(os.path.join(data_dir, f"{mode}-0.vrs"), 80)
        for i in range(n):
            text_len = int(rng.integers(12, 33))
            mel_len = min(370, int(round(9.0 * text_len * rng.uniform(0.85, 1.15))))
            writer.add(f"{mode}-{i:03d}", rng.integers(3, 43, text_len),
                       rng.uniform(0.0, 1.0, (mel_len, 80)).astype(np.float32))
        writer.close()


def audio_signals(np, sample_rate, seed, n=4):
    """``n`` float32 signals of 2-3 s from a seed: 8 harmonics of a random
    fundamental and a little noise."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = np.arange(int(sample_rate * rng.uniform(2.0, 3.0))) / sample_rate
        f0 = rng.uniform(100.0, 250.0)
        y = sum(0.3 / (k + 1) * np.sin(2 * np.pi * f0 * (k + 1) * t + rng.uniform(0, 2 * np.pi))
                for k in range(8))
        out.append((y + 0.02 * rng.standard_normal(len(t))).astype(np.float32))
    return out


def gl_reference_f64(np, window, mag, phase0, n_fft, hop, n_iters):
    """Griffin-Lim in float64 numpy with the JAX package's conventions
    (ops/griffin_lim.py): initial phase [B, bins, F], the window sum-square
    1 where below 1e-11, re-analysis of the untrimmed signal, updates over
    sqrt(|X|^2 + 1e-12); magnitudes [B, F, bins] -> [B, hop * (F - 1)]."""
    B, F, _ = mag.shape
    total = n_fft + hop * (F - 1)
    wss = np.zeros(total)
    for f in range(F):
        wss[f * hop:f * hop + n_fft] += window ** 2
    wss[wss < 1e-11] = 1.0
    idx = np.arange(F)[:, None] * hop + np.arange(n_fft)[None]

    def synth(spec):
        frames = np.fft.irfft(spec, n=n_fft, axis=-1) * window
        y = np.zeros((B, total))
        for f in range(F):
            y[:, f * hop:f * hop + n_fft] += frames[:, f]
        return y / wss

    spec = mag * np.exp(1j * np.transpose(phase0, (0, 2, 1)))
    for _ in range(n_iters):
        x = np.fft.rfft(synth(spec)[:, idx] * window, axis=-1)
        spec = mag * x / np.sqrt(np.abs(x) ** 2 + 1e-12)
    return synth(spec)[:, n_fft // 2: total - n_fft // 2]


def dft_matmul_bases(torch, np, window, device):
    """The DFT as fp32 matmuls, the form the JAX package takes for the TPU's
    matrix unit, kept here only to be timed against the port's cuFFT: the
    windowed basis [n_fft, 2 * bins] and its inverse [2 * bins, n_fft], real
    and imaginary parts interleaved."""
    n_fft = len(window)
    k = np.arange(1 + n_fft // 2)
    angle = 2.0 * np.pi * np.arange(n_fft)[:, None] * k[None, :] / n_fft
    fwd = np.stack([np.cos(angle), -np.sin(angle)], -1) * window[:, None, None]
    weight = np.where((k == 0) | (k == n_fft // 2), 1.0, 2.0) / n_fft
    inv = (np.stack([np.cos(angle.T), -np.sin(angle.T)], 1) * weight[:, None, None]
           * window[None, None, :])
    return (torch.tensor(fwd.reshape(n_fft, -1), dtype=torch.float32, device=device),
            torch.tensor(inv.reshape(-1, n_fft), dtype=torch.float32, device=device))


def matmul_magnitude(torch, ops_stft, y, bases, hop):
    """|STFT| [B, F, bins] of pre-padded [B, T] signals with the DFT as one
    fp32 matmul (TF32 off)."""
    fwd, _ = bases
    with ops_stft.full_fp32_matmuls():
        ri = y.unfold(-1, fwd.shape[0], hop) @ fwd
    return torch.sqrt(ri.reshape(*ri.shape[:-1], -1, 2).square().sum(-1) + 1e-30)


def matmul_mel_to_wav(torch, gl, ops_stft, mel, cfg, bases, generator):
    """``ops.griffin_lim.mel_to_wav`` with each DFT an fp32 basis matmul
    (TF32 off) in place of cuFFT, for the times only."""
    fwd, inv = bases
    n_fft, hop = cfg.n_fft, cfg.frame_shift_sample
    amp = torch.pow(10.0, (ops_stft.denormalize(mel.float(), cfg) + cfg.ref_level_db) * 0.05)
    with ops_stft.full_fp32_matmuls():
        mag = torch.clamp(amp @ ops_stft.inv_mel_basis(cfg, str(mel.device)),
                          min=1e-10) ** cfg.power
        B, F, n_bins = mag.shape
        phase0 = torch.rand((B, n_bins, F), generator=generator, device=mel.device) * (2 * math.pi)
        ri = torch.view_as_real(torch.polar(mag, phase0.transpose(1, 2)))
        wss = gl.window_sumsquare(n_fft, cfg.frame_length_sample, hop, F, str(mel.device))

        def synthesize(ri):
            return gl.overlap_add(ri.reshape(B, F, -1) @ inv, hop) / wss

        for _ in range(cfg.griffin_lim_iters):
            ri = (synthesize(ri).unfold(-1, n_fft, hop) @ fwd).reshape(B, F, n_bins, 2)
            ri = ri * (mag / torch.sqrt(ri.square().sum(-1) + 1e-12))[..., None]
        y = synthesize(ri)
    return y[:, n_fft // 2: y.shape[1] - n_fft // 2]


def spectral_convergence(np, ap, wav, target):
    """||target - |STFT(wav)||| / ||target|| over their common frames;
    ``target`` [bins, F]."""
    got = np.abs(ap._stft(np.asarray(wav, np.float64)))
    k = min(got.shape[1], target.shape[1])
    return float(np.linalg.norm(target[:, :k] - got[:, :k]) / np.linalg.norm(target[:, :k]))


def write_toy_corpus(np, wavfile, root, n, seed):
    """``n`` toy-v2 utterances from a seed in LJSpeech's layout:
    ``metadata.csv`` (fid|text|text) and 22.05 kHz int16 wavs."""
    from vaenar_tts_torch.configs.hparams import get_config
    from vaenar_tts_torch.data.toy import random_text, synthesize_utterance_v2
    hp = get_config("ljspeech")
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    lines = []
    for i in range(n):
        fid, text = f"TOY-{i:04d}", random_text(rng)
        wav = synthesize_utterance_v2(text, hp, rng)
        wavfile.write(os.path.join(root, fid + ".wav"), hp.audio.sample_rate,
                      (wav * 32767).astype(np.int16))
        lines.append(f"{fid}|{text}|{text}")
    with open(os.path.join(root, "metadata.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")


def write_databaker(np, wavfile, root, seed):
    """DATABAKER_LABELS as DataBaker's ``000001-010000.txt`` and 16 kHz
    int16 wavs of ``audio_signals`` under ``Wave/``."""
    os.makedirs(os.path.join(root, "Wave"))
    with open(os.path.join(root, "000001-010000.txt"), "w", encoding="utf-8") as f:
        for i, (hanzi, py) in enumerate(DATABAKER_LABELS):
            f.write(f"{i + 1:06d}\t{hanzi}\n\t{py}\n")
    for i, y in enumerate(audio_signals(np, 16000, seed, n=len(DATABAKER_LABELS))):
        wavfile.write(os.path.join(root, "Wave", f"{i + 1:06d}.wav"), 16000,
                      (0.9 * 32767 * y / np.abs(y).max()).astype(np.int16))


def compare_preprocessed(np, a, b):
    """Two preprocessed directories of one corpus: whether the split lists
    are equal, the largest mel difference (inf where shapes differ), the
    mels compared, and whether the shards hold the same fids and texts."""
    from vaenar_tts_torch.data.records import RecordShardReader, list_shards

    def read(d, name):
        with open(os.path.join(d, name)) as f:
            return f.read()

    splits = all(read(a, f"{m}.txt") == read(b, f"{m}.txt") for m in ("train", "dev", "test"))
    names = sorted(os.listdir(os.path.join(a, "mels")))
    err = 0.0 if names == sorted(os.listdir(os.path.join(b, "mels"))) else math.inf
    for name in names:
        x, y = (np.load(os.path.join(d, "mels", name)) for d in (a, b))
        err = max(err, float(np.abs(x - y).max()) if x.shape == y.shape else math.inf)
    shards = True
    for mode in ("train", "dev", "test"):
        pa, pb = list_shards(a, mode), list_shards(b, mode)
        shards &= [os.path.basename(p) for p in pa] == [os.path.basename(p) for p in pb]
        for x, y in zip(pa, pb):
            rx, ry = RecordShardReader(x), RecordShardReader(y)
            shards &= rx.fids == ry.fids and all(
                np.array_equal(rx.get(i).text, ry.get(i).text) for i in range(len(rx)))
    return {"splits_equal": splits, "max_abs_err_mel": err, "mels": len(names),
            "shards_equal": bool(shards)}


def counting_probe(torch, fa, probe_module, calls):
    """``probe_module.make_toy_ler_probe`` wrapped so that each probe call
    appends its epoch, seconds and kernel launches to ``calls``."""
    make = probe_module.make_toy_ler_probe

    def made(*args, **kwargs):
        probe = make(*args, **kwargs)

        def call(epoch, model):
            torch.cuda.synchronize()
            before, t = dict(fa.launch_counts), time.perf_counter()
            try:
                return probe(epoch, model)
            finally:
                torch.cuda.synchronize()
                calls.append({"epoch": epoch, "seconds": time.perf_counter() - t,
                              "launches": {k: v - before.get(k, 0)
                                           for k, v in fa.launch_counts.items()
                                           if v != before.get(k, 0)}})
        return call
    return made


def letters_ler(toy, hyp, ref):
    """The letters-only LER of scripts/freetext_toyv2_eval.py."""
    return toy.letter_error_rate(hyp.replace(" ", ""), ref.replace(" ", ""))


def run_cli(main, argv):
    """``main(argv)`` with its standard output caught and printed again:
    (its return value, that output)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    print(buf.getvalue(), end="", flush=True)
    return result, buf.getvalue()


def chosen_takes(text):
    """The chosen takes that the free-text CLI printed, in line order."""
    import re
    return [int(x) for m in re.finditer(r"chosen takes \[([0-9, ]*)\]", text)
            for x in m.group(1).split(",") if x.strip()]


def check_audio(torch, np, device, cfg, mels0, lens0):
    """The audio phases: the mel frontend at ``cfg`` against the numpy DSP,
    and Griffin-Lim (4 iterations against fp64 numpy, 60 against gl_core's
    convergence, ``mel_to_wav`` of the synthesized batch ``mels0``, and the
    device streaming backend against the host one on its first utterance);
    returns the AudioProcessor and that utterance's mel."""
    from vaenar_tts_torch.audio.dsp import AudioProcessor
    from vaenar_tts_torch.audio.streaming import StreamingVocoder
    from vaenar_tts_torch.data.corpus import pad_ragged
    from vaenar_tts_torch.ops import griffin_lim as gl
    from vaenar_tts_torch.ops import stft as ops_stft
    # the mel frontend at the shipped audio config against the numpy DSP
    phase("audio_frontend")
    ap = AudioProcessor(cfg)
    n_fft, hop, win = cfg.n_fft, cfg.frame_shift_sample, cfg.frame_length_sample
    ys = audio_signals(np, cfg.sample_rate, seed=77)
    frames = [1 + len(y) // hop for y in ys]
    padded = torch.from_numpy(pad_ragged(ys, n_fft)).to(device)
    pre = torch.from_numpy(pad_ragged([ap.preemphasize(y).astype(np.float32) for y in ys],
                                      n_fft)).to(device)
    audio_share = {"magnitude": 0.0, "magnitude_matmul_form": 0.0, "mel": 0.0,
                   "mel_center_preemphasis": 0.0, "preemphasis": 0.0, "istft": 0.0}
    mag_dev = ops_stft.batched_stft_magnitude(padded, n_fft, hop, win, center=False)
    mags = {"fft": mag_dev.cpu().numpy(), "matmul": matmul_magnitude(
        torch, ops_stft, padded, dft_matmul_bases(torch, np, ops_stft.padded_window(
            n_fft, win, "cpu").double().numpy(), device), hop).cpu().numpy()}
    mel_dev = ops_stft.batched_melspectrogram(pre, cfg, apply_preemphasis=False,
                                              center=False).cpu().numpy()
    mel0 = ops_stft.batched_melspectrogram(torch.from_numpy(ys[0]).to(device), cfg)[0]
    spec = ops_stft.stft(padded, n_fft, hop, win)
    wss = gl.window_sumsquare(n_fft, win, hop, spec.shape[1], str(device))
    y_back = (gl.overlap_add(ops_stft.istft_frames(spec, n_fft, win), hop) / wss).cpu().numpy()
    emph = ops_stft.preemphasis(torch.from_numpy(ys[0]).to(device), cfg.preemphasize).cpu().numpy()
    audio_share["preemphasis"] = float(np.abs(emph - ap.preemphasize(ys[0])).max()
                                       / TOL_PREEMPHASIS)
    for i, y in enumerate(ys):
        ref_mag = np.abs(ap._stft(y)).T
        ref_mel = ap.melspectrogram(ap.preemphasize(y)).T
        audio_share["magnitude"] = max(audio_share["magnitude"], float(
            np.abs(mags["fft"][i, :frames[i]] - ref_mag).max() / TOL_MAG))
        audio_share["magnitude_matmul_form"] = max(audio_share["magnitude_matmul_form"], float(
            np.abs(mags["matmul"][i, :frames[i]] - ref_mag).max() / TOL_MAG))
        audio_share["mel"] = max(audio_share["mel"], float(
            np.abs(mel_dev[i, :frames[i]] - ref_mel).max() / TOL_MEL_NORM))
        if i == 0:
            audio_share["mel_center_preemphasis"] = float(
                np.abs(mel0.cpu().numpy() - ref_mel).max() / TOL_MEL_NORM)
        audio_share["istft"] = max(audio_share["istft"], float(
            np.abs(y_back[i, n_fft // 2:n_fft // 2 + len(y)] - y).max() / TOL_ISTFT))
    print(json.dumps({"signals_s": [len(y) / cfg.sample_rate for y in ys], "frames": frames,
                      "max_share_of_tol": audio_share,
                      "tolerances": {"magnitude": TOL_MAG, "mel": TOL_MEL_NORM,
                                     "preemphasis": TOL_PREEMPHASIS, "istft": TOL_ISTFT}}),
          flush=True)
    gated = {k: v for k, v in audio_share.items() if k != "magnitude_matmul_form"}
    check(max(gated.values()) <= 1.0, f"mel frontend against audio/dsp.py: {gated}")

    # Griffin-Lim on the card against the plain versions
    phase("griffin_lim")
    window = ops_stft.padded_window(n_fft, win, "cpu").double().numpy()
    mag_b = mag_dev
    phase0 = np.random.default_rng(5).uniform(0.0, 2 * np.pi, (len(ys), mag_b.shape[2],
                                                                mag_b.shape[1]))
    gl_ref = gl_reference_f64(np, window, mags["fft"].astype(np.float64), phase0, n_fft, hop, 4)
    got = gl.griffin_lim(mag_b, cfg, init_phase=torch.from_numpy(phase0).float(),
                         n_iters=4).cpu().numpy()
    gl_share = float(np.abs(got - gl_ref).max() / (TOL_GL_F64_REL * np.abs(gl_ref).max()))
    mel_one = ap.melspectrogram(ap.preemphasize(ys[0])).T.astype(np.float32)
    target = ap.mel_to_linear(ap.db_to_amp(ap.denormalize(mel_one.T) + cfg.ref_level_db)) ** cfg.power
    wav_card = gl.mel_to_wav(torch.from_numpy(mel_one)[None].to(device), cfg,
                             torch.Generator(device=device).manual_seed(0))[0].cpu().numpy()
    wav_host = ap.inv_mel_spectrogram(mel_one.T, np.random.default_rng(0))
    conv = {"card": spectral_convergence(np, ap, wav_card, target),
            "host_gl_core": spectral_convergence(np, ap, wav_host, target)}
    wavs_main = gl.mel_to_wav(mels0, cfg, torch.Generator(device=device).manual_seed(0))
    if device.type == "cuda":
        torch.cuda.synchronize()
    n_main = mels0.shape[1]
    mel_s = mels0[0, :int(lens0[0])].cpu().numpy()
    stream_wavs = {be: StreamingVocoder(ap, backend=be, device=device).synthesize(
        mel_s, np.random.default_rng(3)) for be in ("host", "device")}
    corr = float(np.corrcoef(stream_wavs["host"], stream_wavs["device"])[0, 1])
    print(json.dumps({"gl_4_iterations_share_of_tol": gl_share,
                      "spectral_convergence_60_iterations": conv,
                      "mel_to_wav_batch": {"shape": list(wavs_main.shape),
                                           "peak": wavs_main.abs().max().item()},
                      "streaming_lengths": {k: len(v) for k, v in stream_wavs.items()},
                      "streaming_correlation": corr}), flush=True)
    check(gl_share <= 1.0, f"Griffin-Lim against fp64 numpy: {gl_share}")
    check(conv["card"] <= conv["host_gl_core"] * TOL_GL_CONVERGENCE[0] + TOL_GL_CONVERGENCE[1],
          f"spectral convergence {conv}")
    check(list(wavs_main.shape) == [len(mels0), hop * (n_main - 1)]
          and bool(torch.isfinite(wavs_main).all()) and wavs_main.abs().max().item() > 1e-3,
          f"mel_to_wav of the synthesized batch: {list(wavs_main.shape)}")
    check(len(stream_wavs["host"]) == len(stream_wavs["device"]) == hop * (len(mel_s) - 1),
          f"streaming lengths {[len(v) for v in stream_wavs.values()]}")
    check(corr > TOL_STREAM_CORR, f"device streaming against host: correlation {corr}")

    return ap, mel_s


def train_step_times(torch, fa, steps, model, hp, batch, r, reps=10, warmup=2):
    """Host-clock wall times of ``reps`` train steps at reduction factor
    ``r``, each ending in synchronize, and the kernel launches per step."""
    optimizer = steps.make_optimizer(hp, model)
    gen = torch.Generator(device=batch[0].device).manual_seed(5)
    for _ in range(warmup):
        steps.train_step(model, optimizer, hp, *batch, 1e-5, r, gen)
    torch.cuda.synchronize()
    fa.launch_counts.clear()
    walls = []
    for _ in range(reps):
        t = time.perf_counter()
        steps.train_step(model, optimizer, hp, *batch, 1e-5, r, gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    return walls, {k: v / reps for k, v in fa.launch_counts.items()}


def profile_train_steps(torch, steps, model, hp, batch, r, reps=1):
    """torch.profiler over ``reps`` train steps at reduction factor ``r``:
    device time per step (the sum of the kernels' own device time; one
    stream, so kernels do not overlap), kernel launches per step, and the
    kernels that take the most, by name, per step. Host time under the
    profiler is inflated, so the busy share is taken against the wall time
    measured without it."""
    from torch.profiler import ProfilerActivity, profile
    optimizer = steps.make_optimizer(hp, model)
    gen = torch.Generator(device=batch[0].device).manual_seed(6)
    steps.train_step(model, optimizer, hp, *batch, 1e-5, r, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            steps.train_step(model, optimizer, hp, *batch, 1e-5, r, gen)
        torch.cuda.synchronize()
    # kernels only: a user annotation (such as the optimizer's step range)
    # spans the kernels inside it on the device timeline
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
               and not e.is_user_annotation]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return (sum(e.self_device_time_total for e in kernels) / 1e3 / reps,
            sum(e.count for e in kernels) / reps,
            [[e.key[:90], e.self_device_time_total / 1e3 / reps, e.count / reps]
             for e in kernels[:12]])


def preprocess_phase(torch, np, wavfile, tmp, device, smi):
    """``cli.preprocess`` on a toy-v2 corpus of N_TOY utterances
    (LJSpeech's layout) and on DATABAKER_LABELS, with the mels on
    ``device`` and on the host: the same splits, mels within
    TOL_MEL_DEVICE_HOST, the same shards, a smoke batch; and the toy
    corpus's extraction alone, timed once more on each side. Returns the
    card's toy records."""
    from vaenar_tts_torch.cli import preprocess as cli_preprocess
    from vaenar_tts_torch.configs.hparams import get_config
    from vaenar_tts_torch.data.corpus import CORPORA
    phase("toy_corpus_preprocess")
    toy_wavs = os.path.join(tmp, "toy_wavs")
    t = time.perf_counter()
    write_toy_corpus(np, wavfile, toy_wavs, N_TOY, seed=2028)
    toy_write_s = time.perf_counter() - t
    db_wavs = os.path.join(tmp, "databaker_wavs")
    write_databaker(np, wavfile, db_wavs, seed=2029)
    prep, compared = {}, {}
    for dataset, wavs in (("ljspeech", toy_wavs), ("databaker", db_wavs)):
        for where, flags in (("card", ["--device_mels", "--device", device]),
                             ("host", ["--num_workers", "0"])):
            out = os.path.join(tmp, f"{dataset}_{where}")
            t = time.perf_counter()
            _, text = run_cli(cli_preprocess.main, ["--dataset", dataset, "--data_dir", wavs,
                                                    "--save_dir", out, "--record_split", "2",
                                                    *flags])
            torch.cuda.synchronize()
            prep[f"{dataset}_{where}"] = {
                "dir": out, "cli_s": time.perf_counter() - t,
                "smoke_batch": "sample batch:" in text,
                "on_device": f"on {device}" in text if where == "card" else None}
        compared[dataset] = compare_preprocessed(np, prep[f"{dataset}_card"]["dir"],
                                                 prep[f"{dataset}_host"]["dir"])
    # the extraction alone, once more: on the card, and on host processes
    # (serial, and a pool of 8 spawned ones, which pays their start)
    extract_s = {}
    for where, workers in (("card", 0), ("host_serial", 0), ("host_pool8", 8)):
        corpus = CORPORA["ljspeech"](toy_wavs, os.path.join(tmp, f"toy_{where}_again"),
                                     get_config("ljspeech"))
        corpus._validate_dir()
        t = time.perf_counter()
        corpus.extract_mels(num_workers=workers, use_device=where == "card", device=device)
        torch.cuda.synchronize()
        extract_s[where] = time.perf_counter() - t
    print(json.dumps({"card": smi, "toy_utterances": N_TOY, "toy_write_s": toy_write_s,
                      "databaker_utterances": len(DATABAKER_LABELS),
                      "mel_extraction_s": extract_s,
                      "preprocess": {k: {kk: vv for kk, vv in v.items() if kk != "dir"}
                                     for k, v in prep.items()},
                      "card_vs_host": compared}), flush=True)
    for dataset, n in (("ljspeech", N_TOY), ("databaker", len(DATABAKER_LABELS))):
        got = compared[dataset]
        check(got["splits_equal"] and got["shards_equal"] and got["mels"] == n,
              f"{dataset}: card and host preprocessing differ: {got}")
        check(got["max_abs_err_mel"] <= TOL_MEL_DEVICE_HOST,
              f"{dataset}: card mels against host mels {got['max_abs_err_mel']}")
        check(prep[f"{dataset}_card"]["on_device"], f"{dataset}: mels not extracted on {device}")
        check(all(prep[f"{dataset}_{w}"]["smoke_batch"] for w in ("card", "host")),
              f"{dataset}: no smoke batch printed")
    return prep["ljspeech_card"]["dir"]


def probe_phase(torch, fa, tmp, records, hparams_path, device, smi, n_attn, expected_launches):
    """``cli.train`` on ``records`` at ``hparams_path`` with ``--probe
    toy_ler --probe_every 1``, 2 epochs of 2 steps: one ler_probe.jsonl line
    an epoch with a finite LER in [0, 1], 2 * n_attn forward launches inside
    each probe, ``expected_launches(dev batches)`` plus those in the run;
    then export_best.npz, loaded from a directory of its own, synthesizes a
    line. Returns (the run's launches, the synthesis's, those inside the
    probes)."""
    from vaenar_tts_torch.cli import train as cli_train
    from vaenar_tts_torch.cli.inference import encode_lines, synthesize_batch
    from vaenar_tts_torch.configs.serialize import load_hparams
    from vaenar_tts_torch.data.loader import BucketedLoader
    from vaenar_tts_torch.data.records import list_shards
    from vaenar_tts_torch.models.vaenar import load_model
    from vaenar_tts_torch.training import probe as probe_module
    phase("probe_training")
    root = os.path.join(tmp, "probe_run")
    model_dir = os.path.join(root, "ckpt")
    calls = []
    make_probe = probe_module.make_toy_ler_probe
    probe_module.make_toy_ler_probe = counting_probe(torch, fa, probe_module, calls)
    fa.launch_counts.clear()
    try:
        history = cli_train.main([
            "--dataset", "ljspeech", "--data_dir", records, "--model_dir", model_dir,
            "--log_dir", os.path.join(root, "logs"), "--hparams", hparams_path,
            "--device", device, "--max_epochs", "2", "--steps_per_epoch", "2",
            "--probe", "toy_ler", "--probe_every", "1"])
    finally:
        probe_module.make_toy_ler_probe = make_probe
    torch.cuda.synchronize()
    counts = dict(fa.launch_counts)
    rows = []
    if os.path.isfile(os.path.join(root, "ler_probe.jsonl")):
        with open(os.path.join(root, "ler_probe.jsonl")) as f:
            rows = [json.loads(line) for line in f]
    hp = load_hparams(model_dir)
    n_dev = 2 * len(BucketedLoader(list_shards(records, "dev"), hp.train.train_batch_size,
                                   hp.dataset.mel_bucket, hp.dataset.text_bucket, shuffle=False))
    in_probes = sum(c["launches"].get("masked_attention_fwd_tc", 0) for c in calls)
    expected = expected_launches(n_dev)
    expected["masked_attention_fwd_tc"] += in_probes
    check([r["epoch"] for r in rows] == [1, 2]
          and all(math.isfinite(r["probe_ler"]) and 0.0 <= r["probe_ler"] <= 1.0 for r in rows),
          f"ler_probe.jsonl: {rows}")
    check(sorted(history["probe"]) == [1, 2], "the loop recorded no probe result")
    # the best probed weights, from a directory of their own
    best_dir = os.path.join(tmp, "export_best_only")
    os.makedirs(best_dir)
    shutil.copy(os.path.join(root, "export_best.npz"), os.path.join(best_dir, "export.npz"))
    shutil.copy(os.path.join(model_dir, "hparams.json"), best_dir)
    with open(os.path.join(root, "export_best.json")) as f:
        best = json.load(f)
    hp_best, model, best_epoch = load_model(best_dir, device)
    fa.launch_counts.clear()
    mels, lens = synthesize_batch(model, hp_best, encode_lines(hp_best, LINES[:1]), 0.667, False)
    torch.cuda.synchronize()
    best_counts = dict(fa.launch_counts)
    print(json.dumps({"card": smi, "probe_rows": rows, "probe_calls": calls, "launches": counts,
                      "launches_expected": expected, "history_probe": history["probe"],
                      "export_best": best, "export_best_epoch_loaded": best_epoch,
                      "export_best_synthesis": {"mel_shape": list(mels.shape),
                                                "lengths": lens.tolist(),
                                                "launches": best_counts}}), flush=True)
    check([c["epoch"] for c in calls] == [1, 2]
          and all(c["launches"] == {"masked_attention_fwd_tc": 2 * n_attn} for c in calls),
          f"launches inside the probes: {calls}")
    check(counts == expected, f"probed training launches {counts} != {expected}")
    check(best_epoch == best["epoch"] and best_counts == {"masked_attention_fwd_tc": n_attn},
          f"export_best: epoch {best_epoch} of {best}, launches {best_counts}")
    check(bool(torch.isfinite(mels).all()), "non-finite mel from export_best.npz")
    return counts, best_counts, in_probes


def shipped_ler_phase(torch, np, fa, tmp, model_dir, hp, device, smi, n_attn):
    """The letter error rate of ``model_dir`` through the free-text CLI
    over LER_SEEDS, at 1 take (coverage) and 4 (medoid), mean length head,
    temperature 0.6, scored by the port's ToyLetterDecoder, beside the JAX
    package's figures at epoch 1700 and the decoder's floor. Returns the
    forward launches of each setting."""
    from vaenar_tts_torch.audio.dsp import AudioProcessor
    from vaenar_tts_torch.cli import inference as cli_inference
    from vaenar_tts_torch.data import toy
    phase("shipped_ler")
    text_rng = np.random.default_rng(4242)
    texts = [toy.random_text(text_rng) for _ in range(LER_TEXTS)]
    lines = os.path.join(tmp, "ler_lines.txt")
    with open(lines, "w") as f:
        f.write("\n".join(texts) + "\n")
    decoder, ap = toy.ToyLetterDecoder(hp), AudioProcessor(hp.audio)
    render_rng = np.random.default_rng(4243)
    floor = float(np.mean([letters_ler(toy, decoder.decode(ap.melspectrogram(
        toy.synthesize_utterance_v2(text, hp, render_rng)).T), text) for text in texts]))
    jax_ler = {}
    for key, name in (("takes1_coverage", "freetext_eval.json"),
                      ("takes4_medoid", "freetext_eval_takes4_mean_medoid.json")):
        with open(os.path.join(HERE, "artifacts", "toyv2_q90", name)) as f:
            jax_ler[key] = json.load(f)["synthesis_ler"]
    runs, counts_by_key = {}, {}
    for takes, score in ((1, "coverage"), (4, "medoid")):
        key = f"takes{takes}_{score}"
        runs[key], counts_by_key[key] = [], 0
        for seed in LER_SEEDS:
            fa.launch_counts.clear()
            t = time.perf_counter()
            res, _ = run_cli(cli_inference.main, [
                "--dataset", "ljspeech", "--text", lines, "--model_dir", model_dir,
                "--test_dir", os.path.join(tmp, f"ler_{key}_{seed}"), "--device", device,
                "--takes", str(takes), "--take_score", score, "--length_source", "mean",
                "--sample_seed", str(seed), "--no-draw_alignments"])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t
            counts = dict(fa.launch_counts)
            check(counts == {"masked_attention_fwd_tc": takes * n_attn},
                  f"{key} seed {seed}: launches {counts}")
            counts_by_key[key] += counts.get("masked_attention_fwd_tc", 0)
            lers = [letters_ler(toy, decoder.decode(np.load(p)), text)
                    for p, text in zip(res["paths"], texts)]
            runs[key].append({"seed": seed, "ler": float(np.mean(lers)), "cli_s": cli_s})
    summary = {k: {"mean": statistics.mean(r["ler"] for r in v),
                   "stdev": statistics.stdev(r["ler"] for r in v),
                   "min": min(r["ler"] for r in v), "max": max(r["ler"] for r in v),
                   "jax_epoch_1700": jax_ler[k]} for k, v in runs.items()}
    print(json.dumps({"card": smi, "texts": LER_TEXTS, "decoder_floor": floor,
                      "runs": runs, "summary": summary}), flush=True)
    check(round(floor, 3) == LER_FLOOR, f"decoder floor {floor}, expected {LER_FLOOR}")
    check(summary["takes1_coverage"]["mean"] <= LER_CEILING,
          f"1-take LER mean {summary['takes1_coverage']['mean']} above {LER_CEILING}")
    return counts_by_key


def loop_records(tmp):
    """Records for the loop's phases: N_TRAIN train and N_DEV dev
    utterances in the toy-v2 ranges (one padded train batch shape at the
    shipped buckets) and a test split of N_LOOP_TEST."""
    records = os.path.join(tmp, "loop_records")
    os.makedirs(records)
    write_records(records, seed=2030,
                  splits=(("train", N_TRAIN), ("dev", N_DEV), ("test", N_LOOP_TEST)))
    return records


def test_wav_lengths(np, wavfile, test_dir, records, hop, neural):
    """{fid: (mel length, wav samples)} of the test artifacts' wavs of epoch
    1, and whether each has Griffin-Lim's mel length · hop samples or, with
    ``neural``, the ISTFT head's max(mel length - 1, 1) · hop."""
    from vaenar_tts_torch.data.records import RecordShardReader, list_shards
    lens = {}
    for path in list_shards(records, "test"):
        reader = RecordShardReader(path)
        for i in range(len(reader)):
            u = reader.get(i)
            lens[u.fid] = u.mel_len
    out = {}
    for fid, n in lens.items():
        wav_path = os.path.join(test_dir, f"test-1-{fid}.wav")
        samples = len(wavfile.read(wav_path)[1]) if os.path.isfile(wav_path) else -1
        want = (max(n - 1, 1) if neural else n) * hop
        out[fid] = (n, samples, samples == want)
    return out


def h2d_copies(prof):
    """(copies, device ms) of the host-to-device memcpys in a profile."""
    rows = [e for e in prof.key_averages() if "Memcpy HtoD" in e.key]
    return (sum(e.count for e in rows),
            sum(e.self_device_time_total for e in rows) / 1e3)


def loop_phase(torch, np, fa, wavfile, tmp, records, device, smi, hop, init_pass, per_step,
               n_attn):
    """``cli.train`` (bf16, shipped config) with the test-interval artifacts
    every epoch and the device data cache on, then off: 1 epoch of 2 steps
    from a cold start each; test wavs from the device Griffin-Lim, finite
    test metrics in dev/metrics.jsonl, the predicted launches, and the two
    runs' losses against each other. Then each run resumed for 1 more epoch
    under torch.profiler: its host-to-device copies. Returns {path:
    launches}."""
    from torch.profiler import ProfilerActivity, profile

    from vaenar_tts_torch.cli import train as cli_train
    phase("loop_test_artifacts")
    paths, runs, copies = {}, {}, {}
    n_dev = -(-N_DEV // 32)
    expected = {"masked_attention_fwd_tc": init_pass + per_step * (3 + n_dev) + n_attn,
                "masked_attention_bwd_dq_tc": per_step * 3,
                "masked_attention_bwd_dkv_tc": per_step * 3}
    expected_resume = {"masked_attention_fwd_tc": per_step * (2 + n_dev),
                       "masked_attention_bwd_dq_tc": per_step * 2,
                       "masked_attention_bwd_dkv_tc": per_step * 2}
    for name, cache_mb in (("cache", LOOP_CACHE_MB), ("no_cache", 0)):
        root = os.path.join(tmp, f"loop_{name}")
        common = ["--dataset", "ljspeech", "--data_dir", records,
                  "--model_dir", os.path.join(root, "ckpt"), "--log_dir", os.path.join(root, "logs"),
                  "--test_dir", os.path.join(root, "test"), "--device", device,
                  "--steps_per_epoch", "2", "--no-draw_plots"]
        fa.launch_counts.clear()
        history, text = run_cli(cli_train.main, common + [
            "--hparams", os.path.join(MODEL_DIR, "hparams.json"), "--max_epochs", "1",
            "--override", "train.test_interval=1",
            "--override", f"train.device_data_cache_mb={cache_mb}"])
        torch.cuda.synchronize()
        counts = dict(fa.launch_counts)
        with open(os.path.join(root, "logs", "dev", "metrics.jsonl")) as f:
            dev_rows = [json.loads(line) for line in f]
        wavs = test_wav_lengths(np, wavfile, os.path.join(root, "test"), records, hop, False)
        runs[name] = {"history": history, "launches": counts, "dev_rows": dev_rows,
                      "wavs": wavs, "cache_line": [l for l in text.splitlines()
                                                   if l.startswith("device data cache")]}
        check(history["cache"] == (cache_mb > 0), f"{name}: cache {history['cache']}")
        check(counts == expected, f"{name}: launches {counts} != {expected}")
        check(len(wavs) == N_LOOP_TEST and all(ok for _, _, ok in wavs.values()),
              f"{name}: test wavs {wavs}")
        test_row = [r for r in dev_rows if "test_mel_l1" in r]
        check(len(test_row) == 1 and all(math.isfinite(test_row[0][k])
                                         for k in ("test_mel_l1", "test_mel_l2", "test_mcd_db")),
              f"{name}: dev metrics {dev_rows}")
        check(os.path.isfile(os.path.join(root, "logs", "train.log")), "no train.log")
        paths[f"loop_{name}"] = counts
        # one more epoch, resumed, under the profiler: the copies an epoch
        fa.launch_counts.clear()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run_cli(cli_train.main, common + ["--max_epochs", "2",
                                              "--override", "train.test_interval=1000"])
            torch.cuda.synchronize()
        resume_counts = dict(fa.launch_counts)
        check(resume_counts == expected_resume,
              f"{name} resume: launches {resume_counts} != {expected_resume}")
        paths[f"loop_{name}_resume_profiled"] = resume_counts
        copies[name] = h2d_copies(prof)
    a, b = runs["cache"]["history"], runs["no_cache"]["history"]
    pairs = [(a["initial"], b["initial"])] + [(a[s][1], b[s][1]) for s in ("train", "dev")]
    rel = max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30) for x, y in pairs for k in y)
    print(json.dumps({"card": smi, "runs": runs, "losses_equal_exactly": rel == 0.0,
                      "max_rel_diff_cache_vs_no_cache": rel,
                      "h2d_copies_one_resumed_epoch": {
                          k: {"copies": c, "device_ms": ms} for k, (c, ms) in copies.items()},
                      "h2d_copies_saved_per_epoch": copies["no_cache"][0] - copies["cache"][0]}),
          flush=True)
    check(rel <= TOL_CACHE_REL, f"cache on against off: losses differ by {rel} relative")
    return paths


def sigterm_phase(torch, fa, tmp, device, smi, init_pass, per_step):
    """``cli.train`` (bf16, shipped config: epoch 1 is not a checkpoint
    epoch) in a subprocess, SIGTERM after epoch 2's first step line: exit 0,
    the epoch-1 checkpoint and no other new one; then resumed to epoch 3 and
    held against an uninterrupted run to epoch 3. Returns {path:
    launches} of the two in-process runs."""
    import signal
    import threading

    from vaenar_tts_torch.cli import train as cli_train
    from vaenar_tts_torch.utils.checkpoint import checkpoint_epochs
    phase("sigterm")
    records = os.path.join(tmp, "sigterm_records")
    os.makedirs(records)
    write_records(records, seed=2031, splits=(("train", N_SIGTERM_TRAIN), ("dev", N_DEV)))
    steps_per_epoch = N_SIGTERM_TRAIN // 32

    def argv(name, *extra):
        return ["--dataset", "ljspeech", "--data_dir", records,
                "--model_dir", os.path.join(tmp, name, "ckpt"),
                "--log_dir", os.path.join(tmp, name, "logs"), "--device", device,
                "--hparams", os.path.join(MODEL_DIR, "hparams.json"), "--max_epochs", "3",
                "--steps_per_epoch", str(steps_per_epoch), "--log_every", "1", *extra]

    proc = subprocess.Popen([sys.executable, "-m", "vaenar_tts_torch.cli.train", *argv("cut")],
                            cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=dict(os.environ, PYTHONUNBUFFERED="1"))
    watchdog = threading.Timer(SIGTERM_TIMEOUT_S, proc.kill)
    watchdog.start()
    lines, sent_after, epoch2 = [], None, False
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if line.startswith("Epoch 2:"):
                epoch2 = True
            elif epoch2 and sent_after is None and line.strip().startswith("step 1:"):
                proc.send_signal(signal.SIGTERM)
                sent_after = line.strip()
        rc = proc.wait(timeout=60)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    cut_dir = os.path.join(tmp, "cut", "ckpt")
    epochs_after_cut = checkpoint_epochs(cut_dir)
    tail = [l for l in lines if "preemption" in l or "SIGTERM" in l or "step" in l][-8:]
    print(json.dumps({"card": smi, "return_code": rc, "signal_after": sent_after,
                      "checkpoints_after_signal": epochs_after_cut, "lines": tail}), flush=True)
    check(sent_after is not None, "no step line of epoch 2 came: " + " | ".join(lines[-20:]))
    check(rc == 0, f"SIGTERM'd cli.train exited {rc}: " + " | ".join(lines[-20:]))
    check(any(l.startswith("preemption: stopped during epoch 2") for l in lines),
          "no mid-epoch stop line")
    check(epochs_after_cut == [0, 1], f"checkpoints after SIGTERM: {epochs_after_cut}")
    paths = {}
    fa.launch_counts.clear()
    resumed, _ = run_cli(cli_train.main, argv("cut"))
    torch.cuda.synchronize()
    paths["sigterm_resume"] = dict(fa.launch_counts)
    fa.launch_counts.clear()
    whole, _ = run_cli(cli_train.main, argv("whole"))
    torch.cuda.synchronize()
    paths["sigterm_uninterrupted"] = dict(fa.launch_counts)
    n_dev = -(-N_DEV // 32)
    want_resume = {"masked_attention_fwd_tc": per_step * 2 * (steps_per_epoch + n_dev),
                   "masked_attention_bwd_dq_tc": per_step * 2 * steps_per_epoch,
                   "masked_attention_bwd_dkv_tc": per_step * 2 * steps_per_epoch}
    n_steps = 1 + 3 * steps_per_epoch
    want_whole = {"masked_attention_fwd_tc": init_pass + per_step * (n_steps + 3 * n_dev),
                  "masked_attention_bwd_dq_tc": per_step * n_steps,
                  "masked_attention_bwd_dkv_tc": per_step * n_steps}
    got, want = resumed["dev"][3], whole["dev"][3]
    rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30) for k in want}
    print(json.dumps({"card": smi, "resumed_epochs": sorted(resumed["train"]),
                      "dev_epoch3_resumed": got, "dev_epoch3_uninterrupted": want,
                      "equal_exactly": got == want, "rel_diff": rel,
                      "launches": paths}), flush=True)
    check(sorted(resumed["train"]) == [2, 3] and resumed["initial"] is None,
          f"the resumed run trained epochs {sorted(resumed['train'])}")
    check(paths["sigterm_resume"] == want_resume, f"resume launches {paths['sigterm_resume']}")
    check(paths["sigterm_uninterrupted"] == want_whole,
          f"uninterrupted launches {paths['sigterm_uninterrupted']}")
    check(max(rel.values()) <= TOL_RESUME_REL, f"resumed dev losses against uninterrupted: {rel}")
    return paths


def rel_diffs(a, b):
    """{metric: |a - b| / |b|} over two loss dicts."""
    return {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for k in b}


def epoch_graph_phase(torch, np, fa, tmp, device, smi, init_pass, per_step):
    """``cli.train`` with the device data cache and
    ``train.device_cache_epoch_scan`` at the shipped config (GRAPH_SCHEDULE
    aside), in fp32 and bf16: from a cold start to epoch 3 with the flag,
    and to epoch 2 without it, the per-epoch train and dev losses against
    each other; the flag's run resumed from epoch 2 without the flag, and
    the run without it resumed with the flag, each epoch 3 against the
    uninterrupted one; the kernels each captured step launched, the graph's
    replays, and the wrappers' launches (warm-up and capture steps only:
    a replay launches through no wrapper). The fp32 runs above take
    deterministic cuDNN; at fp32 with cuDNN's defaults, 2 epochs with the
    flag and twice 2 without it, the graphed losses against the first
    eager run's beside the second's. Each ``cli.train`` run is a path of
    its own, its launches counted from 0. Then the epoch runner alone on
    the trained state: GRAPH_REPS epochs graphed and eager (wall, ms a
    step), one of each under torch.profiler (device busy share), the
    capture's seconds and pool bytes. Then, per GRAPH_REMAT_MODES, 2 epochs
    with the flag against 2 without it under that ``train.remat`` (each run
    a path), losses and epoch-2 weights equal to the bit, and the runner
    alone from the flag's state: GRAPH_REMAT_REPS epochs graphed and eager,
    the capture's seconds and pool bytes beside the no-remat run's. Returns
    ({path: launches}, {dtype: {kernel: launches replayed in graphs}})."""
    from vaenar_tts_torch.cli import train as cli_train
    from vaenar_tts_torch.configs.overrides import apply_overrides
    from vaenar_tts_torch.configs.serialize import load_hparams
    from vaenar_tts_torch.models.vaenar import VAENAR
    from vaenar_tts_torch.training import loop, steps
    from vaenar_tts_torch.utils.checkpoint import STATE_NAME, CheckpointManager
    from torch.profiler import ProfilerActivity, profile

    from vaenar_tts_torch.utils.profiling import device_summary
    phase("epoch_graph")
    records = os.path.join(tmp, "graph_records")
    os.makedirs(records)
    write_records(records, seed=2032, splits=(("train", GRAPH_TRAIN), ("dev", N_DEV)))
    n_steps = GRAPH_TRAIN // 32
    n_dev = -(-N_DEV // 32)
    paths, replayed, report, ok = {}, {}, {}, True
    for dtype in ("float32", "bfloat16"):
        tol = TOL_GRAPH_FP32_REL if dtype == "float32" else TOL_CACHE_REL
        want = {fa.kernel_name(kind, getattr(torch, dtype)): per_step
                for kind in ("fwd", "dq", "dkv")}
        fwd = fa.kernel_name("fwd", getattr(torch, dtype))
        root = os.path.join(tmp, f"graph_{dtype}")
        overrides = [f"train.compute_dtype={dtype}", f"train.device_data_cache_mb={LOOP_CACHE_MB}",
                     "train.checkpoint_every_n_epochs=2", *GRAPH_SCHEDULE]
        run_walls = {}

        def train(run, ckpt, scan, max_epochs, cold, extra=()):
            """``cli.train`` into the model directory ``ckpt``, with the
            overrides ``extra`` as well; its launches are path ``run``'s,
            counted from 0."""
            argv = ["--dataset", "ljspeech", "--data_dir", records,
                    "--model_dir", os.path.join(root, ckpt), "--log_dir",
                    os.path.join(root, run + "_logs"), "--device", device,
                    "--max_epochs", str(max_epochs), "--no-draw_plots"]
            if cold:
                argv += ["--hparams", os.path.join(MODEL_DIR, "hparams.json")]
            for o in [*overrides, *extra, f"train.device_cache_epoch_scan={str(scan).lower()}"]:
                argv += ["--override", o]
            fa.launch_counts.clear()
            start = time.perf_counter()
            history, text = run_cli(cli_train.main, argv)
            torch.cuda.synchronize()
            run_walls[f"{run}_to_epoch_{max_epochs}"] = time.perf_counter() - start
            paths[f"epoch_graph_{dtype}_{run}"] = dict(fa.launch_counts)
            line = [l for l in text.splitlines() if l.startswith("device data cache")]
            return history, line, dict(fa.launch_counts)

        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = dtype == "float32"
        try:
            on, on_line, on_counts = train("on", "on", True, 3, True)
            off, off_line, _ = train("off", "off", False, 2, True)
            shutil.rmtree(os.path.join(root, "on", "3"))
            on_then_off, _, _ = train("on_then_off", "on", False, 3, False)
            off_then_on, _, _ = train("off_then_on", "off", True, 3, False)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        default_replays = 0
        if dtype == "float32":
            # cuDNN's default algorithms, as users train: two eager runs
            # witness how far fp32 eager drifts from eager, beside the
            # graphed run against the first
            on_d, _, _ = train("on_default", "on_default", True, 2, True)
            eager_a, _, _ = train("off_default_a", "off_default_a", False, 2, True)
            eager_b, _, _ = train("off_default_b", "off_default_b", False, 2, True)
            gaps = {name: {f"epoch{e}_{split}": rel_diffs(h[split][e], eager_a[split][e])
                           for e in (1, 2) for split in ("train", "dev")}
                    for name, h in (("eager_vs_eager", eager_b), ("graphed_vs_eager", on_d))}
            worst_d = {k: max(v for d in g.values() for v in d.values()) for k, g in gaps.items()}
            default_replays = on_d["runner"]["replays"]
            report["cudnn_default_float32"] = {
                "rel_diff": gaps, "worst": worst_d, "tolerance": TOL_GRAPH_FP32_DEFAULT_REL,
                "replays": default_replays}
            ok = (ok and worst_d["graphed_vs_eager"] <= TOL_GRAPH_FP32_DEFAULT_REL
                  and default_replays == 2 * n_steps and eager_a["runner"] is None)
        runner = on["runner"]
        captures = len(runner["captured_launches"])
        want_counts = {k: per_step * (1 + (steps.WARMUP_STEPS + 1) * captures
                                      + (3 * n_dev if k == fwd else 0))
                       + (init_pass if k == fwd else 0) for k in want}
        rel = {f"epoch{e}_{split}": rel_diffs(on[split][e], off[split][e])
               for e in (1, 2) for split in ("train", "dev")}
        rel["initial"] = rel_diffs(on["initial"], off["initial"])
        rel_resume = {f"{name}_{split}": rel_diffs(h[split][3], on[split][3])
                      for name, h in (("on_then_off", on_then_off), ("off_then_on", off_then_on))
                      for split in ("train", "dev")}
        worst = max(v for d in list(rel.values()) + list(rel_resume.values()) for v in d.values())
        report[dtype] = {"cudnn_deterministic": dtype == "float32",
                         "cache_line_on": on_line, "cache_line_off": off_line,
                         "rel_diff_flag_on_vs_off": rel, "rel_diff_resumed_vs_uninterrupted":
                         rel_resume, "worst_rel_diff": worst, "tolerance": tol,
                         "runner": runner, "resumed_runner": off_then_on["runner"],
                         "wrapper_launches_on": on_counts,
                         "wrapper_launches_expected": want_counts,
                         "cli_wall_s": run_walls}
        ok_dtype = (worst <= tol and on["cache"] and off["runner"] is None
                    and runner["graphed"] and runner["replays"] == 3 * n_steps
                    and sorted(runner["captured_launches"]) == [2, 5]
                    and all(c == want for c in runner["captured_launches"].values())
                    and off_then_on["runner"]["replays"] == n_steps
                    and on_then_off["runner"] is None and on_counts == want_counts
                    and sorted(on["train"]) == [1, 2, 3] and sorted(on_then_off["train"]) == [3])
        ok = ok and ok_dtype

        # the runner alone, from the trained state: epochs both ways
        t_alone = time.perf_counter()
        hp = apply_overrides(load_hparams(os.path.join(root, "on")),
                             ["train.device_cache_epoch_scan=true"])
        train_loader, dev_loader, _ = loop.make_loaders(hp, records)
        cache, _ = loop.device_cache(hp, train_loader, dev_loader, torch.device(device))

        def epochs_alone(ckpt, epoch):
            """(runner, r, graphed, eager) from the checkpoint in ``ckpt``:
            one epoch of ``epoch``'s order through the runner (captured
            here), or through eager steps on a second Adam restored alike."""
            hp_c = apply_overrides(load_hparams(os.path.join(root, ckpt)),
                                   ["train.device_cache_epoch_scan=true"])
            model_c = VAENAR(hp_c).to(device)
            opts = [steps.make_optimizer(hp_c, model_c) for _ in range(2)]
            for opt in opts:
                CheckpointManager(os.path.join(root, ckpt)).restore(model_c, opt)
            run_c = steps.make_epoch_runner(model_c, opts[0], hp_c, cache)
            order = train_loader.batch_order(epoch)[:n_steps]
            r_c, kl = hp_c.train.reduction_factor_at(epoch), hp_c.train.kl_weight_at(epoch)
            gen = torch.Generator(device=device).manual_seed(epoch)

            def graphed():
                run_c(order, kl, r_c, gen)

            def eager():
                for i in order:
                    steps.train_step(model_c, opts[1], hp_c, *(x[i] for x in cache), kl, r_c, gen)

            graphed()  # the capture
            return run_c, r_c, graphed, eager

        run, r, graphed, eager = epochs_alone("on", 4)
        walls = {}
        for name, fn in (("graphed", graphed), ("eager", eager)):
            walls[name] = [timed(torch, fn)[1] for _ in range(GRAPH_REPS)]
        busy = {}
        for name, fn in (("graphed", graphed), ("eager", eager)):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _, wall = timed(torch, fn)
            summary = device_summary(prof, top=5)
            busy[name] = {"device_ms_per_epoch": summary["device_ms"],
                          "kernels_per_epoch": summary["launches"],
                          "busy_share": summary["device_ms"] / (1e3 * wall) if wall else None,
                          "profiled_wall_s": wall, "top": summary["top"]}
        rep = run.report()
        report[dtype]["runner_alone"] = {
            "steps_per_epoch": n_steps, "reduction_factor": r,
            "epoch_wall_s": walls,
            "ms_per_step": {k: [1e3 * w / n_steps for w in v] for k, v in walls.items()},
            "profiled": busy, "capture_s": rep["capture_s"], "capture_pool_peak_bytes":
            rep["capture_bytes"], "captured_launches": rep["captured_launches"]}
        ok = ok and rep["captured_launches"] == {r: want}
        replayed[dtype] = {k: v * (runner["replays"] + off_then_on["runner"]["replays"]
                                   + default_replays + rep["replays"]) for k, v in want.items()}
        report[dtype]["runner_alone"]["seconds"] = time.perf_counter() - t_alone
        del run, graphed, eager
        print(json.dumps({"card": smi, "compute_dtype": dtype, **report[dtype]}), flush=True)

        # train.remat inside the graph: the flag on against off under the
        # same remat, then the runner alone from the flag's trained state
        want_remat = {k: v * (2 if k == fwd else 1) for k, v in want.items()}
        for mode in GRAPH_REMAT_MODES[dtype]:
            t_mode = time.perf_counter()
            extra = [f"train.remat={mode}"]
            torch.backends.cudnn.deterministic = dtype == "float32"
            try:
                m_on, _, m_on_counts = train(f"remat_{mode}_flag_on", f"remat_{mode}_on", True, 2,
                                             True, extra)
                m_off, _, _ = train(f"remat_{mode}_flag_off", f"remat_{mode}_off", False, 2,
                                    True, extra)
            finally:
                torch.backends.cudnn.deterministic = deterministic
            m_runner = m_on["runner"]
            m_want_counts = {k: per_step * ((2 if k == fwd else 1)
                                            * (1 + (steps.WARMUP_STEPS + 1)
                                               * len(m_runner["captured_launches"]))
                                            + (2 * n_dev if k == fwd else 0))
                             + (init_pass if k == fwd else 0) for k in want}
            losses_equal = m_on["initial"] == m_off["initial"] and all(
                m_on[split][e] == m_off[split][e] for e in (1, 2) for split in ("train", "dev"))
            on_w, off_w = (torch.load(os.path.join(root, f"remat_{mode}_{flag}", "2", STATE_NAME),
                                      map_location="cpu", weights_only=True)["model"]
                           for flag in ("on", "off"))
            weights_equal = on_w.keys() == off_w.keys() and all(
                torch.equal(v, off_w[k]) for k, v in on_w.items())
            del on_w, off_w
            run, r, graphed, eager = epochs_alone(f"remat_{mode}_on", 3)
            walls = {name: [timed(torch, fn)[1] for _ in range(GRAPH_REMAT_REPS)]
                     for name, fn in (("graphed", graphed), ("eager", eager))}
            m_rep = run.report()
            del run, graphed, eager
            pool, pool_off = m_runner["capture_bytes"], runner["capture_bytes"]
            m_report = {
                "remat": mode, "cudnn_deterministic": dtype == "float32",
                "losses_bit_equal": losses_equal, "weights_bit_equal": weights_equal,
                "ms_per_step": {k: [1e3 * w / n_steps for w in v] for k, v in walls.items()},
                "reduction_factor": r, "capture_s": m_runner["capture_s"],
                "capture_s_alone": m_rep["capture_s"],
                "capture_pool_peak_bytes": pool, "no_remat_capture_pool_peak_bytes": pool_off,
                "pool_peak_vs_no_remat": {f: pool[f] / pool_off[f] for f in pool},
                "captured_launches": m_runner["captured_launches"],
                "captured_launches_expected": want_remat,
                "wrapper_launches_on": m_on_counts, "wrapper_launches_expected": m_want_counts,
                "replays": m_runner["replays"], "cli_wall_s": {k: v for k, v in run_walls.items()
                                                               if k.startswith(f"remat_{mode}_")}}
            ok_mode = (losses_equal and weights_equal and m_on["cache"]
                       and m_off["runner"] is None and m_runner["graphed"]
                       and m_runner["replays"] == 2 * n_steps
                       and sorted(m_runner["captured_launches"]) == [2, 5]
                       and all(c == want_remat for c in m_runner["captured_launches"].values())
                       and m_on_counts == m_want_counts
                       and m_rep["captured_launches"] == {r: want_remat})
            ok = ok and ok_mode
            for k, v in want_remat.items():
                replayed[dtype][k] += v * (m_runner["replays"] + m_rep["replays"])
            m_report["seconds"] = time.perf_counter() - t_mode
            report[dtype][f"remat_{mode}"] = m_report
            print(json.dumps({"card": smi, "compute_dtype": dtype, "remat_in_graph": m_report}),
                  flush=True)
        del cache
    print(json.dumps({"card": smi, "cudnn_default_float32": report["cudnn_default_float32"]}),
          flush=True)
    failure_dir = os.path.join(tmp, "graph_failure")
    os.makedirs(failure_dir)
    t_failure = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(HERE, "chip_smoke.py"),
                           "--graph-failure-worker", "0", "0", failure_dir], cwd=HERE,
                          capture_output=True, text=True, timeout=FLEET_TIMEOUT_S)
    path = os.path.join(failure_dir, "graph_failure.json")
    failure = {"exit_code": proc.returncode, "output": proc.stdout[-2000:] + proc.stderr[-2000:]}
    if os.path.isfile(path):
        with open(path) as f:
            failure = json.load(f)
    print(json.dumps({"card": smi, "fails_closed": failure,
                      "seconds": time.perf_counter() - t_failure}), flush=True)
    check(bool(failure.get("non_capturable_raised")) and bool(failure.get("capture_raised"))
          and failure.get("params_unchanged") is True and failure.get("replays") == 0,
          f"the epoch runner on a failed capture: {failure}")
    gated = {d: {k: v for k, v in r_.items() if k != "runner_alone"} if d in ("float32", "bfloat16")
             else r_ for d, r_ in report.items()}
    check(ok, f"graphed epochs against eager ones: {gated}")
    return paths, replayed


def graph_failure_worker(_rank, _port, out_dir):
    """``chip_smoke.py --graph-failure-worker 0 0 OUT``: the epoch runner on
    the card fails closed. A runner given a non-capturable Adam raises; a
    step that reads a loss on the host (a sync, which stream capture
    refuses) makes the capture raise, after which no step has run eagerly:
    the parameters are those from before the call and nothing was
    replayed. The shipped config cut to one block a stack, batch 8, in a
    process of its own (a failed capture may leave the process's CUDA state
    unusable). Writes OUT/graph_failure.json."""
    import numpy as np
    import torch
    sys.path.insert(0, HERE)
    from vaenar_tts_torch.configs.overrides import apply_overrides
    from vaenar_tts_torch.configs.serialize import load_hparams
    from vaenar_tts_torch.training import loop, steps
    records = os.path.join(out_dir, "records")
    os.makedirs(records)
    write_records(records, seed=2033, splits=(("train", 16), ("dev", 8)))
    hp = apply_overrides(load_hparams(MODEL_DIR), [
        "encoder.n_blk=1", "decoder.nblk=1", "posterior.nblk=1", "prior.n_blk=1",
        "prior.n_transformer_blk=1", "train.train_batch_size=8",
        "train.device_data_cache_mb=64", "train.device_cache_epoch_scan=true"])
    device = torch.device(DEVICE)
    train_loader, dev_loader, _ = loop.make_loaders(hp, records)
    cache, _ = loop.device_cache(hp, train_loader, dev_loader, device)
    model = steps.init_model(hp, 1, device)
    out = {}
    try:
        steps.make_epoch_runner(model, torch.optim.Adam(model.parameters()), hp, cache)
        out["non_capturable_raised"] = None
    except ValueError as e:
        out["non_capturable_raised"] = repr(e)
    runner = steps.make_epoch_runner(model, steps.make_optimizer(hp, model), hp, cache)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    real = steps.train_step

    def syncing_step(*args, **kwargs):
        metrics = real(*args, **kwargs)
        float(metrics["total"])  # a host read of a device value
        return metrics

    steps.train_step = syncing_step
    try:
        runner(train_loader.batch_order(1), 1e-5, 2, torch.Generator(device=device).manual_seed(1))
        out["capture_raised"] = None
    except RuntimeError as e:
        out["capture_raised"] = repr(e)[:300]
    finally:
        steps.train_step = real
    out["params_unchanged"] = all(torch.equal(p.detach(), before[n])
                                  for n, p in model.named_parameters())
    out["replays"] = runner.replays
    with open(os.path.join(out_dir, "graph_failure.json"), "w") as f:
        json.dump(out, f)
    return 0


def grads_share(torch, got, want):
    """The largest share of TOL_GRAD_LEAF · max|want| that a leaf's error
    takes, over all leaves."""
    worst = 0.0
    for n, g in want.items():
        err, tol = (got[n] - g).abs().max().item(), TOL_GRAD_LEAF * g.abs().max().item()
        worst = max(worst, err / tol if tol > 0 else (0.0 if err == 0 else float("inf")))
    return worst


def remat_phase(torch, np, fa, steps, load, hp_train, data_dir, device, smi, per_step):
    """remat "on" and "dots" against "off" on the card: fp32, batch 4, r =
    2, dropout on, one generator state: loss and every gradient element
    within the card-against-CPU step's tolerances, and the predicted
    launches; then bf16 at the shipped batch: peak memory, step time and
    launches per mode. Returns {path: launches}."""
    from vaenar_tts_torch.configs.overrides import apply_overrides
    from vaenar_tts_torch.data.loader import BucketedLoader
    from vaenar_tts_torch.data.records import list_shards
    from vaenar_tts_torch.training.loop import to_device
    phase("remat")
    paths, fp32 = {}, {}
    hp32 = apply_overrides(hp_train, ["train.compute_dtype=float32"])
    small = to_device(next(iter(BucketedLoader(list_shards(data_dir, "train"), 4,
                                               hp32.dataset.mel_bucket, hp32.dataset.text_bucket,
                                               shuffle=False).epoch(0))), device)
    for mode in ("off", "on", "dots"):
        hp_m = apply_overrides(hp32, [f"train.remat={mode}"])
        model = load(hp_m)
        gen = torch.Generator(device=device).manual_seed(7)
        fa.launch_counts.clear()
        metrics = steps.train_step(model, steps.make_optimizer(hp_m, model), hp_m, *small,
                                   1e-5, 2, gen)
        torch.cuda.synchronize()
        paths[f"remat_{mode}_fp32_step"] = dict(fa.launch_counts)
        fp32[mode] = (steps.metric_floats(metrics),
                      {n: p.grad.detach().clone() for n, p in model.named_parameters()})
        del model
    shares = {}
    for mode in ("on", "dots"):
        m, g = fp32[mode]
        m0, g0 = fp32["off"]
        shares[mode] = {"loss": max(abs(m[k] - m0[k]) / ((TOL_KL_REL if k == "kl" else
                                                          TOL_LOSS_REL) * abs(m0[k])) for k in m0),
                        "grads": grads_share(torch, g, g0)}
    want = {"off": 1, "on": 2, "dots": 2}
    for mode, k in want.items():
        check(paths[f"remat_{mode}_fp32_step"] == {"masked_attention_fwd": k * per_step,
                                                   "masked_attention_bwd_dq": per_step,
                                                   "masked_attention_bwd_dkv": per_step},
              f"remat {mode} fp32 launches {paths[f'remat_{mode}_fp32_step']}")
    big = to_device(next(iter(BucketedLoader(list_shards(data_dir, "train"),
                                             hp_train.train.train_batch_size,
                                             hp_train.dataset.mel_bucket,
                                             hp_train.dataset.text_bucket,
                                             shuffle=False).epoch(0))), device)
    bf16 = {}
    for mode in ("off", "on", "dots"):
        hp_m = apply_overrides(hp_train, [f"train.remat={mode}"])
        model = load(hp_m)
        optimizer = steps.make_optimizer(hp_m, model)
        gen = torch.Generator(device=device).manual_seed(8)
        steps.train_step(model, optimizer, hp_m, *big, 1e-5, 2, gen)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa.launch_counts.clear()
        walls = []
        for _ in range(REMAT_REPS):
            t = time.perf_counter()
            steps.train_step(model, optimizer, hp_m, *big, 1e-5, 2, gen)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        counts = dict(fa.launch_counts)
        paths[f"remat_{mode}_bf16_steps"] = counts
        bf16[mode] = {"peak_bytes_above_resident": torch.cuda.max_memory_allocated() - base,
                      "resident_bytes": base, "wall_s": walls,
                      "median_ms": 1e3 * statistics.median(walls),
                      "launches_per_step": {k: v / REMAT_REPS for k, v in counts.items()}}
        del model, optimizer
        check(counts == {"masked_attention_fwd_tc": want[mode] * per_step * REMAT_REPS,
                         "masked_attention_bwd_dq_tc": per_step * REMAT_REPS,
                         "masked_attention_bwd_dkv_tc": per_step * REMAT_REPS},
              f"remat {mode} bf16 launches {counts}")
    print(json.dumps({"card": smi, "fp32_batch": list(small[1].shape),
                      "fp32_share_of_tol": shares, "fp32_loss": {k: v[0] for k, v in fp32.items()},
                      "bf16_batch": list(big[1].shape), "bf16": bf16}), flush=True)
    check(all(v["loss"] <= 1.0 and v["grads"] <= 1.0 for v in shares.values()),
          f"remat against off on the card: {shares}")
    return paths


def batched_lu_phase(torch, fa, steps, load, hp_train, data_dir, device, smi, per_step):
    """prior.batched_lu on against off: the prior's log-probability at fp32
    within TOL_LU_REL, and the bf16 train step's time at the shipped batch
    each way. Returns {path: launches}."""
    from vaenar_tts_torch.configs.overrides import apply_overrides
    from vaenar_tts_torch.data.loader import BucketedLoader
    from vaenar_tts_torch.data.records import list_shards
    from vaenar_tts_torch.training.loop import to_device
    phase("batched_lu")
    big = to_device(next(iter(BucketedLoader(list_shards(data_dir, "train"),
                                             hp_train.train.train_batch_size,
                                             hp_train.dataset.mel_bucket,
                                             hp_train.dataset.text_bucket,
                                             shuffle=False).epoch(0))), device)
    texts, mels, t_lens, m_lens = big
    z_lens = (m_lens + 1) // 2
    z = torch.randn((mels.shape[0], mels.shape[1] // 2, hp_train.common.latent_dim),
                    generator=torch.Generator(device=device).manual_seed(9), device=device)
    paths, logp, times = {}, {}, {}
    for on in (False, True):
        hp32 = apply_overrides(hp_train, ["train.compute_dtype=float32",
                                          f"prior.batched_lu={on}"])
        model = load(hp32)
        fa.launch_counts.clear()
        with torch.no_grad():
            cond = model._encode(texts, t_lens, 2)
            logp[on] = model.prior.log_probability(z, cond, z_lens, t_lens)
        torch.cuda.synchronize()
        paths[f"batched_lu_{on}_fp32_log_prob"] = dict(fa.launch_counts)
        del model
        hp16 = apply_overrides(hp_train, [f"prior.batched_lu={on}"])
        model = load(hp16)
        walls, per_step_counts = train_step_times(torch, fa, steps, model, hp16, big, 2,
                                                  reps=REMAT_REPS, warmup=1)
        paths[f"batched_lu_{on}_bf16_steps"] = {k: int(v * REMAT_REPS)
                                               for k, v in per_step_counts.items()}
        times[str(on)] = {"wall_s": walls, "median_ms": 1e3 * statistics.median(walls)}
        del model
    rel = ((logp[True] - logp[False]).abs() / logp[False].abs()).max().item()
    print(json.dumps({"card": smi, "log_prob_off": logp[False].tolist(),
                      "max_rel_diff": rel, "bf16_train_step": times,
                      "launches": paths}), flush=True)
    check(rel <= TOL_LU_REL, f"batched_lu log-probability differs by {rel} relative")
    return paths


def vocoder_card_cpu_shares(torch, head_card, head_cpu, clip, audio, device):
    """(gated, printed) errors of the vocoder's card run against its CPU
    run, each a share of the CPU side's largest element. Gated: "head", the
    head's raw output (log magnitude, re, im) card against CPU; "frames_math"
    and "istft_math", the frame math (models/vocoder.head_to_frames) and
    spec_to_wav run on ``device`` from the CPU head's output against the
    same on the CPU. Printed: "frames" and "wavs" of the card's head against
    the CPU's, which move by a large share wherever |(re, im)| is near 0."""
    from vaenar_tts_torch.models.vocoder import head_to_frames, spec_to_wav

    def share(got, want):
        return ((got.cpu() - want.cpu()).abs().max() / want.abs().max()).item()

    head_cpu = head_cpu.cpu()
    frames_cpu = head_to_frames(head_cpu, clip)
    wav_cpu = spec_to_wav(frames_cpu, audio)
    frames_math = head_to_frames(head_cpu.to(device), clip)
    frames_card = head_to_frames(head_card.to(device), clip)
    gated = {"head": share(head_card, head_cpu), "frames_math": share(frames_math, frames_cpu),
             "istft_math": share(spec_to_wav(frames_math, audio), wav_cpu)}
    printed = {"frames": share(frames_card, frames_cpu),
               "wavs": share(spec_to_wav(frames_card, audio), wav_cpu)}
    return gated, printed


def neural_vocoder_phase(torch, np, fa, wavfile, tmp, device, smi, hp, mels0, loop_recs,
                         test_records, init_pass, per_step, n_attn, n_test_calls):
    """The ISTFT-head vocoder: ``cli.train_vocoder --toy --toy_version 2``
    at the full VocoderConfig in fp32 and bf16 (the last logged loss under
    VOC_LOSS_DROP of the first); the fp32 forward card against CPU; vocode
    against Griffin-Lim on the shipped lines' mels; ``cli.inference
    --neural_vocoder`` and ``cli.train --neural_vocoder``. Returns {path:
    launches}."""
    from vaenar_tts_torch.cli import inference as cli_inference
    from vaenar_tts_torch.cli import train as cli_train
    from vaenar_tts_torch.cli import train_vocoder as cli_vocoder
    from vaenar_tts_torch.models.vocoder import load_vocoder, vocode
    from vaenar_tts_torch.ops import griffin_lim as gl
    phase("neural_vocoder")
    trained, vdirs = {}, {}
    for dtype in ("float32", "bfloat16"):
        vdirs[dtype] = os.path.join(tmp, f"vocoder_{dtype}")
        t = time.perf_counter()
        result, _ = run_cli(cli_vocoder.main, [
            "--dataset", "ljspeech", "--toy", "--toy_version", "2",
            "--n_toy_utterances", str(VOC_UTTS), "--model_dir", vdirs[dtype],
            "--steps", str(VOC_STEPS), "--log_every", str(VOC_LOG_EVERY),
            "--save_every", str(10 * VOC_STEPS), "--compute_dtype", dtype, "--device", device])
        trained[dtype] = {**result, "cli_s": time.perf_counter() - t}
    print(json.dumps({"card": smi, "vocoder_training": trained}), flush=True)
    for dtype, r in trained.items():
        check(math.isfinite(r["last_loss"]) and r["last_loss"] <= VOC_LOSS_DROP * r["first_loss"],
              f"{dtype} vocoder: loss {r['first_loss']} -> {r['last_loss']}")
    card, _ = load_vocoder(vdirs["float32"], device)
    cpu, _ = load_vocoder(vdirs["float32"], "cpu")
    crop = mels0[:, :VOC_CARD_CPU_FRAMES]
    with torch.no_grad():
        errs, errs_printed = vocoder_card_cpu_shares(
            torch, card.head_output(crop), cpu.head_output(crop.cpu()),
            card.cfg.log_magnitude_clip, card.audio, device)
    bf16_model, _ = load_vocoder(vdirs["bfloat16"], device)
    gen = torch.Generator(device=device)
    ms = {"neural_fp32": time_ms(torch, lambda: vocode(card, mels0), reps=5, warmup=2),
          "neural_bf16": time_ms(torch, lambda: vocode(bf16_model, mels0), reps=5, warmup=2),
          "griffin_lim": time_ms(torch, lambda: gl.mel_to_wav(mels0, hp.audio,
                                                              gen.manual_seed(0)),
                                 reps=3, warmup=1)}
    walls = {}
    for name, fn in (("neural_fp32", lambda: vocode(card, mels0)),
                     ("griffin_lim", lambda: gl.mel_to_wav(mels0, hp.audio, gen.manual_seed(0)))):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t
    print(json.dumps({"card": smi, "card_vs_cpu_fp32_share_of_max": errs,
                      "card_vs_cpu_fp32_share_of_max_not_gated": errs_printed,
                      "card_vs_cpu_frames": crop.shape[1], "vocode_batch": list(mels0.shape),
                      "device_ms": ms, "wall_s": walls}), flush=True)
    check(max(errs.values()) <= TOL_VOC_CARD_CPU, f"vocoder card against CPU: {errs}")
    paths = {}
    out = os.path.join(tmp, "neural_test_set")
    fa.launch_counts.clear()
    run_cli(cli_inference.main, [
        "--dataset", "ljspeech", "--data_dir", test_records, "--model_dir", MODEL_DIR,
        "--batch_size", "4", "--device", device, "--no-draw_alignments", "--test_dir", out,
        "--write_wavs", "--neural_vocoder", vdirs["float32"]])
    torch.cuda.synchronize()
    paths["test_set_cli_neural_vocoder"] = dict(fa.launch_counts)
    hop = hp.audio.frame_shift_sample
    lens = {}
    for name in sorted(os.listdir(out)):
        if name.endswith(".npy"):
            n = np.load(os.path.join(out, name)).shape[0]
            lens[name] = (n, len(wavfile.read(os.path.join(out, name[:-4] + ".wav"))[1]))
    check(len(lens) == N_TEST and all(w == max(n - 1, 1) * hop for n, w in lens.values()),
          f"--neural_vocoder wav lengths: {lens}")
    check(paths["test_set_cli_neural_vocoder"] == {"masked_attention_fwd_tc": n_attn * n_test_calls},
          f"--neural_vocoder test-set launches {paths['test_set_cli_neural_vocoder']}")
    root = os.path.join(tmp, "loop_neural")
    fa.launch_counts.clear()
    run_cli(cli_train.main, [
        "--dataset", "ljspeech", "--data_dir", loop_recs, "--model_dir", os.path.join(root, "ckpt"),
        "--log_dir", os.path.join(root, "logs"), "--test_dir", os.path.join(root, "test"),
        "--hparams", os.path.join(MODEL_DIR, "hparams.json"), "--device", device,
        "--max_epochs", "1", "--steps_per_epoch", "1", "--no-draw_plots",
        "--override", "train.test_interval=1", "--neural_vocoder", vdirs["float32"]])
    torch.cuda.synchronize()
    counts = dict(fa.launch_counts)
    paths["train_cli_neural_vocoder"] = counts
    wavs = test_wav_lengths(np, wavfile, os.path.join(root, "test"), loop_recs, hop, True)
    print(json.dumps({"card": smi, "test_set_wav_lengths": lens, "train_test_wavs": wavs,
                      "launches": paths}), flush=True)
    check(all(ok for _, _, ok in wavs.values()) and len(wavs) == N_LOOP_TEST,
          f"cli.train --neural_vocoder test wavs {wavs}")
    n_dev = -(-N_DEV // 32)
    check(counts == {"masked_attention_fwd_tc": init_pass + per_step * (2 + n_dev) + n_attn,
                     "masked_attention_bwd_dq_tc": per_step * 2,
                     "masked_attention_bwd_dkv_tc": per_step * 2},
          f"cli.train --neural_vocoder launches {counts}")
    return paths


def synthesis_trace_phase(torch, fa, tmp, model, hp, token_ids, use_q, smi, wall_unprofiled_s):
    """One bf16 synthesize_batch call under utils.profiling.profile_trace:
    the device busy share against the unprofiled wall, the kernel launches
    and the operations that take the most device time. Returns {path:
    launches}."""
    from vaenar_tts_torch.cli.inference import synthesize_batch
    from vaenar_tts_torch.utils.profiling import device_summary, profile_trace
    phase("synthesis_trace")
    trace_dir = os.path.join(tmp, "synthesis_trace")
    fa.launch_counts.clear()
    with profile_trace(trace_dir) as prof:
        t = time.perf_counter()
        synthesize_batch(model, hp, token_ids, 0.0, use_q)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    counts = dict(fa.launch_counts)
    summary = device_summary(prof, top=12)
    print(json.dumps({"card": smi, "wall_s_profiled": wall,
                      "wall_s_unprofiled_median": wall_unprofiled_s,
                      "device_busy_share": summary["device_ms"] / (1e3 * wall_unprofiled_s),
                      "trace_bytes": os.path.getsize(os.path.join(trace_dir, "trace.json")),
                      **summary, "attention_launches": counts}), flush=True)
    check(summary["launches"] > 0 and summary["device_ms"] > 0, "the trace saw no device work")
    return {"synthesis_trace": counts}


def write_fleet_records(data_dir, seed):
    """FLEET_SHARDS train shards of FLEET_PER_SHARD utterances and one dev
    shard of N_DEV: texts of 12-64 ids (text buckets 32 and 64 at the
    shipped config), mels of about 9 frames an id (mel buckets 480 and 960)."""
    import numpy as np
    from vaenar_tts_torch.data.records import RecordShardWriter
    rng = np.random.default_rng(seed)
    for name, n in [(f"train-{i}", FLEET_PER_SHARD) for i in range(FLEET_SHARDS)] + [
            ("dev-0", N_DEV)]:
        writer = RecordShardWriter(os.path.join(data_dir, f"{name}.vrs"), 80)
        for i in range(n):
            text_len = int(rng.integers(12, 65))
            mel_len = int(round(9.0 * text_len * rng.uniform(0.85, 1.15)))
            writer.add(f"{name}-{i:03d}", rng.integers(3, 43, text_len),
                       rng.uniform(0.0, 1.0, (mel_len, 80)).astype(np.float32))
        writer.close()


def join_batches(parts, device):
    """The processes' batches of one step -> the global batch on ``device``,
    as the loop feeds it."""
    import numpy as np
    import torch
    texts, mels, t_lens, m_lens = (np.concatenate([getattr(b, k) for b in parts])
                                   for k in ("texts", "mels", "text_lengths", "mel_lengths"))
    return (torch.from_numpy(texts).long().to(device), torch.from_numpy(mels).to(device),
            torch.from_numpy(t_lens).to(device), torch.from_numpy(m_lens).to(device))


def fleet_global_batches(hp, data_dir, nprocs, epoch, device):
    """The global train batches of epoch ``epoch`` of an ``nprocs`` fleet of
    ``cli.train --distributed`` over ``data_dir``: the same shard partition,
    loaders and lockstep schedule, each step's batches joined."""
    import numpy as np
    from vaenar_tts_torch.data.loader import BucketedLoader
    from vaenar_tts_torch.data.records import list_shards
    shards = sorted(list_shards(data_dir, "train"))
    local_bs = hp.train.train_batch_size // nprocs
    loaders = [BucketedLoader(shards[i::nprocs], local_bs, hp.dataset.mel_bucket,
                              hp.dataset.text_bucket, shuffle=hp.train.shuffle,
                              seed=hp.train.random_seed + i, drop_last=True)
               for i in range(nprocs)]
    cap = min(len(ld) for ld in loaders)
    sched = np.max([ld.epoch_shape_schedule(epoch, n_steps=cap) for ld in loaders], axis=0)
    for parts in zip(*(ld.epoch(epoch, shape_schedule=sched) for ld in loaders)):
        yield join_batches(parts, device)


def fleet_mirror(hp, data_dir, nprocs, n_steps, device):
    """One process on the global batches of an ``nprocs`` fleet of
    ``cli.train --distributed`` over ``data_dir`` (the same shard partition,
    loaders, lockstep schedules and generators): the cold start, then
    epoch 1's first ``n_steps`` steps and its dev pass. Returns (the steps'
    metrics, the dev losses, the model and its optimizer)."""
    import numpy as np
    import torch
    from vaenar_tts_torch.data.loader import BucketedLoader, repad_batch
    from vaenar_tts_torch.data.records import list_shards
    from vaenar_tts_torch.training import loop, steps

    local_bs = hp.train.train_batch_size // nprocs
    mb, tb, seed = hp.dataset.mel_bucket, hp.dataset.text_bucket, hp.train.random_seed

    def global_batches(epoch):
        return fleet_global_batches(hp, data_dir, nprocs, epoch, device)

    model = steps.init_model(hp, seed, device)
    optimizer = steps.make_optimizer(hp, model)
    gen = loop.epoch_generator(device, seed, 0)
    first = next(global_batches(0))
    texts, mels, t_lens, m_lens = first
    steps.run_data_dependent_init(model, texts, t_lens, m_lens, mels.shape[1], generator=gen)
    steps.train_step(model, optimizer, hp, *first, hp.train.kl_weight_init,
                     hp.common.max_reduction_factor, gen)
    gen = loop.epoch_generator(device, seed, 1)
    kl_w, r = hp.train.kl_weight_at(1), hp.train.reduction_factor_at(1)
    got = []
    for i, batch in enumerate(global_batches(1)):
        if i >= n_steps:
            break
        got.append(steps.metric_floats(steps.train_step(model, optimizer, hp, *batch, kl_w, r,
                                                        gen)))
    dev_loaders = [BucketedLoader(list_shards(data_dir, "dev"), local_bs, mb, tb, shuffle=False,
                                  seed=seed, shard_index=p, shard_count=nprocs)
                   for p in range(nprocs)]
    dev_groups = -(-dev_loaders[0].num_utterances // local_bs)
    dev_steps = -(-dev_groups // nprocs)
    sched = np.max([ld.epoch_shape_schedule(0, n_steps=dev_steps) for ld in dev_loaders], axis=0)
    slices = [list(ld.epoch(1, shape_schedule=sched)) for ld in dev_loaders]
    sums, n_utts = {}, 0
    for s in range(dev_steps):
        parts, masks, n_valid = [], [], 0
        for p in range(nprocs):
            if s < len(slices[p]):
                b, nv = slices[p][s], slices[p][s].n_valid
            else:  # a dry process re-feeds its last batch with no real rows
                b, nv = repad_batch(slices[p][-1], int(sched[s][0]), int(sched[s][1])), 0
            parts.append(b)
            masks.append((np.arange(b.texts.shape[0]) < nv).astype(np.float32))
            n_valid += nv
        m = steps.metric_floats(steps.dev_step(
            model, hp, *join_batches(parts, device), kl_w,
            torch.from_numpy(np.concatenate(masks)).to(device), r, gen))
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + v * n_valid
        n_utts += n_valid
    return got, {k: v / max(n_utts, 1) for k, v in sums.items()}, model, optimizer


FLEET_STEP_RE = r"step (\d+): (kl [^,]+, len_l2 [^,]+, len_pinball [^,]+, mel_l2 [^,]+, total [^,]+), time ([\d.]+)s"


def fleet_log(text):
    """A fleet process's output -> ({epoch: [(loss fields, step seconds)]},
    {epoch: dev losses})."""
    import re
    steps_, devs, cur = {}, {}, None
    for line in text.splitlines():
        m = re.match(r"Epoch (\d+): kl_weight", line)
        if m:
            cur = int(m.group(1))
            steps_[cur] = []
            continue
        s = re.search(FLEET_STEP_RE, line)
        if cur is not None and s:
            steps_[cur].append((s.group(2), float(s.group(3))))
        d = re.match(r"Epoch (\d+) dev: (\{.*\})", line)
        if d:
            devs[int(d.group(1))] = json.loads(d.group(2).replace("'", '"'))
    return steps_, devs


def loss_fields(fields):
    return {k: float(v) for k, v in (p.split(" ") for p in fields.split(", "))}


def spawn_fleet(root, tag, data_dir, nprocs, max_epochs, extra=(), ckpt=None):
    """``cli.train --distributed`` in ``nprocs`` processes on the one card
    (gloo), the shipped hparams.json, checkpoints in ``ckpt_<ckpt or
    tag>``, output to files. Returns (processes, output paths, log dirs)."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs, outs, logs = [], [], []
    for pid in range(nprocs):
        env = dict(os.environ, PYTHONUNBUFFERED="1", VAENAR_DIST_BACKEND="gloo",
                   VAENAR_COORDINATOR=f"localhost:{port}", VAENAR_NUM_PROCESSES=str(nprocs),
                   VAENAR_PROCESS_ID=str(pid))
        log_dir = os.path.join(root, f"logs_{tag}_p{pid}")
        cmd = [sys.executable, "-m", "vaenar_tts_torch.cli.train", "--dataset", "ljspeech",
               "--data_dir", data_dir, "--model_dir", os.path.join(root, f"ckpt_{ckpt or tag}"),
               "--log_dir", log_dir, "--device", DEVICE, "--distributed", "--no-draw_plots",
               "--max_epochs", str(max_epochs),
               "--steps_per_epoch", str(FLEET_STEPS), "--log_every", "1",
               "--hparams", os.path.join(MODEL_DIR, "hparams.json"), *extra]
        out = os.path.join(root, f"out_{tag}_p{pid}.txt")
        with open(out, "w") as f:
            procs.append(subprocess.Popen(cmd, cwd=HERE, env=env, stdout=f,
                                          stderr=subprocess.STDOUT))
        outs.append(out)
        logs.append(log_dir)
    return procs, outs, logs


def wait_fleet(procs, outs, logs):
    """Wait for a fleet (killed after FLEET_TIMEOUT_S); every process must
    exit 0. Returns (outputs, the processes' process_<i>.json reports)."""
    deadline = time.time() + FLEET_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for out in outs:
        with open(out) as f:
            texts.append(f.read())
    for pid, (p, text) in enumerate(zip(procs, texts)):
        check(p.returncode == 0, f"fleet process {pid} exited {p.returncode}: {text[-3000:]}")
    reports = []
    for pid, log in enumerate(logs):
        with open(os.path.join(log, f"process_{pid}.json")) as f:
            reports.append(json.load(f))
    return texts, reports


def fleet_counts(reports):
    """The kernel launches of a fleet's processes, summed."""
    total = {}
    for r in reports:
        for k, v in r["launch_counts"].items():
            total[k] = total.get(k, 0) + v
    return total


def write_ljspeech_scale_records(data_dir, n=2048, shards=8, seed=5):
    """``n`` utterances of random mels at LJSpeech's lengths (~570 frames,
    70-870, at 22.05 kHz and hop 256; text a sixth of that) in ``shards``
    train shards: the data size a packer meets in a real run (~370 MB)."""
    import numpy as np
    from vaenar_tts_torch.data.records import RecordShardWriter
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    writers = [RecordShardWriter(os.path.join(data_dir, f"train-{i}.vrs"), 80)
               for i in range(shards)]
    for k in range(n):
        ml = int(np.clip(rng.normal(570, 190), 70, 870))
        tl = max(8, ml // 6)
        writers[k % shards].add(f"LJS-{k:05d}", rng.integers(3, 60, tl).astype(np.int32),
                                rng.standard_normal((ml, 80), np.float32))
    for w in writers:
        w.close()


def native_packer_phase(records, tmp, smi):
    """The loader over ``records``' train shards and over a corpus at
    LJSpeech's scale (batch 32, the shipped buckets): the native packer
    runs, every epoch of its batches equals the numpy path's to the byte,
    and an epoch's assembly is timed each way, one batch alive at a time as
    the training loop holds them, 5 epochs a way interleaved (medians)."""
    import numpy as np
    from vaenar_tts_torch import native
    from vaenar_tts_torch.data.loader import BucketedLoader
    from vaenar_tts_torch.data.records import list_shards
    phase("native_packer")
    big = os.path.join(tmp, "ljspeech_scale_records")
    write_ljspeech_scale_records(big)
    report = {"card": smi, "host_cpu": os.cpu_count()}
    for name, data in (("toy", records), ("ljspeech_scale", big)):
        paths = list_shards(data, "train")
        fast = BucketedLoader(paths, 32, 480, 32, seed=1)
        slow = BucketedLoader(paths, 32, 480, 32, seed=1, native=False)
        check(fast.packer == "native" and slow.packer == "numpy",
              f"packers {fast.packer}/{slow.packer}: the native packer did not build "
              f"({native.failure()})")
        equal = len(fast) == len(slow) > 0 and all(
            a.fids == b.fids and a.n_valid == b.n_valid and all(
                getattr(a, k).tobytes() == getattr(b, k).tobytes()
                for k in ("texts", "mels", "text_lengths", "mel_lengths"))
            for a, b in zip(fast.epoch(0), slow.epoch(0)))  # also warms both
        check(equal, f"{name}: native batches differ from the numpy path's")
        seconds = {"native": [], "numpy": []}
        for e in range(1, 6):
            for way, loader in (("native", fast), ("numpy", slow)):
                t = time.perf_counter()
                for _ in loader.epoch(e):
                    pass
                seconds[way].append(time.perf_counter() - t)
        report[name] = {"utterances": fast.num_utterances, "batches": len(fast),
                        "equal_to_the_byte": equal, "epoch_assembly_s": seconds,
                        "median_s": {k: float(np.median(v)) for k, v in seconds.items()}}
    print(json.dumps(report), flush=True)
    shutil.rmtree(big)
    return report


def distributed_phases(torch, tmp, smi, init_pass, per_step):
    """Two-process fleets of ``cli.train --distributed`` on the one card
    (gloo) at the shipped config, full width: fp32 against one process on
    the same global batches; bf16, 3 epochs, against its own processes and
    timed against one process's step; SIGTERM to a bf16 fleet and its
    resume against the 3-epoch fleet, to the last bit. Returns {path:
    launches summed over the processes}."""
    from vaenar_tts_torch.configs.overrides import apply_overrides
    from vaenar_tts_torch.configs.serialize import load_hparams
    from vaenar_tts_torch.training import steps
    import signal
    phase("distributed_training")
    root = os.path.join(tmp, "fleet")
    records = os.path.join(root, "records")
    os.makedirs(records)
    write_fleet_records(records, seed=2032)
    paths = {}
    # one fleet at a time on the card, so that the bf16 one's step walls
    # are its own
    f32_out, f32_rep = wait_fleet(*spawn_fleet(root, "fp32", records, 2, 1,
                                               ["--compute_dtype", "float32"]))
    b16_out, b16_rep = wait_fleet(*spawn_fleet(root, "bf16", records, 2, 3))
    paths["fleet_fp32"], paths["fleet_bf16"] = fleet_counts(f32_rep), fleet_counts(b16_rep)
    hp32 = apply_overrides(load_hparams(MODEL_DIR), ["train.compute_dtype=float32"])
    ref_steps, ref_dev, _, _ = fleet_mirror(hp32, records, 2, FLEET_STEPS, torch.device(DEVICE))
    logs32 = [fleet_log(t) for t in f32_out]
    logs16 = [fleet_log(t) for t in b16_out]
    got = [loss_fields(f) for f, _ in logs32[0][0][1]]
    rel = {f"step{i + 1}_{k}": abs(g[k] - w[k]) / abs(w[k])
           for i, (g, w) in enumerate(zip(got, ref_steps)) for k in w}
    rel.update({f"dev_{k}": abs(logs32[0][1][1][k] - v) / abs(v) for k, v in ref_dev.items()})
    import re
    sched = re.search(r"lockstep bucket schedule \(epoch 0\): (\d+) distinct shapes (.*?); "
                      r"scheduled mel frames = ([\d.]+)%", f32_out[0])
    # one process's bf16 steps on the global batches of the bf16 fleet's
    # epochs 2 and 3, timed as the loop times a step (host clock around
    # train_step, which ends in Adam's update), after a warm-up step
    hp16 = load_hparams(MODEL_DIR)
    _, _, model16, optimizer = fleet_mirror(hp16, records, 2, 1, torch.device(DEVICE))
    walls, shapes = [], []
    for e in (2, 3):
        for i, batch in enumerate(fleet_global_batches(hp16, records, 2, e,
                                                       torch.device(DEVICE))):
            if i >= FLEET_STEPS:
                break
            torch.cuda.synchronize()
            t = time.perf_counter()
            steps.train_step(model16, optimizer, hp16, *batch, hp16.train.kl_weight_at(e),
                             hp16.train.reduction_factor_at(e))
            walls.append(time.perf_counter() - t)
            shapes.append(list(batch[1].shape))
    fleet_walls = [s for e in (2, 3) for _, s in logs16[0][0].get(e, [])]
    local_bs = hp16.train.train_batch_size // 2
    n_dev = -(-(-(-N_DEV // local_bs)) // 2)  # dev steps a process
    expected = {}
    for name, epochs, dt in (("fleet_fp32", 1, ""), ("fleet_bf16", 3, "_tc")):
        n_steps = 1 + epochs * FLEET_STEPS
        expected[name] = {f"masked_attention_fwd{dt}": 2 * (init_pass + per_step * (
            n_steps + epochs * n_dev)), f"masked_attention_bwd_dq{dt}": 2 * per_step * n_steps,
            f"masked_attention_bwd_dkv{dt}": 2 * per_step * n_steps}
    print(json.dumps({
        "card": smi, "fleet": "2 processes on one card, gloo",
        "records": {"train_shards": FLEET_SHARDS, "per_shard": FLEET_PER_SHARD, "dev": N_DEV},
        "schedule_line": sched.group(0) if sched else None,
        "fp32_steps": got, "fp32_steps_one_process": ref_steps,
        "fp32_dev": logs32[0][1].get(1), "fp32_dev_one_process": ref_dev,
        "max_rel_diff": max(rel.values()) if rel else None, "rel_diff": rel,
        "bf16_dev": logs16[0][1], "devices": [r["device"] for r in f32_rep + b16_rep],
        "backends": sorted({r["backend"] for r in f32_rep + b16_rep}),
        "packers": sorted({r["packer"] for r in f32_rep + b16_rep}),
        "checkpoints_written": {t: [r["checkpoints_written"] for r in rep]
                                for t, rep in (("fp32", f32_rep), ("bf16", b16_rep))},
        "bf16_step_wall_s_fleet_process0": fleet_walls,
        "bf16_step_wall_s_one_process_global_batch": walls,
        "global_batches_timed": shapes, "launches": paths,
        "launches_expected": expected}), flush=True)
    check(len(got) == len(ref_steps) == FLEET_STEPS and max(rel.values()) <= TOL_FLEET_REL,
          f"fp32 fleet against one process: {rel}")
    for logs in (logs32, logs16):
        check([[f for f, _ in s] for s in logs[0][0].values()]
              == [[f for f, _ in s] for s in logs[1][0].values()] and logs[0][1] == logs[1][1],
              "the fleet's processes logged different losses")
    check(sched is not None and int(sched.group(1)) >= 2 and float(sched.group(3)) < 100.0,
          f"lockstep schedule: {sched.group(0) if sched else f32_out[0][-2000:]}")
    check(all(r["checkpoints_written"] for r in (f32_rep[0], b16_rep[0]))
          and not any(r["checkpoints_written"] for r in (f32_rep[1], b16_rep[1])),
          "a process other than 0 wrote checkpoints, or process 0 none")
    check(all(r["packer"] == "native" and r["backend"] == "gloo" for r in f32_rep + b16_rep),
          "a fleet process ran without the native packer or without gloo")
    check(all(math.isfinite(v) for e in logs16[0][0].values() for f, _ in e
              for v in loss_fields(f).values()) and len(logs16[0][0]) == 3,
          "bf16 fleet: non-finite or missing losses")
    for name in expected:
        check(paths[name] == expected[name], f"{name} launches {paths[name]} != "
              f"{expected[name]}")

    phase("distributed_sigterm_resume")
    procs, outs, logs = spawn_fleet(root, "sig", records, 2, 30)
    deadline = time.time() + FLEET_TIMEOUT_S
    try:
        while True:  # both processes past their cold start and its handler
            started = []
            for out in outs:
                with open(out) as f:
                    started.append("Epoch 1: kl_weight" in f.read())
            if all(started):
                break
            check(time.time() < deadline and all(p.poll() is None for p in procs),
                  "the SIGTERM fleet did not reach epoch 1")
            time.sleep(0.05)
        for p in procs:
            p.send_signal(signal.SIGTERM)
    finally:
        sig_out, sig_rep = wait_fleet(procs, outs, logs)
    stops = [re.search(r"stopping after epoch (\d+) \(preemption\)", t) for t in sig_out]
    check(all(stops), "a SIGTERM'd process did not stop at an epoch boundary")
    stopped = {int(m.group(1)) for m in stops}
    at = min(stopped)
    res = spawn_fleet(root, "resumed", records, 2, 3, ckpt="sig")
    res_out, res_rep = wait_fleet(*res)
    paths["fleet_sigterm"], paths["fleet_resumed"] = fleet_counts(sig_rep), fleet_counts(res_rep)
    full, resumed = fleet_log(b16_out[0]), fleet_log(res_out[0])
    equal3 = ([f for f, _ in resumed[0].get(3, [])] == [f for f, _ in full[0][3]]
              and resumed[1].get(3) == full[1][3])
    print(json.dumps({"card": smi, "stopped_at": sorted(stopped),
                      "return_codes": [p.returncode for p in procs],
                      "restored": f"Restored from epoch {at}" in res_out[0],
                      "resumed_epochs": sorted(resumed[0]), "epoch3_equal_to_the_bit": equal3,
                      "epoch3_resumed": resumed[0].get(3), "epoch3_uninterrupted": full[0][3],
                      "dev3_resumed": resumed[1].get(3), "dev3_uninterrupted": full[1][3],
                      "launches": {k: paths[k] for k in ("fleet_sigterm", "fleet_resumed")}}),
          flush=True)
    check(len(stopped) == 1 and at in (1, 2), f"the fleet stopped at epochs {stopped}")
    check(f"Restored from epoch {at}" in res_out[0], "the resumed fleet did not restore")
    check(sorted(resumed[0]) == list(range(at + 1, 4)), f"resumed epochs {sorted(resumed[0])}")
    check(equal3, "the resumed fleet's epoch-3 losses differ from the uninterrupted fleet's")
    return paths


def synthesis_worker(rank, port, out_dir):
    """``chip_smoke.py --synthesis-worker RANK PORT OUT``: one of two
    processes of a gloo group on the card: which gloo collectives take CUDA
    tensors in this torch, then ``ShardedSynthesizer`` over the 4 shipped
    lines at fp32, temperature 0 and 0.667 (generator seeded 1234); the
    results and the launch counts to OUT/synthesis_<rank>.pt."""
    import torch
    import torch.distributed as tdist
    sys.path.insert(0, HERE)
    from vaenar_tts_torch.cli.inference import encode_lines, pad_lines
    from vaenar_tts_torch.models.vaenar import load_model
    from vaenar_tts_torch.ops import flash_attention as fa
    from vaenar_tts_torch.parallel.distributed import DistContext
    from vaenar_tts_torch.parallel.synthesis import ShardedSynthesizer
    device = torch.device(DEVICE, 0)
    torch.cuda.set_device(device)
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                             rank=rank)
    dist = DistContext(device)
    probe = {}
    for name, fn in (
            ("all_reduce", lambda t: tdist.all_reduce(t)),
            ("broadcast", lambda t: tdist.broadcast(t, src=0)),
            ("all_gather", lambda t: tdist.all_gather([torch.empty_like(t) for _ in range(2)],
                                                      t)),
            ("reduce", lambda t: tdist.reduce(t, dst=0))):
        try:
            fn(torch.ones(4, device=device))
            torch.cuda.synchronize()
            probe[name] = True
        except Exception as e:  # this collective refuses CUDA tensors
            probe[name] = repr(e)[:200]
        dist.barrier()
    hp, model, _ = load_model(MODEL_DIR, device, "float32")
    batch, text_lens, max_mel = pad_lines(hp, encode_lines(hp, LINES))
    synth = ShardedSynthesizer(hp, model, dist)
    fa.launch_counts.clear()
    result = {"gloo_cuda": probe}
    for temp in (0.0, 0.667):
        gen = torch.Generator(device=device).manual_seed(1234)
        torch.cuda.synchronize()
        t = time.perf_counter()
        mels, lens = synth.synthesize(batch, text_lens, max_mel, temp, gen)
        torch.cuda.synchronize()
        result[f"t{temp}"] = (mels.cpu(), lens.cpu(), time.perf_counter() - t)
    result["launch_counts"] = dict(fa.launch_counts)
    torch.save(result, os.path.join(out_dir, f"synthesis_{rank}.pt"))
    dist.close()
    return 0


def sharded_synthesis_phase(torch, tmp, smi, model32, hp, n_attn):
    """Two processes of ``synthesis_worker`` against one process's
    synthesis of the same lines at fp32 on the card."""
    from vaenar_tts_torch.cli.inference import encode_lines, pad_lines, resolve_length_source
    from vaenar_tts_torch.cli.inference import synthesize
    phase("sharded_synthesis")
    out = os.path.join(tmp, "sharded")
    os.makedirs(out)
    procs = spawn_pair("--synthesis-worker", out)
    texts = finish_pair(procs, FLEET_TIMEOUT_S)
    for r, (p, text) in enumerate(zip(procs, texts)):
        check(p.returncode == 0, f"synthesis process {r} exited {p.returncode}: {text[-3000:]}")
    got = [torch.load(os.path.join(out, f"synthesis_{r}.pt"), weights_only=False)
           for r in range(2)]
    batch, text_lens, max_mel = pad_lines(hp, encode_lines(hp, LINES))
    use_q = resolve_length_source("auto", hp)
    report, ok = {}, True
    for temp in (0.0, 0.667):
        gen = torch.Generator(device=DEVICE).manual_seed(1234)
        torch.cuda.synchronize()
        t = time.perf_counter()
        mels, lens = synthesize(model32, hp, batch, text_lens, max_mel, temp, use_q,
                                generator=gen)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t
        mels, lens = mels.cpu(), lens.cpu()
        errs = [(g[f"t{temp}"][0] - mels).abs().max().item() for g in got]
        same_lens = all(torch.equal(g[f"t{temp}"][1], lens) for g in got)
        report[f"temperature_{temp}"] = {
            "lengths_one_process": lens.tolist(), "lengths_fleet": got[0][f"t{temp}"][1].tolist(),
            "lengths_equal": same_lens, "max_abs_err_mel": errs,
            "max_abs_mel": mels.abs().max().item(), "wall_s_fleet": got[0][f"t{temp}"][2],
            "wall_s_one_process": one_s}
        ok = ok and same_lens and max(errs) <= TOL_SHARDED_MEL
    counts = fleet_counts(got)
    print(json.dumps({"card": smi, "gloo_takes_cuda_tensors": got[0]["gloo_cuda"],
                      **report, "launches": counts}), flush=True)
    check(ok, f"sharded synthesis against one process: {report}")
    check(counts == {"masked_attention_fwd": 2 * n_attn * 2},
          f"sharded synthesis launches {counts}")
    return {"sharded_synthesis": counts}


def ring_case_inputs(torch, device, T, seed):
    """q, k, v fp32 [4, 4, T, 64] and lengths (random, item 3 of length 0)
    of one ring case, the same in every process."""
    q, k, v = random_qkv(torch, device, torch.float32, 4, 4, T, T, 64, seed)
    lens = length_sampler(torch, device, seed)(T, T // 4, (3, 0))
    return q, k, v, lens


def shipped_model(torch, state, device, dtype_name, seq_mesh=None, **train):
    """(hparams, VAENAR) of the shipped configuration at ``dtype_name`` with
    ``train`` fields replaced, on ``device``, holding the export's weights
    (``state``: its load_npz), ringed over ``seq_mesh`` when given."""
    import dataclasses
    from vaenar_tts_torch.configs.serialize import load_hparams
    from vaenar_tts_torch.interop.weights import load_jax_weights
    from vaenar_tts_torch.models.vaenar import VAENAR, resolve_device
    hp = load_hparams(MODEL_DIR)
    hp = dataclasses.replace(hp, train=dataclasses.replace(hp.train, compute_dtype=dtype_name,
                                                           **train))
    model = VAENAR(hp, seq_mesh=seq_mesh)
    load_jax_weights(model, state["params"], state["batch_stats"])
    return hp, model.to(resolve_device(device))


def timed(torch, fn):
    """(fn's result, wall seconds up to the card's idle)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def p2p_probe_worker(rank, port, out_dir):
    """``chip_smoke.py --p2p-probe RANK PORT OUT``: one of two processes that
    try gloo's point-to-point ops (batch_isend_irecv) on a CUDA tensor; what
    happened goes to OUT/p2p_<rank>.json. It may die in gloo."""
    import torch
    import torch.distributed as tdist
    torch.cuda.set_device(0)
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                             rank=rank)
    sent = torch.full((4,), float(rank + 1), device=DEVICE)
    got = torch.zeros_like(sent)
    try:
        for req in tdist.batch_isend_irecv([tdist.P2POp(tdist.isend, sent, 1 - rank),
                                            tdist.P2POp(tdist.irecv, got, 1 - rank)]):
            req.wait()
        torch.cuda.synchronize()
        outcome = {"takes_cuda": True, "received": got.tolist()}
    except RuntimeError as e:  # what gloo says is the finding
        outcome = {"takes_cuda": False, "error": str(e)[:300]}
    with open(os.path.join(out_dir, f"p2p_{rank}.json"), "w") as f:
        json.dump(outcome, f)
    os._exit(0)  # gloo's pairs may be broken: no teardown


def model_axis_worker(rank, port, out_dir):
    """``chip_smoke.py --model-axis-worker RANK PORT OUT``: one of the two
    processes of a model group (mesh data 1 x model 2) on the card: the
    ring at RING cases, tensor-parallel synthesis with the ring over the 4
    shipped lines in fp32 and bf16 at temperature 0 and 0.667 (generator
    seeded 1234; temperature 0 again, warm), an fp32 train step and
    TP_BF16_STEPS bf16 steps with the ring (ring_min_seq 0) on the batch of
    OUT/batch.pt; results, walls and launch counts to OUT/axis_<rank>.pt."""
    import torch
    import torch.distributed as tdist
    sys.path.insert(0, HERE)
    from vaenar_tts_torch.cli.inference import encode_lines, pad_lines
    from vaenar_tts_torch.ops import flash_attention as fa
    from vaenar_tts_torch.parallel.distributed import DistContext
    from vaenar_tts_torch.parallel.mesh import make_mesh, shard_params, unshard_params
    from vaenar_tts_torch.parallel.ring_attention import ring_self_attention
    from vaenar_tts_torch.parallel.synthesis import ShardedSynthesizer
    from vaenar_tts_torch.training import steps
    from vaenar_tts_torch.utils.export import load_npz
    device = torch.device(DEVICE, 0)
    torch.cuda.set_device(device)
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                             rank=rank)
    dist = DistContext(device, make_mesh(data=1, model=2, processes=2))
    result = {"ring": {}, "synthesis": {}}
    with torch.no_grad():
        for i, (name, T, causal) in enumerate(RING_CASES):
            q, k, v, lens = ring_case_inputs(torch, device, T, 300 + i)
            o, _ = timed(torch, lambda: ring_self_attention(q, k, v, lens, dist, 0.125, causal))
            walls = []
            for _ in range(RING_REPS):
                dist.barrier()
                walls.append(timed(torch, lambda: ring_self_attention(q, k, v, lens, dist,
                                                                      0.125, causal))[1])
            result["ring"][name] = {"o": o.cpu(), "wall_ms": [1e3 * w for w in walls]}

    state = load_npz(os.path.join(MODEL_DIR, "export.npz"))
    for dtype_name in ("float32", "bfloat16"):
        hp, model = shipped_model(torch, state, device, dtype_name, seq_mesh=dist)
        batch, text_lens, max_mel = pad_lines(hp, encode_lines(hp, LINES))
        synth = ShardedSynthesizer(hp, model.eval(), dist)
        for tag, temp in (("t0", 0.0), ("t0667", 0.667), ("t0_warm", 0.0)):
            gen = torch.Generator(device=device).manual_seed(1234)
            fa.launch_counts.clear()
            (mels, lens), wall = timed(torch, lambda: synth.synthesize(batch, text_lens, max_mel,
                                                                       temp, gen))
            result["synthesis"][f"{dtype_name}_{tag}"] = {
                "mels": mels.cpu(), "lens": lens.cpu(), "wall_s": wall,
                "launches": dict(fa.launch_counts)}
        del model, synth

    b = [t.to(device) for t in torch.load(os.path.join(out_dir, "batch.pt"))]
    hp, model = shipped_model(torch, state, device, "float32", seq_mesh=dist, ring_min_seq=0)
    shard_params(model, dist.mesh, dist)
    optimizer = steps.make_optimizer(hp, model)
    gen = torch.Generator(device=device).manual_seed(5)
    fa.launch_counts.clear()
    m, wall = timed(torch, lambda: steps.train_step(model, optimizer, hp, *b,
                                                    hp.train.kl_weight_end, 2, gen, dist=dist))
    grads = unshard_params(model, dist.mesh, dist, {n: p.grad for n, p in model.named_parameters()})
    params = unshard_params(model, dist.mesh, dist, dict(model.named_parameters()))
    # the model group's average of the replicated gradients, the one
    # collective a step adds, timed alone (on gradients already equal)
    average_ms = []
    for _ in range(5):
        dist.barrier()
        average_ms.append(1e3 * timed(torch, lambda: dist.average_replicas(model))[1])
    result["train_float32"] = {"metrics": steps.metric_floats(m), "wall_s": wall,
                               "launches": dict(fa.launch_counts),
                               "grads": {n: g.cpu() for n, g in grads.items()},
                               "params": {n: t.cpu() for n, t in params.items()},
                               "average_replicas_ms": average_ms}
    del model, grads, params
    hp, model = shipped_model(torch, state, device, "bfloat16", seq_mesh=dist, ring_min_seq=0)
    shard_params(model, dist.mesh, dist)
    optimizer = steps.make_optimizer(hp, model)
    gen = torch.Generator(device=device).manual_seed(6)
    result["train_bfloat16"] = []
    for _ in range(TP_BF16_STEPS):
        fa.launch_counts.clear()
        m, wall = timed(torch, lambda: steps.train_step(model, optimizer, hp, *b,
                                                        hp.train.kl_weight_end, 2, gen,
                                                        dist=dist))
        result["train_bfloat16"].append({"metrics": steps.metric_floats(m), "wall_s": wall,
                                         "launches": dict(fa.launch_counts)})
    torch.save(result, os.path.join(out_dir, f"axis_{rank}.pt"))
    dist.close()
    return 0


def spawn_pair(flag, out):
    """Two processes of ``chip_smoke.py FLAG RANK PORT OUT`` on a free
    port."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "chip_smoke.py"), flag,
                               str(r), str(port), out], cwd=HERE, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    return procs


def finish_pair(procs, timeout_s):
    """The processes' outputs once they ended; those still running at
    ``timeout_s`` are killed."""
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return texts


def tp_grads_share(got, want):
    """(the largest share of TOL_TP_GRAD that an element's error takes,
    its leaf, the largest error over the largest |want| of all leaves)."""
    atol, rtol = TOL_TP_GRAD
    worst, err_max = (0.0, None), 0.0
    for n, g in want.items():
        d = (got[n] - g).abs()
        worst = max(worst, ((d / (atol + rtol * g.abs())).max().item(), n), key=lambda x: x[0])
        err_max = max(err_max, d.max().item())
    return worst[0], worst[1], err_max / max(g.abs().max().item() for g in want.values())


def model_axis_phases(torch, fa, tmp, smi, hp, model, model32, token_ids, use_q, big, n_attn):
    """Two ``model_axis_worker`` processes (and a point-to-point probe pair
    beside them) against one process on the card: phases ring_attention,
    tensor_parallel_synthesis and tensor_parallel_training."""
    import numpy as np
    from vaenar_tts_torch.cli.inference import pad_lines, synthesize
    from vaenar_tts_torch.training import steps
    from vaenar_tts_torch.utils.export import load_npz
    out = os.path.join(tmp, "model_axis")
    os.makedirs(out)
    torch.save([torch.from_numpy(np.ascontiguousarray(a)) for a in
                (big.texts.astype("int64"), big.mels, big.text_lengths, big.mel_lengths)],
               os.path.join(out, "batch.pt"))
    t_fleet = time.perf_counter()
    probes = spawn_pair("--p2p-probe", out)
    procs = spawn_pair("--model-axis-worker", out)
    texts = finish_pair(procs, FLEET_TIMEOUT_S)
    fleet_s = time.perf_counter() - t_fleet
    probe_texts = finish_pair(probes, 60)
    for r, (p, text) in enumerate(zip(procs, texts)):
        check(p.returncode == 0, f"model-axis process {r} exited {p.returncode}: {text[-3000:]}")
    got = [torch.load(os.path.join(out, f"axis_{r}.pt"), weights_only=False) for r in range(2)]
    p2p = {}
    for r, (p, text) in enumerate(zip(probes, probe_texts)):
        path = os.path.join(out, f"p2p_{r}.json")
        with open(path) if os.path.exists(path) else contextlib.nullcontext() as f:
            p2p[r] = json.load(f) if f else {"died_in_gloo_exit_code": p.returncode,
                                             "output": text[-300:]}
    device = torch.device(DEVICE)

    phase("ring_attention")
    ring_report, ok = {}, True
    for i, (name, T, causal) in enumerate(RING_CASES):
        q, k, v, lens = ring_case_inputs(torch, device, T, 300 + i)
        o_kernel = fa.masked_flash_attention(q, k, v, lens, lens, 0.125, causal)[0]
        kernel_ms = time_ms(torch, lambda: fa.masked_flash_attention(q, k, v, lens, lens,
                                                                     0.125, causal), reps=10)
        kernel_wall = [1e3 * timed(torch, lambda: fa.masked_flash_attention(
            q, k, v, lens, lens, 0.125, causal))[1] for _ in range(RING_REPS)]
        errs = [(g["ring"][name]["o"] - o_kernel.cpu()).abs().max().item() for g in got]
        ring_report[name] = {
            "shape": [4, 4, T, 64], "causal": causal, "lengths": lens.tolist(),
            "max_abs_err_vs_fp32_kernel": errs,
            "ranks_equal": torch.equal(got[0]["ring"][name]["o"], got[1]["ring"][name]["o"]),
            "ring_wall_ms_per_call": [g["ring"][name]["wall_ms"] for g in got],
            "kernel_device_ms_per_call": kernel_ms, "kernel_wall_ms_per_call": kernel_wall}
        ok = ok and max(errs) <= TOL_O["float32"][0] and ring_report[name]["ranks_equal"]
    print(json.dumps({"card": smi, "model_group": "data 1 x model 2, gloo, one card",
                      "gloo_point_to_point_cuda_probe": p2p, "fleet_seconds": fleet_s,
                      **ring_report}), flush=True)
    check(ok, f"ring against the fp32 forward kernel: {ring_report}")

    phase("tensor_parallel_synthesis")
    batch, text_lens, max_mel = pad_lines(hp, token_ids)
    r_final = hp.common.final_reduction_factor
    t_red = -(-max_mel // r_final)
    check(t_red >= hp.train.ring_min_seq and t_red % 2 == 0
          and batch.shape[1] < hp.train.ring_min_seq, f"ring eligibility at {t_red}")
    ringed = hp.decoder.nblk + hp.prior.n_blk * hp.prior.n_transformer_blk
    want_calls = n_attn - ringed
    synth_report, ok, counts = {}, True, {}
    for dtype_name, m_ in (("float32", model32), ("bfloat16", model)):
        kname = fa.kernel_name("fwd", getattr(torch, dtype_name))
        for tag, temp in (("t0", 0.0), ("t0667", 0.667), ("t0_warm", 0.0)):
            gen = torch.Generator(device=device).manual_seed(1234)
            (mels, lens), wall = timed(torch, lambda: synthesize(m_, hp, batch, text_lens,
                                                                 max_mel, temp, use_q,
                                                                 generator=gen))
            mels, lens = mels.cpu(), lens.cpu()
            fleet = [g["synthesis"][f"{dtype_name}_{tag}"] for g in got]
            row = {"lengths_one_process": lens.tolist(),
                   "lengths_fleet": [f["lens"].tolist() for f in fleet],
                   "wall_s_one_process": wall, "wall_s_fleet": [f["wall_s"] for f in fleet],
                   "launches_per_process": [f["launches"] for f in fleet]}
            ok = ok and all(f["launches"] == {kname: want_calls} for f in fleet)
            for f in fleet:
                counts[kname] = counts.get(kname, 0) + f["launches"].get(kname, 0)
            if dtype_name == "float32":
                row["max_abs_err_mel"] = [(f["mels"] - mels).abs().max().item() for f in fleet]
                ok = ok and all(torch.equal(f["lens"], lens) for f in fleet) and max(
                    row["max_abs_err_mel"]) <= TOL_SHARDED_MEL
            else:
                shared = [int(torch.minimum(f["lens"], lens).min()) for f in fleet]
                row["mean_abs_mel_diff_shared_frames"] = [
                    (f["mels"][:, :n] - mels[:, :n]).abs().mean().item()
                    for f, n in zip(fleet, shared)]
                len_share = max(((f["lens"] - lens).abs().float()
                                 / (TOL_LEN_BF16[0] * lens.float() + TOL_LEN_BF16[1])).max().item()
                                for f in fleet)
                row["max_share_of_tol_length"] = len_share
                ok = ok and len_share <= 1.0 and max(
                    row["mean_abs_mel_diff_shared_frames"]) <= TOL_TP_BF16_MEL
            for f in fleet:
                ok = ok and bool(torch.isfinite(f["mels"]).all())
            synth_report[f"{dtype_name}_{tag}"] = row
    print(json.dumps({"card": smi, "ringed_self_attention_sites": ringed,
                      "forward_launches_per_call_predicted": want_calls, **synth_report}),
          flush=True)
    check(ok, f"tensor-parallel synthesis against one process: {synth_report}")
    paths = {"tensor_parallel_synthesis": counts}

    phase("tensor_parallel_training")
    state = load_npz(os.path.join(MODEL_DIR, "export.npz"))
    b = [t.to(device) for t in torch.load(os.path.join(out, "batch.pt"))]
    hp32, one = shipped_model(torch, state, device, "float32")
    optimizer = steps.make_optimizer(hp32, one)
    gen = torch.Generator(device=device).manual_seed(5)
    m, wall32 = timed(torch, lambda: steps.train_step(one, optimizer, hp32, *b,
                                                      hp32.train.kl_weight_end, 2, gen))
    ref_m = steps.metric_floats(m)
    ref_g = {n: p.grad.cpu() for n, p in one.named_parameters()}
    del one
    cross = hp.posterior.nblk + hp.decoder.nblk + hp.prior.n_blk * hp.prior.n_transformer_blk
    train_counts, ok = {}, True
    loss_err = {}
    for r, g in enumerate(got):
        f = g["train_float32"]
        loss_err[r] = {k: abs(f["metrics"][k] - v) / max(abs(v), 1e-30) for k, v in ref_m.items()}
        ok = ok and max(loss_err[r].values()) <= TOL_TP_LOSS_REL
        ok = ok and f["launches"] == {fa.kernel_name(kind, torch.float32): cross
                                      for kind in ("fwd", "dq", "dkv")}
        for k_, n_ in f["launches"].items():
            train_counts[k_] = train_counts.get(k_, 0) + n_
    fleet_g = [g["train_float32"]["grads"] for g in got]
    share, leaf, err_global = tp_grads_share(fleet_g[0], ref_g)
    share_ranks, leaf_ranks, _ = tp_grads_share(fleet_g[1], fleet_g[0])
    # the replicas stay bit-equal: the model group averages the replicated
    # gradients (DistContext.average_replicas), which cuDNN's convolution
    # weight gradients would otherwise leave unequal between the processes
    unequal = sorted(n for n in ref_g if not torch.equal(fleet_g[0][n], fleet_g[1][n]))
    fleet_p = [g["train_float32"]["params"] for g in got]
    unequal_params = sorted(n for n in fleet_p[0] if not torch.equal(fleet_p[0][n], fleet_p[1][n]))
    ok = ok and share <= 1.0 and share_ranks <= 1.0 and unequal == [] and unequal_params == []
    hp16, one = shipped_model(torch, state, device, "bfloat16")
    optimizer = steps.make_optimizer(hp16, one)
    gen = torch.Generator(device=device).manual_seed(6)
    walls16, losses16 = [], []
    for _ in range(TP_BF16_STEPS):
        m, w = timed(torch, lambda: steps.train_step(one, optimizer, hp16, *b,
                                                     hp16.train.kl_weight_end, 2, gen))
        walls16.append(w)
        losses16.append(steps.metric_floats(m)["total"])
    del one
    want16 = {fa.kernel_name(kind, torch.bfloat16): cross for kind in ("fwd", "dq", "dkv")}
    for g in got:
        for s_ in g["train_bfloat16"]:
            ok = ok and s_["launches"] == want16 and all(
                math.isfinite(v) for v in s_["metrics"].values())
            for k_, n_ in s_["launches"].items():
                train_counts[k_] = train_counts.get(k_, 0) + n_
    print(json.dumps({
        "card": smi, "batch": list(big.mels.shape), "reduction_factor": 2,
        "launches_per_step_per_process_predicted": cross,
        "float32": {"metrics_one_process": ref_m,
                    "metrics_fleet": [g["train_float32"]["metrics"] for g in got],
                    "loss_rel_err": loss_err, "worst_grad_share_of_tol": share,
                    "worst_grad_leaf": leaf, "max_abs_grad_err_over_max_grad": err_global,
                    "ranks_worst_share_of_tol": share_ranks, "ranks_worst_leaf": leaf_ranks,
                    "ranks_bit_unequal_leaves": unequal,
                    "ranks_bit_unequal_params_after_step": unequal_params,
                    "average_replicas_ms_per_step": [g["train_float32"]["average_replicas_ms"]
                                                     for g in got],
                    "wall_s_one_process": wall32,
                    "wall_s_fleet": [g["train_float32"]["wall_s"] for g in got],
                    "launches_per_process": [g["train_float32"]["launches"] for g in got]},
        "bfloat16": {"total_one_process": losses16, "wall_s_one_process": walls16,
                     "total_fleet": [[s_["metrics"]["total"] for s_ in g["train_bfloat16"]]
                                     for g in got],
                     "wall_s_fleet": [[s_["wall_s"] for s_ in g["train_bfloat16"]]
                                      for g in got],
                     "launches_per_step_per_process": [
                         [s_["launches"] for s_ in g["train_bfloat16"]] for g in got]}}),
          flush=True)
    check(ok, f"tensor-parallel train step against one process: share {share} at {leaf}, "
              f"losses {loss_err}, ranks {share_ranks} at {leaf_ranks}, bit-unequal "
              f"gradients {unequal}, parameters {unequal_params}")
    paths["tensor_parallel_training"] = train_counts
    return paths


def reference_import_phase(torch, fa, tmp, smi, token_ids):
    """The shipped export written as a reference TensorBundle by the port's
    exporter, read back by its importer and synthesized from: the mels and
    lengths equal those of the export's own weights bit for bit. The
    reference has no quantile length head, so both sides drop it and run
    the configuration without one (the mean head)."""
    import dataclasses
    from vaenar_tts_torch.cli.inference import resolve_length_source, synthesize_batch
    from vaenar_tts_torch.configs.serialize import load_hparams
    from vaenar_tts_torch.interop.importer import (export_reference_checkpoint,
                                                   load_reference_checkpoint)
    from vaenar_tts_torch.models.vaenar import build_model
    from vaenar_tts_torch.utils.export import load_npz
    phase("reference_checkpoint_import")
    hp = load_hparams(MODEL_DIR)
    hp = dataclasses.replace(hp, length_predictor=dataclasses.replace(hp.length_predictor,
                                                                      quantile=0.0))
    state = load_npz(os.path.join(MODEL_DIR, "export.npz"))
    params = dict(state["params"])
    params["length_predictor"] = {k: v for k, v in params["length_predictor"].items()
                                  if k != "q_projection"}
    prefix = os.path.join(tmp, "reference", "ckpt-1700")
    _, export_s = timed(torch, lambda: export_reference_checkpoint(prefix, hp, params,
                                                                   state["batch_stats"]))
    (params2, stats2), import_s = timed(torch, lambda: load_reference_checkpoint(
        prefix, hp, verify_crc=True))
    use_q = resolve_length_source("auto", hp)
    fa.launch_counts.clear()
    outs = []
    for p_, s_ in ((params2, stats2), (params, state["batch_stats"])):
        outs.append(synthesize_batch(build_model(hp, p_, s_, DEVICE), hp, token_ids, 0.0, use_q))
    torch.cuda.synchronize()
    counts = dict(fa.launch_counts)
    (mels_b, lens_b), (mels_e, lens_e) = outs
    size = sum(os.path.getsize(os.path.join(os.path.dirname(prefix), f))
               for f in os.listdir(os.path.dirname(prefix)))
    equal = torch.equal(mels_b, mels_e) and torch.equal(lens_b, lens_e)
    print(json.dumps({"card": smi, "bundle_bytes": size, "export_s": export_s,
                      "import_s_with_crc": import_s, "use_length_quantile": use_q,
                      "lengths": lens_b.tolist(), "mels_equal_bit_for_bit": equal,
                      "launches": counts}), flush=True)
    check(not use_q and equal, "the reference bundle's synthesis differs from the export's")
    return {"reference_checkpoint_import": counts}


def card_vs_cpu_train_step(torch, np, fa, hp0, model_dir, data_dir, device, want_launches):
    """One fp32 train step of the newest checkpoint in ``model_dir`` under
    ``hp0`` (compute dtype float32, dropout off), on the card and on the
    CPU, from one state: r = 2, the first train batch of 4 in ``data_dir``,
    injected posterior noise, and the ReLU inputs that round to the other
    side of 0 on the CPU put on the card's side. Checks the card's kernel
    launches against ``want_launches`` and the losses, every gradient
    element and the BatchNorm statistics against the CPU's; returns the
    card's launches."""
    from vaenar_tts_torch.data.loader import BucketedLoader
    from vaenar_tts_torch.data.records import list_shards
    from vaenar_tts_torch.models.vaenar import VAENAR
    from vaenar_tts_torch.training import steps
    from vaenar_tts_torch.training.loop import to_device
    from vaenar_tts_torch.utils.checkpoint import CheckpointManager
    small = next(iter(BucketedLoader(list_shards(data_dir, "train"), 4,
                                     hp0.dataset.mel_bucket, hp0.dataset.text_bucket,
                                     shuffle=False).epoch(0)))
    eps = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 1, small.mels.shape[1] // 2, hp0.common.latent_dim)).astype(np.float32))
    result, signs, ties = [], {}, []
    for dev in (device, torch.device("cpu")):
        m0 = load_trained(VAENAR, CheckpointManager, hp0, model_dir, dev)
        hooks = relu_sign_hooks(torch, m0, signs, None if dev.type == "cuda" else ties)
        fa.launch_counts.clear()
        metrics = steps.train_step(m0, steps.make_optimizer(hp0, m0), hp0,
                                   *to_device(small, dev), 1e-5, 2, epsilon=eps.to(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            fp32_step_counts = dict(fa.launch_counts)
        for h in hooks:
            h.remove()
        result.append((steps.metric_floats(metrics),
                       {n: p.grad.cpu() for n, p in m0.named_parameters()},
                       {n: b.cpu() for n, b in m0.named_buffers()}))
    (card_m, card_g, card_b), (cpu_m, cpu_g, cpu_b) = result
    loss_share = {k: abs(card_m[k] - cpu_m[k])
                  / ((TOL_KL_REL if k == "kl" else TOL_LOSS_REL) * abs(cpu_m[k]))
                  for k in cpu_m}
    zero_grad = bn_fed_conv_biases(torch, m0)
    grad_share = {}
    for n, g in cpu_g.items():
        if n in zero_grad:
            grad_share[n] = (max(card_g[n].abs().max().item(), g.abs().max().item())
                             / (TOL_ZERO_GRAD * cpu_g[zero_grad[n]].abs().max().item()))
        else:
            err, tol = (card_g[n] - g).abs().max().item(), TOL_GRAD_LEAF * g.abs().max().item()
            grad_share[n] = err / tol if tol > 0 else (0.0 if err == 0 else float("inf"))
    worst_grads = sorted(grad_share, key=grad_share.get)[-5:]
    tie_share = max((t[2] for t in ties), default=0.0) / TOL_RELU_TIE
    bn_share = max(((card_b[n].double() - b.double()).abs()
                    / (TOL_BN[1] + TOL_BN[0] * b.double().abs())).max().item()
                   for n, b in cpu_b.items())
    print(json.dumps({"batch": list(small.mels.shape), "launches_card": fp32_step_counts,
                      "loss_card": card_m, "loss_cpu": cpu_m,
                      "share_of_tol_loss": loss_share,
                      "worst_grads_share_of_tol": {n: grad_share[n] for n in worst_grads},
                      "zero_grad_biases_share_of_tol": {n: grad_share[n] for n in zero_grad},
                      "relu_ties": ties, "relu_inputs_per_step": sum(len(v) for v in signs.values()),
                      "max_share_of_tol_relu_tie": tie_share,
                      "max_share_of_tol_batch_stats": bn_share}), flush=True)
    check(fp32_step_counts == want_launches,
          f"fp32 train step launched {fp32_step_counts}, expected {want_launches}")
    check(max(loss_share.values()) <= 1.0, f"card vs CPU loss error {loss_share}")
    check(max(grad_share.values()) <= 1.0, "card vs CPU gradient error")
    check(tie_share <= 1.0, f"a ReLU input on another side of 0 by more than rounding: {ties}")
    check(bn_share <= 1.0, f"card vs CPU BatchNorm statistics, {bn_share} of tolerance")
    return fp32_step_counts


def merge_worst(into, *found):
    """Fold a check's nested {kernel: {key: value}} dicts (its errors, its
    shares of the tolerance) into the dicts of ``into``, keeping the larger
    value of each."""
    for merged, nested in zip(into, found):
        for kernel, by_key in nested.items():
            for key, value in by_key.items():
                merged.setdefault(kernel, {})[key] = max(
                    merged.get(kernel, {}).get(key, 0.0), value)


def head_widths_phase(torch, np, fa, tmp, data_dir, device, token_ids, use_q, n_attn,
                      init_pass, per_step, shipped_walls):
    """The shipped LJSpeech config at its attention width, 256, in 2 heads
    (D = 128), in 1 (D = 256), the kernels' second and third
    instantiations, and in 8 (D = 32, zero padded to the D = 64 kernels),
    and at attention width WIDE_MODEL_DIM in 1 head (D = 384, the wide
    kernels; the posterior's input width follows), in every stack, from
    fresh weights of ``cli.train``'s seeded
    cold start on the 64 train and 32 dev records of ``data_dir`` at batch
    32, r = 2. At D = 128, 256 and 384 (``native``): bf16 ``cli.train``
    through the device data cache for one epoch, eagerly and as a CUDA
    graph (``train.device_cache_epoch_scan``), the two equal to the bit;
    the eager run's state synthesizes the 4 lines at temperature 0 in bf16
    and in fp32 (the fp32 mels against the CPU's, lengths equal); an fp32
    train step at batch 4 against the CPU's (card_vs_cpu_train_step); the
    launches of one train step at batch 32 in each dtype, and at D = 384
    alone, the newest width, those steps and synthesis timed beside the
    shipped D = 64 walls ``shipped_walls``; then that width's kernels at
    this model's sites (card, bound, plain and SDPA ms), and at D = 384's
    sites the wide kernels at D = 512 too. D = 32: the same two bf16
    epochs, equal to the bit (the graph captures the wrapper's pad and
    slice copies), bf16 synthesis and fp32 synthesis against the CPU.
    Every run checks which kernels it launched, and how often; the report
    gives each width's seconds by part (``d<D>_seconds``). Returns
    ({path: launches}, {kernel: launches replayed in the graphs, at every
    width}, {D: {"fwd": synthesis timing totals, "long": the 1024 x 4104
    case's, "bwd": train step timing totals, each by dtype}}) for D = 128,
    256, 384 and 512."""
    from vaenar_tts_torch.cli import train as cli_train
    from vaenar_tts_torch.cli.inference import synthesize_batch
    from vaenar_tts_torch.configs.overrides import apply_overrides
    from vaenar_tts_torch.configs.serialize import load_hparams
    from vaenar_tts_torch.data.loader import BucketedLoader
    from vaenar_tts_torch.data.records import list_shards
    from vaenar_tts_torch.models.vaenar import VAENAR
    from vaenar_tts_torch.training import steps
    from vaenar_tts_torch.training.loop import to_device
    from vaenar_tts_torch.utils.checkpoint import CheckpointManager
    phase("head_widths")
    paths, report = {}, {}
    n_train = N_TRAIN // 32  # steps an epoch at batch 32
    n_dev = -(-N_DEV // 32)

    def train(heads, dim, tag, extra, argv_extra=()):
        """``cli.train`` from a cold start at ``heads`` heads of ``dim`` /
        ``heads`` a stack, one epoch at r = 2 with the overrides ``extra``;
        its launches are path head_widths_d<D>_<tag>'s. Returns (history,
        model directory)."""
        model_dir = os.path.join(tmp, f"heads{heads}_dim{dim}_{tag}")
        argv = ["--dataset", "ljspeech", "--data_dir", data_dir, "--model_dir", model_dir,
                "--log_dir", model_dir + "_logs", "--device", str(device), "--max_epochs", "1",
                "--hparams", os.path.join(MODEL_DIR, "hparams.json"), "--no-draw_plots",
                *argv_extra]
        # the posterior's blocks add their attention's output to their
        # input (the JAX package's CrossAttentionBlock needs the two widths
        # equal), so its input width, posterior.pre_hidden, follows dim
        for o in [f"{stack}.attention_heads={heads}" for stack in HEAD_STACKS] + [
                f"{stack}.attention_dim={dim}" for stack in HEAD_STACKS] + [
                f"posterior.pre_hidden={dim}", "train.reduction_factors=(2,)",
                "train.reduce_interval=(0,)", *extra]:
            argv += ["--override", o]
        fa.launch_counts.clear()
        history, _ = run_cli(cli_train.main, argv)
        torch.cuda.synchronize()
        paths[f"head_widths_d{dim // heads}_{tag}"] = dict(fa.launch_counts)
        check(all(np.isfinite(v) for split in ("train", "dev") for m in history[split].values()
                  for v in m.values()), f"{heads} heads, {tag}: a non-finite loss")
        return history, model_dir

    def synthesize(model, hp, tag, want):
        """Synthesis of the 4 lines at temperature 0: (mels, lengths); its
        launches are a path of their own and must be ``want``."""
        fa.launch_counts.clear()
        mels, lens = synthesize_batch(model, hp, token_ids, 0.0, use_q)
        torch.cuda.synchronize()
        paths[tag] = dict(fa.launch_counts)
        check(paths[tag] == want, f"{tag}: launched {paths[tag]}, expected {want}")
        check(bool(torch.isfinite(mels).all()), f"{tag}: non-finite mel")
        return mels, lens

    def card_vs_cpu_synthesis(hp, model_dir, tag, want):
        """fp32 synthesis of the 4 lines on the card and on the CPU from the
        state in ``model_dir``: equal lengths, mels within TOL_MEL_CARD_CPU."""
        hp32 = apply_overrides(hp, ["train.compute_dtype=float32"])
        mels, lens = synthesize(load_trained(VAENAR, CheckpointManager, hp32, model_dir, device),
                                hp32, tag, want)
        cpu = load_trained(VAENAR, CheckpointManager, hp32, model_dir, torch.device("cpu"))
        mels_cpu, lens_cpu = synthesize_batch(cpu, hp32, token_ids, 0.0, use_q)
        err = (mels.cpu() - mels_cpu).abs().max().item()
        report[tag] = {"lengths_card": lens.tolist(), "lengths_cpu": lens_cpu.tolist(),
                       "max_abs_err_mel": err, "tolerance": TOL_MEL_CARD_CPU}
        check(torch.equal(lens.cpu(), lens_cpu), f"{tag}: card lengths {lens} != CPU {lens_cpu}")
        check(err <= TOL_MEL_CARD_CPU, f"{tag}: card vs CPU mel error {err}")

    def epochs(heads, dim=256):
        """One bf16 epoch at ``heads`` heads of ``dim`` / ``heads`` through
        the device data cache, eagerly and as a CUDA graph
        (``train.device_cache_epoch_scan``), from the same cold start: each
        run's launches of the kernels of this width, the runner's replays
        and captured launches, the losses equal to the bit. Returns (the
        eager run's model directory, the kernels' names by kind, {kernel:
        launches replayed})."""
        D = dim // heads
        cache = [f"train.device_data_cache_mb={LOOP_CACHE_MB}"]
        eager, eager_dir = train(heads, dim, "bf16_eager",
                                 cache + ["train.device_cache_epoch_scan=false"])
        graphed, _ = train(heads, dim, "bf16_graphed",
                           cache + ["train.device_cache_epoch_scan=true"])
        names = {kind: fa.kernel_name(kind, torch.bfloat16, D) for kind in ("fwd", "dq", "dkv")}
        want_eager = {names["fwd"]: init_pass + per_step * (1 + n_train + n_dev),
                      names["dq"]: per_step * (1 + n_train), names["dkv"]: per_step * (1 + n_train)}
        want_graphed = {names["fwd"]: init_pass + per_step * (1 + steps.WARMUP_STEPS + 1 + n_dev),
                        names["dq"]: per_step * (steps.WARMUP_STEPS + 2),
                        names["dkv"]: per_step * (steps.WARMUP_STEPS + 2)}
        runner = graphed["runner"]
        equal = all(graphed[split][1] == eager[split][1] for split in ("train", "dev")) and (
            graphed["initial"] == eager["initial"])
        got_eager = paths[f"head_widths_d{D}_bf16_eager"]
        got_graphed = paths[f"head_widths_d{D}_bf16_graphed"]
        report[f"d{D}_bf16_epoch"] = {"eager": {s: eager[s][1] for s in ("train", "dev")},
                                      "graphed": {s: graphed[s][1] for s in ("train", "dev")},
                                      "equal_to_the_bit": equal, "runner": runner,
                                      "launches_eager": got_eager,
                                      "launches_graphed": got_graphed}
        print(json.dumps({f"head_widths_d{D}": report[f"d{D}_bf16_epoch"]}), flush=True)
        check(eager["cache"] and eager["runner"] is None, f"the eager run's cache {eager['cache']}")
        check(got_eager == want_eager,
              f"D = {D} eager epoch launched {got_eager}, expected {want_eager}")
        check(got_graphed == want_graphed,
              f"D = {D} graphed epoch launched {got_graphed}, expected {want_graphed}")
        check(runner is not None and runner["graphed"] and runner["replays"] == n_train
              and sorted(runner["captured_launches"]) == [2]
              and runner["captured_launches"][2] == {n: per_step for n in names.values()},
              f"D = {D} epoch runner: {runner}")
        check(equal, f"D = {D}: the graphed bf16 epoch's losses differ from the eager epoch's")
        return eager_dir, names, {n: per_step * runner["replays"] for n in names.values()}

    long_case = [c for c in check_cases(torch, device) if c[0] == "long_1024x4104"][0]

    def native(heads, dim=256, walls=False, also=()):
        """D = dim / heads, a native width (128, 256 or 384): one epoch
        eagerly and as a graph from the same cold start; the eager state's
        synthesis in both dtypes and fp32 train step against the CPU; the
        launches of one train step in each dtype, timed with the synthesis
        beside the shipped model's walls when ``walls``; the kernels at
        this model's sites, at D and at each width of ``also``. Returns
        ({kernel: launches replayed}, {width: timing totals})."""
        D = dim // heads
        seconds, t_lap = {}, time.perf_counter()

        def lap(part):
            """Seconds since the last lap into ``seconds[part]``."""
            nonlocal t_lap
            seconds[part], t_lap = time.perf_counter() - t_lap, time.perf_counter()

        eager_dir, names, replayed_d = epochs(heads, dim)
        lap("epochs")
        hp = load_hparams(eager_dir)
        check(hp.encoder.attention_dim // hp.encoder.attention_heads == D,
              f"{hp.encoder.attention_heads} heads of {hp.encoder.attention_dim}")
        hp32 = apply_overrides(hp, ["train.compute_dtype=float32"])
        model = load_trained(VAENAR, CheckpointManager, hp, eager_dir, device)
        mels, lens = synthesize(model, hp, f"head_widths_d{D}_bf16_synthesis",
                                {names["fwd"]: n_attn})
        card_vs_cpu_synthesis(hp, eager_dir, f"head_widths_d{D}_fp32_synthesis",
                              {fa.kernel_name("fwd", torch.float32, D): n_attn})
        lap("synthesis")
        fp32_names = {kind: fa.kernel_name(kind, torch.float32, D) for kind in ("fwd", "dq", "dkv")}
        paths[f"head_widths_d{D}_fp32_step_card_vs_cpu"] = card_vs_cpu_train_step(
            torch, np, fa, apply_overrides(hp32, NO_DROPOUT), eager_dir, data_dir, device,
            {n: per_step for n in fp32_names.values()})
        lap("fp32_step_card_vs_cpu")

        # the launches of one train step at batch 32 in each dtype; at the
        # newest width, walls beside the shipped model's (the steps timed
        # and counted, and the synthesis); the kernels at this model's sites
        big = next(iter(BucketedLoader(list_shards(data_dir, "train"), 32, hp.dataset.mel_bucket,
                                       hp.dataset.text_bucket, shuffle=False).epoch(0)))
        batch = to_device(big, device)
        reps = 5 if walls else 1
        step_walls = {}
        for dtype_name, h_, want in (("bfloat16", hp, names), ("float32", hp32, fp32_names)):
            m_ = load_trained(VAENAR, CheckpointManager, h_, eager_dir, device)
            walls_t, counts = train_step_times(torch, fa, steps, m_, h_, batch, 2, reps=reps,
                                               warmup=2 if walls else 0)
            # the counted steps' launches (not the warm-up's)
            paths[f"head_widths_d{D}_{dtype_name}_" + ("timed_steps" if walls else "step")] = {
                n: int(round(c * reps)) for n, c in counts.items()}
            step_walls[dtype_name] = statistics.median(walls_t)
            check(counts == {n: float(per_step) for n in want.values()},
                  f"launches per D = {D} {dtype_name} train step: {counts}")
        if walls:
            synthesis_walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                synthesize_batch(model, hp, token_ids, 0.0, use_q)
                torch.cuda.synchronize()
                synthesis_walls.append(time.perf_counter() - t)
            print(json.dumps({"head_widths_walls": {
                "head_dim": D,
                "synthesis_s": {f"d{D}_bfloat16": synthesis_walls,
                                "d64_shipped_bfloat16": shipped_walls["synthesis"],
                                f"d{D}_mel_lengths": lens.tolist(),
                                "d64_mel_lengths": shipped_walls["synthesis_lengths"]},
                "train_step_median_s_r2_batch32": {
                    f"d{D}": step_walls, "d64_shipped": shipped_walls["train_step"]}}}),
                  flush=True)
        lap("steps_and_walls")
        sites = synthesis_sites(torch, hp, token_ids, lens, mels.shape[1], device)
        step_sites = train_sites(torch, hp, big, device)
        timing = {}
        for width in (D, *also):
            timing[width] = {"fwd": {}, "long": {}, "bwd": {}}
            for dtype_name in ("bfloat16", "float32"):
                timing[width]["fwd"][dtype_name] = time_kernels(torch, fa, device, sites,
                                                                dtype_name, heads, width)
                timing[width]["long"][dtype_name] = time_kernels(
                    torch, fa, device, [(long_case[0], 1, *long_case[1:])], dtype_name, heads,
                    width)
                timing[width]["bwd"][dtype_name] = time_backward(torch, fa, device, step_sites,
                                                                 dtype_name, heads, width)
            lap(f"kernel_times_d{width}")
        report[f"d{D}_seconds"] = seconds
        return replayed_d, timing

    replayed, timing = {}, {}
    for heads, dim, walls, also in ((2, 256, False, ()), (1, 256, False, ()),
                                    (1, WIDE_MODEL_DIM, True, (512,))):
        replayed_d, timing_d = native(heads, dim, walls, also)
        replayed.update(replayed_d)
        timing.update(timing_d)

    # D = 32, zero padded to the D = 64 kernels, the pad and slice copies
    # captured in the graphed epoch
    t_d32 = time.perf_counter()
    d32_dir, base, d32_replayed = epochs(8)
    check(base == {kind: fa.kernel_name(kind, torch.bfloat16) for kind in ("fwd", "dq", "dkv")},
          f"D = 32 takes {base}, expected the D = 64 kernels")
    for n, c in d32_replayed.items():
        replayed[n] = replayed.get(n, 0) + c
    hp8 = load_hparams(d32_dir)
    synthesize(load_trained(VAENAR, CheckpointManager, hp8, d32_dir, device), hp8,
               "head_widths_d32_bf16_synthesis", {base["fwd"]: n_attn})
    card_vs_cpu_synthesis(hp8, d32_dir, "head_widths_d32_fp32_synthesis",
                          {fa.kernel_name("fwd", torch.float32): n_attn})
    report["d32_seconds"] = time.perf_counter() - t_d32
    print(json.dumps({"head_widths": report, "launches": paths}), flush=True)
    return paths, replayed, timing


def load_trained(VAENAR, CheckpointManager, hp, model_dir, device):
    """The model of ``hp`` (its compute dtype) with the newest checkpoint of
    ``model_dir`` restored, on ``device``."""
    model = VAENAR(hp).to(device)
    CheckpointManager(model_dir).restore(model)
    return model


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "vaenar_tts_torch")) or not os.path.isdir(MODEL_DIR):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from scipy.io import wavfile
    from vaenar_tts_torch.audio.export import TestUtils
    from vaenar_tts_torch.audio.streaming import StreamingVocoder
    from vaenar_tts_torch.cli import inference as cli_inference
    from vaenar_tts_torch.cli import train as cli_train
    from vaenar_tts_torch.cli.inference import (encode_lines, resolve_length_source,
                                                synthesize_batch)
    from vaenar_tts_torch.ops import griffin_lim as gl
    from vaenar_tts_torch.ops import stft as ops_stft
    from vaenar_tts_torch.configs.overrides import apply_overrides
    from vaenar_tts_torch.configs.serialize import load_hparams
    from vaenar_tts_torch.data.loader import BucketedLoader
    from vaenar_tts_torch.data.records import list_shards
    from vaenar_tts_torch.models.vaenar import VAENAR, load_model
    from vaenar_tts_torch.ops import _build
    from vaenar_tts_torch.ops import flash_attention as fa
    from vaenar_tts_torch.training import steps
    from vaenar_tts_torch.training.loop import to_device
    from vaenar_tts_torch.utils.checkpoint import CheckpointManager
    from vaenar_tts_torch.utils.export import export_model_dir

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
                      "dynamic_shared_bytes_per_block": {
                          name: getattr(lib, f"{name}_shared_bytes")()
                          for name, _ in _build.KERNELS}}), flush=True)

    phase("kernel_checks")
    # the native widths (64, 128, 256 and the wide kernels' 384 and 512) on
    # every case; the padded widths on a subset, their errors folded into
    # the native kernel that served them; D = 1024 on one small case. Each
    # kernel's largest errors by dtype, and its shares of the tolerances at
    # the native and at the padded widths
    worst, shares = {}, {}
    widths = (*fa.KERNEL_HEAD_DIMS, *WIDE_WIDTHS, *PADDED_WIDTHS, UNCAPPED_WIDTH)

    def cases(D, padded_cases):
        if D == UNCAPPED_WIDTH:
            return UNCAPPED_CASES
        return None if is_native(fa, D) else padded_cases

    for D in widths:
        merge_worst((worst, shares), *check_kernels(torch, fa, device, D,
                                                    cases(D, PADDED_FWD_CASES)))

    phase("backward_checks")
    for D in widths:
        merge_worst((worst, shares), *check_backward(torch, fa, device, D,
                                                     cases(D, PADDED_BWD_CASES)))
    print(json.dumps({"backward_device_kernels": check_backward_launches(torch, fa, device)}),
          flush=True)

    phase("load")
    hp, model, epoch = load_model(MODEL_DIR, device)
    check(hp.train.compute_dtype == "bfloat16",
          f"the shipped config says compute_dtype {hp.train.compute_dtype}, expected bfloat16")
    use_q = resolve_length_source("auto", hp)
    check(all(100 <= len(line) <= 150 for line in LINES), "lines must be 100-150 characters")
    token_ids = encode_lines(hp, LINES)
    flow_attn = 2 * hp.prior.n_blk * hp.prior.n_transformer_blk
    n_attn = hp.encoder.n_blk + flow_attn + 2 * hp.decoder.nblk

    # the main path: the shipped configuration, bf16
    phase("synthesis_path")
    fa.launch_counts.clear()
    mels0, lens0 = synthesize_batch(model, hp, token_ids, 0.0, use_q)
    torch.cuda.synchronize()
    per_call = dict(fa.launch_counts)
    gen = torch.Generator(device=device).manual_seed(1234)
    mels1, lens1 = synthesize_batch(model, hp, token_ids, 0.667, use_q, generator=gen)
    torch.cuda.synchronize()
    synthesis_counts = dict(fa.launch_counts)
    print(json.dumps({"epoch": epoch, "compute_dtype": hp.train.compute_dtype,
                      "mel_shape": list(mels0.shape), "mel_dtype": str(mels0.dtype),
                      "lengths_t0": lens0.tolist(), "lengths_t0667": lens1.tolist(),
                      "launches_first_call": per_call, "launches": synthesis_counts}),
          flush=True)
    check(per_call == {"masked_attention_fwd_tc": n_attn} and n_attn == 32,
          f"{per_call} kernel launches in one synthesis, expected 32 masked_attention_fwd_tc")
    check(synthesis_counts == {"masked_attention_fwd_tc": 2 * n_attn},
          f"launches in two synthesis calls {synthesis_counts}, expected 64 forward")
    max_mel = mels0.shape[1]
    for mels, lens in ((mels0, lens0), (mels1, lens1)):
        check(mels.dtype == torch.float32, f"mels come out {mels.dtype}, expected fp32")
        check(bool(torch.isfinite(mels).all()), "non-finite mel")
        check(bool(((lens >= 1) & (lens <= max_mel)).all()), f"lengths out of range {lens}")
    check(torch.equal(lens0, lens1), "predicted lengths changed with the temperature")
    check(not torch.equal(mels0, mels1), "temperature 0.667 gave the temperature-0 mel")

    # the strict gates run at compute_dtype float32, through the fp32 kernels
    phase("synthesis_fp32_card_vs_cpu")
    _, model32, _ = load_model(MODEL_DIR, device, "float32")
    fa.launch_counts.clear()
    mels32, lens32 = synthesize_batch(model32, hp, token_ids, 0.0, use_q)
    torch.cuda.synchronize()
    fp32_synthesis_counts = dict(fa.launch_counts)
    _, cpu_model, _ = load_model(MODEL_DIR, "cpu", "float32")
    mels_cpu, lens_cpu = synthesize_batch(cpu_model, hp, token_ids, 0.0, use_q)
    diff = (mels32.cpu() - mels_cpu).abs()
    print(json.dumps({"launches": fp32_synthesis_counts, "lengths_card": lens32.tolist(),
                      "lengths_cpu": lens_cpu.tolist(), "max_abs_err_mel": diff.max().item(),
                      "max_abs_mel": mels_cpu.abs().max().item()}), flush=True)
    check(fp32_synthesis_counts == {"masked_attention_fwd": n_attn},
          f"fp32 synthesis launched {fp32_synthesis_counts}, expected 32 masked_attention_fwd")
    check(torch.equal(lens_cpu, lens32.cpu()), f"card lengths {lens32} != CPU lengths {lens_cpu}")
    check(diff.max().item() <= TOL_MEL_CARD_CPU, f"card vs CPU mel error {diff.max().item()}")

    # the decoder's alignments, asked of synthesis: the same kernel launches
    # and the same mels, and the weights of the plain softmax beside them
    phase("alignments")
    fa.launch_counts.clear()
    mels_a, lens_a, ali = synthesize_batch(model, hp, token_ids, 0.0, use_q,
                                           return_alignments=True)
    torch.cuda.synchronize()
    alignment_counts = dict(fa.launch_counts)
    mels_b, _ = synthesize_batch(model, hp, token_ids, 0.0, use_q)
    _, _, ali32 = synthesize_batch(model32, hp, token_ids, 0.0, use_q, return_alignments=True)
    _, _, ali_cpu = synthesize_batch(cpu_model, hp, token_ids, 0.0, use_q,
                                     return_alignments=True)
    torch.cuda.synchronize()
    r_final = hp.common.final_reduction_factor
    text_max = -(-max(map(len, token_ids)) // hp.dataset.text_bucket) * hp.dataset.text_bucket
    want_shape = [len(LINES), hp.decoder.attention_heads, max_mel // r_final, text_max]
    row_err = max((a.sum(-1) - 1).abs().max().item() for a in ali.values())
    ali_err = max((ali32[k].cpu() - ali_cpu[k]).abs().max().item() for k in ali_cpu)
    print(json.dumps({"launches": alignment_counts,
                      "shapes": {k: list(a.shape) for k, a in ali.items()},
                      "dtypes": sorted({str(a.dtype) for a in ali.values()}),
                      "mels_equal_kernel_only_run": torch.equal(mels_a, mels0),
                      "kernel_only_runs_equal": torch.equal(mels_b, mels0),
                      "max_row_sum_err": row_err, "max_abs_err_fp32_card_vs_cpu": ali_err}),
          flush=True)
    check(alignment_counts == {"masked_attention_fwd_tc": n_attn},
          f"synthesis with alignments launched {alignment_counts}")
    check(sorted(ali) == [f"dec_{i}" for i in range(hp.decoder.nblk)]
          and all(list(a.shape) == want_shape and a.dtype == torch.float32
                  for a in ali.values()), f"alignments {[(k, a.shape) for k, a in ali.items()]}")
    check(torch.equal(mels_a, mels0) and torch.equal(lens_a, lens0),
          "mels with alignments differ from the kernel-only run")
    check(row_err <= TOL_ALI_ROWSUM, f"alignment rows sum to 1 within {row_err}")
    check(ali_err <= TOL_ALI_CARD_CPU, f"fp32 alignments card vs CPU {ali_err}")
    del cpu_model

    # the bf16 main path's synthesis at temperature 0 against the fp32 one
    phase("synthesis_bf16_vs_fp32")
    len_err = (lens0 - lens32).abs().float()
    len_share = (len_err / (TOL_LEN_BF16[0] * lens32.float() + TOL_LEN_BF16[1])).max().item()
    shared = int(torch.minimum(lens0, lens32).min())
    print(json.dumps({"lengths_bf16": lens0.tolist(), "lengths_fp32": lens32.tolist(),
                      "max_share_of_tol_length": len_share,
                      "mean_abs_mel_diff_shared_frames": (mels0[:, :shared] - mels32[:, :shared])
                      .abs().mean().item()}), flush=True)
    check(len_share <= 1.0, f"bf16 lengths {lens0} against fp32 {lens32}: {len_share} of "
          f"the bound {TOL_LEN_BF16}")

    ap, mel_s = check_audio(torch, np, device, hp.audio, mels0, lens0)
    cfg, hop = hp.audio, hp.audio.frame_shift_sample
    n_fft, n_main = cfg.n_fft, mels0.shape[1]

    with tempfile.TemporaryDirectory(prefix="vaenar_smoke_") as tmp:
        data_dir, model_dir = os.path.join(tmp, "records"), os.path.join(tmp, "ckpt")
        os.makedirs(data_dir)
        write_records(data_dir, seed=2026)

        phase("training_path")
        fa.launch_counts.clear()
        history = cli_train.main([
            "--dataset", "ljspeech", "--data_dir", data_dir, "--model_dir", model_dir,
            "--log_dir", os.path.join(tmp, "logs"),
            "--hparams", os.path.join(MODEL_DIR, "hparams.json"),
            "--device", DEVICE, "--max_epochs", "2", "--steps_per_epoch", "2"])
        torch.cuda.synchronize()
        training_counts = dict(fa.launch_counts)
        hp_train = load_hparams(model_dir)
        check(hp_train.train.compute_dtype == "bfloat16", "cli.train did not keep bfloat16")
        # attention sites: encoder self-attention, and a causal self- and a
        # cross-attention in every CrossAttentionBlock (posterior, decoder,
        # prior couplings)
        blocks = (hp_train.posterior.nblk + hp_train.decoder.nblk
                  + hp_train.prior.n_blk * hp_train.prior.n_transformer_blk)
        per_step = hp_train.encoder.n_blk + 2 * blocks
        init_pass = hp_train.encoder.n_blk + 2 * hp_train.prior.n_blk * hp_train.prior.n_transformer_blk
        n_steps = 1 + 2 * 2  # the priming step, then 2 epochs of 2 steps
        n_dev = 2 * -(-N_DEV // hp_train.train.train_batch_size)
        expected = {"masked_attention_fwd_tc": init_pass + per_step * (n_steps + n_dev),
                    "masked_attention_bwd_dq_tc": per_step * n_steps,
                    "masked_attention_bwd_dkv_tc": per_step * n_steps}
        losses = [history["initial"]] + [history[split][e] for split in ("train", "dev")
                                         for e in (1, 2)]
        print(json.dumps({"losses": losses, "launches": training_counts,
                          "launches_expected": expected, "attention_sites_per_step": per_step}),
              flush=True)
        check(per_step == 36, f"{per_step} attention sites per train step, expected 36")
        check(training_counts == expected, f"training launches {training_counts} != {expected}")
        check(all(np.isfinite(v) for m in losses for v in m.values()), "non-finite loss")
        check(CheckpointManager(model_dir).restore(VAENAR(hp_train).to(device)) == 2,
              "checkpoint 2 did not restore")
        hp32_train = apply_overrides(hp_train, ["train.compute_dtype=float32"])
        trained = load_trained(VAENAR, CheckpointManager, hp_train, model_dir, device)
        trained32 = load_trained(VAENAR, CheckpointManager, hp32_train, model_dir, device)
        check(all(p.dtype == torch.float32 and bool(torch.isfinite(p).all())
                  for p in trained.parameters()), "a parameter not finite fp32 after training")

        phase("train_step_fp32_card_vs_cpu")
        fp32_step_counts = card_vs_cpu_train_step(
            torch, np, fa, apply_overrides(hp32_train, NO_DROPOUT), model_dir, data_dir,
            device, {"masked_attention_fwd": per_step, "masked_attention_bwd_dq": per_step,
                     "masked_attention_bwd_dkv": per_step})

        # the JAX package's own bf16-against-fp32 thresholds, on the card
        phase("dev_step_bf16_vs_fp32")
        dev_batch = next(iter(BucketedLoader(list_shards(data_dir, "dev"),
                                             hp_train.train.train_batch_size,
                                             hp_train.dataset.mel_bucket,
                                             hp_train.dataset.text_bucket,
                                             shuffle=False).epoch(0)))
        n_rows = dev_batch.mels.shape[0]
        valid = (torch.arange(n_rows) < dev_batch.n_valid).float().to(device)
        dev_eps = torch.from_numpy(np.random.default_rng(4).standard_normal(
            (n_rows, 1, dev_batch.mels.shape[1] // 2, hp_train.common.latent_dim))
            .astype(np.float32)).to(device)
        dev_metrics = {}
        for name, m_, h_ in (("bfloat16", trained, hp_train), ("float32", trained32, hp32_train)):
            dev_metrics[name] = steps.metric_floats(steps.dev_step(
                m_, h_, *to_device(dev_batch, device), 1e-5, valid, 2, epsilon=dev_eps))
        b16, f32 = dev_metrics["bfloat16"], dev_metrics["float32"]
        dev_share = {k: abs(b16[k] - f32[k]) / (TOL_BF16_FP32_REL * abs(f32[k]))
                     for k in ("mel_l2", "len_l2", "total")}
        dev_share["kl"] = abs(b16["kl"] - f32["kl"]) / TOL_BF16_FP32_KL
        print(json.dumps({"dev_bf16": b16, "dev_fp32": f32, "share_of_tol": dev_share}),
              flush=True)
        check(max(dev_share.values()) <= 1.0, f"bf16 against fp32 dev losses: {dev_share}")

        phase("export_synthesis")
        # the export alone in its own directory, so that load_model reads it
        # and not the training directory's newest checkpoint
        export = export_model_dir(model_dir)
        export_dir = os.path.join(tmp, "export_only")
        os.makedirs(export_dir)
        for name in (os.path.basename(export), "hparams.json"):
            shutil.copy(os.path.join(model_dir, name), export_dir)
        hp_exp, exported, exp_epoch = load_model(export_dir, device)
        _, restored, ckpt_epoch = load_model(model_dir, device)
        # the export stores floating leaves as float16
        want = restored.state_dict()
        same_weights = all(torch.equal(a, want[k].half().to(a.dtype))
                           for k, a in exported.state_dict().items() if a.is_floating_point())
        mels_e, lens_e = synthesize_batch(exported, hp_exp, encode_lines(hp_exp, LINES), 0.0,
                                          resolve_length_source("auto", hp_exp))
        torch.cuda.synchronize()
        print(json.dumps({"export_bytes": os.path.getsize(export), "epoch": exp_epoch,
                          "checkpoint_epoch": ckpt_epoch, "same_weights": same_weights,
                          "mel_shape": list(mels_e.shape), "lengths": lens_e.tolist()}), flush=True)
        check(exp_epoch == 2 and ckpt_epoch == 2,
              f"exported epoch {exp_epoch} and checkpoint epoch {ckpt_epoch}, expected 2")
        check(same_weights, "the export's weights differ from its epoch-2 checkpoint's in float16")
        check(bool(torch.isfinite(mels_e).all()), "non-finite mel from the exported model")

        # the synthesis CLI's test-set and free-text modes, bf16 on the card
        phase("test_set_cli")
        test_records = os.path.join(tmp, "test_records")
        os.makedirs(test_records)
        write_records(test_records, seed=2027, splits=(("test", N_TEST),))
        test_loader = BucketedLoader(list_shards(test_records, "test"), 4,
                                     hp.dataset.mel_bucket, hp.dataset.text_bucket, shuffle=False)
        n_calls = len(test_loader) + len({tm for tm, _ in test_loader.shape_census()})
        out_dir = os.path.join(tmp, "test_out")
        common = ["--dataset", "ljspeech", "--data_dir", test_records, "--model_dir", MODEL_DIR,
                  "--batch_size", "4", "--device", DEVICE, "--no-draw_alignments"]
        fa.launch_counts.clear()
        test_result, test_text = run_cli(cli_inference.main,
                                         common + ["--test_dir", out_dir, "--write_wavs"])
        torch.cuda.synchronize()
        test_set_counts = dict(fa.launch_counts)
        names = sorted(os.listdir(out_dir))
        npys = [n for n in names if n.endswith(".npy")]
        wav_lens = {}
        for name in npys:
            sr, wav = wavfile.read(os.path.join(out_dir, name[:-4] + ".wav"))
            wav_lens[name] = (np.load(os.path.join(out_dir, name)).shape[0], len(wav),
                              int(np.abs(wav).max()))
        print(json.dumps({"launches": test_set_counts, "result": test_result,
                          "files": len(names), "mel_and_wav_lengths": wav_lens}), flush=True)
        check("Average RTF is" in test_text, "test-set mode printed no RTF line")
        check(test_set_counts == {"masked_attention_fwd_tc": n_attn * n_calls},
              f"test-set launches {test_set_counts}, expected {n_attn * n_calls} forward")
        check(len(npys) == N_TEST and len(names) == 2 * N_TEST, f"test-set files {names}")
        check(all(w == m * hop and peak > 0 for m, w, peak in wav_lens.values()),
              f"wav lengths against mel lengths * hop: {wav_lens}")
        _, stream_text = run_cli(cli_inference.main, common + [
            "--test_dir", os.path.join(tmp, "stream_out"), "--write_wavs", "--stream_wavs"])
        check("time-to-first-audio" in stream_text, "--stream_wavs printed no TTFA")
        lines_file = os.path.join(tmp, "lines.txt")
        with open(lines_file, "w") as f:
            f.write("\n".join(LINES) + "\n")
        free_text_counts = {}
        for score in ("medoid", "coverage"):
            fa.launch_counts.clear()
            res, text = run_cli(cli_inference.main, [
                "--dataset", "ljspeech", "--text", lines_file, "--model_dir", MODEL_DIR,
                "--test_dir", os.path.join(tmp, f"free_{score}"), "--device", DEVICE,
                "--takes", "4", "--take_score", score, "--no-draw_alignments"])
            torch.cuda.synchronize()
            free_text_counts[score] = dict(fa.launch_counts)
            check(chosen_takes(text) == res["chosen"] and len(res["chosen"]) == len(LINES)
                  and all(0 <= c < 4 for c in res["chosen"]),
                  f"--take_score {score}: chosen takes {res['chosen']}")
            check(free_text_counts[score] == {"masked_attention_fwd_tc": 4 * n_attn},
                  f"free-text launches {free_text_counts[score]}")
        print(json.dumps({"free_text_launches": free_text_counts}), flush=True)

        phase("audio_times")
        tester = TestUtils(hp, os.path.join(tmp, "times_out"), device)
        mels_np, lens_np = mels0.cpu().numpy(), lens0.cpu().numpy()
        gl_ms, gl_wall = {}, {}
        # the CLI's padded batch with cuFFT and with the DFT as fp32 matmuls,
        # and the batch cut to its longest line (+1 frame) with cuFFT
        trimmed = mels0[:, :int(lens0.max()) + 1]
        bases = dft_matmul_bases(torch, np, ops_stft.padded_window(
            n_fft, cfg.frame_length_sample, "cpu").double().numpy(), device)
        vocoders = {"fft": lambda m, g: gl.mel_to_wav(m, cfg, g),
                    "matmul": lambda m, g: matmul_mel_to_wav(torch, gl, ops_stft, m, cfg,
                                                             bases, g)}
        for name, mels_in, form in (("fft", mels0, "fft"), ("matmul", mels0, "matmul"),
                                    ("fft_trimmed", trimmed, "fft")):
            def run():
                gen = torch.Generator(device=device).manual_seed(0)
                return vocoders[form](mels_in, gen)
            gl_ms[name] = time_ms(torch, run, reps=3, warmup=1)
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            gl_wall[name] = time.perf_counter() - t
        t = time.perf_counter()
        tester.synthesize_and_save_wavs(0, mels_np, lens_np, list(range(len(LINES))), "host")
        host_gl_s = time.perf_counter() - t
        # the matmul form's products: 2 * iterations + 1 of [frames, n_fft]
        # x [n_fft, 2 * bins] (analysis and synthesis alike), fp32 FMAs
        frames_gl = len(LINES) * n_main
        matmul_flops = (2 * cfg.griffin_lim_iters + 1) * 2 * frames_gl * n_fft * (n_fft + 2)
        ttfa = {}
        for be in ("host", "device"):
            sv = StreamingVocoder(ap, backend=be, device=device)
            t = time.perf_counter()
            next(iter(sv.stream(mel_s, np.random.default_rng(3))))
            ttfa[be] = time.perf_counter() - t
        audio_times = {"gl_batch": [len(LINES), n_main, cfg.griffin_lim_iters],
                       "gl_trimmed_frames": trimmed.shape[1],
                       "gl_device_ms": gl_ms, "gl_wall_s": gl_wall,
                       "gl_matmul_bound_ms": 1e3 * matmul_flops / PEAK_FLOPS["float32"],
                       "host_gl_threads_s": host_gl_s, "host_gl_frames": lens_np.tolist(),
                       "test_set_rtf": test_result["rtf"],
                       "test_set_seconds": test_result["seconds"],
                       "test_set_audio_seconds": test_result["audio_seconds"],
                       "ttfa_s": ttfa, "ttfa_frames": len(mel_s)}
        print(json.dumps(audio_times), flush=True)

        phase("times")
        sites = synthesis_sites(torch, hp, token_ids, lens0, max_mel, device)
        # Tk > 4096, where the TPU ran its blocked kernel: no site of either
        # path, so timed at the check's shape
        long_case = [c for c in check_cases(torch, device) if c[0] == "long_1024x4104"][0]
        totals, blocked, synthesis_walls = {}, {}, {}
        for dtype_name, m_ in (("bfloat16", model), ("float32", model32)):
            totals[dtype_name] = time_kernels(torch, fa, device, sites, dtype_name)
            blocked[dtype_name] = time_kernels(
                torch, fa, device, [(long_case[0], 1, *long_case[1:])], dtype_name)
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                synthesize_batch(m_, hp, token_ids, 0.0, use_q)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
            synthesis_walls[dtype_name] = walls
        print(json.dumps({"synthesis_wall_s": synthesis_walls, "batch": len(LINES),
                          "attention_ms_per_synthesis": {d: v["ms"] for d, v in totals.items()},
                          "bound_ms_per_synthesis": {d: v["bound_ms"] for d, v in totals.items()},
                          "tk_4104": blocked}), flush=True)
        new_paths = synthesis_trace_phase(torch, fa, tmp, model, hp, token_ids, use_q, smi,
                                          statistics.median(synthesis_walls["bfloat16"]))

        # training at the shipped batch of 32, from the trained state
        big = next(iter(BucketedLoader(list_shards(data_dir, "train"),
                                       hp_train.train.train_batch_size,
                                       hp_train.dataset.mel_bucket,
                                       hp_train.dataset.text_bucket, shuffle=False).epoch(0)))
        batch = to_device(big, device)
        step_sites = train_sites(torch, hp_train, big, device)
        bwd, step_times = {}, {}
        for dtype_name, m_, h_ in (("bfloat16", trained, hp_train),
                                   ("float32", trained32, hp32_train)):
            bwd[dtype_name] = time_backward(torch, fa, device, step_sites, dtype_name)
            dt = getattr(torch, dtype_name)
            want = {fa.kernel_name(kind, dt): float(per_step) for kind in ("fwd", "dq", "dkv")}
            for rf in (2, hp_train.common.max_reduction_factor):
                walls_t, per_step_counts = train_step_times(torch, fa, steps, m_, h_, batch, rf)
                step_times[f"{dtype_name}_r{rf}"] = {
                    "wall_s": walls_t, "median_s": statistics.median(walls_t),
                    "launches_per_step": per_step_counts}
                check(per_step_counts == want,
                      f"launches per {dtype_name} train step at r={rf}: {per_step_counts}")
        print(json.dumps({"train_batch": list(big.mels.shape), "train_step": step_times,
                          "attention_per_train_step_r2": bwd}), flush=True)

        phase("train_step_profile")
        for (dtype_name, m_, h_), rf in itertools.product(
                (("bfloat16", trained, hp_train), ("float32", trained32, hp32_train)),
                (2, hp_train.common.max_reduction_factor)):
            device_ms, launches, top = profile_train_steps(torch, steps, m_, h_, batch, rf)
            wall_ms = 1e3 * step_times[f"{dtype_name}_r{rf}"]["median_s"]
            print(json.dumps({"compute_dtype": dtype_name, "reduction_factor": rf,
                              "device_ms_per_step": device_ms,
                              "kernel_launches_per_step": launches,
                              "wall_ms_per_step_unprofiled": wall_ms,
                              "device_busy_share": device_ms / wall_ms if device_ms else None,
                              "top_kernels_ms_per_step": top}), flush=True)

        width_paths, width_replayed, width_timing = head_widths_phase(
            torch, np, fa, tmp, data_dir, device, token_ids, use_q, n_attn, init_pass, per_step,
            {"synthesis": synthesis_walls["bfloat16"], "synthesis_lengths": lens0.tolist(),
             "train_step": {d: step_times[f"{d}_r2"]["median_s"]
                            for d in ("bfloat16", "float32")}})

        toy_records = preprocess_phase(torch, np, wavfile, tmp, DEVICE, smi)
        probe_counts, best_counts, in_probes = probe_phase(
            torch, fa, tmp, toy_records, os.path.join(MODEL_DIR, "hparams.json"), DEVICE, smi,
            n_attn, lambda n_dev: {
                "masked_attention_fwd_tc": init_pass + per_step * (n_steps + n_dev),
                "masked_attention_bwd_dq_tc": per_step * n_steps,
                "masked_attention_bwd_dkv_tc": per_step * n_steps})
        ler_counts = shipped_ler_phase(torch, np, fa, tmp, MODEL_DIR, hp, DEVICE, smi, n_attn)

        # the rest of the training loop and the neural vocoder
        loop_recs = loop_records(tmp)
        new_paths.update(loop_phase(torch, np, fa, wavfile, tmp, loop_recs, DEVICE, smi, hop,
                                    init_pass, per_step, n_attn))
        new_paths.update(sigterm_phase(torch, fa, tmp, DEVICE, smi, init_pass, per_step))
        graph_paths, graph_replayed = epoch_graph_phase(torch, np, fa, tmp, DEVICE, smi,
                                                        init_pass, per_step)
        new_paths.update(graph_paths)

        def load(h):
            return load_trained(VAENAR, CheckpointManager, h, model_dir, device)
        new_paths.update(remat_phase(torch, np, fa, steps, load, hp_train, data_dir, device,
                                     smi, per_step))
        new_paths.update(batched_lu_phase(torch, fa, steps, load, hp_train, data_dir, device,
                                          smi, per_step))
        new_paths.update(neural_vocoder_phase(torch, np, fa, wavfile, tmp, DEVICE, smi, hp, mels0,
                                              loop_recs, test_records, init_pass, per_step,
                                              n_attn, n_calls))

        # multi-process data parallelism and the native batch packer
        native_packer_phase(toy_records, tmp, smi)
        new_paths.update(distributed_phases(torch, tmp, smi, init_pass, per_step))
        new_paths.update(sharded_synthesis_phase(torch, tmp, smi, model32, hp, n_attn))
        new_paths.update(model_axis_phases(torch, fa, tmp, smi, hp, model, model32, token_ids,
                                           use_q, big, n_attn))
        new_paths.update(reference_import_phase(torch, fa, tmp, smi, token_ids))

    phase("done")
    print(smi)
    train_per = (f"ms: one train step at r = 2 (the curriculum's last stage), batch "
                 f"{big.mels.shape[0]}: its {per_step} launches at that step's shapes and "
                 f"lengths; plain_ms and library_ms of the backward kernels are the whole "
                 f"backward (dq, dk and dv)")
    synth_per = "ms: one synthesis call, its 32 launches at the synthesis path's shapes and lengths"
    fa_src = "vaenar_tts_tpu/ops/flash_attention.py"

    def fwd_entry(name, dtype_name, launches, by_path, extra, timing=None):
        timing = timing or {"fwd": totals, "bwd": bwd, "long": blocked}
        t_syn, t_step = timing["fwd"][dtype_name], timing["bwd"][dtype_name]
        t_long = timing["long"][dtype_name]
        return {"name": name, "route": "cuda", "dtype": dtype_name,
                "source": f"vaenar_tts_torch/csrc/{fa.c_function(name)}.cu",
                "replaces": f"{fa_src}:104", "also_replaces": f"{fa_src}:142",
                "launches": launches, "launches_by_path": by_path,
                "max_abs_err": worst[name][dtype_name],
                "ms": t_syn["ms"], "plain_ms": t_syn["plain_ms"], "bound_ms": t_syn["bound_ms"],
                "bound_by": bound_by(name, t_syn),
                "library_ms": t_syn["library_ms"],
                "per_train_step_r2": {
                    "ms": t_step["fwd_ms"], "plain_ms": t_step["fwd_plain_ms"],
                    "bound_ms": t_step["fwd_bound_ms"], "library_ms": t_step["fwd_library_ms"],
                    "bound_by": bound_by(name, t_step, "fwd_")},
                "tk_4104": {"ms": t_long["ms"], "plain_ms": t_long["plain_ms"],
                            "library_ms": t_long["library_ms"], "bound_ms": t_long["bound_ms"],
                            "bound_by": bound_by(name, t_long)},
                "per": synth_per, **extra}

    def bwd_entry(name, kern, dtype_name, launches, by_path, extra, timing=None):
        t = (timing or {"bwd": bwd})["bwd"][dtype_name]
        return {"name": name, "route": "cuda", "dtype": dtype_name,
                "source": f"vaenar_tts_torch/csrc/{BWD_SOURCES[fa.c_function(name)]}",
                "replaces": f"{fa_src}:{320 if kern == 'dq' else 370}",
                "launches": launches, "launches_by_path": by_path,
                "max_abs_err": worst[name][dtype_name],
                "ms": t[f"{kern}_ms"], "plain_ms": t["plain_ms"], "bound_ms": t[f"{kern}_bound_ms"],
                "bound_by": ("operations" if t[f"{kern}_flop_ms"] >= t[f"{kern}_byte_ms"]
                             else "bytes"),
                "library_ms": t["library_ms"], "per": train_per, **extra}

    BWD_SOURCES = {"masked_attention_bwd_dq": "masked_attention_bwd.cu",
                   "masked_attention_bwd_dkv": "masked_attention_bwd_dkv.cu",
                   "masked_attention_bwd_dq_tc": "masked_attention_bwd_dq_tc.cu",
                   "masked_attention_bwd_dkv_tc": "masked_attention_bwd_dkv_tc.cu"}
    kernels = [
        fwd_entry("masked_attention_fwd_tc", "bfloat16",
                  synthesis_counts["masked_attention_fwd_tc"]
                  + training_counts["masked_attention_fwd_tc"]
                  + alignment_counts["masked_attention_fwd_tc"]
                  + test_set_counts["masked_attention_fwd_tc"]
                  + sum(c["masked_attention_fwd_tc"] for c in free_text_counts.values())
                  + probe_counts["masked_attention_fwd_tc"]
                  + best_counts["masked_attention_fwd_tc"] + sum(ler_counts.values()),
                  {"synthesis": synthesis_counts["masked_attention_fwd_tc"],
                   "training": training_counts["masked_attention_fwd_tc"],
                   "synthesis_with_alignments": alignment_counts["masked_attention_fwd_tc"],
                   "test_set_cli": test_set_counts["masked_attention_fwd_tc"],
                   "free_text_cli_takes": {k: c["masked_attention_fwd_tc"]
                                           for k, c in free_text_counts.items()},
                   "probe_training_cli": probe_counts["masked_attention_fwd_tc"],
                   "export_best_synthesis": best_counts["masked_attention_fwd_tc"],
                   "shipped_ler_cli": ler_counts},
                  {**shares["masked_attention_fwd_tc"], "launches_inside_probes": in_probes}),
        fwd_entry("masked_attention_fwd", "float32",
                  fp32_synthesis_counts["masked_attention_fwd"]
                  + fp32_step_counts["masked_attention_fwd"],
                  {"fp32_synthesis": fp32_synthesis_counts["masked_attention_fwd"],
                   "fp32_train_step": fp32_step_counts["masked_attention_fwd"]},
                  shares["masked_attention_fwd"]),
        bwd_entry("masked_attention_bwd_dq_tc", "dq", "bfloat16",
                  training_counts["masked_attention_bwd_dq_tc"]
                  + probe_counts["masked_attention_bwd_dq_tc"],
                  {"training": training_counts["masked_attention_bwd_dq_tc"],
                   "probe_training_cli": probe_counts["masked_attention_bwd_dq_tc"]},
                  shares["masked_attention_bwd_dq_tc"]),
        bwd_entry("masked_attention_bwd_dq", "dq", "float32",
                  fp32_step_counts["masked_attention_bwd_dq"],
                  {"fp32_train_step": fp32_step_counts["masked_attention_bwd_dq"]},
                  shares["masked_attention_bwd_dq"]),
        bwd_entry("masked_attention_bwd_dkv_tc", "dkv", "bfloat16",
                  training_counts["masked_attention_bwd_dkv_tc"]
                  + probe_counts["masked_attention_bwd_dkv_tc"],
                  {"training": training_counts["masked_attention_bwd_dkv_tc"],
                   "probe_training_cli": probe_counts["masked_attention_bwd_dkv_tc"]},
                  shares["masked_attention_bwd_dkv_tc"]),
        bwd_entry("masked_attention_bwd_dkv", "dkv", "float32",
                  fp32_step_counts["masked_attention_bwd_dkv"],
                  {"fp32_train_step": fp32_step_counts["masked_attention_bwd_dkv"]},
                  shares["masked_attention_bwd_dkv"]),
    ]
    # the D = 128 and D = 256 instantiations and the wide kernels (D = 384,
    # with their times at D = 512 at the same sites beside): launched on the
    # head_widths paths only, timed at the sites of the model of that width
    timing_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "per_train_step_r2",
                   "tk_4104")
    for D, heads in ((128, "2 heads"), (256, "1 head"), (WIDE_MODEL_DIM, "1 head")):
        at = f"at D = {D}, attention width {D * int(heads[0])} in {heads} (head_widths)"
        for dtype_name in ("bfloat16", "float32"):
            dt = getattr(torch, dtype_name)
            for kern in ("fwd", "dq", "dkv"):
                name = fa.kernel_name(kern, dt, D)
                extra = {**shares[name], "per": f"{synth_per if kern == 'fwd' else train_per}, {at}"}
                if name.endswith(fa.WIDE_SUFFIX):
                    extra["source"] = "vaenar_tts_torch/csrc/masked_attention_wide" + (
                        "_tc.cu" if dtype_name == "bfloat16" else ".cu")
                    at_512 = (fwd_entry(name, dtype_name, 0, {}, {}, width_timing[512])
                              if kern == "fwd" else
                              bwd_entry(name, kern, dtype_name, 0, {}, {}, width_timing[512]))
                    extra["at_d512_same_sites"] = {k: at_512[k] for k in timing_keys
                                                   if k in at_512}
                if name in TF32X3_KERNELS:
                    extra["source"] = "vaenar_tts_torch/csrc/masked_attention_fwd_3xtf32.cu"
                kernels.append(fwd_entry(name, dtype_name, 0, {}, extra, width_timing[D])
                               if kern == "fwd" else
                               bwd_entry(name, kern, dtype_name, 0, {}, extra, width_timing[D]))
    new_paths.update(width_paths)
    for n, c in width_replayed.items():
        graph_replayed["bfloat16"][n] = graph_replayed["bfloat16"].get(n, 0) + c
    for entry in kernels:
        for path, counts in new_paths.items():
            if counts.get(entry["name"]):
                entry["launches"] += counts[entry["name"]]
                entry["launches_by_path"][path] = counts[entry["name"]]
    for entry in kernels:
        # the graphed epochs' replays, which launch through no wrapper
        entry["launches_replayed_in_cuda_graphs"] = graph_replayed[entry["dtype"]].get(
            entry["name"], 0)
    for entry in kernels:
        check(entry["launches"] > 0, f"{entry['name']} was not launched on its path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    WORKERS = {"--synthesis-worker": synthesis_worker, "--model-axis-worker": model_axis_worker,
               "--p2p-probe": p2p_probe_worker, "--graph-failure-worker": graph_failure_worker}
    if sys.argv[1:2] and sys.argv[1] in WORKERS:
        sys.exit(WORKERS[sys.argv[1]](int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
