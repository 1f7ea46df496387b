"""Train, dev, test and init steps (counterpart of
``vaenar_tts_tpu/training/steps.py``).

The state is the model itself (parameters and BatchNorm buffers) and a
``torch.optim.Adam`` with the JAX package's b1, b2 and eps. The total loss
is mel_l2 + kl_weight * max(kl, 0) + length_weight * len_l2, where len_l2
includes the quantile head's pinball term; the dev loss uses the unclamped
kl. Metrics report ``len_l2`` without the pinball term and the pinball term
as ``len_pinball``, as the JAX steps do.

At ``train.compute_dtype`` bfloat16 the model computes in bf16 where the
JAX package does (``models/vaenar.py``); the parameters, their gradients,
Adam's moments and the losses stay fp32.

Given a ``DistContext`` of several processes (``parallel/distributed.py``),
each holding its rows of a global batch, the steps compute what one process
computes on the global batch, as the JAX package's global ``jit`` does:
every forward runs in a data group (``parallel/data_group.py``: dropout
masks and noise are this process's rows of the global batch's draws, and
BatchNorm and the ActNorm init take the global batch's statistics); the
gradients and the metrics are averaged over the processes before Adam (each
process's loss is a mean over an equal number of rows); and the dev step
returns sums over the real rows, for ``DistContext.allsum``.

On a ``(data, model)`` mesh (``DistContext(device, mesh)``) the rows,
statistics and averages above are the data group's: the processes of a
model group hold the same rows, run one model together (its
tensor-parallel shards, ``parallel/mesh.shard_params``, and its ring
self-attentions, ``VAENAR(seq_mesh=)``) and must draw from generators in
the same state. A shard's gradient is averaged with the shards of its model
coordinate, and Adam steps each process's shards; the gradients of the
parameters left whole are then averaged over the model group
(``DistContext.average_replicas``), so that every process of the group
applies the same update to its replica.

``make_epoch_runner`` runs an epoch of steps over the device data cache:
on the card as replays of a CUDA graph of one step, on the CPU as the
eager steps.
"""

from __future__ import annotations

import math
import time
from collections import Counter
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..configs.hparams import HParams
from ..models.flow import ActNorm, InvertibleLinear, TransformerTransform
from ..models.layers import BatchNorm
from ..models.posterior import TransformerPosterior
from ..models.vaenar import VAENAR, resolve_device
from ..ops.flash_attention import launch_counts
from ..parallel.data_group import data_group

# flax's truncated normal: N(0, 1) cut at +-2, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def init_parameters(model: VAENAR, seed: int) -> VAENAR:
    """Fresh parameters in flax's initializer families, drawn on the CPU from
    a generator seeded with ``seed``: Dense and Conv kernels lecun_normal
    (truncated normal, variance 1 / fan_in) with zero biases; the embedding
    N(0, 1 / width); LayerNorm and BatchNorm scale 1, bias 0, running mean 0
    and var 1; ActNorm log_scale N(0, 0.05²) and bias 0; InvertibleLinear
    orthogonal; every pos_weight 1; and the zero-initialised heads: each
    coupling's log-scale and shift projections (so every coupling starts as
    the identity) and the posterior's mu and logvar."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    for module in model.modules():
        if isinstance(module, nn.Linear):
            _lecun_normal_(module.weight, module.in_features, g)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.Conv1d):
            _lecun_normal_(module.weight, module.in_channels * module.kernel_size[0], g)
            module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(0.0, 1.0 / math.sqrt(module.embedding_dim), generator=g)
        elif isinstance(module, (nn.LayerNorm, BatchNorm)):
            module.reset_parameters()
        elif isinstance(module, ActNorm):
            module.log_scale.normal_(0.0, 0.05, generator=g)
            module.bias.zero_()
        elif isinstance(module, InvertibleLinear):
            nn.init.orthogonal_(module.weight, generator=g)
    for name, param in model.named_parameters():
        if name.endswith("pos_weight"):
            param.fill_(1.0)
    for module in model.modules():
        heads = ()
        if isinstance(module, TransformerTransform):
            heads = (module.log_scale_projection, module.shift_projection)
        elif isinstance(module, TransformerPosterior):
            heads = (module.mu_projection, module.logvar_projection)
        for head in heads:
            head.weight.zero_()
            head.bias.zero_()
    return model


def init_model(hp: HParams, seed: int, device="cuda") -> VAENAR:
    """A freshly initialised VAENAR on ``device`` (see ``init_parameters``)."""
    dev = resolve_device(device)
    return init_parameters(VAENAR(hp), seed).to(dev)


def make_optimizer(hp: HParams, model: nn.Module,
                   capturable: Optional[bool] = None) -> torch.optim.Adam:
    """Adam(learning_rate, b1, b2, eps) as the JAX package's optax.adam:
    both apply lr * m̂ / (sqrt(v̂) + eps). ``capturable`` (None: whether the
    parameters are on the card) keeps the step counts on the card and makes
    the bias corrections fp32 tensors, as optax computes them, which a CUDA
    graph of the step needs (``make_epoch_runner``). Every step on the card
    then runs one arithmetic, graphed or not; on the CPU Adam rounds its
    bias corrections from host doubles."""
    if capturable is None:
        capturable = next(model.parameters()).is_cuda
    return torch.optim.Adam(model.parameters(), lr=hp.train.learning_rate,
                            betas=(hp.train.adam_beta1, hp.train.adam_beta2),
                            eps=hp.train.adam_eps, capturable=capturable)


def _metrics(mel_l2, kl, length_loss, pinball, total) -> Dict[str, torch.Tensor]:
    m = {"total": total, "mel_l2": mel_l2, "kl": kl}
    if pinball is None:
        m["len_l2"] = length_loss
    else:
        m["len_l2"] = length_loss - pinball
        m["len_pinball"] = pinball
    return {k: v.detach() for k, v in m.items()}


def _world(dist) -> Tuple[int, int]:
    """(this process's data index, the data group's size); (0, 1) without a
    fleet. The processes of one model group hold the same rows, so a mesh
    of ``(data=1, model=n)`` is one data-parallel member."""
    if dist is None or dist.data_count == 1:
        return 0, 1
    return dist.data_index, dist.data_count


def train_step(model: VAENAR, optimizer: torch.optim.Optimizer, hp: HParams,
               texts: torch.Tensor, mels: torch.Tensor, t_lens: torch.Tensor,
               m_lens: torch.Tensor, kl_weight, reduction_factor: int,
               generator: Optional[torch.Generator] = None,
               epsilon: Optional[torch.Tensor] = None,
               dist=None) -> Dict[str, torch.Tensor]:
    """One Adam update on the batch. With ``hp.train.grad_accum = A > 1``
    the batch is split into A equal micro-batches whose gradients are
    averaged before the one update; BatchNorm's running statistics carry
    from one micro-batch to the next. Returns the metrics (device scalars,
    averaged over the micro-batches). ``epsilon``: the posterior noise of
    the whole batch, [B, n, T_reduced, latent], in place of draws from
    ``generator``. ``kl_weight``: a float, or a 0-d fp32 tensor on the
    batch's device that the step reads when it runs (a CUDA graph of the
    step reads it at each replay).

    With ``dist`` (W processes) the tensors are this process's rows of the
    global batch and ``epsilon``, if given, the global batch's noise. The
    micro-batches are contiguous rows of the GLOBAL batch, as the JAX step
    splits its global array: the processes first gather the global batch,
    and each then takes its 1 / W of every micro-batch. The kl clamp
    max(kl, 0) acts on the global micro-batch's mean kl (one more scalar
    sum over the processes)."""
    accum = max(1, int(hp.train.grad_accum))
    rank, world = _world(dist)
    if world > 1 and accum > 1:
        texts, mels, t_lens, m_lens = (dist.fetch(x) for x in (texts, mels, t_lens, m_lens))
    batch = texts.shape[0] * (world if accum == 1 else 1)  # the global batch
    if batch % (accum * world):
        raise ValueError(f"grad_accum={accum} x {world} process(es) must divide batch "
                         f"size {batch}")
    size = batch // accum  # rows of a micro-batch
    share = size // world  # this process's rows of it
    optimizer.zero_grad(set_to_none=True)
    sums: Dict[str, torch.Tensor] = {}
    for i in range(accum):
        rows = slice(i * size + rank * share, i * size + (rank + 1) * share)  # global rows
        part = slice(None) if world > 1 and accum == 1 else rows
        with data_group(dist.rows(share) if world > 1 else None):
            _, mel_l2, kl, length_loss, pinball = model(
                texts[part], mels[part], m_lens[part], t_lens[part],
                reduction_factor=reduction_factor, train=True, reduce_loss=True,
                generator=generator,
                epsilon=None if epsilon is None else epsilon[rows])
        if world == 1:
            loss = (mel_l2 + kl_weight * torch.clamp(kl, min=0.0)
                    + hp.train.length_weight * length_loss)
            total = loss
        else:
            # the clamp acts on the GLOBAL micro-batch's kl, as one process's
            # would: a process whose own mean kl is negative still passes its
            # gradient when the global mean is not
            kl_global = dist.all_reduce_sum(kl.detach()) / world
            loss = (mel_l2 + kl_weight * kl * (kl_global >= 0).float()
                    + hp.train.length_weight * length_loss)
            total = (mel_l2 + kl_weight * torch.clamp(kl_global, min=0.0)
                     + hp.train.length_weight * length_loss)
        (loss / accum).backward()
        for k, v in _metrics(mel_l2, kl, length_loss, pinball, total).items():
            sums[k] = sums[k] + v if k in sums else v
    if world > 1:
        sums = dist.average_gradients(list(model.parameters()), sums)
    if dist is not None and dist.model_count > 1:
        dist.average_replicas(model)
    optimizer.step()
    return {k: v / accum for k, v in sums.items()}


# warm-up steps before a capture: the first launch of each attention kernel
# sets its shared-memory attribute, cuBLAS and cuDNN pick their algorithms
# and workspaces, and Adam makes its state, none of which may happen while
# the stream is captured
WARMUP_STEPS = 2


class EpochRunner:
    """``run_epoch(order, kl_weight, reduction_factor, generator)`` (call the
    runner): ``train_step`` on the cached batches ``cache[order[i]]`` in
    order, with ``kl_weight`` and the draws of ``generator``; returns (the
    metric sums, device scalars; the number of steps). The draws, batches
    and resulting state are those of the eager loop's steps over the same
    cache (``training/loop.py``), and ``generator`` ends in the state those
    steps leave it in, for the dev steps that follow. The counterpart of
    the JAX package's ``make_epoch_runner`` (one ``lax.scan`` an epoch).

    On the CPU it runs those eager steps. On the card it captures one step
    in a ``torch.cuda.CUDAGraph`` for each reduction factor (the previous
    factor's graph is freed) and replays it once a step: the graph takes the
    batch ``cache[order[pos]]`` by a device index ``pos`` that it advances
    itself, reads ``kl_weight`` from a device scalar, adds the metrics to
    device sums, and draws from a generator of its own, registered with the
    graph and set to ``generator``'s state before the replays (``generator``
    takes the state it ends in). The host does nothing a step but the
    replay. One step, not the epoch, is captured: the capture then costs
    the time of one step whatever ``steps_per_epoch``, the graph serves any
    order and length of epoch, and the pool holds one step's buffers. The
    optimizer must be capturable (``make_optimizer`` makes it so on the
    card).
    Before a capture the runner takes ``WARMUP_STEPS`` steps on a side
    stream and then puts the parameters, buffers and Adam's state back to
    the values they had, in place. A capture or replay that fails raises:
    nothing falls back to the eager steps.

    ``train.remat`` "on" or "dots" is captured as the eager step runs it:
    the checkpointed blocks' recompute (``models.attention.maybe_remat``:
    non-reentrant ``torch.utils.checkpoint``, no RNG state stashed, "dots"
    through a selective-checkpoint dispatch mode) runs inside the captured
    backward, so a captured step launches the forward kernel twice for each
    attention, and the warm-up steps run the recompute too. Neither the
    checkpoint's check of the recomputed tensors (shapes, dtypes and devices
    only) nor the dispatch mode's version checks (host counters) read the
    card, and the blocks draw no random numbers.

    ``captured_launches`` {reduction factor: {kernel: launches in one
    captured step}}, ``replays`` (steps replayed, all factors),
    ``capture_s`` and ``capture_bytes`` {reduction factor: seconds to
    capture, bytes the capture allocated at most in the graph's pool} are
    there to read. A replay adds nothing to ``launch_counts``, which counts
    the wrappers' launches: the warm-up steps' and the capture's."""

    def __init__(self, model: VAENAR, optimizer: torch.optim.Optimizer, hp: HParams,
                 cache: Sequence[torch.Tensor]):
        self.model, self.optimizer, self.hp = model, optimizer, hp
        self.cache = tuple(cache)
        self.device = self.cache[0].device
        self.n_batches = self.cache[0].shape[0]
        self.graphed = self.device.type == "cuda"
        self.captured_launches: Dict[int, Dict[str, int]] = {}
        self.capture_s: Dict[int, float] = {}
        self.capture_bytes: Dict[int, int] = {}
        self.replays = 0
        self._graph = self._sums = self._r = None
        if self.graphed:
            if not all(g.get("capturable") for g in optimizer.param_groups):
                raise ValueError("a graphed epoch needs a capturable optimizer "
                                 "(make_optimizer's on the card)")
            self._order = torch.zeros(self.n_batches, dtype=torch.int64, device=self.device)
            self._pos = torch.zeros(1, dtype=torch.int64, device=self.device)
            self._kl = torch.zeros((), dtype=torch.float32, device=self.device)
            self._gen = torch.Generator(device=self.device)

    def __call__(self, order, kl_weight: float, reduction_factor: int,
                 generator: torch.Generator) -> Tuple[Dict[str, torch.Tensor], int]:
        order = np.asarray(order, np.int64).reshape(-1)
        if len(order) and (order.min() < 0 or order.max() >= self.n_batches):
            raise ValueError(f"batch order {order} outside the cache's {self.n_batches} batches")
        if not self.graphed:
            sums: Dict[str, torch.Tensor] = {}
            for i in order:
                m = train_step(self.model, self.optimizer, self.hp, *(x[i] for x in self.cache),
                               kl_weight, reduction_factor, generator)
                sums = {k: sums[k] + v if k in sums else v for k, v in m.items()}
            return sums, len(order)
        if not len(order):
            return {}, 0
        if reduction_factor != self._r:
            self._capture(reduction_factor)
        self._order[:len(order)].copy_(torch.from_numpy(order))
        self._pos.zero_()
        self._kl.fill_(kl_weight)
        for v in self._sums.values():
            v.zero_()
        self._gen.set_state(generator.get_state())
        for _ in range(len(order)):
            self._graph.replay()
        self.replays += len(order)
        generator.set_state(self._gen.get_state())
        return {k: v.clone() for k, v in self._sums.items()}, len(order)

    def _step(self, reduction_factor: int) -> Dict[str, torch.Tensor]:
        """The step a graph holds: the batch at ``order[pos]``, then ``pos``
        advanced."""
        idx = self._order.index_select(0, self._pos)
        batch = [x.index_select(0, idx).squeeze(0) for x in self.cache]
        m = train_step(self.model, self.optimizer, self.hp, *batch, self._kl,
                       reduction_factor, self._gen)
        self._pos.add_(1)
        return m

    def _capture(self, reduction_factor: int) -> None:
        self._graph = self._sums = self._r = None  # the previous factor's graph goes
        model, opt, dev = self.model, self.optimizer, self.device
        params = list(model.state_dict().values())
        saved = [t.clone() for t in params]
        opt_saved = {p: {k: v.clone() for k, v in st.items() if torch.is_tensor(v)}
                     for p, st in opt.state.items()}
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._pos.zero_()  # a cache of one batch has one index to read
                m = self._step(reduction_factor)
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.no_grad():
            for t, v in zip(params, saved):
                t.copy_(v)
            for p, st in opt.state.items():
                for k, v in st.items():
                    if not torch.is_tensor(v):
                        continue
                    if k in opt_saved.get(p, {}):
                        v.copy_(opt_saved[p][k])
                    else:  # made by the warm-up: Adam starts it at 0
                        v.zero_()
        del saved, opt_saved
        opt.zero_grad(set_to_none=True)
        sums = {k: torch.zeros((), dtype=v.dtype, device=dev) for k, v in m.items()}
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._gen)
        before = Counter(launch_counts)
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start = time.perf_counter()
        with torch.cuda.graph(graph):
            for k, v in self._step(reduction_factor).items():
                sums[k].add_(v)
        torch.cuda.synchronize(dev)
        self.capture_s[reduction_factor] = time.perf_counter() - start
        self.capture_bytes[reduction_factor] = torch.cuda.max_memory_allocated(dev) - base
        self.captured_launches[reduction_factor] = dict(Counter(launch_counts) - before)
        self._graph, self._sums, self._r = graph, sums, reduction_factor

    def report(self) -> Dict[str, object]:
        return {"graphed": self.graphed, "replays": self.replays,
                "captured_launches": self.captured_launches, "capture_s": self.capture_s,
                "capture_bytes": self.capture_bytes}


def make_epoch_runner(model: VAENAR, optimizer: torch.optim.Optimizer, hp: HParams,
                      cache: Sequence[torch.Tensor]) -> EpochRunner:
    """The runner of epochs over ``cache``, the stacked train batches of
    ``training.loop.device_cache`` (texts, mels, text and mel lengths, each
    [n_batches, ...] on one device); see ``EpochRunner``."""
    return EpochRunner(model, optimizer, hp, cache)


@torch.no_grad()
def dev_step(model: VAENAR, hp: HParams, texts: torch.Tensor, mels: torch.Tensor,
             t_lens: torch.Tensor, m_lens: torch.Tensor, kl_weight: float,
             valid_mask: torch.Tensor, reduction_factor: int,
             generator: Optional[torch.Generator] = None,
             epsilon: Optional[torch.Tensor] = None, dist=None) -> Dict[str, torch.Tensor]:
    """Eval losses (dropout off, BatchNorm on running statistics): the
    per-example losses averaged over the rows where ``valid_mask`` is 1 (a
    repeat-padded tail batch counts only its real rows), kl unclamped.

    With ``dist`` (several processes, each on its rows of a global batch,
    noise drawn for the global batch) the metrics are SUMS over this
    process's real rows instead, with the row count as ``n_valid``: the
    loop adds them over the processes (``DistContext.allsum``) and divides."""
    _, world = _world(dist)
    with data_group(dist.rows(texts.shape[0]) if world > 1 else None):
        _, mel_l2, kl, length_loss, pinball = model(
            texts, mels, m_lens, t_lens, reduction_factor=reduction_factor,
            train=False, reduce_loss=False, generator=generator, epsilon=epsilon)
    n_valid = valid_mask.sum()

    def vmean(x):
        return (x * valid_mask).sum() / (n_valid if world == 1 else 1.0)

    mel_l2, kl, length_loss = vmean(mel_l2), vmean(kl), vmean(length_loss)
    total = mel_l2 + kl_weight * kl + hp.train.length_weight * length_loss
    m = _metrics(mel_l2, kl, length_loss, None if pinball is None else vmean(pinball), total)
    if world > 1:
        m["n_valid"] = n_valid
    return m


@torch.no_grad()
def test_step(model: VAENAR, texts: torch.Tensor, t_lens: torch.Tensor,
              m_lens: torch.Tensor, reduction_factor: int, max_mel_length: int,
              temperature: float = 0.0, generator: Optional[torch.Generator] = None,
              epsilon: Optional[torch.Tensor] = None):
    """The test-interval synthesis (``make_test_step``): a prior sample at
    the given mel lengths, decoded. Returns (mels fp32 [B, max_mel_length,
    out_dim], the decoder's alignments {"dec_<i>": [B, H, T_reduced,
    T_text]}). The JAX package runs it on its plots variant (no Pallas
    kernel); here the forward kernel runs and the alignments are the plain
    softmax of the same q and k beside it (``models/attention.py``)."""
    return model.infer(texts, m_lens, t_lens, reduction_factor=reduction_factor,
                       max_mel_length=max_mel_length, temperature=temperature,
                       generator=generator, epsilon=epsilon, return_alignments=True)


@torch.no_grad()
def run_data_dependent_init(model: VAENAR, texts: torch.Tensor,
                            t_lens: torch.Tensor, m_lens: torch.Tensor,
                            max_mel_length: int,
                            generator: Optional[torch.Generator] = None,
                            epsilon: Optional[torch.Tensor] = None, dist=None) -> None:
    """The cold start's init step: one ``init_pass`` on the batch, whose
    ActNorm statistics become the flow's initial parameters. The BatchNorm
    running statistics that the pass moves are put back, as the JAX package
    keeps only the pass's ``flow_init``. With ``dist`` the batch is this
    process's rows of the global batch, and the statistics the global
    batch's."""
    buffers = {name: b.clone() for name, b in model.named_buffers()}
    with data_group(dist.rows(texts.shape[0]) if _world(dist)[1] > 1 else None):
        flow_init = model.init_pass(texts, m_lens, t_lens, max_mel_length,
                                    generator=generator, epsilon=epsilon)
    for name, b in model.named_buffers():
        b.copy_(buffers[name])
    model.merge_flow_init(flow_init)


def metric_floats(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}
