"""Batch-sharded synthesis over a process group (the port of
``vaenar_tts_tpu/parallel/synthesis.py``).

Each data-group member synthesizes its contiguous rows of a batch through
the synthesis path (``cli.inference.synthesize``: the length head, the
flow prior and the decoder, with the attention kernels on the card); at a
temperature above 0 its noise is its rows of the global batch's draw, so
the fleet's rows equal one process's call on the whole batch. The mels and
lengths are gathered to every process. On a mesh with ``model > 1`` the
processes of a model group synthesize the same rows together: the wide
kernels are cut to tensor-parallel shards (``mesh.shard_params``, as the
JAX package's ``ShardedSynthesizer`` honours the mesh's rules), and a model
built with ``VAENAR(hp, seq_mesh=dist)`` rings its long self-attentions
over the group; their generators must be seeded alike.
"""

from __future__ import annotations

import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..cli.inference import resolve_length_source, synthesize
from ..configs.hparams import HParams
from ..data.loader import Batch, BucketedLoader
from ..models.vaenar import VAENAR
from .data_group import data_group
from .mesh import make_mesh, shard_params


class ShardedSynthesizer:
    def __init__(self, hp: HParams, model: VAENAR, dist=None):
        """``dist``: a ``DistContext`` laid out as its ``mesh`` (None: one
        process, the plain synthesis). The lengths come from the head the
        synthesis CLI picks by default (``resolve_length_source("auto")``),
        without headroom."""
        self.hp = hp
        self.dist = dist
        self.mesh = make_mesh(model=1, processes=1) if dist is None else dist.mesh
        self.model = shard_params(model, self.mesh, dist)
        self.n_data = self.mesh.shape["data"]
        self.use_q = resolve_length_source("auto", hp)

    def synthesize(self, texts: np.ndarray, text_lengths: np.ndarray, max_mel_length: int,
                   temperature: float = 0.0, generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """texts [B, T] (B divisible by the processes) -> (mels [B,
        max_mel_length, num_mels], predicted lengths [B]), whole on every
        process, on the model's device."""
        B = texts.shape[0]
        if B % self.n_data:
            raise ValueError(f"batch {B} does not split over {self.n_data} processes")
        k, group, rows = B // self.n_data, None, slice(None)
        if self.n_data > 1:
            group = self.dist.rows(k)
            rows = slice(group.start, group.stop)
        with data_group(group):
            mels, lens = synthesize(self.model, self.hp, texts[rows], text_lengths[rows],
                                    max_mel_length, temperature, self.use_q,
                                    generator=generator)
        if self.n_data > 1:
            mels, lens = self.dist.fetch(mels), self.dist.fetch(lens)
        return mels, lens

    def run_dataset(self, loader: BucketedLoader, max_mel_length: int,
                    temperature: float = 0.0, seed: int = 0
                    ) -> Iterator[Tuple[Batch, np.ndarray, np.ndarray, float]]:
        """(batch, mels, predicted lengths, seconds) per batch of the
        loader's epoch 0, the noise from one generator seeded ``seed``.
        ``seconds`` is the wall time of the call, the gather and the copy
        of the mels to the host included."""
        device = next(self.model.parameters()).device
        gen = torch.Generator(device=device).manual_seed(seed)
        for batch in loader.epoch(0):
            t0 = time.perf_counter()
            mels, lens = self.synthesize(batch.texts, batch.text_lengths, max_mel_length,
                                         temperature, gen)
            mels, lens = mels.cpu().numpy(), lens.cpu().numpy()
            yield batch, mels, lens, time.perf_counter() - t0
