"""Training checkpoints: ``model_dir/<epoch>/state.pt`` (``torch.save``) of
{model: parameters and BatchNorm buffers, optimizer: Adam's state, epoch}.

The counterpart of ``vaenar_tts_tpu/utils/checkpoint.py`` (Orbax) with its
retention contract: the newest ``max_to_keep`` checkpoints stay, and of the
older ones a checkpoint also stays when it was saved at least
``keep_every_n_hours`` after the last older one that stayed. Directories are
named by the epoch alone, as the training CLI's resume check expects; a save
goes to ``<epoch>.tmp`` first and is renamed into place, and a directory is
renamed away before it is deleted, so every numbered directory holds its
``state.pt``.

A numbered directory without ``state.pt`` is another writer's checkpoint
(the JAX package's Orbax checkpoints are ``model_dir/<epoch>/`` too):
``checkpoint_epochs`` raises ``ForeignCheckpointError`` on such a directory
rather than read past it or overwrite it.

In a multi-process run (``dist``, a ``parallel.distributed.DistContext``)
process 0 writes each checkpoint (every process holds the same state) and
every process then waits at a barrier, so that no process goes on to read
or prune a checkpoint that is half written.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional

import torch

STATE_NAME = "state.pt"


class ForeignCheckpointError(RuntimeError):
    """A model directory holds checkpoints that this package did not write."""


def checkpoint_epochs(model_dir: str) -> List[int]:
    """The sorted epochs of the checkpoints in ``model_dir`` (none if it
    does not exist). Raises ``ForeignCheckpointError``, naming the
    directory, when a numbered directory in it holds no ``state.pt``."""
    if not os.path.isdir(model_dir):
        return []
    numbered = sorted((e for e in os.listdir(model_dir)
                       if e.isdigit() and os.path.isdir(os.path.join(model_dir, e))), key=int)
    foreign = [e for e in numbered
               if not os.path.isfile(os.path.join(model_dir, e, STATE_NAME))]
    if foreign:
        raise ForeignCheckpointError(
            f"{os.path.abspath(model_dir)} holds epoch directories {foreign} without "
            f"{STATE_NAME}: they are not checkpoints of vaenar_tts_torch (an Orbax "
            f"checkpoint of the JAX package?). Nothing was read or written there; "
            f"export the JAX model to export.npz in a directory of its own, or use "
            f"another model directory.")
    return [int(e) for e in numbered]


def _remove_dir(path: str) -> None:
    """Rename ``path`` away, then delete it: an interrupted delete leaves
    no numbered directory without its state."""
    if os.path.isdir(path):
        gone = path + ".del"
        shutil.rmtree(gone, ignore_errors=True)
        os.replace(path, gone)
        shutil.rmtree(gone)


class CheckpointManager:
    def __init__(self, model_dir: str, max_to_keep: int = 20,
                 keep_every_n_hours: float = 4.0, dist=None):
        self.model_dir = os.path.abspath(model_dir)
        self.max_to_keep = max_to_keep
        self.keep_seconds = keep_every_n_hours * 3600.0
        self.dist = dist
        self.written: List[int] = []  # the epochs this process wrote
        checkpoint_epochs(self.model_dir)  # refuses a foreign directory first
        os.makedirs(self.model_dir, exist_ok=True)

    def epochs(self) -> List[int]:
        return checkpoint_epochs(self.model_dir)

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def save(self, epoch: int, model: torch.nn.Module,
             optimizer: Optional[torch.optim.Optimizer] = None) -> str:
        return self.save_state(epoch, model.state_dict(),
                               optimizer.state_dict() if optimizer else None)

    def save_state(self, epoch: int, model_state: dict,
                   optimizer_state: Optional[dict] = None) -> str:
        """``save`` of state dicts taken earlier (a snapshot)."""
        final = os.path.join(self.model_dir, str(epoch))
        if self.dist is None or self.dist.is_main:
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save({"model": model_state, "optimizer": optimizer_state,
                        "epoch": int(epoch)}, os.path.join(tmp, STATE_NAME))
            _remove_dir(final)
            os.replace(tmp, final)
            self._prune()
            self.written.append(int(epoch))
        if self.dist is not None:
            self.dist.barrier()
        return final

    def _prune(self) -> None:
        epochs = self.epochs()
        kept_time = None
        for e in epochs[:max(0, len(epochs) - self.max_to_keep)]:
            path = os.path.join(self.model_dir, str(e))
            saved = os.path.getmtime(os.path.join(path, STATE_NAME))
            if kept_time is None or saved - kept_time >= self.keep_seconds:
                kept_time = saved
                continue
            _remove_dir(path)

    def restore(self, model: torch.nn.Module,
                optimizer: Optional[torch.optim.Optimizer] = None,
                epoch: Optional[int] = None) -> Optional[int]:
        """Load the latest checkpoint, or the one of ``epoch``, into
        ``model`` (and ``optimizer``), on the model's device; return its
        epoch, or None when there is none (of that epoch)."""
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None or epoch not in self.epochs():
            return None
        state = torch.load(os.path.join(self.model_dir, str(epoch), STATE_NAME),
                           map_location=next(model.parameters()).device,
                           weights_only=True)
        model.load_state_dict(state["model"], strict=True)
        if optimizer is not None and state["optimizer"] is not None:
            capturable = [g.get("capturable") for g in optimizer.param_groups]
            optimizer.load_state_dict(state["optimizer"])
            _keep_capturable(optimizer, capturable)
        return int(state["epoch"])


def _keep_capturable(optimizer: torch.optim.Optimizer, flags) -> None:
    """A checkpoint's param groups carry the ``capturable`` flag of the
    optimizer that saved them (Adam: step counts on the card, for a CUDA
    graph). Put back the restoring optimizer's own ``flags`` and move each
    step count to where torch keeps it for that flag: fp32 on the
    parameter's device when capturable, on the host otherwise. A checkpoint
    then resumes across ``train.device_cache_epoch_scan`` either way."""
    for group, flag in zip(optimizer.param_groups, flags):
        if flag is None:  # an optimizer without the flag
            continue
        group["capturable"] = flag
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            if "step" in state:
                state["step"] = (state["step"].to(device=p.device, dtype=torch.float32) if flag
                                 else state["step"].cpu())
