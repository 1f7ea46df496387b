"""Dotted-path config overrides (the port's copy of
``vaenar_tts_tpu/configs/overrides.py``):

    hp = apply_overrides(HParams(), ["prior.n_blk=12", "train.learning_rate=1e-4"])

A path that names no field raises ``AttributeError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from .hparams import HParams


def _parse_value(raw: str, current: Any) -> Any:
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, tuple):
        parts = [p for p in raw.strip("()[]").split(",") if p]
        elem = current[0] if current else 0
        return tuple(type(elem)(p) for p in parts)
    return raw


def apply_overrides(hp: HParams, overrides: Sequence[str]) -> HParams:
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be key.path=value: {ov!r}")
        path, raw = ov.split("=", 1)
        keys = path.strip().split(".")
        nodes = [hp]
        for k in keys[:-1]:
            nodes.append(getattr(nodes[-1], k))
        current = getattr(nodes[-1], keys[-1])
        new = dataclasses.replace(nodes[-1], **{keys[-1]: _parse_value(raw.strip(), current)})
        for node, key in zip(reversed(nodes[:-1]), reversed(keys[:-1])):
            new = dataclasses.replace(node, **{key: new})
        hp = new
    return hp
