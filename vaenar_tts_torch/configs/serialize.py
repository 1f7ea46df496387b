"""Read and write the ``hparams.json`` that sits beside a checkpoint, in
the format of ``vaenar_tts_tpu.configs.serialize``."""

from __future__ import annotations

import dataclasses
import json
import os

from .hparams import HParams


def hparams_to_dict(hp: HParams) -> dict:
    return dataclasses.asdict(hp)


def hparams_from_dict(d: dict) -> HParams:
    """Unknown keys are ignored and missing ones take their defaults, so
    files written before or after a field existed still load. JSON lists
    become tuples."""
    kwargs = {}
    for f in dataclasses.fields(HParams):
        if f.name not in d:
            continue
        if f.default_factory is dataclasses.MISSING:  # a plain field: the name
            kwargs[f.name] = d[f.name]
            continue
        sub, section = f.default_factory, d[f.name]
        kwargs[f.name] = sub(**{
            sf.name: tuple(section[sf.name]) if isinstance(section[sf.name], list)
            else section[sf.name]
            for sf in dataclasses.fields(sub) if sf.name in section})
    return HParams(**kwargs)


def save_hparams(hp: HParams, model_dir: str) -> str:
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, "hparams.json")
    with open(path, "w") as f:
        json.dump(hparams_to_dict(hp), f, indent=2)
    return path


def load_hparams(model_dir: str) -> HParams | None:
    path = os.path.join(model_dir, "hparams.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return hparams_from_dict(json.load(f))
