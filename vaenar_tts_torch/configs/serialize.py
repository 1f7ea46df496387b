"""Read the ``hparams.json`` that sits beside a checkpoint, in the format of
``vaenar_tts_tpu.configs.serialize``."""

from __future__ import annotations

import dataclasses
import json
import os

from .hparams import HParams


def hparams_from_dict(d: dict) -> HParams:
    """Unknown keys are ignored and missing ones take their defaults, so
    files written before or after a field existed still load."""
    kwargs = {}
    for f in dataclasses.fields(HParams):
        if f.name in d:
            sub = f.default_factory
            kwargs[f.name] = sub(**{sf.name: d[f.name][sf.name]
                                    for sf in dataclasses.fields(sub)
                                    if sf.name in d[f.name]})
    return HParams(**kwargs)


def load_hparams(model_dir: str) -> HParams | None:
    path = os.path.join(model_dir, "hparams.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return hparams_from_dict(json.load(f))
