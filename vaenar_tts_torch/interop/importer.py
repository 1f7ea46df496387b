"""Import and export reference ``tf.train.Checkpoint`` weights (the port's
own copy of ``vaenar_tts_tpu/interop/importer.py``, numpy only).

``load_reference_checkpoint`` turns a reference checkpoint prefix (such as
a published pretrained model) into the flax-layout ``(params,
batch_stats)`` trees, which ``interop.weights.load_jax_weights`` loads into
a ``VAENAR``. ``export_reference_checkpoint`` writes the inverse: a
TensorBundle in the reference's variable layout, with the trackable object
graph, so that the reference's own restore finds it.

Strictness, as the JAX package's: every reference ``model/*`` variable must
be consumed and every leaf filled (no silent partial import); a shape that
differs from the configuration's names the variable.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..configs.hparams import HParams
from .tensorbundle import BundleReader, BundleWriter
from .weight_map import build_weight_map


def _set_path(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _get_path(tree: Dict[str, Any], path: Tuple[str, ...]):
    node = tree
    for p in path:
        node = node[p]
    return node


def _tree_paths(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
                ) -> List[Tuple[str, ...]]:
    out: List[Tuple[str, ...]] = []
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.extend(_tree_paths(v, prefix + (k,)))
        else:
            out.append(prefix + (k,))
    return out


def load_reference_checkpoint(
        prefix: str, hp: HParams,
        verify_crc: bool = False) -> Tuple[Dict, Dict]:
    """Read a reference TensorBundle checkpoint into (params, batch_stats).

    ``prefix`` is the checkpoint path without extension (``.../ckpt-234``).
    Works on both full training checkpoints (model + optimizer + step) and
    model-only ones; optimizer slots are ignored like the reference's
    ``expect_partial()`` restore (reference inference.py:123).
    """
    reader = BundleReader(prefix)
    table = build_weight_map(hp)

    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    trees = {"params": params, "batch_stats": batch_stats}

    available = set(reader.keys())
    missing = [k for k in table if k not in available]
    if missing:
        raise ValueError(
            f"checkpoint {prefix} lacks {len(missing)} expected variables "
            f"(config mismatch?), e.g. {sorted(missing)[:3]}")

    for ref_name, (coll, path) in table.items():
        arr = np.asarray(reader.get(ref_name, verify_crc=verify_crc),
                         np.float32)
        _set_path(trees[coll], path, arr)

    # every model variable must be consumed (ignore optimizer/, save_counter,
    # step, the serialized object graph, AND Adam slot variables — TF stores
    # those as 'model/<var>/.OPTIMIZER_SLOT/optimizer/m|v/...', i.e. under
    # the model/ prefix, in full training checkpoints, train.py:246-248)
    consumed = set(table)
    model_vars = {k for k in available
                  if k.startswith("model/") and ".OPTIMIZER_SLOT" not in k}
    orphans = model_vars - consumed
    if orphans:
        raise ValueError(
            f"{len(orphans)} reference model variables not covered by the "
            f"weight map, e.g. {sorted(orphans)[:3]}")
    return params, batch_stats


def check_tree_match(imported: Dict, initialized: Dict,
                     label: str = "params") -> None:
    """Assert the imported tree has exactly the init tree's structure+shapes."""
    imp = {p: np.shape(_get_path(imported, p)) for p in _tree_paths(imported)}
    ini = {p: np.shape(_get_path(initialized, p))
           for p in _tree_paths(initialized)}
    only_imp = set(imp) - set(ini)
    only_ini = set(ini) - set(imp)
    if only_imp or only_ini:
        raise ValueError(
            f"{label}: tree mismatch; extra-in-import={sorted(only_imp)[:3]} "
            f"missing-from-import={sorted(only_ini)[:3]}")
    bad = [(p, imp[p], ini[p]) for p in imp if imp[p] != ini[p]]
    if bad:
        raise ValueError(f"{label}: shape mismatches: {bad[:5]}")


_ATTR_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"


def _object_graph_bytes(keys: List[str]) -> bytes:
    """Serialize a TF TrackableObjectGraph proto reconstructed from the
    checkpoint-key paths, so the reference's OBJECT-BASED restore
    (tf.train.Checkpoint(model=...).restore(prefix), reference
    inference.py:121-123) resolves our exported bundle — without this entry
    TF falls back to name matching, finds nothing, and expect_partial()
    silently restores fresh weights.

    The trackable object topology is recoverable from the keys themselves:
    each '/'-separated component of 'model/a/b/kernel/.ATTRIBUTES/
    VARIABLE_VALUE' is a child attribute name along the reference's Python
    object graph, and the terminal node is the variable holding one
    SerializedTensor attribute named VARIABLE_VALUE."""
    from .tensorbundle import _pb_bytes, _pb_varint

    trie: Dict = {}
    for k in keys:
        if not k.endswith(_ATTR_SUFFIX):
            raise ValueError(f"unexpected checkpoint key layout: {k}")
        node = trie
        for part in k[: -len(_ATTR_SUFFIX)].split("/"):
            node = node.setdefault(part, {})
        node["__key__"] = k

    nodes: List[Optional[Tuple[List[Tuple[int, str]],
                               List[str]]]] = []

    def build(t: Dict) -> int:
        idx = len(nodes)
        nodes.append(None)
        attrs = [t["__key__"]] if "__key__" in t else []
        children = []
        for name in sorted(n for n in t if n != "__key__"):
            children.append((build(t[name]), name))
        nodes[idx] = (children, attrs)
        return idx

    build(trie)

    out = bytearray()
    for children, attrs in nodes:
        obj = bytearray()
        for node_id, local_name in children:
            ref = (_pb_varint(1, node_id)
                   + _pb_bytes(2, local_name.encode("utf-8")))
            obj += _pb_bytes(1, ref)  # TrackableObject.children
        for key in attrs:
            st = (_pb_bytes(1, b"VARIABLE_VALUE")
                  + _pb_bytes(3, key.encode("utf-8")))
            obj += _pb_bytes(2, st)  # TrackableObject.attributes
        out += _pb_bytes(1, bytes(obj))  # TrackableObjectGraph.nodes
    return bytes(out)


def export_reference_checkpoint(prefix: str, hp: HParams, params: Dict,
                                batch_stats: Dict) -> None:
    """Write (params, batch_stats) as a TensorBundle in the reference's exact
    model variable layout (model-only checkpoint, like the published ones),
    including the trackable object graph so the reference's own
    ``tf.train.Checkpoint(model=...).restore(prefix)`` loads it."""
    table = build_weight_map(hp)
    trees = {"params": params, "batch_stats": batch_stats}
    w = BundleWriter(prefix)
    for ref_name, (coll, path) in table.items():
        arr = np.asarray(_get_path(trees[coll], path), np.float32)
        w.add(ref_name, arr)
    # uncovered Flax leaves would silently vanish from the export — check
    for coll, tree in trees.items():
        covered = {path for c, path in table.values() if c == coll}
        leaves = set(_tree_paths(tree))
        extra = leaves - covered
        if extra:
            raise ValueError(f"export: {coll} leaves not in the weight map: "
                             f"{sorted(extra)[:3]}")
    counter_key = "save_counter" + _ATTR_SUFFIX
    w.add(counter_key, np.asarray(1, np.int64))
    w.add_strings("_CHECKPOINTABLE_OBJECT_GRAPH",
                  [_object_graph_bytes(list(table) + [counter_key])],
                  scalar=True)
    w.close()
