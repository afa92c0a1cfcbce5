"""Sharded checkpoints of parameter trees; port of
``githubrepostorag_tpu/training/checkpoint.py``.

JAX writes orbax checkpoints whose arrays round-trip with their shardings.
The port has its own format over ``models/safetensors_io.py``, one
directory a checkpoint:

  shard-<i>.safetensors  rank i's slices (i: its place in the row-major
                         device grid), one entry a leaf, keyed by its path
  manifest.json          the plan, and per leaf its path, dtype, whole
                         shape and spec; the quantized NamedTuple nodes

Every rank writes its own slices into ``<path>.partial``; the first rank
of the mesh writes the manifest last and renames the directory into place,
so a reader finds a whole checkpoint or none.  Restoring onto a template
reads only this rank's file (no gather); without one, the whole tensors
are assembled on the CPU from every rank's slices.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from githubrepostorag_tpu_torch.models import quant
from githubrepostorag_tpu_torch.models.safetensors_io import load_file, save_file
from githubrepostorag_tpu_torch.parallel.mesh import AXIS_NAMES, Mesh, MeshPlan
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

MANIFEST = "manifest.json"
_NODES = {cls.__name__: cls for cls in quant.QUANTIZED_TYPES}


def _flatten(tree, specs, prefix=""):
    """(path, tensor, spec) of every leaf, and the paths of quantized nodes."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, None if specs is None else specs[k], f"{prefix}{k}/")
    elif isinstance(tree, tuple):
        yield prefix[:-1], type(tree).__name__, None
        for name, v, spec in zip(tree._fields, tree, specs or (None,) * len(tree)):
            yield from _flatten(v, spec, f"{prefix}{name}/")
    elif isinstance(tree, torch.Tensor):
        yield prefix[:-1], tree, tuple(specs or (None,) * tree.dim())
    else:
        raise TypeError(f"{prefix[:-1]}: a checkpoint holds tensors, not {type(tree).__name__}")


def _unflatten(leaves: dict, nodes: dict) -> dict:
    tree: dict = {}
    for path, t in leaves.items():
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = t

    def build(node, prefix):
        if not isinstance(node, dict):
            return node
        out = {k: build(v, f"{prefix}{k}/") for k, v in node.items()}
        cls = nodes.get(prefix[:-1])
        return cls(**out) if cls is not None else out

    return build(tree, "")


def save_checkpoint(path: str, tree: Any, *, force: bool = True, mesh: Mesh | None = None,
                    specs: Any = None) -> None:
    """Write a tree (dicts of tensors and quantized NamedTuples; this rank's
    slices, per ``specs``, on ``mesh``) to ``path``.  Every rank of the mesh
    calls it; ``force`` overwrites an existing checkpoint."""
    mesh = mesh if mesh is not None else Mesh(MeshPlan())
    path = os.path.abspath(path)
    stage = path + ".partial"
    if os.path.exists(path) and not force:
        raise FileExistsError(f"checkpoint {path} exists (force=False)")
    lead = mesh.index == 0
    if lead:
        shutil.rmtree(stage, ignore_errors=True)
        os.makedirs(stage)
    mesh.barrier()

    tensors, entries, nodes = {}, [], {}
    for name, leaf, spec in _flatten(tree, specs):
        if isinstance(leaf, str):
            nodes[name] = leaf
            continue
        shape = [d * (mesh.shape[a] if a else 1) for d, a in zip(leaf.shape, spec)]
        tensors[name] = leaf
        entries.append({"path": name, "dtype": str(leaf.dtype).removeprefix("torch."),
                        "shape": shape, "spec": list(spec)})
    save_file(tensors, os.path.join(stage, f"shard-{mesh.index}.safetensors"))
    mesh.barrier()
    if lead:
        manifest = {"plan": mesh.shape, "leaves": entries, "nodes": nodes}
        tmp = os.path.join(stage, MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(stage, MANIFEST))
        shutil.rmtree(path, ignore_errors=True)
        os.replace(stage, path)
        logger.info("checkpoint written: %s", path)
    mesh.barrier()


def load_checkpoint(path: str, template: Any | None = None, *, mesh: Mesh | None = None) -> Any:
    """Restore a tree.  With ``template`` (a tree of the same structure,
    e.g. this rank's freshly initialised slices) each rank reads its own
    slices onto the template's device and dtype; the checkpoint's plan
    must be ``mesh``'s.  Without it the whole tensors come back on the
    CPU, assembled from every rank's slices."""
    path = os.path.abspath(path)
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    nodes = {k: _NODES[v] for k, v in manifest["nodes"].items()}
    plan = manifest["plan"]
    if template is not None:
        mesh = mesh if mesh is not None else Mesh(MeshPlan())
        if plan != mesh.shape:
            raise ValueError(f"checkpoint {path} was written on plan {plan}, this mesh is "
                             f"{mesh.shape}")
        stored = load_file(os.path.join(path, f"shard-{mesh.index}.safetensors"))
        out = {}
        for name, ref, _ in _flatten(template, None):
            if isinstance(ref, str):
                continue
            t = stored[name]
            if t.shape != ref.shape:
                raise ValueError(f"{name}: checkpoint slice {tuple(t.shape)}, template "
                                 f"{tuple(ref.shape)}")
            out[name] = t.to(device=ref.device, dtype=ref.dtype, copy=True)
        return _unflatten(out, nodes)

    sizes = [plan[a] for a in AXIS_NAMES]
    whole = {e["path"]: torch.empty(e["shape"], dtype=getattr(torch, e["dtype"]))
             for e in manifest["leaves"]}
    for i in range(int(np.prod(sizes))):
        coords = dict(zip(AXIS_NAMES, (int(c) for c in np.unravel_index(i, sizes))))
        stored = load_file(os.path.join(path, f"shard-{i}.safetensors"))
        for e in manifest["leaves"]:
            dst = whole[e["path"]]
            for dim, axis in enumerate(e["spec"]):
                if axis:
                    size = dst.shape[dim] // plan[axis]
                    dst = dst.narrow(dim, coords[axis] * size, size)
            dst.copy_(stored[e["path"]])
    return _unflatten(whole, nodes)
