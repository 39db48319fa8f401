"""Checkpoints: a sha256-manifested store of one ``.npy`` file a leaf (the
port of ``repro/ckpt/checkpoint.py``, in its on-disk format).

Layout (one directory per step)::

  step-000100/
    manifest.json     tree leaves' shape / dtype / file / sha256 and the
                      step's extra metadata; written last, and the directory
                      renamed into place from ``step-000100.tmp``, so a
                      crashed save is invisible
    <leaf-path>.npy   one array per leaf (row-major, ``np.save`` format)

A leaf's name is its path in the reference model's tree, joined by
``/``: dict keys, sequence indices and named-tuple fields, as the
reference's ``_flatten_with_paths`` names them, so ``(params,
AdamWState(step, mu, nu))`` gives ``0/...``, ``1/step``, ``1/mu/...``,
``1/nu/...``.  The port's parameter tree names some leaves otherwise than
the reference's (the embedding ``embed`` for ``embed/table``, the dense
stack ``layers`` for ``dense_layers``, a kernel without its ``/kernel``),
and the reference's name depends on the model's family, so every entry
point that writes or reads a model's tree takes ``family`` (the model
config's): each dict-key tail of a path is then written as the reference
names it (the inverse of the bridge's renaming,
:func:`repro_torch.models.params._jax_path`), and each side restores the
other's checkpoints of a model and its optimizer state.  A tree that is
not a model's is given no family and keeps its own keys, as it does in
the reference.

Dtypes: numpy has no bfloat16, so the port writes a bfloat16 leaf as its
exact f32 values (manifest dtype ``float32``) and casts it back through a
bfloat16 template; a reference file of a bfloat16 leaf (raw 2-byte
``|V2`` records, manifest dtype ``bfloat16``), which the reference itself
cannot cast back, is read bit for bit.

The reference's restore is elastic: it reshards each array onto a mesh.
The port runs on one card, so there is nothing to reshard: a restored leaf
goes to its template leaf's device, whole.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.models.params import _jax_path

PyTree = Any


def _children(node) -> list[tuple[str, Any]] | None:
    """(name, child) pairs of an inner node in the reference's order (dict
    keys sorted, as ``jax.tree_util`` flattens them), None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten_with_paths(tree: PyTree, family: str | None = None) -> list[tuple[str, Any]]:
    out = []

    def walk(node, path: tuple[str, ...], keys: int) -> None:
        kids = _children(node)
        if kids is None:
            if family is not None and keys:
                path = path[: len(path) - keys] + _jax_path(path[len(path) - keys :], family)
            out.append(("/".join(path), node))
            return
        is_dict = isinstance(node, dict)
        for name, child in kids:
            walk(child, path + (name,), keys + 1 if is_dict else 0)

    walk(tree, (), 0)
    return out


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def save_checkpoint(
    directory: str, step: int, tree: PyTree, *, extra: dict | None = None,
    family: str | None = None,
) -> str:
    """Write ``tree`` at ``directory/step-NNNNNN``; returns the path.  A
    model's tree is given its config's ``family``, whose leaves are then
    named as the reference names them."""
    cdir = os.path.join(directory, f"step-{step:06d}")
    tmp = cdir + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest: dict[str, Any] = {"step": step, "leaves": {}, "extra": extra or {}}
    for name, leaf in _flatten_with_paths(tree, family):
        arr = _to_numpy(leaf)
        fname = name.replace("/", "__") + ".npy"
        fpath = os.path.join(tmp, fname)
        np.save(fpath, arr)
        manifest["leaves"][name] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "sha256": _sha256_file(fpath),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(cdir):
        raise FileExistsError(cdir)
    os.rename(tmp, cdir)  # atomic publish
    return cdir


def _steps(directory: str) -> list[int]:
    return sorted(int(d.split("-")[1]) for d in os.listdir(directory)
                  if d.startswith("step-") and not d.endswith(".tmp"))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def _to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A stored array as a CPU tensor; a reference bfloat16 leaf's 2-byte
    records are reinterpreted, not converted."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def restore_checkpoint(
    directory: str,
    step: int | None = None,
    *,
    template: PyTree | None = None,
    verify: bool = True,
    family: str | None = None,
) -> tuple[PyTree, dict]:
    """Load step ``step`` (the latest by default).  With ``template`` (a
    tree of tensors, whose leaves give the structure, the shape, the dtype
    to cast to and the device; a leaf on the ``meta`` device restores to
    the CPU) returns that tree; without, a dict of leaf name to CPU
    tensor.  ``verify`` checks every file's sha256 against the
    manifest and raises ``IOError`` on a mismatch.  ``family`` as for
    :func:`save_checkpoint`: a model's template finds each leaf under the
    reference's name."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    cdir = os.path.join(directory, f"step-{step:06d}")
    with open(os.path.join(cdir, "manifest.json")) as f:
        manifest = json.load(f)

    tensors: dict[str, torch.Tensor] = {}
    for name, meta in manifest["leaves"].items():
        fpath = os.path.join(cdir, meta["file"])
        if verify and _sha256_file(fpath) != meta["sha256"]:
            raise IOError(f"checksum mismatch for {name} in {cdir}")
        tensors[name] = _to_tensor(np.load(fpath), meta["dtype"])

    if template is None:
        return tensors, manifest

    leaves = iter(_flatten_with_paths(template, family))

    def build(node):
        kids = _children(node)
        if kids is None:
            name, tmpl = next(leaves)
            if name not in tensors:
                raise KeyError(f"checkpoint missing leaf {name}")
            t = tensors[name]
            want = tuple(tmpl.shape)
            if tuple(t.shape) != want:
                raise ValueError(f"shape mismatch for {name}: ckpt {tuple(t.shape)} vs {want}")
            dev = "cpu" if tmpl.device.type == "meta" else tmpl.device
            return t.to(device=dev, dtype=tmpl.dtype)
        built = {k: build(v) for k, v in kids}
        if isinstance(node, dict):
            return {k: built[str(k)] for k in node}
        values = [built[k] for k, _ in kids]
        return type(node)(*values) if hasattr(node, "_fields") else type(node)(values)

    return build(template), manifest


class CheckpointManager:
    """Keep-last-N rotation and a save every K steps around save and
    restore; ``family`` as for :func:`save_checkpoint`, for a model's
    tree."""

    def __init__(self, directory: str, *, keep: int = 3, every: int = 100,
                 family: str | None = None):
        self.directory = directory
        self.keep = keep
        self.every = every
        self.family = family

    def maybe_save(self, step: int, tree: PyTree, **extra: Any) -> str | None:
        if step % self.every != 0:
            return None
        path = save_checkpoint(self.directory, step, tree, extra=extra, family=self.family)
        self._rotate()
        return path

    def _rotate(self) -> None:
        for s in _steps(self.directory)[: -self.keep]:
            cdir = os.path.join(self.directory, f"step-{s:06d}")
            for f in os.listdir(cdir):
                os.remove(os.path.join(cdir, f))
            os.rmdir(cdir)

    def restore_latest(self, **kw: Any):
        return restore_checkpoint(self.directory, family=self.family, **kw)
