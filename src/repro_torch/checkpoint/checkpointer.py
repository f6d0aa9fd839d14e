"""Fault-tolerant checkpointing: background save, atomic commit.

Counterpart of ``repro.checkpoint.checkpointer``. Layout:

  <dir>/step_<n>/leaves.npz     the tree's tensors, ``leaf_<i>`` in order
  <dir>/step_<n>/MANIFEST.json  step, leaf count, structure string
  <dir>/LATEST                  the newest complete step, replaced atomically

Fault tolerance:
  * a save writes ``step_<n>.tmp`` and renames it when complete, so a crash
    mid-save never corrupts the restore point, and ``LATEST`` moves by
    ``os.replace``;
  * the write runs on a background thread; the tree is snapshotted on the
    caller's thread first, as host copies that later in-place writes to the
    tree (on either device) cannot reach;
  * ``_gc`` keeps the newest ``keep`` steps;
  * :meth:`Checkpointer.restore` checks the manifest's structure against the
    template's, so a snapshot never loads into another structure.

A tree is a GP (``AdditiveGP`` and the dataclasses under it: ``DimOps``,
``Banded``, ``HealthState``, ``CoarseLevel``), a fleet's stack, or any
nesting of dataclasses, tuples, lists and dicts over tensors. The port's
own :func:`flatten` walks it: tensors are the leaves; field names and the
static fields (the baked ``GPConfig``, band ``lo``/``hi``, level strides)
make the structure string. A dataclass is rebuilt through its constructor
from its ``init`` fields, so derived fields (a ``DimOps``' block-CR
factors) are made again from the restored bands, with the same bits.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

__all__ = ["Checkpointer", "flatten", "unflatten"]


def flatten(tree):
    """``(leaves, structure)``: the tree's tensors in a fixed order, and a
    string naming every node, field and static value (tensors as ``*``)."""
    leaves: list = []

    def walk(o) -> str:
        if torch.is_tensor(o):
            leaves.append(o)
            return "*"
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            return type(o).__name__ + "(" + ", ".join(
                f"{f.name}={walk(getattr(o, f.name))}"
                for f in dataclasses.fields(o) if f.init) + ")"
        if isinstance(o, (tuple, list)):
            inner = ", ".join(walk(x) for x in o)
            return f"({inner},)" if isinstance(o, tuple) else f"[{inner}]"
        if isinstance(o, dict):
            return "{" + ", ".join(f"{k!r}: {walk(o[k])}"
                                   for k in sorted(o)) + "}"
        return repr(o)

    structure = walk(tree)
    return leaves, structure


def unflatten(template, leaves):
    """The template's structure with its tensors replaced, in
    :func:`flatten` order, by ``leaves`` (numpy arrays or tensors), each
    moved to the device of the template tensor it replaces."""
    it = iter(leaves)

    def build(o):
        if torch.is_tensor(o):
            return torch.as_tensor(next(it)).to(o.device)
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            return type(o)(**{f.name: build(getattr(o, f.name))
                              for f in dataclasses.fields(o) if f.init})
        if isinstance(o, (tuple, list)):
            return type(o)(build(x) for x in o)
        if isinstance(o, dict):
            return {k: build(o[k]) for k in sorted(o)}
        return o

    return build(template)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = False):
        """Snapshot ``tree`` now (host copies) and write it as ``step`` on a
        background thread (``blocking``: wait for the write)."""
        leaves, structure = flatten(tree)
        # .to(copy=True): a CPU tensor's .cpu() is the same storage
        host = [t.detach().to("cpu", copy=True).numpy() for t in leaves]
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, host, structure), daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        """Join the write in flight; re-raise an error it met."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    def _write(self, step: int, host: list, structure: str):
        try:
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "leaves.npz"),
                     **{f"leaf_{i}": a for i, a in enumerate(host)})
            manifest = {"step": step, "n_leaves": len(host),
                        "structure": structure, "time": time.time()}
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            with open(os.path.join(self.dir, "LATEST.tmp"), "w") as f:
                f.write(str(step))
            os.replace(os.path.join(self.dir, "LATEST.tmp"),
                       os.path.join(self.dir, "LATEST"))
            self._gc()
        except BaseException as e:  # handed to the caller by wait()
            self._error = e

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.dir)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def latest_step(self) -> int | None:
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip())

    def restore(self, template):
        """``(tree, step)`` from the newest checkpoint, the tree shaped as
        ``template`` and on its device; ``(None, 0)`` when there is none.

        The manifest's structure must equal the template's: the leaf count
        alone cannot tell apart two trees with as many tensors but other
        static fields (a GP saved under another baked config), and loading
        into the wrong structure is the corrupt restore the health layer
        exists to catch. A mismatch raises ``ValueError``."""
        step = self.latest_step()
        if step is None:
            return None, 0
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        leaves_t, structure = flatten(template)
        if manifest["n_leaves"] != len(leaves_t):
            raise ValueError(
                f"checkpoint {d}: {manifest['n_leaves']} leaves on disk, "
                f"template has {len(leaves_t)}")
        if manifest["structure"] != structure:
            raise ValueError(
                f"checkpoint {d}: tree structure mismatch\n"
                f"  on disk:  {manifest['structure']}\n"
                f"  template: {structure}")
        with np.load(os.path.join(d, "leaves.npz"),
                     allow_pickle=False) as data:
            leaves = [data[f"leaf_{i}"] for i in range(len(leaves_t))]
        return unflatten(template, leaves), step
