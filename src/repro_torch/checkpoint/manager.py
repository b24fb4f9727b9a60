"""Durable engine checkpoints with atomic commit and async writes
(the reference's DESIGN.md §15) — the port of
``repro.checkpoint.manager``, with its layout, leaf names and manifest, so
a checkpoint that either package writes restores in the other.

Layout (one directory per step)::

    <dir>/step_000120/
        manifest.json        # step, leaf names/shapes/dtypes, extra payload
        <leaf-name>.npy      # one file per pytree leaf
        vpq/...              # side files written by the capture hook
        COMMITTED            # written last inside the tmp dir

Writes go to ``step_N.tmp`` and are renamed into place only after every
file — leaves, side files, manifest, commit marker — exists, so a crash at
*any* moment never corrupts a restorable step: restart just picks the
newest directory whose ``COMMITTED`` marker exists (``committed_steps()``
skips ``.tmp`` and uncommitted dirs).  The rename is the single commit
point (:meth:`_commit` — factored out so the crash-injection harness can
kill the process between tmp-write and rename and prove exactly that).

Saving is split in two so the engine can keep mutating after ``save()``
returns:

* the **capture hook** runs synchronously on the caller's thread —
  anything that references live, mutable engine structures (the VPQ's
  spill runs, which the engine deletes as they exhaust) must be captured
  *now*, into the tmp dir (``capture(tmp_dir) -> dict``); its return value
  lands in the manifest's ``extra`` field;
* the **leaf writes** plus manifest and commit run on a background thread
  (async checkpointing — the run continues while the previous step
  flushes); ``wait()`` joins it.  The leaves are host copies made before
  ``save()`` returns: a tensor on the CPU converts to a numpy *view* of
  its storage, which the engine may overwrite while the writer runs, so
  each leaf is copied explicitly, on the CPU as from the card.

The reference walks its tree with ``jax.tree``; :func:`_flatten` and
:func:`_unflatten` do the same over dicts, lists and tuples, in the same
leaf order (dict keys sorted, sequence items in order, ``None`` holding no
leaf) and under the same names (path parts joined by ``__``, sequence
indices in decimal).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import NOOP


def _flatten(tree, path: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """``(path, leaf)`` pairs of ``tree`` in ``jax.tree``'s leaf order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten(tree[key], path + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _flatten(item, path + (str(i),))
    elif tree is not None:
        yield path, tree


def _unflatten(like, leaves: List[Any]):
    """``like``'s structure with its leaves replaced by ``leaves``, taken
    in :func:`_flatten`'s order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(item) for item in node)
        return None if node is None else next(it)
    return build(like)


def _leaf_names(tree) -> list:
    return ["__".join(path) for path, _ in _flatten(tree)]


def _host_copy(x) -> np.ndarray:
    """A numpy copy of ``x`` that shares no storage with it."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.array(x, copy=True)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3, obs=None):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        # observability handles (DESIGN.md §16); metrics are thread-safe,
        # so the writer thread records into the same registry
        self.obs = obs if obs is not None else NOOP
        self._m_saves = self.obs.counter(
            "checkpoint_saves_total", "checkpoint save() calls")
        self._m_bytes = self.obs.counter(
            "checkpoint_bytes_written_total",
            "bytes committed (leaves + side files + manifest)")
        self._h_capture = self.obs.histogram(
            "checkpoint_capture_seconds",
            "synchronous capture-hook duration (blocks the engine)")
        self._h_commit = self.obs.histogram(
            "checkpoint_commit_seconds",
            "writer-thread flush+commit duration (off the engine path)")
        # a crash between tmp-write and rename strands a ``.tmp`` dir;
        # it is uncommitted garbage by definition (the rename is the
        # commit point), so sweep it on attach
        for d in os.listdir(directory):
            if d.startswith("step_") and d.endswith(".tmp"):
                shutil.rmtree(os.path.join(directory, d),
                              ignore_errors=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, blocking: bool = False,
             capture: Optional[Callable[[str], Dict[str, Any]]] = None):
        """Snapshot ``tree`` to host, run ``capture`` synchronously into the
        tmp dir, then write and commit asynchronously."""
        with self.obs.span("checkpoint.save"):
            self._m_saves.inc()
            host_tree = _unflatten(
                tree, [_host_copy(x) for _, x in _flatten(tree)])
            self.wait()
            final = os.path.join(self.dir, f"step_{step:08d}")
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            # synchronous: side files must reference engine structures
            # *before* the caller mutates them again (e.g. VPQ runs
            # deleted on exhaust)
            t0 = time.perf_counter() if self.obs.enabled else 0.0
            with self.obs.span("checkpoint.capture"):
                extra = capture(tmp) if capture is not None else None
            if self.obs.enabled:
                self._h_capture.observe(time.perf_counter() - t0)
            self._thread = threading.Thread(
                target=self._write,
                args=(step, host_tree, tmp, final, extra), daemon=True)
            self._thread.start()
        if blocking:
            self.wait()

    def _write(self, step: int, host_tree, tmp: str, final: str, extra):
        t0 = time.perf_counter() if self.obs.enabled else 0.0
        with self.obs.span("checkpoint.commit"):
            names = _leaf_names(host_tree)
            leaves = [leaf for _, leaf in _flatten(host_tree)]
            manifest = {"step": step, "leaves": [], "extra": extra}
            for name, leaf in zip(names, leaves):
                np.save(os.path.join(tmp, name + ".npy"), leaf)
                manifest["leaves"].append(
                    {"name": name, "shape": list(leaf.shape),
                     "dtype": str(leaf.dtype)})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "COMMITTED"), "w") as f:
                f.write("ok")
            if self.obs.enabled:
                self._m_bytes.inc(sum(
                    os.path.getsize(os.path.join(root, f))
                    for root, _dirs, files in os.walk(tmp) for f in files))
            self._commit(tmp, final)
            self._gc()
        if self.obs.enabled:
            self._h_commit.observe(time.perf_counter() - t0)

    def _commit(self, tmp: str, final: str):
        """The atomic commit point: everything before this is invisible to
        ``committed_steps()``; after the rename the step is durable."""
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)

    def _gc(self):
        steps = sorted(self.committed_steps())
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self):
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    # --------------------------------------------------------------- restore
    def committed_steps(self) -> list:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, d, "COMMITTED")):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        """Directory of a committed step (the capture hook's side files
        live under it)."""
        return os.path.join(self.dir, f"step_{step:08d}")

    def read_manifest(self, step: Optional[int] = None) -> Dict[str, Any]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        with open(os.path.join(self.path(step), "manifest.json")) as f:
            return json.load(f)

    def restore(self, like: Any, step: Optional[int] = None) -> Any:
        """Restore the leaf arrays into the structure of ``like``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        path = self.path(step)
        names = _leaf_names(like)
        leaves = [np.load(os.path.join(path, n + ".npy")) for n in names]
        return _unflatten(like, leaves)
