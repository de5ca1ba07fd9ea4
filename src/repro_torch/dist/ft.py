"""Fault tolerance for a long-lived service (port of ``repro.dist.ft``).

``ServiceFT`` gives the graph server (``repro_torch.serve``) atomic,
shape-blind checkpoints of its resident edges and assignment through
``repro_torch.ckpt``, optionally written on a background thread, and
times its microbatches with a ``StragglerWatch``.

The training half of the reference module (``FTConfig``, ``FTState``,
``run``) waits for the port's training slice (ROADMAP, Queue 1: training).
"""
from __future__ import annotations

import statistics
import threading
from collections import deque

import numpy as np
import torch

from .. import ckpt


class StragglerWatch:
    """Running-median step timer.  ``observe(dt)`` returns True when the
    step exceeds ``factor`` × the median of the recorded history; the
    median is taken before ``dt`` is recorded, so one slow step cannot
    drown its own baseline.  ``factor=0`` disables; ``warmup`` steps of
    history are required before anything can be flagged."""

    def __init__(self, factor: float, warmup: int = 2, maxlen: int = 256):
        self.factor = factor
        self.warmup = warmup
        self._hist: deque[float] = deque(maxlen=maxlen)
        self.flagged = 0
        self.last_median = 0.0     # baseline the last observe compared to

    def observe(self, dt: float) -> bool:
        slow = False
        if self.factor > 0 and len(self._hist) >= self.warmup:
            self.last_median = statistics.median(self._hist)
            slow = dt > self.factor * max(self.last_median, 1e-9)
        self._hist.append(dt)
        if slow:
            self.flagged += 1
        return slow


def _host_copy(tree):
    """Host copies of every leaf, so a background write never sees a
    caller's later change."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return np.array(tree, copy=True)


class _Saver:
    """Serialized checkpoint writes, each on a background thread in
    ``async_mode``; ``wait`` joins the one in flight and re-raises its
    error."""

    def __init__(self, async_mode: bool):
        self.async_mode = async_mode
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def _save(self, ckpt_dir: str, step: int, tree, extra):
        try:
            ckpt.save(ckpt_dir, step, tree, extra=extra)
        except BaseException as e:  # noqa: BLE001 — re-raised in wait()
            self._error = e

    def save(self, ckpt_dir: str, step: int, tree, extra: dict | None = None):
        self.wait()
        tree = _host_copy(tree)
        if self.async_mode:
            self._thread = threading.Thread(
                target=self._save, args=(ckpt_dir, step, tree, extra),
                daemon=True)
            self._thread.start()
        else:
            ckpt.save(ckpt_dir, step, tree, extra=extra)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err


class ServiceFT:
    """Preemption survival for a long-lived service.

    Live ingest grows the resident arrays between snapshots, so restores
    are shape-blind (``ckpt.restore_raw``) and carry a JSON ``extra``
    (the session's config blob, watermarks) beside the arrays.  The
    writes keep the atomic-write, torn-read contract of ``ckpt.save``.
    """

    def __init__(self, ckpt_dir: str, *, async_checkpoint: bool = False,
                 straggler_factor: float = 0.0, straggler_warmup: int = 2):
        self.ckpt_dir = str(ckpt_dir)
        self._saver = _Saver(async_checkpoint)
        self.watch = StragglerWatch(straggler_factor, straggler_warmup)

    def snapshot(self, step: int, tree, extra: dict | None = None):
        """Atomic (optionally async) snapshot of a flat array tree plus a
        JSON-serializable ``extra`` dict."""
        self._saver.save(self.ckpt_dir, step, tree, extra=extra)

    def restore_latest(self):
        """``(flat, extra, step)`` of the newest intact snapshot, or
        ``(None, None, -1)`` when there is none.  ``flat`` is keyed by the
        tree's own keys (flat dict snapshots only)."""
        steps = ckpt.list_steps(self.ckpt_dir)
        if not steps:
            return None, None, -1
        flat, manifest = ckpt.restore_raw(self.ckpt_dir, steps[-1])
        flat = {k.strip("[]'\""): v for k, v in flat.items()}
        return flat, manifest.get("extra", {}), steps[-1]

    def wait(self):
        """Block until any in-flight async snapshot lands (re-raises)."""
        self._saver.wait()
