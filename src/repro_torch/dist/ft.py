"""Fault tolerance: checkpoint-restart and the straggler watch (port of
``repro.dist.ft``).

``run`` wraps any ``step_fn(params, opt_state, batch, i)`` in a loop that
- restores the latest intact checkpoint on entry (``ckpt.restore_latest``
  onto the current trees),
- checkpoints every ``ckpt_every`` steps (optionally on a background
  thread) and once at completion,
- times every step, synchronized on its loss (``loss.item()``), and
  flags stragglers (a step above factor × the running median),
- can inject a failure at a given step for restart tests.

``ServiceFT`` gives the graph server (``repro_torch.serve``) atomic,
shape-blind checkpoints of its resident edges and assignment through
``repro_torch.ckpt``, optionally written on a background thread, and
times its microbatches with a ``StragglerWatch``.
"""
from __future__ import annotations

import dataclasses
import statistics
import threading
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from .. import ckpt


@dataclasses.dataclass
class FTConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    resume: str = "auto"               # "auto" restores latest; "none" skips
    async_checkpoint: bool = False     # save on a background thread
    fail_at_step: int | None = None    # inject RuntimeError (tests)
    straggler_factor: float = 0.0      # 0 disables detection
    straggler_warmup: int = 2          # steps of timing history required


@dataclasses.dataclass
class FTState:
    step: int = 0          # next step to execute (== total when done)
    stragglers: int = 0
    restarts: int = 0


def _tree(params, opt_state):
    return {"params": params, "opt": opt_state}


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


def run(step_fn: Callable, params, opt_state, data_fn: Callable,
        total_steps: int, cfg: FTConfig, *, log_every: int = 10,
        log_fn: Callable = print, on_straggler: Callable | None = None):
    """Drive ``total_steps`` of training with checkpoint-restart.

    ``step_fn(params, opt_state, batch, i) → (params, opt_state, loss)``
    with ``i`` a Python int and ``loss`` a 0-d tensor; ``data_fn(i)`` gives
    step i's batch.  A restored checkpoint lands on the devices of the
    current ``params`` and ``opt_state``.  Returns (params, opt_state,
    losses, state); ``losses`` covers only the steps executed in *this*
    invocation (a restart resumes mid-stream)."""
    state = FTState()
    start = 0
    if cfg.resume == "auto":
        try:
            restored, step = ckpt.restore_latest(
                cfg.ckpt_dir, _tree(params, opt_state))
        except (AssertionError, KeyError) as e:
            raise RuntimeError(
                f"checkpoint in {cfg.ckpt_dir!r} does not match the current "
                f"model (different arch/config?) — pass resume='none' or a "
                f"fresh ckpt_dir to start over: {e}") from e
        if step >= 0:
            params, opt_state = restored["params"], restored["opt"]
            start = step + 1
            state.restarts = 1
            if log_every:
                log_fn(f"[ft] restored step {step}, resuming at {start}")
    saver = _Saver(cfg.async_checkpoint)
    losses: list[float] = []
    watch = StragglerWatch(cfg.straggler_factor, cfg.straggler_warmup)
    last_saved = -1
    for i in range(start, total_steps):
        if cfg.fail_at_step is not None and i == cfg.fail_at_step:
            saver.wait()
            raise RuntimeError(f"injected failure at step {i}")
        batch = data_fn(i)
        t0 = time.perf_counter()
        params, opt_state, loss = step_fn(params, opt_state, batch, i)
        loss = loss.item()               # waits for the step
        dt = time.perf_counter() - t0
        if watch.observe(dt):
            state.stragglers += 1
            if on_straggler is not None:
                on_straggler(i, dt, watch.last_median)
        losses.append(loss)
        state.step = i + 1
        if log_every and i % log_every == 0:
            log_fn(f"[ft] step {i} loss {loss:.4f} {dt*1e3:.1f}ms")
        if cfg.ckpt_every and i > 0 and i % cfg.ckpt_every == 0:
            saver.save(cfg.ckpt_dir, i, _tree(params, opt_state))
            last_saved = i
    if total_steps > start and last_saved != total_steps - 1:
        saver.save(cfg.ckpt_dir, total_steps - 1, _tree(params, opt_state))
    saver.wait()
    state.step = max(state.step, start)
    return params, opt_state, losses, state


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
