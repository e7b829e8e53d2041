"""Fault-tolerant training driver.

Port of ``repro/runtime/trainer.py``:

- **checkpoint/restart**: periodic async checkpoints; a step that raises
  ``FloatingPointError``, ``RuntimeError`` or ``ValueError`` (on a card
  that includes ``torch.OutOfMemoryError`` and CUDA launch errors) triggers
  a restore from the latest checkpoint and the run goes on, up to
  ``max_restarts`` times;
- **straggler watchdog**: per-step wall time against a rolling median;
  a step slower than ``straggler_factor`` x the median is a straggler
  event (and a call of ``on_straggler``);
- ``inject_failure``, a hook for tests, is called before each step.

Each step waits for the device (``torch.cuda.synchronize`` on the state's
CUDA device) before its time is taken.  ``resize`` moves the live state
onto other shardings (elastic re-mesh: each leaf gathered whole, then laid
out on its new mesh).
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Iterator, Optional

import torch
from torch.distributed.tensor import DTensor

from ..ckpt import checkpoint as ckpt
from ..dist import sharding as shd

Tree = Any


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep_ckpts: int = 3
    max_restarts: int = 3
    straggler_factor: float = 3.0
    straggler_window: int = 20
    async_ckpt: bool = True


def _wait(tree: Tree):
    """The reference's ``jax.block_until_ready`` on the first leaf."""
    leaf = next(ckpt._flatten(tree))[1]
    if isinstance(leaf, DTensor):
        leaf = leaf.to_local()
    if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)


class Trainer:
    def __init__(
        self,
        cfg: TrainerConfig,
        state: Tree,
        step_fn: Callable[[Tree, dict], tuple[Tree, dict]],
        data: Iterator[dict],
        *,
        state_shardings: Optional[Tree] = None,
        on_straggler: Optional[Callable[[int, float, float], None]] = None,
    ):
        self.cfg = cfg
        self.state = state
        self.step_fn = step_fn
        self.data = data
        self.state_shardings = state_shardings
        self.on_straggler = on_straggler
        self.step_times: list[float] = []
        self.events: list[dict] = []
        self.restarts = 0
        self._ckpt_thread = None
        self.inject_failure: Optional[Callable[[int], None]] = None
        self.metrics_log: list[dict] = []

    # -- fault handling -----------------------------------------------------

    def _checkpoint(self, step: int):
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()  # one in flight at a time
        self._ckpt_thread = ckpt.save(
            self.cfg.ckpt_dir, step, self.state, blocking=not self.cfg.async_ckpt
        )
        ckpt.prune(self.cfg.ckpt_dir, self.cfg.keep_ckpts)

    def _restore_latest(self):
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
        self.state, step = ckpt.restore(
            self.cfg.ckpt_dir, self.state, sharding_tree=self.state_shardings
        )
        self.events.append({"kind": "restore", "step": step})
        return step

    def resize(self, new_state_shardings: Tree):
        """Elastic re-mesh: every leaf of the live state gathered whole
        (a DTensor's ``full_tensor()``) and put on its leaf of
        ``new_state_shardings`` (devices or ``NamedSharding``s)."""
        leaves = [shd.put(t.full_tensor() if isinstance(t, DTensor) else t, s)
                  for (_, t), (_, s) in zip(ckpt._flatten(self.state),
                                            ckpt._flatten(new_state_shardings))]
        self.state = ckpt._unflatten(self.state, iter(leaves))
        self.state_shardings = new_state_shardings
        self.events.append({"kind": "resize"})

    # -- main loop ------------------------------------------------------------

    def run(self, num_steps: int, *, start_step: int = 0) -> Tree:
        step = start_step
        while step < num_steps:
            try:
                batch = next(self.data)
                if self.inject_failure is not None:
                    self.inject_failure(step)
                t0 = time.perf_counter()
                self.state, metrics = self.step_fn(self.state, batch)
                _wait(self.state)
                dt = time.perf_counter() - t0
                self._watch(step, dt)
                metrics = {k: float(v) for k, v in metrics.items()}
                metrics["step"] = step
                metrics["step_time_s"] = dt
                self.metrics_log.append(metrics)
                step += 1
                if step % self.cfg.ckpt_every == 0:
                    self._checkpoint(step)
            except (FloatingPointError, RuntimeError, ValueError) as e:
                self.restarts += 1
                self.events.append({"kind": "failure", "step": step, "err": repr(e)})
                if self.restarts > self.cfg.max_restarts:
                    raise
                try:
                    step = self._restore_latest()
                except FileNotFoundError:
                    step = start_step  # no checkpoint yet: restart from scratch
        self._checkpoint(step)
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
        return self.state

    def _watch(self, step: int, dt: float):
        self.step_times.append(dt)
        w = self.step_times[-self.cfg.straggler_window :]
        if len(w) >= 5:
            med = statistics.median(w)
            if dt > self.cfg.straggler_factor * med:
                self.events.append(
                    {"kind": "straggler", "step": step, "dt": dt, "median": med}
                )
                if self.on_straggler:
                    self.on_straggler(step, dt, med)
