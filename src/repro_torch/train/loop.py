"""Fault-tolerant training loop.

  * resume from the latest checkpoint on start (crash or preemption
    recovery): the step counter, params, optimizer state and data position
    all come from the checkpoint;
  * periodic async checkpoints (snapshot to host on the loop's thread,
    serialize on a worker thread);
  * straggler watchdog: each step's wall time against the running median; a
    step slower than ``straggler_factor`` x median is recorded as a
    ``StragglerEvent`` and surfaced to the caller;
  * a fault-injection hook for tests (``fault_hook(step)`` may raise);
  * a metrics JSONL log (loss, grad_norm, step time) beside the checkpoints.

A step's time ends on a sync of its loss, the counterpart of the
reference's ``block_until_ready``. The checkpoints are the JAX package's:
an ``LM`` is saved as the reference's params tree (groups stacked on axis
0) and its ``AdamWState`` with the same leaf names, so a run saved by
either package resumes in the other (``convert.lm_train_state_*``); an
LM on a device mesh (`distributed.parallel.MeshLM`) is gathered and saved
the same way, and resumes in place; any other params and optimizer state
are saved as the trees they are.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import time
from pathlib import Path
from typing import Callable, Iterator

import torch

from repro_torch import convert
from repro_torch.distributed import checkpoint as ckpt_lib
from repro_torch.distributed.parallel import MeshLM
from repro_torch.models.model import LM


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    keep_last: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    straggler_warmup: int = 5  # steps before the watchdog arms


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    median: float


def _trees(params, opt_state) -> dict:
    """What a checkpoint holds: the reference's trees for an LM."""
    if isinstance(params, LM):
        return convert.lm_train_state_to_numpy(params, opt_state, params.cfg)
    if isinstance(params, MeshLM):
        return convert.lm_train_state_to_numpy(
            params.gather(), type(opt_state)(opt_state.step, _gathered(opt_state.mu),
                                             _gathered(opt_state.nu)), params.cfg)
    return {"params": params, "opt_state": opt_state}


def _gathered(tree: dict) -> dict:
    return {n: sh.gather("cpu") for n, sh in tree.items()}


def _meta(tree: dict) -> dict:
    return {n: torch.empty(sh.shape, dtype=sh.dtype, device="meta") for n, sh in tree.items()}


def _restore(ckpt_dir: Path, params, opt_state):
    """(step, params, opt_state) from the latest checkpoint; an LM and its
    state are loaded in place."""
    if isinstance(params, LM):
        templates = convert.lm_train_state_templates(params, opt_state, params.cfg)
        step, trees = ckpt_lib.restore(ckpt_dir, templates, device="cpu")
        params, opt_state = convert.load_lm_train_state(params, opt_state, trees, params.cfg)
        return step, params, opt_state
    if isinstance(params, MeshLM):
        templates = convert.lm_train_state_templates(
            _meta(params.params), type(opt_state)(opt_state.step, _meta(opt_state.mu),
                                                  _meta(opt_state.nu)), params.cfg)
        step, trees = ckpt_lib.restore(ckpt_dir, templates, device="cpu")
        cfg = params.cfg
        for mine, tree in ((params.params, trees["params"]), (opt_state.mu, trees["opt_state"].mu),
                           (opt_state.nu, trees["opt_state"].nu)):
            for name, arr in convert._by_name(tree, cfg).items():
                mine[name].copy_(convert._host_tensor(arr))
        saved = torch.tensor(int(trees["opt_state"].step), dtype=torch.int32)
        return step, params, type(opt_state)(saved, opt_state.mu, opt_state.nu)
    leaves = [t for _, t in ckpt_lib._leaves({"p": params, "o": opt_state})
              if isinstance(t, torch.Tensor)]
    device = leaves[0].device if leaves else "cpu"
    step, trees = ckpt_lib.restore(ckpt_dir, {"params": params, "opt_state": opt_state},
                                   device=device)
    return step, trees["params"], trees["opt_state"]


def _ready(loss) -> None:
    """Wait for the device work that produces ``loss``."""
    if isinstance(loss, torch.Tensor) and loss.device.type == "cuda":
        torch.cuda.current_stream(loss.device).synchronize()


class TrainLoop:
    def __init__(
        self,
        train_step: Callable,  # (params, opt_state, batch) -> (params, opt_state, metrics)
        data_iter_factory: Callable[[int], Iterator],  # start_step -> iterator
        ckpt_dir: str | Path,
        loop_cfg: LoopConfig = LoopConfig(),
        fault_hook: Callable[[int], None] | None = None,
    ):
        self.train_step = train_step
        self.data_iter_factory = data_iter_factory
        self.ckpt_dir = Path(ckpt_dir)
        self.cfg = loop_cfg
        self.fault_hook = fault_hook
        self.checkpointer = ckpt_lib.AsyncCheckpointer(self.ckpt_dir, loop_cfg.keep_last)
        self.straggler_events: list[StragglerEvent] = []
        self._step_times: list[float] = []

    def run(self, params, opt_state):
        """Run to total_steps, resuming from the latest checkpoint if present.
        Returns (params, opt_state, history)."""
        start = 0
        if ckpt_lib.latest_step(self.ckpt_dir) is not None:
            start, params, opt_state = _restore(self.ckpt_dir, params, opt_state)
        history: list[dict] = []
        log_path = self.ckpt_dir / "metrics.jsonl"
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        data = self.data_iter_factory(start)

        try:
            for step in range(start, self.cfg.total_steps):
                if self.fault_hook is not None:
                    self.fault_hook(step)
                batch = next(data)
                t0 = time.perf_counter()
                params, opt_state, metrics = self.train_step(params, opt_state, batch)
                _ready(metrics["loss"])
                dt = time.perf_counter() - t0
                self._watchdog(step, dt)
                if step % self.cfg.log_every == 0 or step == self.cfg.total_steps - 1:
                    rec = {
                        "step": step,
                        "time_s": round(dt, 4),
                        **{k: float(v) for k, v in metrics.items()},
                    }
                    history.append(rec)
                    with log_path.open("a") as f:
                        f.write(json.dumps(rec) + "\n")
                if (step + 1) % self.cfg.checkpoint_every == 0:
                    self.checkpointer.save(step + 1, _trees(params, opt_state))
        finally:
            self.checkpointer.wait()
        # a final checkpoint, so a restart is a no-op
        ckpt_lib.save(self.ckpt_dir, self.cfg.total_steps, _trees(params, opt_state),
                      keep_last=self.cfg.keep_last)
        return params, opt_state, history

    def _watchdog(self, step: int, dt: float) -> None:
        self._step_times.append(dt)
        if len(self._step_times) <= self.cfg.straggler_warmup:
            return
        med = statistics.median(self._step_times[:-1])
        if dt > self.cfg.straggler_factor * med:
            self.straggler_events.append(StragglerEvent(step, dt, med))
