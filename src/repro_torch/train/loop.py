"""Fault-tolerant training loop: checkpoint/restart, deterministic data
skip-ahead, per-step wall-clock telemetry (straggler visibility).

A torch copy of ``repro.train.loop``. ``run_training`` is the
single-process driver of ``launch/train.py``; fault injection
(``fail_at_step``) powers the restart tests. A step's wall clock stops
after the device has finished it (a CUDA synchronisation where the loss
lies on the card).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["LoopConfig", "SimulatedFailure", "run_training"]


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 2.0  # step slower than factor*median -> logged
    fail_at_step: Optional[int] = None  # fault injection for tests


class SimulatedFailure(RuntimeError):
    pass


def _block_until_ready(x) -> None:
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def run_training(step_fn: Callable, batch_fn: Callable, params, opt_state,
                 cfg: LoopConfig, log=print):
    """Run (or resume) training.

    step_fn(params, opt_state, batch) -> (params, opt_state, metrics)
    batch_fn(step) -> batch   (deterministic in step — resume contract)

    Auto-resumes from the latest checkpoint in cfg.ckpt_dir if present (a
    module in ``params`` takes the restored values in place).
    Returns (params, opt_state, history).
    """
    mgr = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
    start = 0
    state = {"params": params, "opt": opt_state}
    latest = mgr.latest_step()
    if latest is not None:
        state, start = mgr.restore(state, latest)
        log(f"[resume] restored step {start} from {cfg.ckpt_dir}")
    params, opt_state = state["params"], state["opt"]

    durations = []
    history = []
    for step in range(start, cfg.total_steps):
        if cfg.fail_at_step is not None and step == cfg.fail_at_step:
            raise SimulatedFailure(f"injected failure at step {step}")
        t0 = time.perf_counter()
        batch = batch_fn(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        _block_until_ready(metrics["loss"])
        dt = time.perf_counter() - t0
        durations.append(dt)
        if len(durations) > 20:
            med = sorted(durations[-20:])[10]
            if dt > cfg.straggler_factor * med:
                log(f"[straggler] step {step} took {dt:.3f}s "
                    f"(median {med:.3f}s)")
        if step % cfg.log_every == 0:
            log(f"step {step}: loss={float(metrics['loss']):.4f} "
                f"lr={float(metrics['lr']):.2e} {dt*1e3:.0f}ms")
        history.append(float(metrics["loss"]))
        if (step + 1) % cfg.ckpt_every == 0 or step + 1 == cfg.total_steps:
            mgr.save(step + 1, {"params": params, "opt": opt_state})
    return params, opt_state, history
