"""Training loop with checkpoint/restart, failure injection and straggler
accounting (counterpart of ``repro.train.loop``).

  * resume from the latest committed checkpoint on start (a crash is a
    restart, no special casing);
  * periodic two-phase checkpoints of ``{"params", "opt"}`` and pruning;
  * an optional ``FailureInjector`` that raises at a chosen step to
    exercise the recovery path;
  * per-step wall-clock telemetry with a straggler count (steps slower
    than ``straggler_factor`` x the median of the last 64);
  * optional int8 error-feedback gradient compression.

A step flattens the parameters (``tree.flatten``), takes the loss and
``torch.autograd.grad`` of it over the leaves (the reference's
``jax.value_and_grad``), optionally compresses the gradients, and applies
``adamw_update``.  Each step's loss is read to the host, as the reference
reads ``float(loss)``, so a step's time ends when the card is done."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.train.checkpoint import (
    latest_checkpoint,
    prune_checkpoints,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.train.compression import compressed_grads, init_error_state
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.tree import flatten, map_leaves, unflatten


class FailureInjector:
    """Raises at a specified step (once) to simulate a node failure."""

    def __init__(self, fail_at_step: Optional[int] = None):
        self.fail_at_step = fail_at_step
        self.fired = False

    def maybe_fail(self, step: int):
        if self.fail_at_step is not None and step == self.fail_at_step and not self.fired:
            self.fired = True
            raise RuntimeError(f"injected failure at step {step}")


@dataclasses.dataclass
class TrainResult:
    final_step: int
    losses: list
    restarts: int
    straggler_steps: int
    #: wall seconds of each step this run took (batch, loss, gradient,
    #: update, the loss read to the host; a checkpoint save after the step
    #: not included)
    step_seconds: list = dataclasses.field(default_factory=list)


def value_and_grad(loss_fn, params, batch):
    """(loss, gradient tree) of ``loss_fn(params, batch)``: the counterpart
    of ``jax.value_and_grad``, by ``torch.autograd.grad`` over the flattened
    leaves (a leaf the loss does not use gets zeros)."""
    leaves, _ = flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    loss = loss_fn(unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return loss.detach(), unflatten(params, list(grads))


def train(
    loss_fn: Callable,          # (params, batch) -> scalar loss
    init_params_fn: Callable,   # () -> params
    batch_fn: Callable,         # (step) -> batch: a dict of arrays or tensors
    n_steps: int,
    ckpt_dir: str,
    opt_cfg: AdamWConfig | None = None,
    ckpt_every: int = 20,
    keep_ckpts: int = 3,
    failure: Optional[FailureInjector] = None,
    compress_grads: bool = False,
    straggler_factor: float = 3.0,
    device="cuda",
) -> TrainResult:
    """Train from the latest checkpoint under ``ckpt_dir`` (or from
    ``init_params_fn()``) up to step ``n_steps``, on ``device``: the
    parameters and every batch's values are moved there, and the
    checkpoint restores there."""
    dev = resolve_device(device)
    params = map_leaves(lambda p: p.to(dev), init_params_fn())
    opt_cfg = opt_cfg if opt_cfg is not None else AdamWConfig()
    opt_state = adamw_init(params, opt_cfg)
    err_state = init_error_state(params) if compress_grads else None
    start_step = 0
    restarts = 0

    cp = latest_checkpoint(ckpt_dir)
    if cp is not None:
        state = {"params": params, "opt": opt_state}
        restored, start_step = restore_checkpoint(cp[1], state, device=dev)
        params, opt_state = restored["params"], restored["opt"]
        restarts += 1

    losses, durations = [], []
    straggler_steps = 0
    for step in range(start_step, n_steps):
        if failure is not None:
            failure.maybe_fail(step)
        t0 = time.perf_counter()
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch_fn(step).items()}
        loss, grads = value_and_grad(loss_fn, params, batch)
        if compress_grads:
            grads, err_state = compressed_grads(grads, err_state)
        params, opt_state = adamw_update(opt_cfg, params, grads, opt_state)
        del grads
        loss = float(loss)
        dt = time.perf_counter() - t0
        durations.append(dt)
        if len(durations) > 8:
            med = float(np.median(durations[-64:]))
            if dt > straggler_factor * med:
                straggler_steps += 1
        losses.append(loss)
        if (step + 1) % ckpt_every == 0 or step + 1 == n_steps:
            save_checkpoint(ckpt_dir, step + 1, {"params": params, "opt": opt_state})
            prune_checkpoints(ckpt_dir, keep_ckpts)
    return TrainResult(final_step=n_steps, losses=losses, restarts=restarts,
                       straggler_steps=straggler_steps, step_seconds=durations)


def train_with_recovery(*args, max_restarts: int = 3, **kwargs) -> TrainResult:
    """Supervisor: restart on an injected failure, resuming from the latest
    checkpoint; any other error, or more than ``max_restarts`` failures,
    propagates.  The single-process analogue of a cluster controller
    replacing a failed worker and relaunching the job."""
    restarts = 0
    while True:
        try:
            res = train(*args, **kwargs)
            return dataclasses.replace(res, restarts=res.restarts + restarts)
        except RuntimeError as e:
            if "injected failure" not in str(e) or restarts >= max_restarts:
                raise
            restarts += 1
