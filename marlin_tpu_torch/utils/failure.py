"""Failure detection and checkpoint-based elastic recovery.

Counterpart of ``marlin_tpu/utils/failure.py``, over the port's checkpoint
module; the device probe runs on every CUDA card this process sees (or on
the CPU when that is the configured device), named ``cuda:<i>`` / ``cpu``.

The reference has *no* failure handling of its own — Spark's lineage
recomputation and task retry cover it invisibly. Without lineage a device
failure kills the step and the state with it, so recovery is an explicit
subsystem:

- :class:`ResilientLoop` — wraps an iterative workload's step function with
  periodic checkpointing, failure detection (exceptions from the runtime,
  non-finite losses), and resume-from-last-checkpoint retry with a bounded
  retry budget. This is the checkpoint-restart answer to Spark's
  recompute-from-lineage, stated as such.
- :func:`heartbeat` — a lightweight liveness probe: runs a trivial op on
  every device and reports per-device latency; a hung/failed device shows
  up as a timeout instead of a silent stall.

Both are chaos-tested through :mod:`marlin_tpu_torch.utils.faults`: the ``step.run``
point fires before every step (and can mutate its metric — NaN injection),
``device.probe`` fires inside every heartbeat probe, and the checkpoint IO
underneath carries its own points. The state may hold matrices on a mesh over
``torch.distributed`` ranks: every rank runs the loop, each checkpoint leaf
of such a matrix is its ranks' blocks, and a run saved on one world size
resumes on another (each rank restores its new block) and continues the same
trajectory. Recovery walks *backward* through committed
checkpoint generations — a torn or corrupt latest generation
(:class:`~marlin_tpu_torch.io.checkpoint.CheckpointCorruptError`) falls back to the
newest one that still verifies instead of killing the run.
"""

from __future__ import annotations

import time
import zipfile
from typing import Any, Callable

import torch

from . import faults as _faults
from .tracing import get_default_event_log

__all__ = ["ResilientLoop", "heartbeat", "NonFiniteLossError",
           "restore_latest"]


class NonFiniteLossError(RuntimeError):
    """Raised when a step's loss/metric goes NaN/Inf — numeric failure is a
    failure mode too, and restarting from the last good checkpoint is the
    same remedy as a device loss."""


#: What a generation may raise while being loaded that means "this generation
#: is unusable, try an older one" rather than "abort": integrity failures
#: (CheckpointCorruptError), vanished files (FileNotFoundError/OSError),
#: truncated npy/npz payloads (ValueError/EOFError/BadZipFile), corrupt JSON
#: manifests (JSONDecodeError is a ValueError), and mangled structures
#: (KeyError). Broader than the old (FileNotFoundError, OSError) pair, which
#: let a corrupt manifest or truncated array escape the recovery path
#: entirely.
def _resume_errors():
    from ..io.checkpoint import CheckpointCorruptError

    return (CheckpointCorruptError, FileNotFoundError, OSError, EOFError,
            ValueError, KeyError, zipfile.BadZipFile)


def heartbeat(timeout_s: float = 30.0, raise_on_failure: bool = True) -> dict:
    """Probe every visible device with a tiny computation; returns
    {device_str: latency_s}, with ``float('inf')`` marking devices that
    missed the deadline or raised (a dead device usually *errors* from the
    runtime rather than hangs — those exceptions ride on the returned
    mapping as ``.errors``). All probes launch concurrently and every device
    is waited on against one shared deadline, so a single wedged device
    neither serializes the sweep nor hides the status of the devices behind
    it. With ``raise_on_failure`` a TimeoutError naming *all* failed devices
    (and their errors) is raised after the full sweep; the per-device map
    rides on the exception as ``.results``. A truly hung
    probe thread cannot be killed from Python; it is left as
    a daemon and never re-joined, so a stuck probe cannot wedge later
    heartbeats.

    The ``device.probe`` fault point fires inside each probe (ctx ``path`` is
    the device string, so a fault can target one device): an injected raise
    lands in ``.errors``, an injected delay past the deadline shows up as a
    timeout — exactly how a real dead vs. wedged device presents."""
    import threading

    from ..config import resolve_device

    results: dict[str, float] = {}
    errors: dict[str, Exception] = {}
    lock = threading.Lock()
    t0 = time.perf_counter()

    def probe(d):
        try:
            _faults.fire("device.probe", path=str(d), device=str(d))
            y = torch.ones((), device=d) + 1.0
            if y.item() != 2.0:  # .item() waits for the card
                raise RuntimeError(f"{d}: probe computed {y.item()}")
            with lock:
                results[str(d)] = time.perf_counter() - t0
        except Exception as e:  # a dead device ERRORS rather than hangs —
            with lock:          # record it instead of mislabeling as timeout
                errors[str(d)] = e

    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if resolve_device(None).type == "cuda"
               else [torch.device("cpu")])
    threads = [threading.Thread(target=probe, args=(d,), daemon=True)
               for d in devices]
    for th in threads:
        th.start()
    deadline = t0 + timeout_s
    for th in threads:
        th.join(max(0.0, deadline - time.perf_counter()))

    class _Results(dict):
        pass

    out = _Results({str(d): results.get(str(d), float("inf"))
                    for d in devices})
    out.errors = dict(errors)
    failed = sorted(k for k, v in out.items() if v == float("inf"))
    if failed and raise_on_failure:
        detail = "; ".join(f"{k}: {errors[k]!r}" for k in failed if k in errors)
        err = TimeoutError(
            f"{len(failed)}/{len(out)} device heartbeats failed after "
            f"{timeout_s:.1f}s: {', '.join(failed)}"
            + (f" (device errors: {detail})" if detail else ""))
        err.results = out
        raise err
    return out


def restore_latest(state_template, checkpoint_dir: str, log=None,
                   who: str = "ResilientLoop"):
    """``(state, step)`` of the newest committed generation under
    ``checkpoint_dir`` that loads and verifies, walking backward past torn
    and corrupt ones (each skip logged as ``resume_skip`` through
    ``log(kind, **fields)``, the restore as ``resume``); ``(None, 0)`` when
    none restores, with a warning when generations existed. The trainers'
    ``resume=True`` and :class:`ResilientLoop` share it."""
    from ..io.checkpoint import list_generations, load_checkpoint

    log = log or (lambda kind, **fields: None)
    committed = list_generations(checkpoint_dir)
    if not committed:
        uncommitted = list_generations(checkpoint_dir, committed_only=False)
        if uncommitted:
            # generation directories exist but none carries a COMMITTED
            # marker: either torn writes, or checkpoints written before the
            # atomic-commit protocol (docs/robustness.md explains the
            # one-time migration) — restarting fresh must not be silent
            import warnings

            warnings.warn(
                f"{who}: {checkpoint_dir} holds generation directories "
                f"{uncommitted} but none is committed (torn writes, or "
                "pre-protocol checkpoints needing a one-time COMMITTED "
                "marker — see docs/robustness.md); restarting from the "
                "initial state", RuntimeWarning, stacklevel=4)
    skipped = []
    for step in reversed(committed):
        try:
            state, s = load_checkpoint(state_template, checkpoint_dir,
                                       step=step)
        except _resume_errors() as e:
            log("resume_skip", step=step, error=repr(e))
            skipped.append((step, e))
            continue
        log("resume", step=s)
        return state, s
    if skipped:
        # checkpoints existed but NONE restored — restarting from scratch is
        # the contract, but silently doing so would mask e.g. a
        # template/configuration mismatch, so say it loudly
        import warnings

        warnings.warn(
            f"{who}: no generation under {checkpoint_dir} was restorable — "
            "restarting from the initial state. Skipped: "
            + "; ".join(f"step {s}: {e!r}" for s, e in skipped),
            RuntimeWarning, stacklevel=4)
    return None, 0


class ResilientLoop:
    """Run ``state, metric = step_fn(state, i)`` for ``iterations`` steps with
    checkpoint/resume fault tolerance.

    On any runtime exception or non-finite metric — from the step itself *or*
    from the checkpoint save (a transient IO failure must not kill a run) —
    the loop restores the newest checkpoint generation that verifies and
    continues from there, up to ``max_retries`` times. A fresh run resumes
    automatically if ``checkpoint_dir`` already holds a committed checkpoint
    (crash-restart of the whole process); a torn or corrupt latest generation
    falls back to the one before it.

    ``keep`` bounds on-disk retention to that many committed generations
    (the fall-back depth); ``event_log`` (or the process default,
    :func:`~marlin_tpu_torch.utils.tracing.set_default_event_log`) receives
    ``resume``/``resume_skip``/``step_failure`` events for post-mortems.
    """

    def __init__(
        self,
        step_fn: Callable[[Any, int], tuple[Any, float]],
        checkpoint_dir: str,
        checkpoint_every: int = 50,
        max_retries: int = 3,
        check_finite: bool = True,
        keep: int = 3,
        event_log=None,
    ):
        self.step_fn = step_fn
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = max(1, checkpoint_every)
        self.max_retries = max_retries
        self.check_finite = check_finite
        self.keep = keep
        self.event_log = event_log
        self.retries = 0

    def _log(self, kind: str, **fields) -> None:
        log = self.event_log or get_default_event_log()
        if log is not None:
            log.event(kind, **fields)

    def _try_resume(self, state_template):
        """Restore the newest checkpoint generation that loads and verifies,
        walking backward past torn/corrupt ones; with none restorable,
        restart from the pristine initial state (never from a
        possibly-corrupt current one)."""
        state, step = restore_latest(state_template, self.checkpoint_dir,
                                     self._log)
        return (self._initial, 0) if state is None else (state, step)

    def run(self, state, iterations: int):
        from ..io.checkpoint import save_checkpoint

        self._initial = state
        state, start = self._try_resume(state)
        i = start
        metrics = []
        while i < iterations:
            try:
                _faults.fire("step.run", step=i)
                new_state, metric = self.step_fn(state, i)
                m = float(metric)
                m = _faults.mutate("step.run", m, step=i)
                if self.check_finite and not (m == m and abs(m) != float("inf")):
                    raise NonFiniteLossError(f"non-finite metric {m} at step {i}")
                state = new_state
                metrics.append(m)
                i += 1
                if i % self.checkpoint_every == 0 or i == iterations:
                    save_checkpoint(state, self.checkpoint_dir, i,
                                    keep=self.keep)
            except Exception as e:
                self.retries += 1
                self._log("step_failure", step=i, retry=self.retries,
                          error=repr(e))
                if self.retries > self.max_retries:
                    raise
                state, i = self._try_resume(state)
                # drop metrics for the steps being replayed so the returned
                # history has exactly one entry per step
                del metrics[max(0, i - start):]
                continue
        return state, metrics
