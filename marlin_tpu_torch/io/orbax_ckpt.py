"""Training checkpoints with asynchronous save, retention and atomic steps.

Counterpart of ``marlin_tpu/io/orbax_ckpt.py``, which layers an
``orbax.checkpoint.CheckpointManager`` over the self-contained layer of
:mod:`marlin_tpu_torch.io.checkpoint`. Orbax is JAX's; here the same API
(:meth:`OrbaxCheckpointer.save`, :meth:`~OrbaxCheckpointer.restore`,
:meth:`~OrbaxCheckpointer.latest_step`, :meth:`~OrbaxCheckpointer.wait`, the
``ckpt.write`` fault point) is built on ``torch.distributed.checkpoint`` in
one process, with no process group:

- a state is flattened in the JAX package's leaf order
  (:func:`~marlin_tpu_torch.io.checkpoint.tree_flatten`) into a flat
  ``{"leaf_<i>": leaf}`` state dict;
- a save copies the leaves to the host on the caller's thread, then writes
  them on a background thread (``async_save``) into ``<step>.tmp`` and
  renames that to ``<step>`` once complete, so a reader never sees a torn
  step;
- after each committed save all but the newest ``max_to_keep`` steps go;
- a restore loads into the template's leaves and puts each on the template
  leaf's device; a template whose structure or shapes disagree with the
  step is an error.

The directory format is that of ``torch.distributed.checkpoint``, not
Orbax's: a directory written by one package does not load in the other.
"""

from __future__ import annotations

import concurrent.futures
import os
import shutil

import torch

from ..utils import faults as _faults
from .checkpoint import tree_flatten, tree_unflatten

__all__ = ["OrbaxCheckpointer"]


def _no_dist() -> bool:
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized())


def _host(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return leaf


class OrbaxCheckpointer:
    """Training-state checkpoints in the style of an Orbax
    ``CheckpointManager``.

    >>> ckpt = OrbaxCheckpointer(dir, max_to_keep=3)
    >>> ckpt.save(state, step)          # returns once the leaves are copied
    >>> state, step = ckpt.restore(state_like)   # latest, onto the
    ...                                          # template's devices
    >>> ckpt.wait()                     # barrier before exit/eval
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = True):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._keep = max_to_keep
        self._pool = (concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="marlin-ckpt") if async_save else None)
        self._pending: list[concurrent.futures.Future] = []

    def _write(self, state_dict: dict, step: int) -> None:
        import torch.distributed.checkpoint as dcp

        final = os.path.join(self._dir, str(step))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        dcp.save(state_dict, checkpoint_id=tmp, no_dist=_no_dist())
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        if self._keep:
            for old in self.all_steps()[:-self._keep]:
                shutil.rmtree(os.path.join(self._dir, str(old)),
                              ignore_errors=True)

    def save(self, state, step: int) -> None:
        """Save the tree ``state`` as ``step`` (in the background with
        ``async_save``). Fires the ``ckpt.write`` fault point so chaos tests
        target this path with the same harness as the self-contained
        layer."""
        _faults.fire("ckpt.write", path=os.path.join(self._dir, str(step)),
                     step=step)
        leaves, _ = tree_flatten(state)
        state_dict = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
        if self._pool is None:
            self._write(state_dict, step)
            return
        self._pending = [f for f in self._pending if not f.done()]
        self._pending.append(self._pool.submit(self._write, state_dict, step))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like, step: int | None = None):
        """Restore into the structure of ``state_like``, each leaf on the
        template leaf's device; returns ``(state, step)``. ``step=None``
        loads the latest retained step."""
        import torch.distributed.checkpoint as dcp

        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self._dir}")
        leaves, spec = tree_flatten(state_like)
        targets = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
        dcp.load(targets, checkpoint_id=os.path.join(self._dir, str(step)),
                 no_dist=_no_dist())
        restored = [targets[f"leaf_{i}"].to(x.device)
                    if isinstance(x, torch.Tensor) else targets[f"leaf_{i}"]
                    for i, x in enumerate(leaves)]
        return tree_unflatten(spec, restored), step

    def all_steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self._dir) if n.isdigit())

    def wait(self) -> None:
        """Block until queued saves are durable (re-raises a failed one)."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self) -> None:
        self.wait()
        if self._pool is not None:
            self._pool.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
