"""Memory planning: the long-context training planner, KV page sizes and
the device budget.

Counterpart of ``marlin_tpu/models/planner.py``. :func:`plan_context` picks
the long-context memory knobs — ``remat``, ``loss_chunk``, ``mlp_chunk``,
``compute_dtype``, ``offload_residuals`` — escalating them cheapest
throughput cost first (:func:`_ladder`) until a rung fits the budget. The
JAX package reads each rung's peak from the TPU compiler's memory analysis
of the training step, compiled for a compile-only topology; eager PyTorch
compiles nothing ahead, so here the default measure runs one real
``lm_train_step`` per rung on the card and reads
``torch.cuda.max_memory_allocated`` (an out-of-memory error is the rung's
result, as a compile failure is there). The ladder and the plan are the JAX
package's logic. The TPU topology has no counterpart (ROADMAP queue 3).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import resolve_device

__all__ = ["plan_context", "ContextPlan", "usable_hbm_bytes",
           "kv_page_bytes", "request_pages"]

GIB = 1024 ** 3


def usable_hbm_bytes(device=None) -> int:
    """Device memory this process can still fill on ``device`` (default: the
    configured one): the free bytes CUDA reports (``torch.cuda.mem_get_info``)
    plus what PyTorch's caching allocator already holds, which it hands out
    again. Raises without CUDA."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"usable_hbm_bytes needs a CUDA device, got {dev}")
    free, _ = torch.cuda.mem_get_info(dev)
    return int(free) + int(torch.cuda.memory_reserved(dev))


def kv_page_bytes(params: dict, heads: int, page_len: int,
                  compute_dtype=None) -> int:
    """Bytes of ONE KV page across every layer: layers x {k,v} x page_len x
    kv_heads x dh in the compute dtype — the paged admission unit."""
    from .transformer import _cdtype, _n_layers

    d = params["emb"].shape[1]
    dh = d // heads
    kv_dim = params["l0"]["wk"].shape[1]  # kv_heads * dh (GQA-aware)
    itemsize = torch.empty((), dtype=_cdtype(compute_dtype, params)).element_size()
    return _n_layers(params) * 2 * page_len * (kv_dim // dh) * dh * itemsize


def request_pages(prompt_len: int, steps: int, page_len: int) -> int:
    """KV pages one request can ever write: cache positions run
    ``[0, prompt_len + steps - 1)`` (the final token is never decoded from),
    rounded up to whole pages — the admission charge and the allocation."""
    if prompt_len < 1 or steps < 1 or page_len < 1:
        raise ValueError(f"prompt_len/steps/page_len must be >= 1, got "
                         f"{(prompt_len, steps, page_len)}")
    return -(-(prompt_len + steps - 1) // page_len)


@dataclasses.dataclass(frozen=True)
class ContextPlan:
    """The planner's verdict: ``model`` is the escalated TransformerLM ready
    to train; ``trail`` records every rung probed as
    ``(knobs, peak_bytes | None, fits, note)``."""

    model: object  # TransformerLM
    knobs: dict
    peak_bytes: int | None
    fits: bool
    budget_bytes: int
    seq: int
    trail: tuple

    @property
    def peak_gib(self) -> float | None:
        return None if self.peak_bytes is None else round(
            self.peak_bytes / GIB, 3)

    def describe(self) -> str:
        head = (f"seq={self.seq}: {'fits' if self.fits else 'DOES NOT FIT'} "
                f"{self.peak_gib} GiB of {round(self.budget_bytes / GIB, 3)} "
                f"GiB usable with {self.knobs or 'no knobs'}")
        rungs = "\n".join(
            f"  probed {k or '{}'}: "
            f"{'?' if p is None else round(p / GIB, 3)} GiB"
            f"{' (fits)' if f else ''}{' — ' + n if n else ''}"
            for k, p, f, n in self.trail)
        return head + "\n" + rungs


def _ladder(model, seq: int):
    """Cumulative knob escalation, cheapest throughput cost first: remat
    trades FLOPs, the chunk knobs trade loop overhead, bf16 trades
    activation precision, and host-offloaded residuals trade PCIe traffic
    (last — it only nets out for residual-dominated shapes). Rungs already
    set on the user's config are skipped (they cannot un-set)."""
    rungs = [{}]
    acc = {}
    chunk = max(1, min(16384, seq))
    for knob, val in (("remat", True), ("loss_chunk", chunk),
                      ("mlp_chunk", chunk), ("compute_dtype", "bfloat16"),
                      ("offload_residuals", True)):
        if getattr(model, knob, None) in (None, False):
            acc = dict(acc, **{knob: val})
            rungs.append(dict(acc))
    return rungs


def _measured_peak(model, seq: int, mesh, device) -> tuple[int | None, str]:
    """(peak_bytes, note) of one ``lm_train_step`` of ``model`` on a
    ``seq``-token stream on ``device``: ``max_memory_allocated`` after
    ``reset_peak_memory_stats``. Running out of memory is a result: the rung
    gets ``None`` and a note, and the cache is released for the next."""
    import numpy as np

    from .transformer import adam_init, lm_train_step

    tokens = np.random.default_rng(0).integers(
        0, model.vocab, seq).astype(np.int32)
    params = opt = None
    try:
        params = model.init_params(device=device)
        opt = adam_init(params)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        _, _, loss = lm_train_step(
            params, opt, tokens, mesh, model.heads, model.attn, model.remat,
            model.precision, model.learning_rate, model.loss_chunk,
            model.compute_dtype, model.mlp_chunk, model.offload_residuals,
            model._moe(), model.moe_aux_weight)
        float(loss)  # waits for the step
        return int(torch.cuda.max_memory_allocated(device)), ""
    except torch.cuda.OutOfMemoryError:
        return None, "out of memory"
    finally:
        del params, opt
        torch.cuda.empty_cache()


def plan_context(seq: int, model, hbm_budget: int | None = None,
                 chips: int = 1, topology_name: str | None = None,
                 measure=None, mesh=None):
    """Pick the cheapest knob set under which ``model`` trains ``seq`` tokens
    within ``hbm_budget`` bytes per device on a ``chips``-rank ring.

    ``model`` is a :class:`~marlin_tpu_torch.models.transformer.
    TransformerLM` (its knob settings are respected and never weakened).
    ``hbm_budget`` defaults to :func:`usable_hbm_bytes`. ``chips`` must
    equal the ring's size, the ``rows`` axis of ``mesh`` (default: the
    default mesh). ``topology_name`` names a compile-only TPU topology,
    which has no counterpart here: it raises. ``measure(model) -> (peak,
    note)`` overrides the probe and runs anywhere; the default trains one
    step per rung on the mesh's CUDA device and raises ``ValueError``
    without one — it never measures on the CPU.

    Returns a :class:`ContextPlan`; when nothing fits, the plan carries the
    lowest-peak rung with ``fits=False``."""
    if topology_name is not None:
        raise ValueError(
            "topology_name names a compile-only TPU topology, which has no "
            "counterpart here: the planner measures one training step per "
            "rung on the card (ROADMAP queue 3)")
    if measure is None:
        from ..mesh import default_mesh

        mesh = mesh or default_mesh()
        ring = mesh.shape["rows"]
        if chips != ring:
            raise ValueError(f"chips ({chips}) must equal the ring's size, "
                             f"the mesh's rows axis ({ring})")
        if mesh.device.type != "cuda":
            raise ValueError(
                f"plan_context's default measure needs a CUDA device (one "
                f"training step per rung, read by max_memory_allocated); "
                f"the mesh is on {mesh.device}. Pass measure= to plan "
                f"without one")

        def measure(m):
            return _measured_peak(m, seq, mesh, mesh.device)
    budget = (usable_hbm_bytes(None if mesh is None else mesh.device)
              if hbm_budget is None else int(hbm_budget))

    trail = []
    best = None  # (peak, knobs, model)
    for knobs in _ladder(model, seq):
        candidate = dataclasses.replace(model, **knobs)
        peak, note = measure(candidate)
        fits = peak is not None and peak <= budget
        trail.append((knobs, peak, fits, note))
        if peak is not None and (best is None or peak < best[0]):
            best = (peak, knobs, candidate)
        if fits:
            return ContextPlan(model=candidate, knobs=knobs, peak_bytes=peak,
                               fits=True, budget_bytes=budget, seq=seq,
                               trail=tuple(trail))
    peak, knobs, candidate = best if best else (None, {}, model)
    return ContextPlan(model=candidate, knobs=knobs, peak_bytes=peak,
                       fits=False, budget_bytes=budget, seq=seq,
                       trail=tuple(trail))
