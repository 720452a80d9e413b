"""Global configuration for marlin_tpu_torch.

Counterpart of ``marlin_tpu/config.py``: one dataclass with a global instance
and a context manager, holding the knobs this package reads. The JAX package's
``pallas_interpret`` has no meaning here and is dropped: a CUDA kernel has no
interpreter, and a wrapper runs the plain PyTorch version of its kernel only
for tensors that lie on the CPU.

``device`` (new) is where entry points put what they create: ``"cuda"`` by
default, ``"cpu"`` when the caller asks for it. Asking for CUDA on a host
without it raises; nothing falls back to the CPU quietly.

Precision mapping of ``matmul_precision`` (the ``precision=`` argument of the
products that go to ``torch.matmul``), set per call and restored after it:

- ``"highest"`` and ``"high"``: IEEE f32, TF32 off. On the TPU ``"high"`` is
  bf16×3 (relative error ~8e-6); TF32 alone (~1e-3) would be far less exact.
- ``"default"``: TF32 on.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator

import torch

# matmul_precision → torch.backends.cuda.matmul.allow_tf32 for that product
TF32_BY_PRECISION = {"highest": False, "high": False, "default": True}


@dataclasses.dataclass
class MarlinConfig:
    # Factorization base block sizes (reference defaults: 1000).
    lu_base_size: int = 1000
    cholesky_base_size: int = 1000
    inverse_base_size: int = 1000
    # Size threshold (matrix dim) up to which factorizations take the local
    # path ("breeze" mode in the reference, DenseVecMatrix.scala:289-298 uses
    # n > 6000 for its distributed one).
    local_fallback_dim: int = 6000
    # Broadcast-multiply threshold in MB (DenseVecMatrix.scala:196-198 default 300).
    broadcast_threshold_mb: float = 300.0
    # Default element dtype for matrices.
    default_dtype: Any = torch.float32
    # Precision of the products on the hot path (see the module docstring).
    matmul_precision: str = "highest"
    # SVD mode thresholds (DenseVecMatrix.scala:1569-1588).
    svd_local_dim: int = 2000
    # Lanczos iterations multiplier for dist-eigs SVD.
    lanczos_max_iter_factor: int = 10
    # Where the autotune winners persist across processes. None =
    # build/marlin_tpu_torch/autotune.json at the repository root; "" disables
    # the disk layer (in-process caching still works).
    autotune_cache_path: str | None = None
    # Device entry points create their tensors on: "cuda" or "cpu".
    device: str = "cuda"
    # --- checkpoints (io/checkpoint.py) --------------------------------------
    # Host-RAM ceiling (bytes) of the remote-shard download cache of
    # load_sharded: a restore touching every saved shard re-downloads past
    # this bound instead of holding the whole array on the host.
    ckpt_cache_bytes: int = 1 << 30
    # Retention: after each committed save, save_checkpoint prunes all but
    # the newest ckpt_keep generations (0 = keep everything). ResilientLoop
    # passes its own keep (default 3, its fall-back depth).
    ckpt_keep: int = 0
    # --- streaming prefetch (parallel/prefetch.py) ---------------------------
    # Default of the streamed ops (streamed_matmul/streamed_gramian,
    # OutOfCoreMatrix): False runs the read -> convert -> upload loop on the
    # caller's thread.
    prefetch_enabled: bool = True
    # At most this many chunks read but not yet consumed (2 = double
    # buffering: chunk i+1 is produced and copied while the card computes on
    # chunk i).
    prefetch_depth: int = 2
    # Producer threads (reads stay serialized; more threads overlap the
    # conversion and the pinned staging copy of several chunks).
    prefetch_workers: int = 1
    # In-flight device budget (bytes) of prefetched-but-unconsumed chunks; a
    # producer waits before its host-to-device copy while the budget is full
    # (one chunk always proceeds). 0 = depth alone bounds it.
    prefetch_hbm_budget_bytes: int = 2 << 30
    # --- native data plane (io/chunkstore.py) --------------------------------
    # Reader threads per chunk-store read (the native mcs_read fans the
    # touched chunks' CRC check and dtype conversion over them, outside the
    # GIL). 1 = serial reads.
    data_plane_threads: int = 4
    # Staging dtype chunk-store reads convert into natively (None = the
    # stored dtype). "bfloat16" makes chunks surface pre-compressed, so the
    # streamed ops' host cast is a no-op and the H2D bytes halve.
    data_plane_dtype: str | None = None
    # CRC32C-check every touched chunk on read.
    data_plane_verify: bool = True
    # --- serving engine (serving/engine.py) ----------------------------------
    # The JAX package's knobs and defaults (marlin_tpu/config.py), as far as
    # the port's paged engine reads them.
    # Slot rows per bucket: every decode step runs this many rows (free ones
    # run a harmless dummy against page 0).
    serve_max_batch: int = 8
    # The JAX engine's partial-batch wait (ms); accepted, checked >= 0 by
    # the batcher and ignored there: row-level scheduling claims work as
    # soon as a row frees.
    serve_max_wait_ms: float = 10.0
    # Admission bound on requests pending-or-in-flight; submissions beyond it
    # are rejected with a reason (backpressure, never blocking the caller).
    serve_queue_depth: int = 256
    # The static (padded_prompt, decode_steps) shape set; a request rounds UP
    # to the smallest fitting bucket.
    serve_buckets: tuple = ((64, 32), (256, 64))
    # Padded batch widths of the one-shot BucketPrograms a caller registers
    # through ServeEngine(programs=...) (serving/programs/base.py); the LM
    # program steps its own max_batch rows and does not read it.
    serve_program_batches: tuple = (8, 32)
    # Top-k buckets of the ALS and PageRank programs: a request's k rounds
    # up to the smallest listed value (values above the item / edge count
    # are dropped at program construction).
    serve_program_topk: tuple = (8,)
    # The paged KV pool (the only backend the port serves; False raises).
    serve_paged: bool = True
    # Tokens per KV page.
    serve_page_len: int = 16
    # Total pages in the pool (page 0 is the dummy); 0 = auto: every bucket's
    # extent at full width plus slack (serving.kvpool.auto_num_pages).
    serve_num_pages: int = 0
    # Prefill at most this many prompt tokens per worker iteration; decode
    # steps interleave between chunks.
    serve_prefill_chunk: int = 256
    # Copy-on-write prefix cache of completed full prompt pages.
    serve_prefix_cache: bool = True
    # Paged decode-attention backend: 'pallas' (the CUDA kernel, named as in
    # the JAX package), 'gather', or 'auto' (pallas on a CUDA device, gather
    # on the CPU).
    serve_decode_kernel: str = "auto"
    # Scale admission cost by a peak measured in this process for the exact
    # program key (obs.memledger.admission_ratio); 1.0 when none was.
    serve_admission_calibration: bool = True
    # Default relative deadline (seconds from submit) of requests that carry
    # none. None = requests without a deadline never expire.
    serve_default_deadline_s: float | None = None
    # --- serving resilience (serving/supervisor.py, serving/router.py) ------
    # Supervisor watchdog: a worker whose heartbeat is older than this many
    # real seconds while work is pending is declared stuck and recovered.
    # 0 disables the stuck-worker check (crash detection stays on).
    serve_watchdog_s: float = 30.0
    # Restart circuit breaker: more than serve_restart_max worker restarts
    # inside a sliding serve_restart_window_s window fails the engine
    # permanently instead of crash-looping.
    serve_restart_max: int = 5
    serve_restart_window_s: float = 60.0
    # Base delay between worker restarts (doubles per restart in the
    # window, capped at 16x).
    serve_restart_backoff_s: float = 0.05
    # Engine replicas a Router builds when none are passed explicitly.
    serve_replicas: int = 2
    # Prefix-affine routing: prompts sharing a first full KV page are
    # rendezvous-hashed to one ready replica's prefix cache (from their
    # second sighting on); False = always power-of-two-choices.
    serve_prefix_affinity: bool = True
    # How long a migration requester waits for the target worker to service
    # an adopt / cache-warm handoff before cancelling it (unbound rows fall
    # back to the retry path).
    serve_migrate_timeout_s: float = 30.0
    # Prefix-cache chains a rebuilt or added replica pulls from the warmest
    # peer (best-effort). 0 disables cache warming.
    serve_cache_warm_prefixes: int = 32
    # --- serving SLOs (obs/slo.py, obs/timeseries.py) ------------------------
    # Declarative objectives, a tuple of dicts {"name", "metric", "target",
    # "window_s"[, "op", "budget"]} (metric grammar in obs/slo.py). Empty
    # disables the SLO engine and the time-series store entirely.
    serve_slo: tuple = ()
    # Seconds between SLO evaluations (the tick's rate limit).
    serve_slo_eval_interval_s: float = 5.0
    # The reactive burn window that trips breaches.
    serve_slo_fast_window_s: float = 60.0
    # Fast-window burn rate that flips an objective to breached.
    serve_slo_burn_fast: float = 10.0
    # Consecutive evaluations under half the threshold before a breach
    # clears.
    serve_slo_hysteresis: int = 2
    # A breach sheds low-priority admissions (clean reject with a reason);
    # False = observe only.
    serve_slo_shed: bool = True
    # Deadline slack (seconds) under which a request earns one tier of shed
    # protection.
    serve_slo_shed_slack_s: float = 2.0
    # Time-series store geometry: longest trailing window, bucket width.
    serve_ts_window_s: float = 600.0
    serve_ts_bucket_s: float = 5.0
    # --- elastic fleet (serving/fleet.py) ------------------------------------
    # Fleet-size bounds the controller scales within.
    serve_fleet_min_replicas: int = 1
    serve_fleet_max_replicas: int = 8
    # Seconds between controller evaluations on its own clock.
    serve_fleet_eval_interval_s: float = 5.0
    # Fleet-merged fast burn at/above which an evaluation counts toward
    # scale-out, and at/below which it counts toward scale-in.
    serve_fleet_out_burn: float = 1.0
    serve_fleet_in_burn: float = 0.1
    # Consecutive hot (or slack) evaluations before the controller acts.
    serve_fleet_hysteresis: int = 3
    # Seconds after an action during which the controller only observes.
    serve_fleet_cooldown_s: float = 30.0
    # An action reversing the previous one inside this window is damped.
    serve_fleet_flap_window_s: float = 120.0
    # Queue depth of the most loaded replica over the fleet mean that
    # triggers a rebalance.
    serve_fleet_rebalance_ratio: float = 3.0
    # Share of the hot replica's rendezvous weight a rebalance sheds.
    serve_fleet_shed_frac: float = 0.5
    # An action still running past this many seconds is recorded as timed
    # out; the controller starts nothing new until it ends.
    serve_fleet_action_timeout_s: float = 60.0
    # --- observability (obs/) ------------------------------------------------
    # Port of the /metrics endpoint obs.start_from_config() starts: None
    # disables, 0 binds an ephemeral port.
    obs_http_port: int | None = None
    # EventLog rotation bound in bytes (0 = unbounded).
    obs_log_max_bytes: int = 0
    # Roofline peak overrides (FLOP/s, bytes/s); None = obs.perf.peak_rates'
    # per-GPU table.
    obs_peak_flops: float | None = None
    obs_peak_bw: float | None = None
    # Where profiler captures and flight-recorder dumps land (None =
    # <tempdir>/marlin_tpu_torch_captures), and its size cap.
    obs_profile_dir: str | None = None
    obs_profile_cap_bytes: int = 256 << 20
    # Flight-recorder ring length.
    obs_flight_len: int = 256
    # Leak-detector patience, in reconciliation windows.
    obs_mem_leak_windows: int = 3


_config = MarlinConfig()


def get_config() -> MarlinConfig:
    return _config


def set_config(**kwargs: Any) -> MarlinConfig:
    for k, v in kwargs.items():
        if not hasattr(_config, k):
            raise AttributeError(f"unknown marlin_tpu_torch config key: {k}")
        setattr(_config, k, v)
    return _config


@contextlib.contextmanager
def config_context(**kwargs: Any) -> Iterator[MarlinConfig]:
    old = {k: getattr(_config, k) for k in kwargs}
    try:
        set_config(**kwargs)
        yield _config
    finally:
        set_config(**old)


def resolve_device(device=None) -> torch.device:
    """``device`` or the configured one, as a ``torch.device``. Raises when
    CUDA is asked for and this host has none."""
    dev = torch.device(device if device is not None else _config.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "marlin_tpu_torch: device 'cuda' requested but torch.cuda is not "
            "available; pass device='cpu' or use config_context(device='cpu')")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device: {dev}")
    return dev


def tf32_for(precision: str) -> bool:
    """Whether a product at ``precision`` may use TF32."""
    try:
        return TF32_BY_PRECISION[precision]
    except KeyError:
        raise ValueError(
            f"unknown matmul precision {precision!r} (one of "
            f"{tuple(TF32_BY_PRECISION)})") from None
