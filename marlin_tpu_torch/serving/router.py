"""Multi-replica serving router: obs-fed load balancing over N supervised
:class:`~marlin_tpu_torch.serving.engine.ServeEngine` replicas, with failover
and drain-safe rolling restarts.

Counterpart of ``marlin_tpu/serving/router.py``, copied (host-side routing
over the engine's migration hooks; no device code). Replicas may share one
card: each has its own page slab, sized by ``auto_num_pages``, and its own
memory-ledger ``kvpool`` account.

One engine is one worker loop on one device; serving heavy traffic needs N
of them behind one front door. A :class:`Router` owns that front door:

- **Routing** is prefix-affine first, power-of-two-choices otherwise
  (``serve_prefix_affinity``): a prompt with at least one shareable KV
  page is keyed by a hash of its FIRST full page of tokens and — once that
  key has been seen before — rendezvous-hashed (highest-random-weight)
  over the ready replicas, so every request sharing a system prompt lands
  on the same replica's prefix cache — without affinity a shared prefix
  sprays misses across the fleet and the router bench records 0 hits where
  one engine gets 63/64. A key's FIRST occurrence routes load-aware like
  any other request (a one-off prompt has no cache hit to win, and pinning
  it to a hash-chosen replica regardless of queue depth measurably costs
  tail TTFT under load); the router remembers recent keys in a small LRU
  (:data:`_SEEN_PREFIX_CAP`) so repeat traffic engages affinity from its
  second request on. Short prompts (nothing shareable) and degraded
  fleets (< 2 ready) fall back to
  power-of-two-choices over the same readiness set: pick two distinct
  candidates at random, route to the less loaded by the same queue-depth
  gauge ``/metrics`` exports (``AdmissionQueue.count`` — the obs-fed
  signal, read directly so routing needs no scrape).
- **Failover**: a replica that rejects (overload), reports shutting-down,
  or fails outright (the ``serve.router_route`` fault point simulates
  this) is skipped for this request and the remaining replicas are tried
  in order — the rendezvous order for affine requests (the second-highest
  replica is every affine request's CONSISTENT fallback, so affinity
  survives a replica failure), load order otherwise. Only when every
  replica refuses does the caller see a terminal Result — deterministic,
  never an exception from a healthy router.
- **Rolling restart** (:meth:`rolling_restart`) is migrate-then-restart:
  one replica at a time is pulled from rotation and FROZEN at a step
  boundary (:meth:`~.engine.ServeEngine.freeze_rows`); its live rows'
  KV pages, cursors, and sampling state are exported into a CRC-framed
  host blob and adopted mid-stream by the least-loaded ready peer
  (:meth:`~.engine.ServeEngine.adopt_rows` — decode continues
  bit-identically, zero tokens re-generated), its queued backlog moves
  wholesale, and only then is the engine closed, rebuilt via the factory,
  its prefix cache warmed from a peer (``serve_cache_warm_prefixes``),
  and put back before the next replica starts. Any migration leg that
  fails (the ``serve.migrate`` fault point simulates each) degrades that
  row to the retry path — a fresh-attempt twin on a healthy replica,
  reservation carried exactly once, nothing double-delivers — and a
  replica that cannot freeze at all (already terminal) falls back to a
  drain-in-place rotation.
- **One scrape target**: the router registers a single aggregated health
  provider (each adopted engine's individual provider is unregistered —
  a draining replica mid-rotation must NOT 503 the process while its
  peers absorb traffic; the router reports not-ready only when NO replica
  accepts) and publishes ``marlin_serve_replica_state{router=,replica=}``
  (0 accepting / 1 draining / 2 restarting / 3 closed / 4 failed).
  Per-engine serving metrics already aggregate in the process registry;
  :meth:`snapshot` merges the per-replica ``ServeMetrics`` snapshots for
  tests and the bench.

- **Elastic membership**: :meth:`add_replica` factory-spawns a
  replica, warms its prefix cache from the warmest peer, and joins it to
  the rendezvous ring in one atomic list append (in-flight ``_candidates``
  snapshots either see it fully or not at all); :meth:`retire_replica`
  pulls one out of rotation FIRST (it leaves every rendezvous score list
  immediately — no request can route to a closing replica), migrates its
  live rows and queued backlog out over the same freeze→adopt path the
  rolling restart uses, and removes it. Replica indices are stable and
  never reused (a per-router counter), so the HRW mapping of surviving
  replicas is untouched by membership changes — only keys the lost replica
  owned re-place. :meth:`shed_weight` is the rebalance half: scoring is
  *weighted* rendezvous hashing (at the default weight 1.0 the order is
  exactly the classic digest order), so multiplying one hot replica's
  weight down re-places precisely that fraction of its keys and nobody
  else's. :class:`~marlin_tpu_torch.serving.fleet.FleetController` drives all
  three off the fleet-merged SLO burn signal.

``Router(factory, replicas=N)`` builds N engines up front via the zero-arg
``factory`` (also used by rolling restarts and scale-out);
``Router(engines=[...])`` adopts existing engines but cannot
rolling-restart or scale out without a factory.
"""

from __future__ import annotations

import hashlib
import itertools
import math
from collections import OrderedDict
import random
import threading
import time

import numpy as np

from ..config import get_config
from ..obs.exposition import (register_health_provider,
                              register_slo_provider,
                              unregister_health_provider,
                              unregister_slo_provider)
from ..obs.slo import fleet_merge
from ..obs.metrics import get_registry
from ..utils import faults
from .engine import MigrationError
from .request import (STATUS_REJECTED, STATUS_SHUTTING_DOWN, Request, Result,
                      ResultHandle)
from .supervisor import Supervisor, _emit

__all__ = ["Router", "REPLICA_STATES"]

_router_ids = itertools.count()

#: the ``marlin_serve_replica_state`` gauge encoding
REPLICA_STATES = {"accepting": 0, "draining": 1, "restarting": 2,
                  "closed": 3, "failed": 4}

#: handle statuses that trigger failover to the next replica (an expired
#: deadline is final everywhere; an error Result means the request RAN)
_FAILOVER = (STATUS_REJECTED, STATUS_SHUTTING_DOWN)

#: ServeMetrics counters a retired replica's final snapshot folds into the
#: router's running totals at rotation — without this, every rotation
#: silently zeroes the fleet's history (its prefix hit/miss record among
#: it). Gauges (pages_*) stay current-replicas-only: a dead pool holds no
#: pages.
_COUNTER_KEYS = ("submitted", "rejected", "expired", "completed", "errors",
                 "shut_down", "retries", "batches", "steps", "new_tokens",
                 "prefix_hits", "prefix_misses", "migrated_out",
                 "migrated_in", "migrate_fallback", "busy_s",
                 "program_steps", "program_rows", "swaps")


def _prefix_route_key(request, ready) -> bytes | None:
    """The affinity key: a 16-byte hash of the prompt's FIRST full KV page
    of tokens — the same granularity the prefix cache shares at, and
    deliberately ONLY the first page, so requests sharing a system prompt
    map together whatever their tails do. None when nothing is shareable
    (prompt must be strictly longer than a page: the cache never shares
    the last-token page) or no ready replica is paged. Non-LM BucketProgram
    requests have no KV prefix to be affine to, so they deterministically
    fall back to power-of-two-choices placement — mixed traffic load-
    balances instead of piling onto whichever replica owns a hot prompt."""
    if getattr(request, "program", "lm") != "lm":
        return None
    if not get_config().serve_prefix_affinity:
        return None
    prompt = getattr(request, "prompt", None)
    page_len = next((r.engine._page_len for r in ready
                     if getattr(r.engine, "paged", False)), 0)
    if prompt is None or not page_len or len(prompt) <= page_len:
        return None
    head = np.ascontiguousarray(np.asarray(prompt[:page_len], np.int32))
    return hashlib.blake2b(head.tobytes(), digest_size=16).digest()


#: Distinct first-page keys the router remembers for affinity gating. A
#: shared system prompt is one key however many requests ride it, so even a
#: small window outlives any realistic hot-prefix set; unique-prompt traffic
#: cycles through without growing the router.
_SEEN_PREFIX_CAP = 1024


def _rendezvous_score(key: bytes, idx: int) -> bytes:
    """Highest-random-weight score of (prefix key, replica): each replica
    set change remaps only the keys that hashed to the lost/gained replica
    — a rolling restart does not reshuffle the whole fleet's affinity."""
    return hashlib.blake2b(key + idx.to_bytes(4, "little"),
                           digest_size=8).digest()


def _weighted_score(key: bytes, idx: int, weight: float) -> float:
    """Weighted rendezvous score (Mosharaf/HRW with weights): map the
    8-byte digest to a uniform u in (0, 1) and score ``-weight / ln(u)``.
    At weight 1.0 the score is strictly monotone in the digest, so the
    ordering is exactly the classic unweighted rendezvous order; shrinking
    one replica's weight moves ONLY the keys it owned (each key's other
    scores are untouched) — the minimal-churn property rebalance relies
    on. Weights are clamped to a small positive floor: a zero weight
    would un-rank the replica for every key at once."""
    digest = _rendezvous_score(key, idx)
    u = (int.from_bytes(digest, "big") + 1) / (2 ** 64 + 1)
    return -max(weight, 1e-6) / math.log(u)


class _Replica:
    """One engine + its supervisor + routing state. ``routable`` is the
    router-side gate (rolling restart pulls a replica from rotation before
    the engine itself starts draining); ``weight`` scales its rendezvous
    scores (1.0 = classic HRW; rebalance sheds by shrinking it)."""

    __slots__ = ("idx", "engine", "supervisor", "routable", "restarts",
                 "weight")

    def __init__(self, idx: int, engine, supervisor):
        self.idx = idx
        self.engine = engine
        self.supervisor = supervisor
        self.routable = True
        self.restarts = 0
        self.weight = 1.0

    def state(self) -> str:
        if self.supervisor is not None and self.supervisor.breaker_open:
            return "failed"
        eng_state = {"running": "accepting", "draining": "draining",
                     "freezing": "draining", "frozen": "draining",
                     "closing": "closed",
                     "closed": "closed"}[self.engine._state]
        if eng_state == "closed":
            return "closed"
        if not self.routable:
            return "restarting"   # pulled from rotation, being rebuilt
        return eng_state

    def ready(self) -> bool:
        return self.state() == "accepting"

    def load(self) -> int:
        return self.engine._queue.count


class Router:
    """Route :class:`Request` submissions across N engine replicas.

    ``factory`` is a zero-arg callable returning a fresh, started
    :class:`ServeEngine`; ``replicas`` defaults from
    ``config.serve_replicas``. Pass ``engines=[...]`` to adopt
    pre-built engines instead (``factory`` then remains optional but is
    required for :meth:`rolling_restart`). ``supervise=True`` (default)
    wraps every replica in a :class:`~.supervisor.Supervisor`;
    ``supervisor_kw`` tunes it (watchdog_s, restart_max, ...). ``rng``
    seeds the power-of-two choice for deterministic tests.

    Thread-safe: ``submit`` may be called from any number of threads;
    ``rolling_restart``/``drain``/``close`` serialize against each other.
    Usable as a context manager (``close()`` on exit)."""

    def __init__(self, factory=None, replicas: int | None = None, *,
                 engines=None, supervise: bool = True,
                 supervisor_kw: dict | None = None, rng=None, log=None,
                 warmup: bool = False):
        if factory is None and engines is None:
            raise ValueError("Router needs a factory or engines=[...]")
        self._factory = factory
        self._supervise = supervise
        self._supervisor_kw = dict(supervisor_kw or {})
        self._log = log
        self._rng = rng if rng is not None else random.Random()
        self._lock = threading.Lock()        # replica list + lifecycle
        self._restart_lock = threading.Lock()  # one rotation at a time
        self._closed = False
        self._seen_prefixes = OrderedDict()  # first-page key -> True (LRU)
        self._retired = {k: 0 for k in _COUNTER_KEYS}  # rotated-out totals
        self._name = f"marlin-router-{next(_router_ids)}"
        reg = get_registry()
        self._m_replica_state = reg.gauge(
            "marlin_serve_replica_state",
            "Router replica state (0 accepting / 1 draining / 2 restarting "
            "/ 3 closed / 4 failed)", labelnames=("router", "replica"))
        if engines is None:
            n = int(get_config().serve_replicas if replicas is None
                    else replicas)
            if n < 1:
                raise ValueError(f"replicas must be >= 1, got {n}")
            engines = [factory() for _ in range(n)]
        self._replicas = [self._adopt(i, eng)
                          for i, eng in enumerate(engines)]
        # stable replica indices, never reused: a scale-out after a retire
        # must not resurrect a retired index — rendezvous keys the index,
        # and reuse would silently inherit the dead replica's affinity
        self._next_idx = itertools.count(len(self._replicas))
        if warmup:
            for rep in self._replicas:
                rep.engine.warmup()
        register_health_provider(self._name, self._health_info)
        # fleet-wide SLO view: the replicas' per-engine /debug/slo scopes
        # stay registered (drill-down); the router adds the worst-case
        # merge (obs/slo.py fleet_merge) under its own name
        register_slo_provider(self._name, self._fleet_slo)
        self._publish_states()

    # -------------------------------------------------------------- plumbing

    def _adopt(self, idx: int, engine) -> _Replica:
        # the router is THE scrape target: fold the engine's readiness into
        # the aggregate view so one draining replica cannot 503 a process
        # whose other replicas are absorbing its traffic
        unregister_health_provider(engine._name)
        sup = Supervisor(engine, log=self._log,
                         **self._supervisor_kw) if self._supervise else None
        return _Replica(idx, engine, sup)

    def _emit(self, **fields) -> None:
        _emit(self._log, **fields)

    def _publish_states(self) -> None:
        with self._lock:
            reps = list(self._replicas)
        for rep in reps:
            self._m_replica_state.labels(
                router=self._name, replica=rep.idx).set(
                    REPLICA_STATES[rep.state()])

    # --------------------------------------------------------------- routing

    def _prefix_seen(self, key: bytes) -> bool:
        """Record ``key`` in the LRU window; True iff it was already there.
        Affinity engages only for prefixes observed more than once: the
        first occurrence has no warm cache anywhere, so hashing it to a
        fixed replica regardless of queue depth would trade real load
        balance for a hit that cannot happen — exactly the tail-TTFT
        regression the unique-prompt router bench leg caught."""
        with self._lock:
            seen = key in self._seen_prefixes
            self._seen_prefixes[key] = True
            self._seen_prefixes.move_to_end(key)
            while len(self._seen_prefixes) > _SEEN_PREFIX_CAP:
                self._seen_prefixes.popitem(last=False)
        return seen

    def _candidates(self, request: Request | None = None) -> list[_Replica]:
        """Ready replicas in routing preference order. A request whose
        shareable prefix has been seen before gets the full rendezvous
        order over its key (affine pick first; the runner-up is the
        consistent fallback); everything else — short prompts, first
        touches of a new prefix — gets power-of-two-choices first (two
        distinct random picks, less loaded first), then the rest by load.
        Either order doubles as the failover order."""
        with self._lock:
            ready = [r for r in self._replicas if r.ready()]
        if request is not None and len(ready) >= 2:
            key = _prefix_route_key(request, ready)
            if key is not None and self._prefix_seen(key):
                return sorted(
                    ready, reverse=True,
                    key=lambda r: _weighted_score(key, r.idx, r.weight))
        if len(ready) <= 2:
            return sorted(ready, key=lambda r: r.load())
        a, b = self._rng.sample(ready, 2)
        first = sorted([a, b], key=lambda r: r.load())
        rest = sorted((r for r in ready if r is not a and r is not b),
                      key=lambda r: r.load())
        return first + rest

    def submit(self, request: Request) -> ResultHandle:
        """Route one request: exactly one terminal Result, always. Tries
        the affine / power-of-two pick, then fails over across every
        remaining ready replica on rejection / shutdown / route failure;
        only when all refuse does the caller see the last refusal (or a
        synthesized ``rejected`` Result when no replica is ready at
        all)."""
        last = None
        for rep in self._candidates(request):
            try:
                faults.fire("serve.router_route", path=f"replica-{rep.idx}")
                h = rep.engine.submit(request)
            except Exception as exc:
                self._emit(ev="route_failover", router=self._name,
                           replica=rep.idx, rid=request.rid,
                           reason=f"{type(exc).__name__}: {exc}")
                continue
            if h.done() and h.result().status in _FAILOVER:
                last = h
                self._emit(ev="route_failover", router=self._name,
                           replica=rep.idx, rid=request.rid,
                           reason=h.result().reason)
                continue
            return h
        if last is not None:
            return last
        handle = ResultHandle(request)
        handle._set(Result(
            request.rid, STATUS_REJECTED,
            reason=f"no ready replica ({self._name}: "
                   f"{[r.state() for r in self._replicas]})"))
        return handle

    def submit_many(self, requests) -> list[ResultHandle]:
        return [self.submit(r) for r in requests]

    # ------------------------------------------------------------- lifecycle

    def rolling_restart(self) -> dict:
        """Migrate-then-restart fleet rotation: one replica at a time
        leaves rotation, its live rows are FROZEN and handed to a ready
        peer (KV pages + cursors over the wire, decode resumes mid-stream
        bit-identically — zero decodes restart from token 0), its queued
        backlog moves wholesale, and only then is the engine closed,
        rebuilt via the factory, its prefix cache warmed from a peer, and
        rejoined before the next replica leaves — peers absorb traffic
        throughout. A replica that cannot freeze (already terminal) falls
        back to a drain-in-place rotation; a migration leg that fails
        degrades those rows to retry twins — zero dropped requests either
        way. Returns per-replica timings. Requires a factory; serialized
        against concurrent rotations."""
        if self._factory is None:
            raise RuntimeError("rolling_restart needs the Router built "
                               "with a factory")
        out = {}
        with self._restart_lock:
            with self._lock:
                rotation = list(self._replicas)
            for rep in rotation:
                t0 = time.monotonic()
                with self._lock:
                    if self._closed:
                        break  # close() won the race; nothing to rotate
                    if rep not in self._replicas:
                        continue  # retired underneath us (scale-in)
                    rep.routable = False
                idx = rep.idx
                self._publish_states()
                self._emit(ev="replica_rotate", router=self._name,
                           replica=idx, phase="migrate")
                # supervisor still attached while we freeze: a worker
                # crash mid-freeze is stashed (freeze_rows consumes it
                # into the retry fallback) and the supervisor idles on the
                # freezing/frozen states rather than respawning under us
                if not self._migrate_out(rep):
                    # can't freeze (already terminal): drain FIRST,
                    # supervisor attached, so a
                    # crash mid-drain recovers and accepted work completes
                    self._emit(ev="replica_rotate", router=self._name,
                               replica=idx, phase="drain")
                    rep.engine.drain()
                if rep.supervisor is not None:
                    rep.supervisor.close()
                rep.engine.close()
                self._accumulate(rep.engine)
                fresh = self._factory()
                with self._lock:
                    pos = self._replicas.index(rep)
                    newrep = self._adopt(idx, fresh)
                    newrep.restarts = rep.restarts + 1
                    newrep.weight = rep.weight
                    self._replicas[pos] = newrep
                self._publish_states()
                self._warm_replica(newrep)
                out[idx] = round(time.monotonic() - t0, 6)
                self._emit(ev="replica_rotate", router=self._name,
                           replica=idx, phase="done", seconds=out[idx])
        return out

    # ---------------------------------------------------- elastic membership

    def add_replica(self) -> int:
        """Scale-out: factory-spawn a replica, warm its prefix cache from
        the warmest ready peer, and join it to the rendezvous ring — the
        join is one list append under the lock, so a concurrent
        ``_candidates`` snapshot sees the fleet either before or after,
        never half-joined. The fresh replica gets a brand-new supervisor
        (fresh restart-breaker window — it must not inherit a struggling
        peer's sliding-window history) and a never-before-used index. A
        spawn that fails or dies before the join is closed and discarded
        — the ring is untouched, no work existed to lose. Returns the new
        replica's index. Serialized against rotations/retires."""
        if self._factory is None:
            raise RuntimeError("add_replica needs the Router built with "
                               "a factory")
        with self._restart_lock:
            with self._lock:
                if self._closed:
                    raise RuntimeError("router is closed")
                idx = next(self._next_idx)
            faults.fire("serve.fleet", path=f"spawn-{idx}")
            rep = self._adopt(idx, self._factory())
            try:
                self._warm_replica(rep)
                faults.fire("serve.fleet", path=f"join-{idx}")
                if not rep.ready():
                    raise RuntimeError(
                        f"fresh replica {idx} not accepting "
                        f"(state {rep.state()}) — refusing to join it")
                with self._lock:
                    if self._closed:
                        raise RuntimeError("router closed during spawn")
                    self._replicas.append(rep)
            except BaseException:
                # orphan cleanup: the spawn never joined, nothing routed
                # to it, closing it drops no work
                if rep.supervisor is not None:
                    rep.supervisor.close()
                rep.engine.close()
                raise
        self._publish_states()
        self._emit(ev="replica_add", router=self._name, replica=idx,
                   replicas=self.replica_count())
        return idx

    def retire_replica(self, idx: int | None = None) -> int:
        """Scale-in: pull one replica (the least-loaded ready one when
        ``idx`` is None) out of rotation FIRST — it drops out of every
        rendezvous score list and readiness snapshot immediately — then
        migrate its live rows and queued backlog to its peers over the
        same lossless freeze→adopt path the rolling restart uses (legs
        that fail degrade to retry twins, never to dropped work), close
        it, and remove it from the fleet. Refuses to retire the last
        replica. Returns the retired index. Serialized against
        rotations/adds."""
        with self._restart_lock:
            with self._lock:
                if self._closed:
                    raise RuntimeError("router is closed")
                live = list(self._replicas)
                if len(live) <= 1:
                    raise RuntimeError("cannot retire the last replica")
                if idx is None:
                    ready = [r for r in live if r.ready()]
                    pool = ready if len(ready) >= 2 else live
                    rep = min(pool, key=lambda r: r.load())
                else:
                    rep = next((r for r in live if r.idx == idx), None)
                    if rep is None:
                        raise ValueError(f"no replica with index {idx}")
                rep.routable = False  # leaves every rendezvous list NOW
            self._publish_states()
            try:
                faults.fire("serve.fleet", path=f"retire-{rep.idx}")
            except BaseException:
                with self._lock:
                    rep.routable = True  # aborted before any state moved
                self._publish_states()
                raise
            self._emit(ev="replica_retire", router=self._name,
                       replica=rep.idx, phase="migrate")
            if not self._migrate_out(rep):
                self._emit(ev="replica_retire", router=self._name,
                           replica=rep.idx, phase="drain")
                rep.engine.drain()
            if rep.supervisor is not None:
                rep.supervisor.close()
            rep.engine.close()
            self._accumulate(rep.engine)
            with self._lock:
                if rep in self._replicas:
                    self._replicas.remove(rep)
            self._m_replica_state.labels(
                router=self._name, replica=rep.idx).set(
                    REPLICA_STATES["closed"])
        self._publish_states()
        self._emit(ev="replica_retire", router=self._name, replica=rep.idx,
                   phase="done", replicas=self.replica_count())
        return rep.idx

    def shed_weight(self, idx: int | None = None,
                    frac: float = 0.5) -> tuple[int, float]:
        """Rebalance: shrink one replica's rendezvous weight by ``frac``
        (the most-loaded ready replica when ``idx`` is None), re-placing
        exactly that share of its seen-prefix ownership onto its peers —
        weighted HRW guarantees no other replica's keys move. In-flight
        rows stay where they are (re-placement affects new routing only);
        the weight floor keeps the replica in every score list so it
        still serves as a failover candidate. Returns (index, new
        weight)."""
        with self._lock:
            if self._closed:
                raise RuntimeError("router is closed")
            live = [r for r in self._replicas if r.ready()]
            if not live:
                raise RuntimeError("no ready replica to rebalance")
            if idx is None:
                rep = max(live, key=lambda r: r.load())
            else:
                rep = next((r for r in self._replicas if r.idx == idx),
                           None)
                if rep is None:
                    raise ValueError(f"no replica with index {idx}")
        faults.fire("serve.fleet", path=f"shed-{rep.idx}")
        with self._lock:
            rep.weight = max(0.05, rep.weight * (1.0 - float(frac)))
            new = rep.weight
        self._emit(ev="rebalance", router=self._name, replica=rep.idx,
                   weight=round(new, 4), frac=frac)
        return rep.idx, new

    def replica_count(self) -> int:
        with self._lock:
            return len(self._replicas)

    def replica_view(self) -> list[dict]:
        """Per-replica routing state for the fleet controller and
        ``GET /debug/fleet``: index, lifecycle state, queue depth,
        rendezvous weight, restart count. The controller's ONLY source of
        truth — it keeps no fleet state of its own, so a restarted
        controller reconstructs everything from this view."""
        with self._lock:
            reps = list(self._replicas)
        return [{"replica": r.idx, "state": r.state(), "load": r.load(),
                 "weight": round(r.weight, 4), "restarts": r.restarts}
                for r in reps]

    def _migrate_out(self, rep: _Replica) -> bool:
        """Freeze ``rep`` and move everything it holds: live rows adopt
        onto the least-loaded ready paged peer (KV travels, decode resumes
        mid-stream), the queued backlog moves as-is (same entries — they
        never started, no twin needed), and rows any leg failed on degrade
        to fresh-attempt retry twins. Admission reservations move exactly
        once: the target charges at bind (``AdmissionQueue.adopt``), the
        source releases here per moved row; a row nobody can take retires
        on the SOURCE (still charged there) so the release stays paired.
        Returns False when the engine cannot freeze — caller drains."""
        eng = rep.engine
        try:
            frozen = eng.freeze_rows()
        except Exception as exc:
            self._emit(ev="migrate", router=self._name, replica=rep.idx,
                       phase="freeze_failed",
                       reason=f"{type(exc).__name__}: {exc}")
            return False
        if frozen is None:
            return False
        entries = dict(frozen["entries"])
        fallback = list(frozen["fallback"])
        adopted: list = []
        target = None
        if frozen["blob"] is not None and entries:
            target = self._pick_target(exclude=rep)
            if target is None:
                fallback.extend(entries.values())
            else:
                try:
                    res = target.engine.adopt_rows(frozen)
                    adopted = list(res["adopted"])
                    fallback.extend(res["fallback"])
                except MigrationError as exc:
                    self._emit(ev="migrate", router=self._name,
                               replica=rep.idx, target=target.idx,
                               phase="adopt_failed",
                               reason=f"{type(exc).__name__}: {exc}")
                    fallback.extend(entries.values())
        elif entries:
            fallback.extend(entries.values())
        # the target charged each adopted row's reservation at bind —
        # release the source's half of the handoff
        for rid in adopted:
            eng._queue.release(entries[rid].cost)
        moved_q = self._place_entries(rep, frozen["queued"], retry=False)
        retried = self._place_entries(rep, fallback, retry=True)
        if fallback:
            eng.metrics.record_migration("fallback", len(fallback))
        self._emit(ev="migrate", router=self._name, replica=rep.idx,
                   target=target.idx if target is not None else None,
                   adopted=len(adopted), queued_moved=moved_q,
                   fallback=len(fallback), retried=retried)
        return True

    def _pick_target(self, exclude: _Replica) -> _Replica | None:
        """Least-loaded ready PAGED peer — the adoption target."""
        with self._lock:
            cands = [r for r in self._replicas
                     if r is not exclude and r.ready()
                     and getattr(r.engine, "paged", False)]
        return min(cands, key=lambda r: r.load(), default=None)

    def _place_entries(self, src: _Replica, entries, retry: bool) -> int:
        """Move queue-only work off a frozen source: each entry (or its
        fresh-attempt twin when ``retry`` — the retry contract for rows
        whose migration failed) is force-admitted on a ready peer and the
        source's reservation released; an entry no peer can take — or a
        retry with no attempts left — retires on the source, whose charge
        the retirement releases. Returns how many were placed."""
        placed = 0
        for e in entries:
            if e.superseded or e.handle.done():
                continue
            if retry:
                moved = e.retry()  # supersedes e; reservation carried
                # an infrastructure-initiated restart is not the request's
                # fault: the attempt budget charges compute faults
                # (crash/decode retries), never a migration fallback — a
                # max_attempts=1 request must still survive a rotation
                moved.attempt = e.attempt
                src.engine.metrics.record_retry(
                    e.request.rid, moved.attempt, e.request.max_attempts,
                    "migration fallback")
            else:
                moved = e
            landed = False
            with self._lock:
                cands = sorted((r for r in self._replicas
                                if r is not src and r.ready()),
                               key=lambda r: r.load())
            for cand in cands:
                try:
                    if cand.engine.adopt_entries([moved]):
                        landed = True
                        break
                except Exception:
                    continue
            if landed:
                src.engine._queue.release(e.cost)
                placed += 1
            else:
                # nobody accepting: retire on the source, still charged
                # there — its release pairs with the original admit
                src.engine._retire(moved, Result(
                    moved.request.rid, STATUS_SHUTTING_DOWN,
                    reason="no ready replica to migrate to"))
        return placed

    def _warm_replica(self, fresh: _Replica) -> None:
        """Warm a rebuilt or freshly spawned replica's prefix cache from
        the busiest ready peer's hottest chains
        (``serve_cache_warm_prefixes``). ``fresh`` need not be in the
        replica list yet — scale-out warms BEFORE the ring join. Entirely
        best-effort: every failure path is a cold cache, never a failed
        rotation."""
        n = get_config().serve_cache_warm_prefixes
        with self._lock:
            peers = [r for r in self._replicas
                     if r is not fresh and r.ready()
                     and getattr(r.engine, "paged", False)]
        if n <= 0 or not getattr(fresh.engine, "paged", False) or not peers:
            return
        # warmest peer first: the one whose cache has answered the most —
        # affinity concentrates a shared prefix there
        peers.sort(key=lambda r: r.engine.metrics.snapshot()["prefix_hits"],
                   reverse=True)
        for peer in peers:
            try:
                blob = peer.engine.export_prefixes(n)
                if not blob:
                    continue
                got = fresh.engine.import_prefixes(blob)
            except Exception:
                continue
            if got:
                self._emit(ev="migrate", router=self._name,
                           replica=fresh.idx, phase="cache_warm",
                           source=peer.idx, prefixes=got)
                return

    def _accumulate(self, engine) -> None:
        """Fold a retiring engine's final counter snapshot into the
        router's running totals (see ``_COUNTER_KEYS``)."""
        try:
            snap = engine.metrics.snapshot()
        except Exception:
            return
        with self._lock:
            for k in _COUNTER_KEYS:
                self._retired[k] += snap.get(k) or 0

    def drain(self) -> None:
        """Drain every replica (concurrently — they are independent) and
        stop routing. Terminal. Serializes behind an in-flight rotation —
        the documented drain/close/rolling_restart mutual exclusion; a
        drain racing the rotation's replica swap would miss the fresh
        engine."""
        with self._restart_lock:
            with self._lock:
                reps = list(self._replicas)
                for rep in reps:
                    rep.routable = False
            threads = [threading.Thread(target=rep.engine.drain)
                       for rep in reps]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        self._publish_states()

    def close(self) -> None:
        """Close supervisors and engines; unregister the health provider.
        Idempotent; waits out an in-flight rolling restart so a
        freshly-built replica can never be swapped in (and leaked) after
        the close."""
        with self._restart_lock:
            with self._lock:
                if self._closed:
                    return
                self._closed = True
                reps = list(self._replicas)
                for rep in reps:
                    rep.routable = False
            for rep in reps:
                if rep.supervisor is not None:
                    rep.supervisor.close()
                rep.engine.close()
        self._publish_states()
        unregister_health_provider(self._name)
        unregister_slo_provider(self._name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --------------------------------------------------------- introspection

    def pending(self) -> int:
        with self._lock:
            return sum(r.engine.pending() for r in self._replicas)

    def _fleet_slo(self) -> dict | None:
        """The fleet scope for ``GET /debug/slo``: every live replica's SLO
        payload worst-case-merged
        (:func:`~marlin_tpu_torch.obs.slo.fleet_merge`)
        so one burning replica surfaces at the top level with its name.
        None (provider prunes) when no replica has objectives configured."""
        with self._lock:
            if self._closed:
                return None
            reps = list(self._replicas)
        payloads = []
        for rep in reps:
            try:
                p = rep.engine._slo_payload()
            except Exception:
                p = None
            if p is not None:
                payloads.append(p)
        if not payloads:
            return None
        merged = fleet_merge(payloads)
        merged["router"] = self._name
        return merged

    def _health_info(self) -> dict:
        """The aggregated /healthz payload: ready while ANY replica
        accepts (a rolling restart must not 503 the process), with the
        per-replica detail inline."""
        with self._lock:
            reps = list(self._replicas)
        detail = []
        for rep in reps:
            info = rep.engine._health_info()
            info["name"] = rep.engine._name
            info["replica"] = rep.idx
            info["state"] = rep.state() if rep.state() != "accepting" \
                else info["state"]
            if rep.supervisor is not None:
                info["supervisor"] = rep.supervisor.info()
            detail.append(info)
        any_ready = any(rep.ready() for rep in reps)
        return {"state": "accepting" if any_ready else "closed",
                "replicas": detail}

    def snapshot(self) -> dict:
        """Merged per-replica ``ServeMetrics.snapshot()`` counters plus the
        per-replica list — the router-level accounting the bench records.
        The replica list is copied under the lock so a concurrent rotation
        cannot be read mid-swap. Counters (including the prefix hit/miss
        pair and the migration legs) span the fleet's whole history:
        engines retired by a rotation folded their final snapshots into
        the router's totals at swap time. Gauges (pages_*) are
        current-replicas-only."""
        with self._lock:
            reps = list(self._replicas)
            retired = dict(self._retired)
        snaps = [(rep.idx, rep.engine.metrics.snapshot()) for rep in reps]
        agg: dict = {"replicas": {i: s for i, s in snaps}}
        for key in ("submitted", "rejected", "expired", "completed",
                    "errors", "shut_down", "retries", "batches", "steps",
                    "new_tokens", "prefix_hits", "prefix_misses",
                    "migrated_out", "migrated_in", "migrate_fallback",
                    "program_steps", "program_rows", "swaps"):
            agg[key] = (sum(s.get(key, 0) for _, s in snaps)
                        + retired.get(key, 0))
        for key in ("pages_total", "pages_used", "pages_shared"):
            agg[key] = sum(s.get(key, 0) for _, s in snaps)
        busy = sum(s["busy_s"] for _, s in snaps) + retired.get("busy_s", 0)
        agg["busy_s"] = round(busy, 6)
        agg["tok_s"] = (round(agg["new_tokens"] / busy, 2) if busy > 0
                        else None)
        lookups = agg["prefix_hits"] + agg["prefix_misses"]
        agg["prefix_hit_rate"] = (round(agg["prefix_hits"] / lookups, 4)
                                  if lookups else None)
        return agg
