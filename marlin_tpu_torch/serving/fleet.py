"""Elastic fleet controller: SLO-burn-driven scale-out/in/rebalance over a
:class:`~marlin_tpu_torch.serving.router.Router`'s replica set.

Counterpart of ``marlin_tpu/serving/fleet.py``, copied (a host-side control
loop; no device code).

The reference delegated elasticity to Spark (SURVEY.md §0: a lost executor's
work is rescheduled, a busy cluster grows); this package closes that loop
itself. :mod:`~marlin_tpu_torch.obs.slo` computes multi-window error-budget
burn per replica and fleet-merged; migration makes replicas disposable
(lossless freeze→adopt, warm-from-peer prefix caches, consistent rendezvous
re-placement). A :class:`FleetController` sits on top of both and turns the
fleet-merged burn signal into topology:

- **scale OUT** — fast-window burn at/above ``serve_fleet_out_burn`` for
  ``serve_fleet_hysteresis`` consecutive evaluations: factory-spawn a
  replica (:meth:`~.router.Router.add_replica` — warm prefix cache from the
  warmest peer, fresh supervisor/breaker window, atomic rendezvous-ring
  join), bounded by ``serve_fleet_max_replicas``.
- **scale IN** — burn at/below ``serve_fleet_in_burn`` (budget slack) past
  the same hysteresis: retire the least-loaded replica
  (:meth:`~.router.Router.retire_replica` — out of every rendezvous list
  first, live rows + queued backlog migrated losslessly, then closed),
  floored at ``serve_fleet_min_replicas``.
- **REBALANCE** — one replica's queue depth exceeds the fleet mean by
  ``serve_fleet_rebalance_ratio`` past hysteresis (prefix affinity
  hot-spotting): shed ``serve_fleet_shed_frac`` of its rendezvous weight
  (:meth:`~.router.Router.shed_weight` — weighted HRW re-places exactly
  that share of its seen-prefix keys, nobody else's move).

**Robustness is the point, not a rider.** Actions are single-flight (a
second decision while one runs is a no-op); each runs on its own
``marlin-fleet-act-*`` thread and is recorded as ``timeout`` if it outlives
``serve_fleet_action_timeout_s`` — the controller then *degrades to doing
nothing* until the leg actually finishes (the underlying migration paths
own their own timeouts and are lossless by construction, so a stuck action
can delay elasticity but never drop work). ``serve_fleet_cooldown_s``
after any completed action lets its effect reach the burn windows;
opposite-direction actions inside ``serve_fleet_flap_window_s`` are
suppressed (flap damping — oscillating burn thrashes streak counters,
never the fleet). The controller keeps NO durable state of its own:
topology, loads, and weights live in the Router
(:meth:`~.router.Router.replica_view` / ``snapshot()``), so killing and
rebuilding the controller mid-action loses nothing but the transient
streak counters — the next evaluations re-derive the decision. The
``serve.fleet`` fault point fires inside each action leg
(``spawn-*``/``join-*``/``retire-*``/``shed-*``) so the chaos suite can
kill any leg mid-flight.

Observability: ``marlin_fleet_*`` gauges/counters, ``kind="fleet"``
EventLog records per decision and outcome, a ``GET /debug/fleet`` payload
(:meth:`FleetController.payload`, registered via
:func:`~marlin_tpu_torch.obs.exposition.register_fleet_provider`), and a
fleet panel in the ops console. The evaluation clock is injectable; call
:meth:`tick` from any loop, or :meth:`start` a ``marlin-fleet-ctl-*``
poll thread (the tests' thread-leak check watches the prefix;
:meth:`close` joins it).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

from ..config import get_config
from ..obs.exposition import (register_fleet_provider,
                              unregister_fleet_provider)
from ..obs.metrics import get_registry
from ..utils.tracing import get_default_event_log

__all__ = ["FleetController"]

_ctl_ids = itertools.count()

#: scale direction per action — flap damping suppresses an action whose
#: direction OPPOSES the previous one inside the flap window; rebalance is
#: direction-neutral (never damped, only cooled down)
_DIRECTION = {"scale_out": 1, "scale_in": -1, "rebalance": 0}


class FleetController:
    """Close the loop from fleet-merged SLO burn to fleet topology.

    ``FleetController(router)`` reads every knob from the config
    (``serve_fleet_*``; keyword overrides win) and registers its
    ``/debug/fleet`` provider. Nothing evaluates until :meth:`tick` is
    called (or :meth:`start` spawns the poll thread) — construction is
    passive, so tests drive the controller deterministically on an
    injectable ``clock``. ``threaded=False`` runs actions inline on the
    ticking thread (deterministic tests); the default runs each on its own
    ``marlin-fleet-act-*`` thread so a slow migration never blocks the
    evaluation loop.

    The controller is restart-safe by design: its only durable state is
    the Router's own replica set. Rebuilding a controller on the same
    router (e.g. after a crash mid-action) resumes correct control —
    streak counters restart empty and re-derive from the live burn
    signal."""

    def __init__(self, router, *, clock=time.monotonic, log=None,
                 min_replicas: int | None = None,
                 max_replicas: int | None = None,
                 eval_interval_s: float | None = None,
                 out_burn: float | None = None,
                 in_burn: float | None = None,
                 hysteresis: int | None = None,
                 cooldown_s: float | None = None,
                 flap_window_s: float | None = None,
                 rebalance_ratio: float | None = None,
                 shed_frac: float | None = None,
                 action_timeout_s: float | None = None,
                 threaded: bool = True):
        cfg = get_config()
        self.router = router
        self._clock = clock
        self._log = log
        self.min_replicas = int(cfg.serve_fleet_min_replicas
                                if min_replicas is None else min_replicas)
        self.max_replicas = int(cfg.serve_fleet_max_replicas
                                if max_replicas is None else max_replicas)
        self.eval_interval_s = float(
            cfg.serve_fleet_eval_interval_s if eval_interval_s is None
            else eval_interval_s)
        self.out_burn = float(cfg.serve_fleet_out_burn if out_burn is None
                              else out_burn)
        self.in_burn = float(cfg.serve_fleet_in_burn if in_burn is None
                             else in_burn)
        self.hysteresis = int(cfg.serve_fleet_hysteresis if hysteresis is
                              None else hysteresis)
        self.cooldown_s = float(cfg.serve_fleet_cooldown_s if cooldown_s is
                                None else cooldown_s)
        self.flap_window_s = float(
            cfg.serve_fleet_flap_window_s if flap_window_s is None
            else flap_window_s)
        self.rebalance_ratio = float(
            cfg.serve_fleet_rebalance_ratio if rebalance_ratio is None
            else rebalance_ratio)
        self.shed_frac = float(cfg.serve_fleet_shed_frac if shed_frac is
                               None else shed_frac)
        self.action_timeout_s = float(
            cfg.serve_fleet_action_timeout_s if action_timeout_s is None
            else action_timeout_s)
        self._threaded = bool(threaded)
        # re-entrant: tick() holds it across _decide/_reset_streak, which
        # take it again at their own write sites (lock-discipline wants
        # every cross-thread write lexically under the lock)
        self._lock = threading.RLock()
        self._closed = False
        self._hot = 0          # consecutive evaluations at/above out_burn
        self._slack = 0        # consecutive evaluations at/below in_burn
        self._imbalance = 0    # consecutive hot-spotted evaluations
        self._last_eval: float | None = None
        self._last_burn = 0.0
        self._action: dict | None = None      # the single in-flight action
        self._last_action: dict | None = None  # most recent COMPLETED one
        self._history: collections.deque = collections.deque(maxlen=16)
        self._rs_mark: float | None = None    # replica-seconds accumulator
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._name = f"marlin-fleet-{next(_ctl_ids)}"
        reg = get_registry()
        self._m_replicas = reg.gauge(
            "marlin_fleet_replicas",
            "Live replicas behind the router the fleet controller drives",
            labelnames=("router",)).labels(router=router._name)
        self._m_burn = reg.gauge(
            "marlin_fleet_burn",
            "Fleet-merged worst-objective fast-window error-budget burn "
            "rate the controller last evaluated", labelnames=("router",)
        ).labels(router=router._name)
        self._m_weight = reg.gauge(
            "marlin_fleet_weight",
            "Per-replica rendezvous routing weight (1.0 = classic HRW; "
            "rebalance sheds by shrinking it)",
            labelnames=("router", "replica"))
        self._m_actions = reg.counter(
            "marlin_fleet_actions_total",
            "Fleet controller actions by outcome (ok / error / timeout / "
            "damped)", labelnames=("router", "action", "outcome"))
        self._m_replica_seconds = reg.counter(
            "marlin_fleet_replica_seconds_total",
            "Accumulated replica-seconds of fleet capacity (replicas x "
            "wall time between controller evaluations) — the bench's "
            "replica-hours denominator", labelnames=("router",)
        ).labels(router=router._name)
        register_fleet_provider(self._name, self.payload)

    # ------------------------------------------------------------ lifecycle

    def start(self, poll_s: float = 1.0) -> None:
        """Spawn the ``marlin-fleet-ctl-*`` poll thread: ``tick()`` every
        ``poll_s`` real seconds (the eval-interval rate limit still
        applies on the controller's own clock). Idempotent."""
        with self._lock:
            if self._closed or self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._poll, args=(float(poll_s),), daemon=True,
                name=f"{self._name}-ctl")
        self._thread.start()

    def _poll(self, poll_s: float) -> None:
        while not self._stop.wait(poll_s):
            try:
                self.tick()
            except Exception:
                # the control loop must never die of its own bug; the
                # next poll re-evaluates from the router's live state
                pass

    def close(self) -> None:
        """Stop evaluating and unregister the ``/debug/fleet`` provider.
        Joins the poll thread and any in-flight action thread (bounded —
        the action's own migration timeouts make it finite). The router
        is untouched: closing the controller freezes the fleet at its
        current size, it does not shrink it. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            action = self._action
            thread = self._thread
        self._stop.set()
        if thread is not None and thread.is_alive():
            thread.join(timeout=30.0)
        t = (action or {}).get("thread")
        if t is not None and t is not threading.current_thread() \
                and t.is_alive():
            t.join(timeout=30.0)
        unregister_fleet_provider(self._name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ----------------------------------------------------------- evaluation

    def _emit(self, **fields) -> None:
        log = self._log or get_default_event_log()
        if log is not None:
            log.event("fleet", controller=self._name,
                      router=self.router._name, **fields)

    def _burn_signal(self) -> float:
        """Worst fast-window burn across the fleet-merged objectives, 0.0
        when no SLOs are configured (a burn-less fleet never scales out
        and always counts as slack — min_replicas floors the shrink)."""
        try:
            merged = self.router._fleet_slo()
        except Exception:
            return 0.0
        if not merged:
            return 0.0
        burns = [o.get("burn_rate") or 0.0
                 for o in merged.get("objectives", ())]
        return max(burns, default=0.0)

    def _hot_spot(self, view: list[dict]) -> int | None:
        """The hot-spotted replica's index, or None. Hot-spotted = the
        most loaded ready replica's queue depth is nontrivial (>= 4) and
        exceeds ``rebalance_ratio`` times its peers' mean depth."""
        ready = [r for r in view if r["state"] == "accepting"]
        if len(ready) < 2:
            return None
        top = max(ready, key=lambda r: r["load"])
        if top["load"] < 4:
            return None
        others = [r["load"] for r in ready if r is not top]
        mean = sum(others) / len(others)
        if top["load"] >= self.rebalance_ratio * max(mean, 1.0):
            return top["replica"]
        return None

    def tick(self, now: float | None = None) -> dict:
        """One evaluation on the controller's clock: accumulate
        replica-seconds, rate-limit to ``eval_interval_s``, update the
        burn/imbalance streaks, and start at most one action. Returns a
        small decision record (``{"evaluated": bool, "action": ...}``) —
        the tests' window into the state machine. Never raises from a
        signal-read failure; action failures are recorded, not thrown."""
        now = self._clock() if now is None else now
        with self._lock:
            if self._closed:
                return {"evaluated": False, "reason": "closed"}
            n = self.router.replica_count()
            if self._rs_mark is not None and now > self._rs_mark:
                self._m_replica_seconds.inc((now - self._rs_mark) * n)
            self._rs_mark = now
            if self._last_eval is not None \
                    and now - self._last_eval < self.eval_interval_s:
                return {"evaluated": False, "reason": "interval"}
            self._last_eval = now
        burn = self._burn_signal()
        view = self.router.replica_view()
        hot_idx = self._hot_spot(view)
        self._m_replicas.set(len(view))
        self._m_burn.set(burn)
        for r in view:
            self._m_weight.labels(router=self.router._name,
                                  replica=r["replica"]).set(r["weight"])
        with self._lock:
            self._last_burn = burn
            if burn >= self.out_burn:
                self._hot += 1
                self._slack = 0
            elif burn <= self.in_burn:
                self._slack += 1
                self._hot = 0
            else:
                self._hot = self._slack = 0
            self._imbalance = self._imbalance + 1 if hot_idx is not None \
                else 0
            decision = self._decide(now, len(view), hot_idx)
        if decision.get("action") and decision.get("outcome") is None:
            self._launch(decision["action"], decision.get("replica"))
        return decision

    def _decide(self, now: float, n: int, hot_idx: int | None) -> dict:
        """Pick at most one action (caller holds the lock). Ordering:
        an in-flight action wins (single-flight), then cooldown, then
        scale-out (capacity protects the SLO) over scale-in over
        rebalance."""
        base = {"evaluated": True, "replicas": n,
                "burn": round(self._last_burn, 4), "action": None,
                "outcome": None}
        act = self._action
        if act is not None:
            if not act["timed_out"] \
                    and now - act["started"] > self.action_timeout_s:
                act["timed_out"] = True
                self._emit(action=act["action"], outcome="timeout",
                           seconds=round(now - act["started"], 3))
            return dict(base, reason="busy", action=None)
        last = self._last_action
        if last is not None and now - last["finished"] < self.cooldown_s:
            return dict(base, reason="cooldown")
        want = None
        if self._hot >= self.hysteresis:
            want = "scale_out" if n < self.max_replicas else None
            if want is None:
                return dict(base, reason="at-max")
        elif self._slack >= self.hysteresis:
            want = "scale_in" if n > self.min_replicas else None
            if want is None:
                return dict(base, reason="at-min")
        elif self._imbalance >= self.hysteresis:
            want = "rebalance"
        if want is None:
            return dict(base, reason="steady")
        if last is not None and _DIRECTION[want] \
                and _DIRECTION[want] == -_DIRECTION.get(last["action"], 0) \
                and now - last["finished"] < self.flap_window_s:
            # flap damping: reversing the previous action this soon means
            # the signal is oscillating, not trending — suppress, reset
            # the streak, and record the refusal
            self._reset_streak(want)
            self._m_actions.labels(router=self.router._name, action=want,
                                   outcome="damped").inc()
            self._emit(action=want, outcome="damped",
                       previous=last["action"],
                       age_s=round(now - last["finished"], 3))
            return dict(base, action=want, outcome="damped")
        self._reset_streak(want)
        with self._lock:  # re-entrant (tick holds it)
            self._action = {"action": want, "started": now,
                            "replica": hot_idx if want == "rebalance"
                            else None,
                            "timed_out": False, "thread": None}
        return dict(base, action=want,
                    replica=hot_idx if want == "rebalance" else None)

    def _reset_streak(self, action: str) -> None:
        with self._lock:  # re-entrant (tick holds it)
            if action == "scale_out":
                self._hot = 0
            elif action == "scale_in":
                self._slack = 0
            else:
                self._imbalance = 0

    # -------------------------------------------------------------- actions

    def _launch(self, action: str, replica: int | None) -> None:
        if not self._threaded:
            self._run_action(action, replica)
            return
        t = threading.Thread(target=self._run_action,
                             args=(action, replica), daemon=True,
                             name=f"{self._name}-act-{action}")
        with self._lock:
            if self._action is not None:
                self._action["thread"] = t
        t.start()

    def _run_action(self, action: str, replica: int | None) -> None:
        """Execute one action against the router. Every failure mode —
        exception, fault injection, a peer dying mid-migration — degrades
        to 'did nothing' or 'did it losslessly'; the router's own paths
        guarantee no work is dropped either way."""
        outcome, detail = "ok", {}
        try:
            if action == "scale_out":
                detail["replica"] = self.router.add_replica()
            elif action == "scale_in":
                detail["replica"] = self.router.retire_replica()
            else:
                idx, w = self.router.shed_weight(idx=replica,
                                                 frac=self.shed_frac)
                detail["replica"] = idx
                detail["weight"] = round(w, 4)
        except Exception as exc:
            outcome = "error"
            detail["error"] = f"{type(exc).__name__}: {exc}"
        now = self._clock()
        with self._lock:
            act = self._action
            self._action = None
            timed_out = bool(act and act["timed_out"])
            record = {"action": action, "outcome":
                      "timeout" if timed_out and outcome == "ok"
                      else outcome, "finished": now, **detail}
            self._last_action = record
            self._history.append(record)
        self._m_actions.labels(router=self.router._name, action=action,
                               outcome=record["outcome"]).inc()
        self._m_replicas.set(self.router.replica_count())
        self._emit(action=action, outcome=record["outcome"],
                   replicas=self.router.replica_count(), **detail)

    # -------------------------------------------------------- introspection

    def replica_seconds(self) -> float:
        """Replica-seconds accumulated so far (the bench's replica-hours
        source) — read off the process counter."""
        return float(self._m_replica_seconds.value)

    def payload(self) -> dict:
        """The ``GET /debug/fleet`` scope: bounds, streaks, burn, the
        in-flight action (if any), recent completed actions, and the
        router's live per-replica view — everything an operator needs to
        see why the fleet is (not) moving."""
        with self._lock:
            act = dict(self._action) if self._action else None
            if act is not None:
                act.pop("thread", None)
            body = {
                "controller": self._name,
                "router": self.router._name,
                "closed": self._closed,
                "replicas": self.router.replica_count(),
                "bounds": {"min": self.min_replicas,
                           "max": self.max_replicas},
                "burn": round(self._last_burn, 4),
                "thresholds": {"out": self.out_burn, "in": self.in_burn,
                               "hysteresis": self.hysteresis},
                "streaks": {"hot": self._hot, "slack": self._slack,
                            "imbalance": self._imbalance},
                "action": act,
                "history": list(self._history),
            }
        body["view"] = self.router.replica_view()
        body["replica_seconds"] = round(self.replica_seconds(), 3)
        return body
