"""Prometheus ``/metrics`` HTTP exposition over the stdlib ``http.server``.

Counterpart of ``marlin_tpu/obs/exposition.py``, copied (the module is
stdlib-only). The SLO and fleet provider registries are kept so the endpoint
contract is the JAX package's; nothing in the port registers one yet.

:class:`MetricsServer` binds a loopback (by default) port and serves, from
one daemon thread named ``marlin-obs-http-*`` (the test suite's thread-leak
fixture watches the prefix; :meth:`close` joins it):

- ``GET /metrics`` — the process registry's Prometheus text rendering.
- ``GET /healthz`` — a *readiness* probe, not just liveness: registered
  health providers (serving engines register themselves) report lifecycle
  (accepting/draining/closed), live-slot count, queue depth, and worker
  heartbeat age as JSON; any non-accepting engine turns the response 503 so
  a load balancer stops routing before drain completes. With no providers
  registered the endpoint degrades to the old static ``ok`` (process-up
  liveness).
- ``POST /debug/profile?seconds=N`` — a single-flight on-demand
  ``torch.profiler`` capture (:func:`marlin_tpu_torch.obs.perf.capture_profile`);
  a second concurrent request gets 409 while the first records.
- ``GET /debug/flight`` — every live flight recorder's ring as JSONL
  (:func:`marlin_tpu_torch.obs.perf.flight_records`), the in-memory black box
  without waiting for a dump trigger.
- ``GET /debug/kvpool`` — every registered paged engine's
  :meth:`~marlin_tpu_torch.serving.engine.ServeEngine.kvpool_audit` invariant
  report as JSON (refcounts vs block tables vs free list vs prefix cache;
  the chaos-suite postcondition, scrapeable in production).
- ``GET /debug/slo`` — every registered SLO scope's live evaluation
  (:meth:`~marlin_tpu_torch.obs.slo.SloEngine.payload`: per-objective compliance,
  burn rate, budget remaining, breach state, recent transitions) as JSON —
  the ops console's (``python -m marlin_tpu_torch.obs.console``) data source.
- ``GET /debug/fleet`` — every registered fleet controller's state
  (:meth:`~marlin_tpu_torch.serving.fleet.FleetController.payload`: replica
  view, burn streaks, in-flight/recent scale actions, bounds) as JSON —
  why the fleet is (not) resizing, scrapeable in production.
- ``GET /debug/memory`` — the process MemoryLedger's full account
  (:func:`marlin_tpu_torch.obs.memledger.memory_payload`: per-component
  registered bytes, the self-audit, live vs unattributed reconciliation
  — "n/a" on backends without ``memory_stats`` — the per-bucket
  planner-ratio table, recent leak alerts) as JSON; 503 when the audit
  reports an accounting violation.

:func:`start_from_config` is the config-driven entry: it starts a server
when ``config.obs_http_port`` is set (0 = ephemeral port), installs the
SIGUSR2 profile hook, and returns None when exposition is disabled (the
default), so long-running entrypoints call it unconditionally.

Starting a server also installs the default runtime collectors
(:func:`marlin_tpu_torch.obs.collectors.install_default_collectors`): a scrapeable
endpoint with no compile, device-memory, or program-cost series would
silently re-open the exact blind spots this layer exists to close.
"""

from __future__ import annotations

import http.server
import itertools
import json
import math
import threading
import urllib.parse

from .metrics import MetricsRegistry, get_registry

__all__ = ["MetricsServer", "start_from_config", "register_health_provider",
           "unregister_health_provider", "health_payload",
           "register_kvpool_provider", "unregister_kvpool_provider",
           "kvpool_payload", "register_slo_provider",
           "unregister_slo_provider", "slo_payload",
           "register_fleet_provider", "unregister_fleet_provider",
           "fleet_payload"]

_ids = itertools.count()

# ------------------------------------------------------------ health registry

_health_lock = threading.Lock()
_health_providers: dict[str, object] = {}  # name -> callable() -> dict
_kvpool_providers: dict[str, object] = {}  # name -> callable() -> audit dict
_slo_providers: dict[str, object] = {}     # name -> callable() -> SLO dict
_fleet_providers: dict[str, object] = {}   # name -> callable() -> fleet dict

#: provider states that flip readiness to 503 — an engine past "accepting"
#: must drop out of rotation even while it finishes accepted work
_NOT_READY = ("draining", "closing", "closed")


def register_health_provider(name: str, fn) -> None:
    """Register a readiness probe: ``fn()`` returns a small dict with at
    least ``state`` (``accepting`` / ``draining`` / ``closed``). Serving
    engines self-register; anything long-running may join. Re-registering a
    name replaces the provider."""
    with _health_lock:
        _health_providers[name] = fn


def unregister_health_provider(name: str) -> None:
    with _health_lock:
        _health_providers.pop(name, None)


def register_kvpool_provider(name: str, fn) -> None:
    """Register a paged-pool audit probe: ``fn()`` returns the engine's
    :meth:`~marlin_tpu_torch.serving.engine.ServeEngine.kvpool_audit` dict (or
    None to prune itself). Paged serving engines self-register; the report
    rides ``GET /debug/kvpool``. Re-registering a name replaces it."""
    with _health_lock:
        _kvpool_providers[name] = fn


def unregister_kvpool_provider(name: str) -> None:
    with _health_lock:
        _kvpool_providers.pop(name, None)


def register_slo_provider(name: str, fn) -> None:
    """Register an SLO probe: ``fn()`` returns an
    :meth:`~marlin_tpu_torch.obs.slo.SloEngine.payload` dict (or None to prune
    itself). Engines with objectives configured self-register per replica,
    the router registers the fleet merge; the reports ride
    ``GET /debug/slo``. Re-registering a name replaces it."""
    with _health_lock:
        _slo_providers[name] = fn


def unregister_slo_provider(name: str) -> None:
    with _health_lock:
        _slo_providers.pop(name, None)


def register_fleet_provider(name: str, fn) -> None:
    """Register a fleet-controller probe: ``fn()`` returns a
    :meth:`~marlin_tpu_torch.serving.fleet.FleetController.payload` dict (or
    None to prune itself). Controllers self-register; the reports ride
    ``GET /debug/fleet``. Re-registering a name replaces it."""
    with _health_lock:
        _fleet_providers[name] = fn


def unregister_fleet_provider(name: str) -> None:
    with _health_lock:
        _fleet_providers.pop(name, None)


def fleet_payload() -> tuple[int, dict]:
    """(status_code, body) of the fleet-controller probe — always 200 (a
    busy or cooling controller is a *state*, not an endpoint failure),
    one entry per registered controller. A provider that raises reports
    ``error`` instead of taking the endpoint down."""
    with _health_lock:
        providers = dict(_fleet_providers)
    fleets = []
    for name, fn in sorted(providers.items()):
        try:
            info = fn()
            if info is None:  # provider pruned itself (e.g. GC'd engine)
                continue
            info = dict(info)
        except Exception as e:
            info = {"error": f"{type(e).__name__}: {e}"}
        info.setdefault("name", name)
        fleets.append(info)
    return 200, {"status": "ok", "fleets": fleets}


def slo_payload() -> tuple[int, dict]:
    """(status_code, body) of the live-SLO probe — always 200 (a breached
    SLO is an *alert*, not an endpoint failure; readiness stays /healthz's
    job), with one entry per registered scope. A provider that raises
    reports ``error`` instead of taking the endpoint down."""
    with _health_lock:
        providers = dict(_slo_providers)
    scopes = []
    for name, fn in sorted(providers.items()):
        try:
            info = fn()
            if info is None:  # provider pruned itself (e.g. GC'd engine)
                continue
            info = dict(info)
        except Exception as e:
            info = {"error": f"{type(e).__name__}: {e}"}
        info.setdefault("name", name)
        scopes.append(info)
    return 200, {"status": "ok", "scopes": scopes}


def kvpool_payload() -> tuple[int, dict]:
    """(status_code, body) of the pool-invariant probe — 200 when every
    registered pool audits clean, 503 when any reports a violation (an
    inconsistent pool is as out-of-rotation as a draining engine). A
    provider that raises reports ``ok=False``: an unanswerable audit is
    not a clean one, but must not take the endpoint down."""
    with _health_lock:
        providers = dict(_kvpool_providers)
    pools = []
    ok = True
    for name, fn in sorted(providers.items()):
        try:
            info = fn()
            if info is None:  # provider pruned itself (e.g. GC'd engine)
                continue
            info = dict(info)
        except Exception as e:
            info = {"ok": False,
                    "errors": [f"{type(e).__name__}: {e}"]}
        info.setdefault("name", name)
        if not info.get("ok", False):
            ok = False
        pools.append(info)
    return (200 if ok else 503,
            {"status": "ok" if ok else "violated", "pools": pools})


def health_payload() -> tuple[int, dict]:
    """(status_code, body) of the readiness probe — pure over the provider
    registry so tests exercise the 503 logic without racing a live drain.
    A provider that raises reports ``state="error"`` (and 503s): a probe
    that cannot answer is not ready, but must not take the endpoint down."""
    with _health_lock:
        providers = dict(_health_providers)
    engines = []
    ready = True
    for name, fn in sorted(providers.items()):
        try:
            info = fn()
            if info is None:  # provider pruned itself (e.g. GC'd engine)
                continue
            info = dict(info)
        except Exception as e:
            info = {"state": "error", "error": f"{type(e).__name__}: {e}"}
        info.setdefault("name", name)
        state = info.get("state")
        if state in _NOT_READY or state == "error":
            ready = False
        engines.append(info)
    return (200 if ready else 503,
            {"status": "ok" if ready else "unavailable", "engines": engines})


class _Handler(http.server.BaseHTTPRequestHandler):
    # the registry rides on the server object (one handler class serves
    # every MetricsServer instance)
    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
        path = self.path.split("?")[0]
        if path == "/metrics":
            body = self.server._marlin_registry.render().encode()
            self._reply(200, body,
                        "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/healthz":
            code, payload = health_payload()
            if not payload["engines"]:
                # liveness fallback: nothing registered, process is up
                self._reply(200, b"ok\n", "text/plain; charset=utf-8")
            else:
                self._reply(code, (json.dumps(payload) + "\n").encode(),
                            "application/json")
        elif path == "/debug/flight":
            from .perf import flight_records

            lines = "".join(json.dumps(r) + "\n" for r in flight_records())
            self._reply(200, lines.encode(), "application/jsonl")
        elif path == "/debug/kvpool":
            code, payload = kvpool_payload()
            self._reply(code, (json.dumps(payload) + "\n").encode(),
                        "application/json")
        elif path == "/debug/slo":
            code, payload = slo_payload()
            self._reply(code, (json.dumps(payload) + "\n").encode(),
                        "application/json")
        elif path == "/debug/fleet":
            code, payload = fleet_payload()
            self._reply(code, (json.dumps(payload) + "\n").encode(),
                        "application/json")
        elif path == "/debug/memory":
            from .memledger import memory_payload

            code, payload = memory_payload()
            self._reply(code, (json.dumps(payload) + "\n").encode(),
                        "application/json")
        else:
            self._reply(404, b"not found\n", "text/plain; charset=utf-8")

    def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler API
        parsed = urllib.parse.urlparse(self.path)
        if parsed.path != "/debug/profile":
            self._reply(404, b"not found\n", "text/plain; charset=utf-8")
            return
        from .perf import ProfileBusy, capture_profile

        q = urllib.parse.parse_qs(parsed.query)
        try:
            seconds = float(q.get("seconds", ["2"])[0])
        except ValueError:
            seconds = float("nan")
        if not math.isfinite(seconds):  # nan slides through min/max clamps
            self._reply(400, b"seconds must be a finite number\n",
                        "text/plain; charset=utf-8")
            return
        seconds = min(max(seconds, 0.0), 600.0)  # bound a typo'd capture
        try:
            path = capture_profile(seconds)
        except ProfileBusy as e:
            self._reply(409, (str(e) + "\n").encode(),
                        "text/plain; charset=utf-8")
            return
        except Exception as e:
            self._reply(500, f"{type(e).__name__}: {e}\n".encode(),
                        "text/plain; charset=utf-8")
            return
        body = json.dumps({"path": path, "seconds": seconds}) + "\n"
        self._reply(200, body.encode(), "application/json")

    def _reply(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # scrapes must not spam stderr
        pass


class MetricsServer:
    """Serve ``registry.render()`` at ``http://host:port/metrics``.

    ``port=0`` binds an ephemeral port; the bound port is :meth:`start`'s
    return value (and ``.port`` afterwards). Usable as a context manager.
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: MetricsRegistry | None = None):
        self._host = host
        self._want_port = int(port)
        self._registry = registry if registry is not None else get_registry()
        self._httpd: http.server.ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self.port: int | None = None

    @property
    def url(self) -> str:
        if self.port is None:
            raise RuntimeError("metrics server not started")
        return f"http://{self._host}:{self.port}/metrics"

    def start(self) -> int:
        """Bind and serve from a daemon thread; returns the bound port.
        Idempotent (a second start returns the live port)."""
        if self._httpd is not None:
            return self.port
        from .collectors import install_default_collectors

        install_default_collectors(self._registry)
        httpd = http.server.ThreadingHTTPServer(
            (self._host, self._want_port), _Handler)
        httpd.daemon_threads = True  # per-request threads must not pin exit
        httpd._marlin_registry = self._registry
        self._httpd = httpd
        self.port = httpd.server_address[1]
        self._thread = threading.Thread(
            target=httpd.serve_forever, daemon=True,
            name=f"marlin-obs-http-{next(_ids)}")
        self._thread.start()
        return self.port

    def close(self) -> None:
        """Stop serving and join the server thread. Idempotent; never
        raises (exposition shutdown rides error paths)."""
        httpd, thread = self._httpd, self._thread
        self._httpd = self._thread = None
        if httpd is None:
            return
        try:
            httpd.shutdown()
            httpd.server_close()
        except Exception:
            pass
        if thread is not None:
            thread.join(timeout=10.0)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()


def start_from_config(registry: MetricsRegistry | None = None,
                      ) -> MetricsServer | None:
    """Start a metrics endpoint when ``config.obs_http_port`` says so
    (None = disabled, the default; 0 = ephemeral port; otherwise the fixed
    port). Returns the running server, or None when disabled — callers in
    long-running entrypoints (benches, serving mains) invoke this
    unconditionally and close whatever comes back. Also installs the
    SIGUSR2 on-demand profiler hook (main thread only; a no-op elsewhere)
    — the same capture the HTTP endpoint triggers, for processes reachable
    only by signal."""
    from ..config import get_config

    port = get_config().obs_http_port
    if port is None:
        return None
    server = MetricsServer(port=port, registry=registry)
    server.start()
    from .perf import install_profile_signal

    install_profile_signal()
    return server
