"""Opt-in live metrics endpoint: Prometheus text exposition over plain HTTP.

Copy of ``sheeprl_tpu/obs/metrics_http.py`` kept by the port (which imports
nothing of the JAX package).

``metric.telemetry.http_port`` (default off) makes the telemetry facade serve
the gauges it ALREADY aggregates — the training window gauges of
:class:`~sheeprl_tpu_torch.obs.telemetry.RunTelemetry`, the serving window gauges of
:class:`~sheeprl_tpu_torch.serve.telemetry.ServingTelemetry`, and the fleet runner's
member board — at ``GET /metrics`` in Prometheus text-exposition format
(version 0.0.4), so a ``PolicyServer`` or a fleet runner is scrapeable in
place with a stock Prometheus/Grafana stack. There is deliberately NO second
bookkeeping path: the telemetry window emit pushes the same numbers it writes
to ``telemetry.jsonl`` into the endpoint's gauge map, and the endpoint only
renders that map on scrape. That single push point is how new gauge families
arrive for free — e.g. the device-ring storage gauges
(``Buffer/ring_fill``/``ring_occupancy``/``ring_overwritten``,
howto/device_replay.md) and the window-capture attribution gauges
(``Perf/xla_comm_fraction``/``xla_mxu_fraction``/``xla_idle_fraction``,
howto/observability.md "Profiling a fused program") are scrapeable on any run
that produces them, with no endpoint change.

Off (the default ``http_port: null``) constructs nothing: no socket, no
thread, no artifact. ``http_port: 0`` binds an ephemeral port (tests read it
back from :attr:`MetricsEndpoint.port`). The listener binds
``metric.telemetry.http_host`` (default ``127.0.0.1`` — scraping across hosts
is an explicit opt-in, not a default exposure).

The same listener also answers ``GET /healthz`` — the readiness/liveness probe
the serving tier's drain/overload lifecycle needs (howto/serving.md,
"Operating a server"): the owner pushes a health dict via
:meth:`MetricsEndpoint.set_health` (``{"ready": bool, "status": str, ...}``)
and the probe returns it as JSON with 200 when ready, 503 when not (a draining
or still-loading server is alive but must be pulled from rotation). With no
health dict set the probe reports ``{"ready": true, "status": "ok"}`` — a
process serving metrics is, at minimum, alive.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Mapping, Optional

__all__ = ["MetricsEndpoint", "prometheus_name", "render_prometheus"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def prometheus_name(name: str, namespace: str = "sheeprl") -> str:
    """Map a telemetry gauge name onto the Prometheus grammar:
    ``Perf/sps`` → ``sheeprl_perf_sps``, ``Serve/latency_p99_ms`` →
    ``sheeprl_serve_latency_p99_ms``."""
    flat = _NAME_RE.sub("_", str(name)).strip("_").lower()
    return f"{namespace}_{flat}" if namespace else flat


def render_prometheus(
    gauges: Mapping[str, float],
    labels: Optional[Mapping[str, str]] = None,
    namespace: str = "sheeprl",
) -> str:
    """One gauge family per entry, ``# TYPE`` annotated, deterministic order."""
    label_str = ""
    if labels:
        # label VALUES must escape \ " \n per the exposition grammar — a run
        # name with a quote would otherwise fail every scrape of the endpoint
        def esc(v: Any) -> str:
            return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")

        inner = ",".join(
            f'{prometheus_name(k, namespace="")}="{esc(v)}"' for k, v in sorted(labels.items())
        )
        label_str = "{" + inner + "}"
    lines = []
    for name in sorted(gauges):
        value = gauges[name]
        if value is None:
            continue
        prom = prometheus_name(name, namespace)
        lines.append(f"# TYPE {prom} gauge")
        lines.append(f"{prom}{label_str} {float(value):g}")
    return "\n".join(lines) + "\n"


class MetricsEndpoint:
    """A daemon-threaded HTTP listener rendering the current gauge map.

    ``update(gauges)`` merges (``replace=True`` swaps the whole map — the
    window emit's contract, so a gauge that disappears from the stream does not
    linger forever); ``close()`` shuts the listener down. Construction raises
    ``OSError`` on an unbindable port — callers decide whether that is fatal
    (the CLI warns and runs without the endpoint)."""

    def __init__(
        self,
        port: int,
        host: str = "127.0.0.1",
        *,
        labels: Optional[Mapping[str, str]] = None,
        namespace: str = "sheeprl",
    ) -> None:
        self._lock = threading.Lock()
        self._gauges: Dict[str, float] = {}
        self._health: Dict[str, Any] = {}
        self._labels = dict(labels or {})
        self._namespace = namespace
        endpoint = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 — http.server API
                route = self.path.split("?", 1)[0]
                if route == "/healthz":
                    ready, payload = endpoint.health()
                    body = (json.dumps(payload) + "\n").encode("utf-8")
                    # readiness semantics: 503 pulls a draining/booting server
                    # out of rotation while the process stays alive (liveness
                    # is the connection itself)
                    self.send_response(200 if ready else 503)
                    self.send_header("Content-Type", "application/json; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if route not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = endpoint.render().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args: Any) -> None:
                pass  # scrapes are not run events; keep stdout clean

        self._server = ThreadingHTTPServer((host, int(port)), _Handler)
        self._server.daemon_threads = True
        self.host = self._server.server_address[0]
        self.port = int(self._server.server_address[1])
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="sheeprl-metrics-http", daemon=True
        )
        self._thread.start()

    def update(self, gauges: Mapping[str, Any], replace: bool = True) -> None:
        numeric = {
            k: float(v)
            for k, v in gauges.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        }
        with self._lock:
            if replace:
                self._gauges = numeric
            else:
                self._gauges.update(numeric)

    def set_health(self, health: Mapping[str, Any]) -> None:
        """Replace the ``/healthz`` payload. ``{"ready": bool, "status": str,
        ...}`` — extras (weight version, active sessions) pass through as
        JSON. The owner pushes state transitions (loading → ok → draining);
        the probe only renders."""
        with self._lock:
            self._health = dict(health)

    def health(self) -> tuple:
        with self._lock:
            payload = dict(self._health) if self._health else {"ready": True, "status": "ok"}
        payload.setdefault("ready", True)
        payload.setdefault("status", "ok" if payload["ready"] else "not_ready")
        return bool(payload["ready"]), payload

    def render(self) -> str:
        with self._lock:
            gauges = dict(self._gauges)
            labels = dict(self._labels)
        return render_prometheus(gauges, labels, self._namespace)

    def close(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:
            pass
        self._thread.join(timeout=5.0)


def build_endpoint(
    tcfg: Mapping[str, Any], labels: Optional[Mapping[str, str]] = None
) -> Optional[MetricsEndpoint]:
    """The config-gated constructor every telemetry facade shares: None when
    ``http_port`` is unset (the zero-socket default), a bound endpoint
    otherwise; an unbindable port degrades to a warning, never a crash."""
    port = tcfg.get("http_port")
    if port is None or (isinstance(port, str) and not port.strip()):
        return None
    import warnings

    try:
        # ValueError/TypeError: the port may arrive as a raw override string
        # (fleet specs pass base args verbatim) — a typo degrades like a bind
        # failure, it must not kill the run the telemetry is supposed to watch
        return MetricsEndpoint(
            int(port), str(tcfg.get("http_host") or "127.0.0.1"), labels=labels
        )
    except (OSError, ValueError, TypeError) as exc:
        warnings.warn(
            f"telemetry: could not bind the metrics endpoint on port {port!r}: {exc} "
            "— continuing without it"
        )
        return None
