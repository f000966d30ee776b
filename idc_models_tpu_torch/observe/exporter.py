"""Live metrics exposition: a stdlib HTTP endpoint over the registry,
the counterpart of ``idc_models_tpu/observe/exporter.py``.

- ``GET /metrics`` -- the registry's Prometheus text, equal to
  `registry.prometheus_text()` at the instant of the scrape
  (``Content-Type: text/plain; version=0.0.4``).
- ``GET /healthz`` -- a small JSON document for load-balancer probes:
  seconds since the serve scheduler's last cycle (`last_tick_age_s`,
  from the ``serve_last_tick_monotonic_seconds`` gauge the serving
  metrics stamp), the `queue_depth` and `slot_occupancy` gauges, the
  paged engine's `kv_pages_used` / `kv_pages_total`, the brownout
  `brownout_stage`, and ``"status": "ok"``; a field whose gauge was never
  set is null.

The server is a daemon `ThreadingHTTPServer` on its own thread, so a
scrape never blocks the serve loop; `close()` (or leaving the context)
takes it down with its owner. Port 0 binds an ephemeral port (`.port`).
The per-tenant block of /healthz comes with tenancy (ROADMAP A9.4), the
fleet surfaces with the cluster (A10).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from idc_models_tpu_torch.observe import metrics_registry as mreg

# the /healthz freshness anchor: the serve metrics stamp this gauge with
# time.monotonic() once per scheduler cycle
LAST_TICK_GAUGE = "serve_last_tick_monotonic_seconds"


class MetricsExporter:
    """Serve `registry` (the process-wide one by default) over HTTP from
    a daemon thread.

    >>> with MetricsExporter(port=0) as exp:
    ...     print(exp.url)          # http://127.0.0.1:<os-assigned>
    """

    def __init__(self, registry: mreg.MetricsRegistry | None = None, *,
                 port: int = 0, host: str = "127.0.0.1"):
        self.registry = registry if registry is not None else mreg.REGISTRY
        self._host = host
        self._requested_port = int(port)
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "MetricsExporter":
        if self._server is not None:
            raise RuntimeError("exporter already started")
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            # scrape logging would interleave with the run's own output
            def log_message(self, fmt, *args):  # noqa: ARG002
                return

            def do_GET(self):
                try:
                    if self.path in ("/metrics", "/metrics/"):
                        body = exporter.registry.prometheus_text().encode()
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                    elif self.path in ("/healthz", "/healthz/"):
                        body = (json.dumps(exporter.health())
                                + "\n").encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404, "unknown path (serving "
                                             "/metrics and /healthz)")
                        return
                except Exception as e:  # noqa: BLE001 -- a scrape must
                    # never kill the handler thread: the scraper sees
                    # the error instead
                    self.send_error(500, f"{type(e).__name__}: {e}")
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer(
            (self._host, self._requested_port), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="idc-metrics-exporter", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        """Shut the endpoint down with its owning loop. Idempotent."""
        server, self._server = self._server, None
        if server is None:
            return
        server.shutdown()           # stops serve_forever
        server.server_close()       # releases the socket
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "MetricsExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- introspection ----------------------------------------------------

    @property
    def port(self) -> int:
        if self._server is None:
            raise RuntimeError("exporter not started")
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def health(self) -> dict:
        """The /healthz document, from the registry's gauges alone: any
        process that keeps the gauges gets an honest health surface."""

        def gauge_value(name):
            # the health gauges are unlabeled by contract
            inst = self.registry.get(name)
            if inst is None or inst.kind != "gauge" or inst.label_names:
                return None
            return inst.value(default=None)

        last_tick = gauge_value(LAST_TICK_GAUGE)
        stage = gauge_value("serve_brownout_stage")
        doc = {
            "status": "ok",
            "last_tick_age_s": (
                None if last_tick is None
                else round(time.monotonic() - last_tick, 4)),
            "queue_depth": gauge_value("serve_queue_depth"),
            "slot_occupancy": gauge_value("serve_slot_occupancy"),
            "kv_pages_used": gauge_value("serve_kv_pages_used"),
            "kv_pages_total": gauge_value("serve_kv_pages_total"),
            "brownout_stage": None if stage is None else int(stage),
        }
        return doc
