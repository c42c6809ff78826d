"""Minimal HTTP sidecar for the gateway: ``/healthz`` + ``/metrics``.

A copy of the reference package's ``gateway/httpapi.py``. Two
read-only endpoints, stdlib ``http.server`` only:

* ``GET /healthz`` -- the health JSON a load balancer keys on: the
  pool's ``serve`` block plus the gateway's own ``gateway`` block
  (:meth:`~rocalphago_tpu_torch.gateway.server.GatewayServer.stats`).
  ``status`` is ``draining`` once a drain started, else ``ok``; served
  with 503 while draining so plain HTTP checks fail over without
  parsing.
* ``GET /metrics`` -- the obs registry's Prometheus text exposition
  (:func:`rocalphago_tpu_torch.obs.registry.render_text`), so the
  gateway's counters scrape like every other metric in the process.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from rocalphago_tpu_torch.obs import registry as obs_registry


class GatewayHTTP:
    """The probe server; ``server`` is the :class:`GatewayServer` whose
    pool and stats it exposes. ``port=0`` binds an ephemeral port;
    :meth:`close` is bounded (the serve loop is joined)."""

    def __init__(self, server, host: str = "127.0.0.1",
                 port: int = 0):
        gateway = server

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: N802 -- quiet
                pass

            def _reply(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 -- http.server contract
                if self.path == "/metrics":
                    self._reply(200,
                                obs_registry.render_text().encode(),
                                "text/plain; version=0.0.4")
                    return
                if self.path == "/healthz":
                    draining = gateway.draining
                    body = json.dumps({
                        "status": ("draining" if draining else "ok"),
                        "serve": gateway.pool.stats(),
                        "gateway": gateway.stats(),
                    }, sort_keys=True).encode()
                    self._reply(503 if draining else 200, body,
                                "application/json")
                    return
                self._reply(404, b"not found\n", "text/plain")

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1}, name="gateway-http")

    def start(self) -> "GatewayHTTP":
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def close(self) -> None:
        self._httpd.shutdown()
        self._thread.join(timeout=10.0)
        self._httpd.server_close()
