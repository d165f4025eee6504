"""HTTP telemetry plane: scrape a live (or finished) engine in-process
(the port's own copy of ``repro/serving/server.py``).

A deliberately small stdlib-asyncio HTTP/1.0 server — no framework, no
dependency — that runs its own event loop on a daemon thread next to
``ServingEngine.serve()`` and exposes read-only observability:

===================  ====================================================
endpoint             body
===================  ====================================================
``GET /metrics``     Prometheus text exposition from the engine's
                     :class:`MetricsRegistry` (``render_prometheus()``)
``GET /healthz``     JSON liveness: engine present, virtual ``now`` and
                     the age of the last decode step, both on the
                     *injected* clock
``GET /debug/state`` the deep-copied ``engine.stats()`` tree as JSON
``GET /debug/trace`` the flight recorder's Chrome-trace dump
===================  ====================================================

The server thread never touches the device: ``engine.stats()`` and the
tracer's events hold host values only (Python numbers, strings, lists
and dicts), and the JSON encoder's last resort turns a numpy scalar into
a Python number and anything else into a description that reads no
values — a CUDA tensor's ``.item()`` or ``repr`` would synchronize the
card from this second thread.

Thread-safety is by construction, not locks: every handler only *reads*
engine state; the GIL keeps individual dict/deque operations atomic, and
the only cross-thread hazard — "dict changed size during iteration"
while the engine mutates a registry mid-render — is handled by
retrying the snapshot a few times.  The serving loop itself never sees
the server: attaching one cannot change the token stream.

A router in front of several replicas would scrape these endpoints per
replica.
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Callable, Optional, Tuple

import numpy as np

__all__ = ["TelemetryServer"]

_STATUS_TEXT = {200: "OK", 404: "Not Found", 405: "Method Not Allowed",
                500: "Internal Server Error"}

#: Attempts at a consistent read while the engine thread mutates state.
_SNAPSHOT_ATTEMPTS = 8


def _jsonable(obj):
    """Last-resort encoder: numpy scalars → python, a tensor → its shape,
    type and device (never its values: reading a CUDA tensor from this
    thread would synchronize the card), else repr."""
    if isinstance(obj, np.generic):
        return obj.tolist()
    if hasattr(obj, "device") and hasattr(obj, "shape"):
        return (f"<{type(obj).__name__} {tuple(obj.shape)} "
                f"{getattr(obj, 'dtype', '?')} on {obj.device}>")
    return repr(obj)


class TelemetryServer:
    """Serve an engine's telemetry over HTTP from a background thread.

    ``port=0`` binds an ephemeral port; :meth:`start` returns the bound
    port and records it as :attr:`bound_port`.  Usable as a context
    manager::

        with TelemetryServer(engine, port=0) as srv:
            engine.serve(requests, seed=0)
            # curl http://127.0.0.1:{srv.bound_port}/metrics
    """

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0):
        self.engine = engine
        self.host = host
        self.port = port
        self.bound_port: Optional[int] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._server: Optional[asyncio.AbstractServer] = None

    # -- lifecycle -----------------------------------------------------

    def start(self, timeout_s: float = 10.0) -> int:
        if self._thread is not None:
            raise RuntimeError("TelemetryServer already started")
        self._loop = asyncio.new_event_loop()
        started = threading.Event()

        def _run():
            asyncio.set_event_loop(self._loop)
            try:
                self._server = self._loop.run_until_complete(
                    asyncio.start_server(self._handle, self.host, self.port))
                self.bound_port = \
                    self._server.sockets[0].getsockname()[1]
            finally:
                started.set()
            self._loop.run_forever()
            # drain: close the listener inside the loop it belongs to
            if self._server is not None:
                self._server.close()
                self._loop.run_until_complete(self._server.wait_closed())
            self._loop.close()

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="telemetry-http")
        self._thread.start()
        if not started.wait(timeout_s) or self.bound_port is None:
            raise RuntimeError(
                f"telemetry server failed to bind {self.host}:{self.port}")
        return self.bound_port

    def stop(self, timeout_s: float = 10.0) -> None:
        if self._thread is None:
            return
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout_s)
        self._thread = None
        self._server = None
        self._loop = None

    def __enter__(self) -> "TelemetryServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- request handling ----------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            request_line = await reader.readline()
            while True:  # drain headers; we never need them
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
            parts = request_line.split()
            if len(parts) < 2:
                return
            method, path = parts[0].decode("latin-1"), \
                parts[1].decode("latin-1")
            try:
                status, ctype, body = self._route(method, path)
            except Exception as e:  # surface, don't kill the server
                status, ctype = 500, "text/plain; charset=utf-8"
                body = f"internal error: {type(e).__name__}: {e}\n"
            payload = body.encode("utf-8")
            head = (f"HTTP/1.0 {status} {_STATUS_TEXT[status]}\r\n"
                    f"Content-Type: {ctype}\r\n"
                    f"Content-Length: {len(payload)}\r\n"
                    "Connection: close\r\n\r\n")
            writer.write(head.encode("latin-1") + payload)
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    def _route(self, method: str, path: str) -> Tuple[int, str, str]:
        if method != "GET":
            return 405, "text/plain; charset=utf-8", "GET only\n"
        path = path.split("?", 1)[0]
        if path == "/metrics":
            text = self._read(self.engine.metrics.render_prometheus)
            return 200, "text/plain; version=0.0.4; charset=utf-8", text
        if path == "/healthz":
            return 200, "application/json", self._healthz()
        if path == "/debug/state":
            state = self._read(self.engine.stats)
            return 200, "application/json", json.dumps(
                state, sort_keys=True, default=_jsonable) + "\n"
        if path == "/debug/trace":
            trace = self._read(self.engine.tracer.chrome_trace)
            return 200, "application/json", json.dumps(
                trace, sort_keys=True, default=_jsonable) + "\n"
        return 404, "text/plain; charset=utf-8", f"no route {path}\n"

    def _healthz(self) -> str:
        now = float(self.engine.clock())
        last = self.engine.last_step_t
        doc = {
            "status": "ok" if last is not None else "idle",
            "now": now,
            "last_step_t": last,
            "last_step_age_s": (now - last) if last is not None else None,
            "slots": int(self.engine.slots),
        }
        wd = getattr(self.engine, "watchdog", None)
        if wd is not None:
            doc["page_active"] = bool(wd.page_active)
            doc["alerts"] = len(wd.alert_log)
        return json.dumps(doc, sort_keys=True) + "\n"

    @staticmethod
    def _read(fn: Callable[[], object]):
        """Snapshot engine state while the serve loop mutates it: any
        single dict op is GIL-atomic, so the only failure mode is an
        iteration invalidated mid-walk — retry a bounded number of
        times, then let the error propagate to the 500 handler."""
        for _ in range(_SNAPSHOT_ATTEMPTS - 1):
            try:
                return fn()
            except RuntimeError:
                continue
        return fn()
