"""Threaded HTTP front-end for the REST controller (the port of the JAX
package's ``rest/http_server.py``).

Analog of the netty4 HTTP transport (modules/transport-netty4/...
Netty4HttpServerTransport.java) at the fidelity this slice needs: a
thread-per-connection stdlib server handing parsed (method, path, params,
body) to ``RestController.dispatch``.  The request body's bytes are
charged to the ``in_flight_requests`` breaker before they are read (429
with ``Retry-After`` when it trips); responses are negotiated by
``?format=`` or ``Accept`` (``common/xcontent.py``).  Connections are
kept alive (HTTP/1.1) and written without Nagle's delay.  The ``_cat`` text
tables and the Prometheus text payload are not ported: every route that
would render them answers 501.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl, urlsplit

from opensearch_tpu_torch.common.breakers import (CircuitBreakingError,
                                                  breaker_service)
from opensearch_tpu_torch.common.errors import OpenSearchTpuError
from opensearch_tpu_torch.common.xcontent import to_bytes


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "opensearch-tpu"
    # TCP_NODELAY: the handler writes a response's headers and its body
    # in two sends; with Nagle's algorithm on, the body waits for the
    # client's delayed ACK of the headers, ~40 ms per response on a
    # keep-alive connection (the JAX package's server pays it)
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # quiet
        pass

    def _handle(self):
        split = urlsplit(self.path)
        params = dict(parse_qsl(split.query, keep_blank_values=True))
        length = int(self.headers.get("Content-Length") or 0)
        # in-flight byte accounting BEFORE the body is read into memory
        # (the reference's in_flight_requests breaker)
        breaker = breaker_service().in_flight
        extra_headers: dict = {}
        try:
            breaker.add_estimate(length, label=f"<http_request> "
                                               f"{split.path}")
        except CircuitBreakingError as e:
            # the body stays UNREAD (that's the point): the connection
            # cannot be reused, or the next parse reads body bytes as a
            # request line
            self.close_connection = True
            status, payload = 429, e.to_xcontent()
            extra_headers["Retry-After"] = "1"
        else:
            try:
                body = self.rfile.read(length) if length else b""
                status, payload = self.server.controller.dispatch(
                    self.command, split.path, params, body,
                    self.headers.get("Content-Type") or "",
                    response_headers=extra_headers)
            finally:
                breaker.release(length)
        try:
            data, ctype = to_bytes(payload, self.headers.get("Accept") or "",
                                   params.get("format") or "")
        except OpenSearchTpuError as e:
            status = e.status
            data = (json.dumps(e.to_xcontent()) + "\n").encode()
            ctype = "application/json; charset=UTF-8"
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        for k, v in extra_headers.items():
            # error-mapping headers (Retry-After on 429 rejections)
            self.send_header(k, str(v))
        opaque = self.headers.get("X-Opaque-Id")
        if opaque:
            # the reference echoes X-Opaque-Id on every response so
            # clients can correlate (Task.X_OPAQUE_ID response header)
            self.send_header("X-Opaque-Id", opaque)
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(data)

    do_GET = do_POST = do_PUT = do_DELETE = do_HEAD = _handle


class _Server(ThreadingHTTPServer):
    # accept backlog sized like the reference's netty transport, not the
    # stdlib default (5): bursts of concurrent connects would otherwise
    # overflow it and clients see resets instead of answers.  The OS
    # clamps it to somaxconn.
    request_queue_size = 1024


class HttpServer:
    def __init__(self, controller, host: str = "127.0.0.1", port: int = 9200):
        self.httpd = _Server((host, port), _Handler)
        self.httpd.controller = controller
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="http-server", daemon=True)
        self._thread.start()

    def stop(self):
        """Idempotent, and safe WITHOUT a prior start():
        ``ThreadingHTTPServer.shutdown()`` blocks forever unless
        ``serve_forever`` is actually running, so it is only called when
        the serving thread exists."""
        thread, self._thread = self._thread, None
        if thread is not None:
            self.httpd.shutdown()
        self.httpd.server_close()
        if thread is not None:
            thread.join(timeout=5)
