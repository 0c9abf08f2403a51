"""Minimal WSGI toolkit (stdlib-only): the port's copy of the JAX
package's ``utils/httpkit.py``, the same classes and functions
(``tests/test_torch_copies.py``), for the port's web demo.

The reference's web apps use Flask; this environment ships no Flask, so the
demo and reviewer apps run on ``wsgiref`` with this small kit: multipart/
form parsing, cookies, HTML escaping, and dual-stack (IPv4+IPv6) serving —
matching the reference's two-servers-in-threads layout (``web/app.py:96-104``).
"""
from __future__ import annotations

import threading
from email.parser import BytesParser
from email.policy import HTTP
from http.cookies import SimpleCookie
from html import escape  # noqa: F401  (re-exported for apps)
from urllib.parse import parse_qs


class Request:
    def __init__(self, environ):
        self.environ = environ
        self.method = environ.get("REQUEST_METHOD", "GET")
        path = environ.get("PATH_INFO", "/")
        try:
            # PEP 3333: servers decode PATH_INFO as latin-1; browsers send
            # UTF-8 percent-encoding. Without the re-decode every path with
            # a non-ASCII segment (the dataset's Chinese label dirs) 404s.
            path = path.encode("iso-8859-1").decode("utf-8")
        except (UnicodeEncodeError, UnicodeDecodeError):
            pass
        self.path = path
        self.query = parse_qs(environ.get("QUERY_STRING", ""))
        self.form: dict[str, list[str]] = {}
        self.files: list[tuple[str, str, bytes]] = []  # (field, filename, data)
        self._parse_body()

    def _parse_body(self):
        if self.method != "POST":
            return
        try:
            length = int(self.environ.get("CONTENT_LENGTH") or 0)
        except ValueError:
            length = 0
        body = self.environ["wsgi.input"].read(length) if length else b""
        ctype = self.environ.get("CONTENT_TYPE", "")
        if ctype.startswith("multipart/form-data"):
            raw = (
                b"Content-Type: " + ctype.encode() + b"\r\n"
                b"MIME-Version: 1.0\r\n\r\n" + body
            )
            msg = BytesParser(policy=HTTP).parsebytes(raw)
            for part in msg.iter_parts():
                name = part.get_param("name", header="content-disposition")
                filename = part.get_filename()
                payload = part.get_payload(decode=True) or b""
                if filename:
                    self.files.append((name or "", filename, payload))
                elif name:
                    self.form.setdefault(name, []).append(
                        payload.decode("utf-8", "replace")
                    )
        elif ctype.startswith("application/x-www-form-urlencoded"):
            for k, v in parse_qs(body.decode("utf-8", "replace")).items():
                self.form.setdefault(k, []).extend(v)

    def form_value(self, key: str, default: str = "") -> str:
        return self.form.get(key, [default])[0]

    @property
    def cookies(self) -> dict[str, str]:
        jar = SimpleCookie(self.environ.get("HTTP_COOKIE", ""))
        return {k: m.value for k, m in jar.items()}


class Response:
    def __init__(self, html_body: str = "", status: str = "200 OK",
                 content_type: str = "text/html; charset=utf-8"):
        self.body = html_body.encode() if isinstance(html_body, str) else html_body
        self.status = status
        self.headers = [("Content-Type", content_type)]

    def set_cookie(self, key: str, value: str, path: str = "/"):
        self.headers.append(("Set-Cookie", f"{key}={value}; Path={path}"))

    def __call__(self, start_response):
        self.headers.append(("Content-Length", str(len(self.body))))
        start_response(self.status, self.headers)
        return [self.body]


def make_wsgi_app(handler):
    """handler(Request) -> Response."""

    def app(environ, start_response):
        try:
            resp = handler(Request(environ))
        except Exception as e:  # pragma: no cover - last-resort error page
            import traceback

            traceback.print_exc()
            resp = Response(f"<h1>500</h1><pre>{escape(str(e))}</pre>",
                            status="500 Internal Server Error")
        return resp(start_response)

    return app


def serve_dual_stack(app, port_v4: int, port_v6: int):
    """IPv4 + IPv6 servers in two threads (web/app.py:96-104 layout).

    Threaded request handling: wsgiref's plain WSGIServer serializes the
    whole app per port, which would starve the ModelDaemon's cross-request
    micro-batching (built so N concurrent requests cost ~1 device batch)
    and hang even the status-banner GET behind a cold-compile POST."""
    import socket
    import socketserver
    from wsgiref.simple_server import WSGIServer, make_server

    class V4Server(socketserver.ThreadingMixIn, WSGIServer):
        daemon_threads = True

    class V6Server(socketserver.ThreadingMixIn, WSGIServer):
        address_family = socket.AF_INET6
        daemon_threads = True

    s4 = make_server("0.0.0.0", port_v4, app, server_class=V4Server)
    threads = [threading.Thread(target=s4.serve_forever, daemon=True)]
    try:
        s6 = make_server("::", port_v6, app, server_class=V6Server)
        threads.append(threading.Thread(target=s6.serve_forever, daemon=True))
    except OSError as e:
        print(f"IPv6 server unavailable: {e}")
    for t in threads:
        t.start()
    print(f"Serving on :{port_v4} (IPv4)" + (f" and :{port_v6} (IPv6)" if len(threads) > 1 else ""))
    for t in threads:
        t.join()
