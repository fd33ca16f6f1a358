"""Minimal WSGI web framework (stdlib only).

The reference is a Flask app (oldapp.py:17-18 with flask_cors); Flask is not
available in this image, so the framework itself is first-party: routing
with path parameters, JSON request/response helpers, multipart/form-data
parsing, permissive CORS (matching flask_cors defaults), a threaded HTTP
server, and an in-process test client for contract tests.

Only what the evo-ssearch API contract needs — not a general framework.
"""

from __future__ import annotations

import json
import re
import threading
import traceback
import urllib.parse
from dataclasses import dataclass, field
from socketserver import ThreadingMixIn
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server

_STATUS_TEXT = {
    200: "OK", 204: "No Content", 400: "Bad Request", 403: "Forbidden",
    404: "Not Found", 405: "Method Not Allowed", 413: "Payload Too Large",
    415: "Unsupported Media Type", 500: "Internal Server Error",
}


def _status_line(code: int) -> str:
    return f"{code} {_STATUS_TEXT.get(code, 'Unknown')}"


@dataclass
class FilePart:
    """One uploaded file from a multipart body."""

    filename: str
    content: bytes
    content_type: str = "application/octet-stream"

    @property
    def stream(self):
        import io

        return io.BytesIO(self.content)


def _parse_multipart(body: bytes, boundary: bytes):
    """multipart/form-data -> (form fields, file parts).

    Only the exact CRLF delimiters around each part are removed — binary
    payloads legitimately begin/end with 0x0D/0x0A bytes, so stripping all
    of them would corrupt uploads.
    """
    form: dict[str, str] = {}
    files: dict[str, FilePart] = {}
    delim = b"--" + boundary
    parts = body.split(delim)
    for chunk in parts[1:]:  # parts[0] is the preamble
        if chunk.startswith(b"--"):
            break  # closing delimiter
        if chunk.startswith(b"\r\n"):
            chunk = chunk[2:]
        if chunk.endswith(b"\r\n"):
            chunk = chunk[:-2]
        if not chunk:
            continue
        head, _, payload = chunk.partition(b"\r\n\r\n")
        headers = {}
        for line in head.decode("utf-8", "replace").split("\r\n"):
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
        disp = headers.get("content-disposition", "")
        name_m = re.search(r'name="([^"]*)"', disp)
        if not name_m:
            continue
        name = name_m.group(1)
        file_m = re.search(r'filename="([^"]*)"', disp)
        if file_m is not None:
            files[name] = FilePart(
                filename=file_m.group(1),
                content=payload,
                content_type=headers.get("content-type", "application/octet-stream"),
            )
        else:
            form[name] = payload.decode("utf-8", "replace")
    return form, files


class HTTPError(Exception):
    """Raise inside a handler to produce a non-200 JSON error response."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class Request:
    def __init__(self, environ: dict):
        self.environ = environ
        self.method = environ["REQUEST_METHOD"].upper()
        self.path = environ.get("PATH_INFO", "/")
        self.query_string = environ.get("QUERY_STRING", "")
        self.content_type = environ.get("CONTENT_TYPE", "")
        try:
            # clamp: a negative Content-Length must not become read(-1)
            # (read-to-EOF — the unbounded read the 413 cap exists to
            # prevent)
            length = max(0, int(environ.get("CONTENT_LENGTH") or 0))
        except ValueError:
            length = 0
        self.body = environ["wsgi.input"].read(length) if length else b""
        self._form: dict | None = None
        self._files: dict | None = None

    @property
    def args(self) -> dict[str, str]:
        """Query parameters (last value wins)."""
        return dict(urllib.parse.parse_qsl(self.query_string, keep_blank_values=True))

    @property
    def json(self):
        """Parsed JSON body; HTTPError(400) on malformed JSON, None if empty."""
        if not self.body:
            return None
        try:
            return json.loads(self.body)
        except ValueError:
            raise HTTPError(400, "Invalid JSON body")

    def _parse_form(self) -> None:
        if self._form is not None:
            return
        ctype = self.content_type
        if ctype.startswith("multipart/form-data"):
            m = re.search(r"boundary=([^;]+)", ctype)
            if not m:
                raise HTTPError(400, "Missing multipart boundary")
            boundary = m.group(1).strip('"').encode()
            self._form, self._files = _parse_multipart(self.body, boundary)
        elif ctype.startswith("application/x-www-form-urlencoded"):
            self._form = dict(
                urllib.parse.parse_qsl(
                    self.body.decode("utf-8", "replace"), keep_blank_values=True
                )
            )
            self._files = {}
        else:
            self._form, self._files = {}, {}

    @property
    def form(self) -> dict[str, str]:
        self._parse_form()
        return self._form

    @property
    def files(self) -> dict[str, FilePart]:
        self._parse_form()
        return self._files


@dataclass
class Response:
    body: bytes = b""
    status: int = 200
    headers: dict = field(default_factory=dict)
    content_type: str = "text/html; charset=utf-8"

    def wsgi(self):
        headers = {"Content-Type": self.content_type, **self.headers}
        headers["Content-Length"] = str(len(self.body))
        return _status_line(self.status), list(headers.items()), [self.body]


def jsonify(obj, status: int = 200) -> Response:
    return Response(
        body=json.dumps(obj).encode("utf-8"),
        status=status,
        content_type="application/json",
    )


def html_response(text: str, status: int = 200, headers: dict | None = None) -> Response:
    return Response(body=text.encode("utf-8"), status=status, headers=headers or {})


def send_file(path: str) -> Response:
    import mimetypes

    ctype = mimetypes.guess_type(path)[0] or "application/octet-stream"
    with open(path, "rb") as f:
        return Response(body=f.read(), content_type=ctype)


_PARAM_RE = re.compile(r"<(?:(?P<conv>\w+):)?(?P<name>\w+)>")


def _compile_rule(rule: str) -> re.Pattern:
    pattern = ""
    pos = 0
    for m in _PARAM_RE.finditer(rule):
        pattern += re.escape(rule[pos : m.start()])
        if m.group("conv") == "path":
            pattern += f"(?P<{m.group('name')}>.+)"
        else:
            pattern += f"(?P<{m.group('name')}>[^/]+)"
        pos = m.end()
    pattern += re.escape(rule[pos:])
    return re.compile(f"^{pattern}$")


class App:
    """WSGI application with Flask-like routing and permissive CORS."""

    def __init__(
        self, name: str = "app", cors: bool = True,
        max_body_bytes: int | None = None,
    ):
        self.name = name
        self.cors = cors
        # Reject oversized bodies BEFORE reading them: this is a threaded
        # first-party server with permissive CORS, so trusting the client's
        # Content-Length unbounded is a one-request OOM. (The reference had
        # the MAX_FILE_SIZE_MB knob but never enforced it; we do.)
        self.max_body_bytes = max_body_bytes
        self._routes: list[tuple[re.Pattern, set[str], object]] = []

    def route(self, rule: str, methods: tuple[str, ...] = ("GET",)):
        compiled = _compile_rule(rule)

        def deco(fn):
            self._routes.append((compiled, {m.upper() for m in methods}, fn))
            return fn

        return deco

    def _dispatch(self, request: Request) -> Response:
        path_matched = False
        for pattern, methods, fn in self._routes:
            m = pattern.match(request.path)
            if not m:
                continue
            path_matched = True
            if request.method not in methods:
                continue
            result = fn(request, **m.groupdict())
            if isinstance(result, Response):
                return result
            if isinstance(result, tuple) and len(result) == 2:
                body, status = result
                if isinstance(body, Response):
                    body.status = status
                    return body
                return html_response(str(body), status)
            if isinstance(result, (dict, list)):
                return jsonify(result)
            return html_response(str(result))
        if path_matched:
            if request.method == "OPTIONS" and self.cors:
                return Response(status=204)
            return jsonify({"error": "Method not allowed"}, 405)
        return jsonify({"error": "Not found"}, 404)

    def __call__(self, environ, start_response):
        try:
            if self.max_body_bytes is not None:
                try:
                    length = int(environ.get("CONTENT_LENGTH") or 0)
                except ValueError:
                    length = 0
                if length > self.max_body_bytes:
                    raise HTTPError(413, "Request body too large")
            request = Request(environ)
            response = self._dispatch(request)
        except HTTPError as e:
            response = jsonify({"error": e.message}, e.status)
        except Exception as e:
            traceback.print_exc()
            response = jsonify({"error": str(e)}, 500)
        if self.cors:
            response.headers.setdefault("Access-Control-Allow-Origin", "*")
            response.headers.setdefault(
                "Access-Control-Allow-Headers", "Content-Type"
            )
            response.headers.setdefault(
                "Access-Control-Allow-Methods", "GET, POST, OPTIONS"
            )
        status, headers, body = response.wsgi()
        start_response(status, headers)
        return body


# -- server --


class _ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
    daemon_threads = True


class _QuietHandler(WSGIRequestHandler):
    def log_message(self, fmt, *args):  # route access logs through logging
        import logging

        logging.getLogger("evossearch.http").debug(fmt, *args)


def serve(app: App, host: str, port: int, debug: bool = False):
    """Blocking threaded HTTP server (stand-in for app.run, oldapp.py:2258)."""
    handler = WSGIRequestHandler if debug else _QuietHandler
    with make_server(
        host, port, app, server_class=_ThreadingWSGIServer, handler_class=handler
    ) as httpd:
        httpd.serve_forever()


# -- in-process test client (SURVEY §4.4 contract tests) --


@dataclass
class TestResponse:
    status_code: int
    headers: dict
    data: bytes

    def get_json(self):
        try:
            return json.loads(self.data)
        except ValueError:
            return None

    @property
    def json(self):
        return self.get_json()


class TestClient:
    __test__ = False  # not a pytest class

    def __init__(self, app: App):
        self.app = app

    def open(
        self, path: str, method: str = "GET", json_body=None, data: dict | None = None,
        files: dict | None = None, body: bytes = b"", content_type: str | None = None,
    ) -> TestResponse:
        import io

        if json_body is not None:
            body = json.dumps(json_body).encode()
            content_type = "application/json"
        elif files is not None or (data is not None and method != "GET"):
            boundary = "testboundary123"
            parts = []
            for k, v in (data or {}).items():
                parts.append(
                    f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"'
                    f"\r\n\r\n{v}\r\n".encode()
                )
            for k, (fname, content) in (files or {}).items():
                parts.append(
                    f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"; '
                    f'filename="{fname}"\r\nContent-Type: application/octet-stream'
                    f"\r\n\r\n".encode() + content + b"\r\n"
                )
            body = b"".join(parts) + f"--{boundary}--\r\n".encode()
            content_type = f"multipart/form-data; boundary={boundary}"

        path_only, _, query = path.partition("?")
        environ = {
            "REQUEST_METHOD": method,
            "PATH_INFO": urllib.parse.unquote(path_only),
            "QUERY_STRING": query,
            "CONTENT_TYPE": content_type or "",
            "CONTENT_LENGTH": str(len(body)),
            "wsgi.input": io.BytesIO(body),
            "wsgi.errors": io.StringIO(),
            "wsgi.url_scheme": "http",
            "SERVER_NAME": "test",
            "SERVER_PORT": "80",
        }
        captured = {}

        def start_response(status, headers):
            captured["status"] = int(status.split()[0])
            captured["headers"] = dict(headers)

        chunks = self.app(environ, start_response)
        return TestResponse(
            status_code=captured["status"],
            headers=captured["headers"],
            data=b"".join(chunks),
        )

    def get(self, path: str, **kw) -> TestResponse:
        return self.open(path, "GET", **kw)

    def post(self, path: str, **kw) -> TestResponse:
        return self.open(path, "POST", **kw)
