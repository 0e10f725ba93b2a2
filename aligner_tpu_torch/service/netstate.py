"""Network-reachable queue + store — the multi-host state endpoint.

The reference scales out because Kafka and MariaDB are *network
services* any node can reach (docker-compose.yml:1-63,
repository/mod.rs:278-334 reads MARIADB_HOST/PORT from env).  sqlite
over a shared filesystem cannot replace that (WAL mode is unsupported on
network filesystems), so host 0 serves its local sqlite state over HTTP
and remote workers talk to it through :class:`RemoteStore` /
:class:`RemoteQueue` — same method surface as the local classes, one
POST per call.

Selection is by URL: ``ALIGNER_DB=http://host0:3031`` gives every
service component a remote store/queue via :func:`open_store` /
:func:`open_queue`; a filesystem path keeps the local sqlite classes.

Run the endpoint with ``python -m aligner_tpu_torch.service.netstate --db
/path/state.db --port 3031`` (``aligner-torch-state``) on host 0.

Security: the endpoint binds 127.0.0.1 by default; multi-host deploys
bind an internal interface explicitly and SHOULD set
``ALIGNER_STATE_TOKEN`` (a shared secret exported on every host) — the
server then rejects requests without a matching ``X-Aligner-Token``
header, and the clients attach it automatically.
The reference's MariaDB at least required credentials
(config/node/dev.env); an open state endpoint would let anyone with
network reach read or corrupt the results database.
"""

from __future__ import annotations

import hmac
import json
import os
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np

from ..errors import ValidationError

_REQ_FIELDS = (
    "kd_value", "r_squared_value", "del_value", "dim_value",
    "matrices_volume_value",
)


def _encode(obj):
    """JSON-safe encoding with ndarray / request-object tagging."""
    if isinstance(obj, np.ndarray):
        return {
            "__nd__": {
                "shape": list(obj.shape),
                "dtype": str(obj.dtype),
                "data": obj.ravel().tolist(),
            }
        }
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (list, tuple)):
        return [_encode(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if hasattr(obj, "kd_value"):  # an AlignJobRequest-shaped object
        return {"__req__": {f: float(getattr(obj, f)) for f in _REQ_FIELDS}}
    return obj


def _decode(obj):
    if isinstance(obj, dict):
        if "__nd__" in obj:
            nd = obj["__nd__"]
            return np.asarray(nd["data"], dtype=nd["dtype"]).reshape(nd["shape"])
        if "__req__" in obj:
            return SimpleNamespace(**obj["__req__"])
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(o) for o in obj]
    return obj


def _method_names(cls) -> frozenset[str]:
    return frozenset(
        name
        for name in dir(cls)
        if not name.startswith("_") and callable(getattr(cls, name))
    )


class _Handler(BaseHTTPRequestHandler):
    server_version = "aligner-state/1"

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def do_POST(self):
        if self.path != "/rpc":
            self.send_error(404)
            return
        token = self.server.token
        if token and not hmac.compare_digest(
            self.headers.get("X-Aligner-Token", "").encode("utf-8", "replace"),
            token.encode("utf-8", "replace"),
        ):
            self.send_error(403, "bad or missing X-Aligner-Token")
            return
        length = int(self.headers.get("Content-Length", 0))
        try:
            # request decoding only — a KeyError from INSIDE the invoked
            # method must not be misreported as a malformed request
            # (HTTP 400 makes the client's urlopen raise before the
            # structured error is ever parsed)
            try:
                body = json.loads(self.rfile.read(length))
                target = body["target"]
                method = body["method"]
                args = _decode(body.get("args", []))
                kwargs = _decode(body.get("kwargs", {}))
                obj, allowed = self.server.targets[target]
            except (KeyError, ValueError) as e:
                payload = {"ok": False, "error": f"bad request: {e}",
                           "kind": "bad"}
                status = 400
            else:
                if method not in allowed:
                    raise ValidationError(f"method {method!r} not exposed")
                result = getattr(obj, method)(*args, **kwargs)
                payload = {"ok": True, "result": _encode(result)}
                status = 200
        except ValidationError as e:
            payload = {"ok": False, "error": str(e), "kind": "validation"}
            status = 200
        except Exception as e:  # surfaced to the caller, server stays up
            payload = {"ok": False, "error": f"{type(e).__name__}: {e}",
                       "kind": "error"}
            status = 200
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path == "/healthz":
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"ok")
        else:
            self.send_error(404)


def serve_state(
    host: str, port: int, db_path: str, token: str | None = None
) -> ThreadingHTTPServer:
    """Serve the sqlite-backed Store + JobQueue at ``db_path`` over HTTP.

    ``token`` (default: ALIGNER_STATE_TOKEN env) gates every RPC behind
    an X-Aligner-Token header.  Returns the server; call
    ``serve_forever`` (or use :func:`run_state_server`)."""
    from .queue import JobQueue
    from .store import Store

    store = Store(db_path)
    queue = JobQueue(db_path)
    server = ThreadingHTTPServer((host, port), _Handler)
    server.targets = {
        "store": (store, _method_names(Store)),
        "queue": (queue, _method_names(JobQueue)),
    }
    server.token = (
        token if token is not None else os.environ.get("ALIGNER_STATE_TOKEN")
    )
    return server


class _RemoteProxy:
    """One POST per method call; same surface as the local class."""

    _target: str
    _methods: frozenset[str]

    def __init__(self, url: str, timeout: float = 30.0,
                 token: str | None = None):
        self.url = url.rstrip("/")
        self.timeout = timeout
        self.token = (
            token if token is not None
            else os.environ.get("ALIGNER_STATE_TOKEN")
        )

    def _call(self, method: str, *args, **kwargs):
        body = json.dumps(
            {
                "target": self._target,
                "method": method,
                "args": _encode(list(args)),
                "kwargs": _encode(dict(kwargs)),
            }
        ).encode()
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["X-Aligner-Token"] = self.token
        req = urllib.request.Request(
            f"{self.url}/rpc", data=body, headers=headers,
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            payload = json.loads(resp.read())
        if not payload.get("ok"):
            if payload.get("kind") == "validation":
                raise ValidationError(payload.get("error", "remote error"))
            raise RuntimeError(payload.get("error", "remote error"))
        return _decode(payload.get("result"))

    def __getattr__(self, name: str):
        if name.startswith("_") or name not in self._methods:
            raise AttributeError(name)

        def call(*args, **kwargs):
            return self._call(name, *args, **kwargs)

        call.__name__ = name
        return call


class RemoteStore(_RemoteProxy):
    _target = "store"
    _methods_cache: frozenset[str] | None = None

    @property
    def _methods(self):
        # cached per class: every RPC attribute access goes through here
        if RemoteStore._methods_cache is None:
            from .store import Store

            RemoteStore._methods_cache = _method_names(Store)
        return RemoteStore._methods_cache


class RemoteQueue(_RemoteProxy):
    _target = "queue"
    _methods_cache: frozenset[str] | None = None

    @property
    def _methods(self):
        if RemoteQueue._methods_cache is None:
            from .queue import JobQueue

            RemoteQueue._methods_cache = _method_names(JobQueue)
        return RemoteQueue._methods_cache


def is_url(path: str | None) -> bool:
    return bool(path) and (
        path.startswith("http://") or path.startswith("https://")
    )


def run_state_server(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="aligner-torch-state", description=__doc__,
    )
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address; multi-host deploys pass an "
                         "internal interface explicitly and should set "
                         "ALIGNER_STATE_TOKEN")
    ap.add_argument("--port", type=int, default=3031)
    ap.add_argument("--db", default=None, help="sqlite path (ALIGNER_DB)")
    args = ap.parse_args(argv)
    from .store import default_db_path

    db = args.db or default_db_path()
    if is_url(db):
        raise SystemExit("the state server needs a local sqlite path, not a URL")
    server = serve_state(args.host, args.port, db)
    print(f"aligner-state serving {db} on {args.host}:{server.server_address[1]}",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def main(argv=None) -> int:
    return run_state_server(argv)


if __name__ == "__main__":
    raise SystemExit(main())
