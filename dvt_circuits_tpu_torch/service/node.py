"""HTTP service exposing prove/execute/spec routes.

Re-creates the reference's experimental axum service (src/service/node.rs):

  POST /prove/:typ    — body: scenario JSON; proves and returns status
  POST /execute/:typ  — body: scenario JSON; dry-runs the witness
  GET  /prove/:typ/spec, /execute/:typ/spec — JSON schema for the input

Same semantics: synchronous handlers (a prove blocks the worker), errors map
to HTTP 500 with the error string (node.rs:77-98).  Built on the stdlib
threading HTTP server — the service is a control-plane shim; heavy lifting
happens on the device.

The port's copy of ``dvt_circuits_tpu/service/node.py``: the same routes,
codes and payloads; ``make_server`` and ``serve`` take the ``device`` every
prove runs on (default ``"cuda"``; ``"cpu"`` runs the plain PyTorch path).
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..circuits.registry import CIRCUITS, get_circuit
from ..dkg.schemas import schema_for
from ..dkg.types import DeserializeError
from ..prover.pipeline import ProveError, execute_circuit, prove_circuit
from ..kernels import resolve_device
from ..stark.config import DEFAULT_CONFIG


def _make_handler(auth: bool, device):
    class Handler(BaseHTTPRequestHandler):
        server_version = "dvt-circuits-tpu"

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _route(self):
            parts = [p for p in self.path.split("/") if p]
            return parts

        def do_GET(self):  # noqa: N802
            parts = self._route()
            if len(parts) == 3 and parts[0] in ("prove", "execute") and parts[2] == "spec":
                typ = parts[1]
                if typ not in CIRCUITS:
                    return self._reply(500, {"error": f"unknown circuit type {typ}"})
                spec = get_circuit(typ)
                schema = schema_for(spec.schema_name, spec.setup.layout, auth)
                return self._reply(200, {"status": "ok", "schema": schema})
            return self._reply(404, {"error": "not found"})

        def do_POST(self):  # noqa: N802
            parts = self._route()
            if len(parts) != 2 or parts[0] not in ("prove", "execute"):
                return self._reply(404, {"error": "not found"})
            action, typ = parts
            if typ not in CIRCUITS:
                return self._reply(500, {"error": f"unknown circuit type {typ}"})
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"null")
                spec = get_circuit(typ)
                data = spec.data_type.from_json(payload, spec.setup.layout, auth)
                if action == "execute":
                    result = execute_circuit(typ, data, auth)
                    if result.exit_code != 0:
                        return self._reply(
                            500, {"error": f"execution failed: {result.panic_message}"}
                        )
                    return self._reply(200, {"status": "executed"})
                container = prove_circuit(typ, data, auth, DEFAULT_CONFIG, device=device)
                return self._reply(
                    200,
                    {
                        "status": "proved",
                        "circuit": container["circuit"],
                        "public_values": container["public_values"],
                        "timing": container["timing"],
                    },
                )
            except (DeserializeError, json.JSONDecodeError) as e:
                return self._reply(500, {"error": str(e)})
            except ProveError as e:
                return self._reply(500, {"error": str(e)})
            except Exception as e:  # pragma: no cover
                return self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def make_server(host: str, port: int, auth: bool, device="cuda") -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), _make_handler(auth, resolve_device(device)))


def serve(host: str, port: int, auth: bool, device="cuda") -> None:
    make_server(host, port, auth, device).serve_forever()
