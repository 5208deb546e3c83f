"""Threaded HTTP server exposing cluster state (reference dashboard/head.py)."""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ray_tpu_torch.core.rpc import RpcClient

logger = logging.getLogger(__name__)

_PAGE = """<!doctype html>
<html><head><title>ray_tpu_torch dashboard</title>
<style>body{{font-family:monospace;margin:2em}}table{{border-collapse:collapse}}
td,th{{border:1px solid #999;padding:4px 8px;text-align:left}}</style></head>
<body><h2>ray_tpu_torch cluster</h2>
<h3>Resources</h3><pre>{resources}</pre>
<h3>Nodes</h3>{nodes}
<h3>Actors</h3>{actors}
<h3>Jobs</h3>{jobs}
<p><a href="/metrics">/metrics</a> · <a href="/api/nodes">/api/nodes</a> ·
<a href="/api/actors">/api/actors</a> · <a href="/api/jobs">/api/jobs</a> ·
<a href="/api/timeline">/api/timeline</a></p>
</body></html>"""


def _table(rows, cols):
    import html

    if not rows:
        return "<p>(none)</p>"
    head = "".join(f"<th>{html.escape(str(c))}</th>" for c in cols)
    # Values are cluster-supplied strings (entrypoints, actor names):
    # escape so a hostile name can't script the dashboard page.
    body = "".join(
        "<tr>" + "".join(f"<td>{html.escape(str(r.get(c, '')))}</td>"
                         for c in cols) + "</tr>"
        for r in rows)
    return f"<table><tr>{head}</tr>{body}</table>"


class DashboardServer:
    def __init__(self, gcs_address: str, host: str = "127.0.0.1",
                 port: int = 0):
        self._gcs_address = gcs_address
        self._gcs: Optional[RpcClient] = None
        dashboard = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # stay off stderr
                logger.debug("dashboard: " + fmt, *args)

            def do_GET(self):
                try:
                    dashboard._route(self)
                except Exception as e:  # noqa: BLE001
                    try:
                        self.send_error(500, str(e))
                    except Exception:  # noqa: BLE001 — client gone
                        pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address
        self.url = f"http://{self.host}:{self.port}"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="dashboard", daemon=True)

    # ----------------------------------------------------------- lifecycle

    def start(self) -> "DashboardServer":
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._gcs is not None:
            self._gcs.close()

    def _client(self) -> RpcClient:
        if self._gcs is None or self._gcs.is_closed:
            self._gcs = RpcClient(self._gcs_address, name="dashboard->gcs")
        return self._gcs

    # -------------------------------------------------------------- routes

    _PAGE_CALL_TIMEOUT_S = 5.0

    def _gather(self, gcs, methods):
        """Fan the page's GCS calls out in parallel, each with its own
        timeout — one slow/stuck table must not make `/` hang forever or
        serialize four round trips. Failures degrade to empty sections."""
        from concurrent.futures import ThreadPoolExecutor

        def one(method):
            try:
                # RpcClient multiplexes message ids, so concurrent calls
                # share the one GCS connection safely.
                return gcs.call(method, timeout=self._PAGE_CALL_TIMEOUT_S)
            except Exception as e:  # noqa: BLE001 — render what we have
                logger.warning("dashboard: %s failed: %s", method, e)
                return None
        with ThreadPoolExecutor(max_workers=len(methods)) as pool:
            return list(pool.map(one, methods))

    def _route(self, req: BaseHTTPRequestHandler):
        from urllib.parse import parse_qs, urlsplit

        parts = urlsplit(req.path)
        path = parts.path.rstrip("/") or "/"
        query = parse_qs(parts.query)
        gcs = self._client()
        if path == "/":
            import html

            nodes, actors, jobs, subs, res = self._gather(
                gcs, ["get_nodes", "get_actors", "get_jobs", "list_jobs",
                      "cluster_resources"])
            page = _PAGE.format(
                resources=html.escape(
                    json.dumps(res, indent=2, default=str)),
                nodes=_table(nodes or [], ["NodeID", "Alive",
                                           "RayletAddress"]),
                actors=_table(actors or [], ["ActorID", "ClassName",
                                             "State", "Name"]),
                jobs=_table((jobs or []) + (subs or []),
                            ["JobID", "submission_id", "State",
                             "status", "Entrypoint", "entrypoint"]))
            self._send(req, 200, page.encode(), "text/html")
        elif path == "/metrics":
            text = gcs.call("metrics_prometheus")["text"]
            self._send(req, 200, text.encode(),
                       "text/plain; version=0.0.4")
        elif path == "/api/metrics":
            # Same series as /metrics, structured: the programmatic twin
            # of the Prometheus text surface.
            self._json(req, gcs.call("metrics_snapshot"))
        elif path == "/api/nodes":
            self._json(req, gcs.call("get_nodes"))
        elif path == "/api/actors":
            self._json(req, gcs.call("get_actors"))
        elif path == "/api/jobs":
            self._json(req, {"driver_jobs": gcs.call("get_jobs"),
                             "submissions": gcs.call("list_jobs")})
        elif path.startswith("/api/jobs/"):
            # /api/jobs/<sid> -> status record; /api/jobs/<sid>/logs ->
            # the retained log tail (job_log_tail_bytes budget).
            rest = path[len("/api/jobs/"):]
            sid, _, tail = rest.partition("/")
            if tail == "logs":
                resp = gcs.call("job_logs", {"submission_id": sid})
                if not resp.get("found"):
                    self._send(req, 404, b"no such job", "text/plain")
                else:
                    self._send(req, 200, resp["logs"].encode(),
                               "text/plain")
            elif not tail:
                resp = gcs.call("job_info", {"submission_id": sid})
                if not resp.get("found"):
                    self._send(req, 404, b"no such job", "text/plain")
                else:
                    self._json(req, resp["details"])
            else:
                self._send(req, 404, b"not found", "text/plain")
        elif path == "/api/cluster_resources":
            self._json(req, gcs.call("cluster_resources"))
        elif path.startswith("/api/traces/"):
            from ray_tpu_torch.observability import span_tree

            trace_id = path[len("/api/traces/"):]
            resp = gcs.call("trace_get", {"trace_id": trace_id})
            self._json(req, span_tree(resp.get("spans") or [], trace_id))
        elif path == "/api/timeline":
            from ray_tpu_torch.observability import chrome_trace_events

            # ?window=SECONDS and ?limit=N cap the export server-side so
            # a huge trace buffer cannot OOM the JSON encoder.
            window = query.get("window", [None])[0]
            limit = query.get("limit", [None])[0]
            resp = gcs.call("trace_timeline", {
                "window_s": float(window) if window else None,
                "limit": int(limit) if limit else self._TIMELINE_MAX_SPANS})
            out = chrome_trace_events(resp.get("spans") or [])
            out["spanDropCount"] = resp.get("dropped", 0)
            out["spanTruncated"] = resp.get("truncated", 0)
            self._json(req, out)
        else:
            self._send(req, 404, b"not found", "text/plain")

    # Default span cap for /api/timeline when no ?limit= is given.
    _TIMELINE_MAX_SPANS = 20000

    @staticmethod
    def _send(req, code: int, body: bytes, ctype: str):
        req.send_response(code)
        req.send_header("Content-Type", ctype)
        req.send_header("Content-Length", str(len(body)))
        req.end_headers()
        req.wfile.write(body)

    def _json(self, req, obj):
        self._send(req, 200, json.dumps(obj, default=str).encode(),
                   "application/json")
