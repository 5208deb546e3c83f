"""Tracing CLI: export the cluster timeline or one trace's span tree.

    python -m ray_tpu_torch.observability timeline [--out timeline.json]
                                                   [--window 300] [--limit N]
    python -m ray_tpu_torch.observability trace <trace_id> [--out tree.json]

The port's counterpart of `ray_tpu/observability/__main__.py`. The GCS
address comes from --address or the RAY_TPU_TORCH_GCS_ADDRESS env var
(set for every cluster process by the raylet; for a driver shell, pass it
explicitly).
Load the timeline file in https://ui.perfetto.dev or chrome://tracing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _gcs_client(address: str):
    from ray_tpu_torch.core.rpc import RpcClient

    return RpcClient(address, name="trace-cli->gcs")


def _resolve_address(args) -> str:
    addr = args.address or os.environ.get("RAY_TPU_TORCH_GCS_ADDRESS")
    if not addr:
        sys.exit("no GCS address: pass --address HOST:PORT or set "
                 "RAY_TPU_TORCH_GCS_ADDRESS")
    return addr


def _write(out_path: str, obj) -> None:
    text = json.dumps(obj)
    if out_path == "-":
        sys.stdout.write(text + "\n")
        return
    with open(out_path, "w", encoding="utf-8") as f:
        f.write(text)
    print(f"wrote {out_path} ({len(text)} bytes)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ray_tpu_torch.observability")
    ap.add_argument("--address", default=None,
                    help="GCS address (default: $RAY_TPU_TORCH_GCS_ADDRESS)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    tl = sub.add_parser("timeline",
                        help="export the Chrome trace-event timeline")
    tl.add_argument("--out", default="timeline.json",
                    help="output path, or - for stdout")
    tl.add_argument("--window", type=float, default=None,
                    help="only spans ending within the last WINDOW seconds")
    tl.add_argument("--limit", type=int, default=None,
                    help="cap on exported spans (newest win)")
    tr = sub.add_parser("trace", help="export one trace's span tree")
    tr.add_argument("trace_id")
    tr.add_argument("--out", default="-", help="output path (default stdout)")
    args = ap.parse_args(argv)

    from ray_tpu_torch.observability import chrome_trace_events, span_tree

    gcs = _gcs_client(_resolve_address(args))
    try:
        if args.cmd == "timeline":
            resp = gcs.call("trace_timeline",
                            {"window_s": args.window, "limit": args.limit},
                            timeout=30)
            spans = resp.get("spans") or []
            if not spans:
                print("no spans recorded (is tracing_enabled on?)",
                      file=sys.stderr)
            _write(args.out, chrome_trace_events(spans))
            if resp.get("dropped"):
                print(f"note: GCS dropped {resp['dropped']} spans "
                      "(trace_gcs_max_spans)", file=sys.stderr)
        else:
            resp = gcs.call("trace_get", {"trace_id": args.trace_id},
                            timeout=30)
            _write(args.out, span_tree(resp.get("spans") or [],
                                       args.trace_id))
    finally:
        gcs.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
