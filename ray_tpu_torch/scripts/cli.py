"""Command-line state inspection: `python -m ray_tpu_torch <command>`.

The port's counterpart of `ray_tpu/scripts/cli.py`, the equivalent of the
reference CLI surface (`ray status`, `ray list ...`,
`ray summary tasks`, `ray timeline`, `python/ray/scripts/scripts.py`)
against a running cluster, addressed by --address (or
RAY_TPU_TORCH_ADDRESS, the name `init` reads).

Commands:
    start --head | --address=X     start a node daemon (see cluster_cli)
    stop                           stop this machine's node daemons
    status                         cluster resources + node/actor summary
    list nodes|actors|jobs|tasks   entity tables
    summary tasks|actors           aggregated counts
    timeline --output FILE         chrome://tracing JSON
    metrics                        Prometheus text from the GCS
    serve deploy|status|shutdown|build   Serve's config-file commands
    debug [--list] [--index N]     attach to a worker's breakpoint
                                   (util/rpdb.py)
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _connect(address: str | None):
    import ray_tpu_torch

    if ray_tpu_torch.is_initialized():
        return ray_tpu_torch, False  # piggyback on the caller's runtime
    addr = address or os.environ.get("RAY_TPU_TORCH_ADDRESS")
    if not addr:
        print("error: --address (or RAY_TPU_TORCH_ADDRESS) required",
              file=sys.stderr)
        raise SystemExit(2)
    ray_tpu_torch.init(address=addr)
    return ray_tpu_torch, True


def _dump(obj):
    print(json.dumps(obj, indent=2, default=str))


def main(argv=None):
    from ray_tpu_torch.scripts import cluster_cli

    ap = argparse.ArgumentParser(prog="ray_tpu_torch")
    ap.add_argument("--address", help="GCS address host:port")
    sub = ap.add_subparsers(dest="cmd", required=True)
    cluster_cli.add_start_parser(sub)
    cluster_cli.add_stop_parser(sub)
    sub.add_parser("status")
    p_list = sub.add_parser("list")
    p_list.add_argument("what", choices=["nodes", "actors", "jobs", "tasks",
                                         "objects"])
    p_sum = sub.add_parser("summary")
    p_sum.add_argument("what", choices=["tasks", "actors"])
    p_tl = sub.add_parser("timeline")
    p_tl.add_argument("--output", default="timeline.json")
    sub.add_parser("metrics")
    p_serve = sub.add_parser("serve")
    serve_sub = p_serve.add_subparsers(dest="serve_cmd", required=True)
    p_sd = serve_sub.add_parser("deploy")
    p_sd.add_argument("config", help="YAML config file (serve schema)")
    serve_sub.add_parser("status")
    serve_sub.add_parser("shutdown")
    p_sb = serve_sub.add_parser("build")
    p_sb.add_argument("import_path", help="module:app to describe")
    p_sb.add_argument("--output", default=None)
    p_dbg = sub.add_parser("debug")
    p_dbg.add_argument("--index", type=int, default=None,
                       help="breakpoint index to attach (default: newest)")
    p_dbg.add_argument("--list", action="store_true", dest="list_only")
    args = ap.parse_args(argv)

    # Cluster lifecycle commands manage daemons; they never connect a driver.
    if args.cmd == "start":
        raise SystemExit(cluster_cli.cmd_start(args, args.address))
    if args.cmd == "stop":
        raise SystemExit(cluster_cli.cmd_stop(args))

    rt, owns_runtime = _connect(args.address)
    from ray_tpu_torch import state

    if args.cmd == "status":
        _dump(state.cluster_summary())
    elif args.cmd == "list":
        _dump(getattr(state, f"list_{args.what}")())
    elif args.cmd == "summary":
        _dump(getattr(state, f"summarize_{args.what}")())
    elif args.cmd == "timeline":
        events = rt.timeline(filename=args.output)
        print(f"wrote {args.output} ({len(events)} events)")
    elif args.cmd == "metrics":
        print(rt._require_runtime().gcs.call(
            "metrics_prometheus")["text"])
    elif args.cmd == "serve":
        from ray_tpu_torch import serve as _serve

        if args.serve_cmd == "deploy":
            from ray_tpu_torch.serve.schema import deploy_config_file

            deploy_config_file(args.config)
            _dump(_serve.status())
        elif args.serve_cmd == "status":
            _dump(_serve.status())
        elif args.serve_cmd == "shutdown":
            _serve.shutdown()
            print("serve: shut down")
        elif args.serve_cmd == "build":
            import yaml as _yaml

            from ray_tpu_torch.serve.schema import build as _build, import_attr

            cfg = _build(import_attr(args.import_path))
            cfg["applications"][0]["import_path"] = args.import_path
            text = _yaml.safe_dump(cfg, sort_keys=False)
            if args.output:
                open(args.output, "w").write(text)
                print(f"wrote {args.output}")
            else:
                print(text)
    elif args.cmd == "debug":
        from ray_tpu_torch.util import rpdb

        entries = rpdb.list_breakpoints()
        if args.list_only or not entries:
            _dump(entries or {"breakpoints": []})
        else:
            idx = args.index if args.index is not None else len(entries) - 1
            if not 0 <= idx < len(entries):
                print(f"error: no breakpoint #{idx} "
                      f"({len(entries)} active; run with --list)",
                      file=sys.stderr)
                raise SystemExit(2)
            entry = entries[idx]
            print(f"attaching to {entry['filename']}:{entry['lineno']} "
                  f"(pid {entry['pid']})")
            rpdb.attach(entry)
    if owns_runtime:
        rt.shutdown()


if __name__ == "__main__":
    main()
