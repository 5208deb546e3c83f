"""Spawned gloo ranks for the port's CPU tests of distributed code.

`GlooRanks(world)` starts `world` processes, the ranks of one gloo group,
each running the functions it is sent. A test module makes one pool and
reuses it; the functions it sends live at module level of a test file,
which every rank imports (so such files import JAX only inside fixtures:
the ranks start in half the time without it).
"""

import importlib
import multiprocessing
import socket
import traceback

import torch

from ray_tpu_torch.parallel import distributed as tdist


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(rank, world, port, tasks, results, preload):
    """A rank's loop: import `preload` (a test module, while the test
    process does its own set-up), join the group, then run each (fn, args)
    it is sent as fn(rank, *args) until it is sent None."""
    torch.set_num_threads(1)
    if preload:
        importlib.import_module(preload)
    tdist.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                 device="cpu", timeout_s=60)
    try:
        while True:
            item = tasks.get()
            if item is None:
                return
            fn, args = item
            try:
                results.put((rank, None, fn(rank, *args)))
            except Exception:  # noqa: BLE001 — sent back to the test
                results.put((rank, traceback.format_exc(), None))
    finally:
        tdist.shutdown_distributed()


class GlooRanks:
    """`world` spawned processes, the ranks of one gloo group, that run
    the functions they are sent: `run(fn, *args)` calls fn(rank, *args) on
    every rank (fn at module level of a test file) and returns the results
    in rank order; a rank that raises fails the call with its traceback."""

    def __init__(self, world: int, timeout_s: float = 60.0,
                 preload: str = ""):
        ctx = multiprocessing.get_context("spawn")
        self.world, self.timeout_s = world, timeout_s
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        port = _free_port()
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, world, port, self.tasks[r],
                                        self.results, preload))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args):
        for q in self.tasks:
            q.put((fn, args))
        got = {}
        for _ in range(self.world):
            rank, error, value = self.results.get(timeout=self.timeout_s)
            if error is not None:
                raise AssertionError(f"rank {rank} failed:\n{error}")
            got[rank] = value
        return [got[r] for r in range(self.world)]

    def close(self):
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        assert not any(p.is_alive() for p in self.procs)
