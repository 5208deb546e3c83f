"""Spawned gloo ranks for the port's CPU tests of distributed code.

`GlooRanks(world)` starts `world` processes, the ranks of one gloo group,
each running the functions it is sent. A test module makes one pool and
reuses it; the functions it sends live at module level of a test file,
which every rank imports (so such files import JAX only inside fixtures:
the ranks start in half the time without it). `fake_tp_mesh` is a tp mesh
of a fake process group in the test process, for checks that need no
peers.

Rank 0 binds the group's rendezvous port itself (port 0, the kernel's
pick) and hands it to the others: a port picked and released by the test
process could be taken by any other process before rank 0 bound it, and
on a loaded host, with other test workers opening connections, it was.
"""

import contextlib
import datetime
import importlib
import multiprocessing
import queue
import time
import traceback

import torch

from ray_tpu_torch.parallel import distributed as tdist


@contextlib.contextmanager
def fake_tp_mesh(tp: int):
    """A ("tp",) CPU mesh over `tp` ranks of a fake process group: this
    process is rank 0, and every collective is a no-op."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from ray_tpu_torch.parallel import MeshSpec, build_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=tp)
    try:
        yield build_mesh(MeshSpec({"tp": tp}), device_type="cpu")
    finally:
        dist.destroy_process_group()


#: Seconds a rank may take to start: spawn, import torch and the preload
#: module, join the group (a loaded host takes tens of seconds).
START_TIMEOUT_S = 300.0


def _join(rank, world, ports):
    """Join the group. Rank 0 starts the rendezvous server on a port the
    kernel picks and keeps it; the tcp:// rendezvous in its
    `initialize_distributed` reuses that server (a multi-tenant store:
    one server per port in a process), and the other ranks learn the port
    from `ports`. Returns rank 0's store, which must outlive the group."""
    import torch.distributed as dist

    store = None
    if rank == 0:
        store = dist.TCPStore("127.0.0.1", 0, world, is_master=True,
                              wait_for_workers=False, multi_tenant=True,
                              timeout=datetime.timedelta(seconds=60))
        port = store.port
        for _ in range(world - 1):
            ports.put(port)
    else:
        port = ports.get(timeout=START_TIMEOUT_S)
    tdist.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                 device="cpu", timeout_s=60)
    return store


def _serve(rank, world, ports, ready, tasks, results, preload):
    """A rank's loop: import `preload` (a test module, while the test
    process does its own set-up), join the group and say so on `ready`
    (or send why it could not), then run each (fn, args) it is sent as
    fn(rank, *args) until it is sent None."""
    torch.set_num_threads(1)
    try:
        if preload:
            importlib.import_module(preload)
        store = _join(rank, world, ports)
    except Exception:  # noqa: BLE001 — sent back to the test
        ready.put((rank, traceback.format_exc()))
        return
    ready.put((rank, None))
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
        del store


class GlooRanks:
    """`world` spawned processes, the ranks of one gloo group, that run
    the functions they are sent: `run(fn, *args)` calls fn(rank, *args) on
    every rank (fn at module level of a test file) and returns the results
    in rank order; a rank that raises fails the call with its traceback.
    The first call first waits up to START_TIMEOUT_S for every rank to
    have joined the group; each call then has `timeout_s`."""

    def __init__(self, world: int, timeout_s: float = 60.0,
                 preload: str = ""):
        ctx = multiprocessing.get_context("spawn")
        self.world, self.timeout_s = world, timeout_s
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        self.ready = ctx.Queue()
        self.ports = ctx.Queue()  # held here: the ranks unpickle it later
        self._joined = False
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, world, self.ports, self.ready,
                                        self.tasks[r], self.results,
                                        preload))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def _wait_joined(self):
        waiting = set(range(self.world))
        deadline = time.monotonic() + START_TIMEOUT_S
        while waiting:
            try:
                rank, error = self.ready.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r in waiting
                        if self.procs[r].exitcode is not None]
                if dead:
                    raise AssertionError(
                        f"ranks {dead} exited before joining the group "
                        f"(exit codes "
                        f"{[self.procs[r].exitcode for r in dead]})"
                    ) from None
                if time.monotonic() > deadline:
                    raise AssertionError(
                        f"ranks {sorted(waiting)} did not join the group "
                        f"within {START_TIMEOUT_S} s") from None
                continue
            if error is not None:
                raise AssertionError(f"rank {rank} could not join the "
                                     f"group:\n{error}")
            waiting.discard(rank)
        self._joined = True

    def run(self, fn, *args):
        if not self._joined:
            self._wait_joined()
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
