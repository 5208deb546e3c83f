"""The port's platform utilities against the JAX package's, on the CPU.

`util/actor_pool`, `util/queue`, `util/iter`, `util/multiprocessing`,
`util/joblib`, `experimental/internal_kv`, `experimental/dynamic_resources`,
`experimental/tqdm_ray` and `util/rpdb` (with `python -m ray_tpu_torch
debug`). Each behaviour runs on a cluster of each package, both up at once
in this process (one module-scoped pair), and the two results must be the
same: order, errors, `Empty`/`Full`, the KV's mixed keys. The cases are
those of the JAX package's tests/test_util.py, tests/test_ecosystem.py and
tests/test_breadth.py, with more where the port's contract is wider.

The slice as a whole: two CPU actors of the port in an `ActorPool` score
windows with a tiny GPT-2 whose weights come from the JAX GPT-2's
parameters (`params_from_jax`); each window's mean next-token NLL is held
within 1e-5 (relative, float32) of the JAX GPT-2 applied to the same
windows in this process, its flash kernels in interpret mode.

JAX is imported only inside the slice test: the actors import this file.
"""

import importlib
import io
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = (ray_tpu, ray_tpu_torch)
ACCELERATOR = {"ray_tpu": ("TPU", "num_tpus"),
               "ray_tpu_torch": ("GPU", "num_gpus")}


@pytest.fixture(scope="module", autouse=True)
def clusters():
    """Both packages' runtimes, up at once: 4 CPUs and one accelerator
    (a grant only, without a card)."""
    ray_tpu.init(num_cpus=4, num_tpus=1)
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    try:
        yield {"ray_tpu": ray_tpu._global_runtime.gcs.address,
               "ray_tpu_torch": ray_tpu_torch._global_runtime.gcs.address}
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()


def sub(mod, name):
    return importlib.import_module(f"{mod.__name__}.{name}")


def both(behaviour, *args):
    """`behaviour(package, *args)` for the JAX package, then the port."""
    return [behaviour(mod, *args) for mod in PACKAGES]


def wait_for(predicate, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what} not met within {timeout} s")
        time.sleep(0.02)


# --------------------------------------------------------------- ActorPool


class PoolWorker:
    def __init__(self, slow_on=None, release=None):
        self.slow_on = slow_on
        self.release = release

    def double(self, x):
        if self.slow_on is not None and x == self.slow_on:
            # Held until the driver has seen a later item finish.
            while not os.path.exists(self.release):
                time.sleep(0.01)
        return 2 * x

    def fail_on(self, x):
        if x == 1:
            raise ValueError(f"bad item {x}")
        return x

    def wait_file(self, path):
        while not os.path.exists(path):
            time.sleep(0.01)
        return path


def _pool(mod, n=2, **kw):
    cls = mod.remote(PoolWorker)
    actors = [cls.remote(**kw) for _ in range(n)]
    return sub(mod, "util.actor_pool").ActorPool(actors), actors


def _kill(mod, actors):
    for a in actors:
        mod.kill(a)


def _double(a, v):
    return a.double.remote(v)


def test_actor_pool_map_ordered():
    def run(mod):
        pool, actors = _pool(mod)
        out = list(pool.map(_double, range(8)))
        _kill(mod, actors)
        return out

    assert both(run) == [[2 * i for i in range(8)]] * 2


def test_actor_pool_map_unordered_completes_all(tmp_path):
    """Item 0 is held on its actor until item 5 has come back: unordered
    results arrive in completion order, all of them."""
    def run(mod):
        release = str(tmp_path / f"release-{mod.__name__}")
        pool, actors = _pool(mod, slow_on=0, release=release)
        out = []
        for v in pool.map_unordered(_double, range(6)):
            out.append(v)
            if v == 10:
                open(release, "w").close()
        _kill(mod, actors)
        return out

    for out in both(run):
        assert sorted(out) == [2 * i for i in range(6)]
        assert out[-1] == 0 and out.index(10) < len(out) - 1


def test_actor_pool_backlog_exceeds_actors():
    def run(mod):
        pool, actors = _pool(mod)
        for i in range(10):
            pool.submit(_double, i)
        backlog = len(pool._backlog)
        results = []
        while pool.has_next():
            results.append(pool.get_next())
        with pytest.raises(StopIteration):
            pool.get_next()
        _kill(mod, actors)
        return backlog, results, pool.has_next(), len(pool._free)

    assert both(run) == [(8, [2 * i for i in range(10)], False, 2)] * 2


def test_actor_pool_get_next_unordered_empty_raises():
    def run(mod):
        pool, actors = _pool(mod, 1)
        with pytest.raises(StopIteration):
            pool.get_next_unordered()
        _kill(mod, actors)
        return True

    assert both(run) == [True, True]


def test_actor_pool_push_pop_idle():
    def run(mod):
        pool, actors = _pool(mod)
        a = pool.pop_idle()
        state = [a is not None, pool.has_free()]
        b = pool.pop_idle()
        state += [pool.has_free(), pool.pop_idle()]
        pool.push(a)
        pool.push(b)
        state.append(len(pool._free))
        # A pushed actor takes work again.
        state.append(list(pool.map(_double, [3, 4])))
        _kill(mod, actors)
        return state

    assert both(run) == [[True, True, False, None, 2, [6, 8]]] * 2


def test_actor_pool_task_error_consumes_its_slot():
    """A failed item re-raises its error from get_next and frees its
    actor; the items after it still come back in order."""
    def run(mod):
        pool, actors = _pool(mod, 1)
        for v in range(3):
            pool.submit(lambda a, x: a.fail_on.remote(x), v)
        out = [pool.get_next()]
        with pytest.raises(ValueError, match="bad item 1"):
            pool.get_next()
        out.append(pool.get_next())
        _kill(mod, actors)
        return out, pool.has_next()

    assert both(run) == [([0, 2], False)] * 2


def test_actor_pool_get_next_timeout_keeps_the_slot(tmp_path):
    """A timed-out get_next leaves the item to be harvested later."""
    def run(mod):
        exceptions = sub(mod, "exceptions")
        path = str(tmp_path / f"go-{mod.__name__}")
        pool, actors = _pool(mod, 1)
        pool.submit(lambda a, p: a.wait_file.remote(p), path)
        with pytest.raises((exceptions.GetTimeoutError, TimeoutError)):
            pool.get_next(timeout=0.2)
        open(path, "w").close()
        got = pool.get_next(timeout=30) == path
        _kill(mod, actors)
        return got, pool.has_next()

    assert both(run) == [(True, False)] * 2


# ------------------------------------------------------------------- Queue


class QueueFeeder:
    def feed(self, queue, items):
        for x in items:
            queue.put(x)
        return len(items)


def test_queue_fifo_sizes_and_full():
    def run(mod):
        qmod = sub(mod, "util.queue")
        q = qmod.Queue(maxsize=3)
        seen = [q.empty(), q.full(), q.qsize()]
        for x in ("a", b"b", {"c": 3}):
            q.put(x)
        seen += [q.empty(), q.full(), q.qsize()]
        with pytest.raises(qmod.Full):
            q.put_nowait("d")
        with pytest.raises(qmod.Full):
            q.put("d", timeout=0.1)
        seen += [q.get(), q.get_nowait(), q.get(timeout=5), q.qsize()]
        q.shutdown()
        return seen

    assert both(run) == [[True, False, 0, False, True, 3,
                          "a", b"b", {"c": 3}, 0]] * 2


def test_queue_empty_raises():
    def run(mod):
        qmod = sub(mod, "util.queue")
        q = qmod.Queue()
        with pytest.raises(qmod.Empty):
            q.get_nowait()
        with pytest.raises(qmod.Empty):
            q.get(timeout=0.1)
        with pytest.raises(qmod.Empty):
            q.get(block=False)
        q.shutdown()
        return issubclass(qmod.Empty, Exception), \
            issubclass(qmod.Full, Exception)

    assert both(run) == [(True, True)] * 2


def test_queue_filled_by_an_actor_and_async():
    """A handle passed to an actor puts from there; put_async/get_async
    return refs of (ok, item) as the reference's."""
    def run(mod):
        q = sub(mod, "util.queue").Queue()
        feeder = mod.remote(QueueFeeder).remote()
        n = mod.get(feeder.feed.remote(q, list(range(5))), timeout=60)
        out = [q.get(timeout=10) for _ in range(n)]
        ok = mod.get(q.put_async("x"), timeout=30)
        got = mod.get(q.get_async(), timeout=30)
        mod.kill(feeder)
        q.shutdown()
        return out, ok, got

    assert both(run) == [([0, 1, 2, 3, 4], True, (True, "x"))] * 2


# --------------------------------------------------- multiprocessing.Pool


def _sq(x):
    return x * x


def _add(a, b):
    return a + b


def _boom(x):
    raise ValueError("boom")


def _stamped_sleep(x):
    start = time.monotonic()
    time.sleep(0.3)
    return (start, time.monotonic())


def test_pool_map_apply_starmap():
    def run(mod):
        Pool = sub(mod, "util.multiprocessing").Pool
        with Pool(processes=4) as pool:
            r = pool.apply_async(_add, (1, 2))
            return (pool.map(_sq, range(10)), pool.apply(_add, (3, 4)),
                    r.get(timeout=30), r.successful(), r.ready(),
                    pool.starmap(_add, [(1, 2), (3, 4)]))

    assert both(run) == [([x * x for x in range(10)], 7, 3, True, True,
                          [3, 7])] * 2


def test_pool_imap_orders():
    def run(mod):
        Pool = sub(mod, "util.multiprocessing").Pool
        with Pool(processes=4) as pool:
            return (list(pool.imap(_sq, range(8), chunksize=2)),
                    sorted(pool.imap_unordered(_sq, range(8), chunksize=3)))

    squares = [x * x for x in range(8)]
    assert both(run) == [(squares, squares)] * 2


def test_pool_async_error_callbacks_and_close():
    def run(mod):
        Pool = sub(mod, "util.multiprocessing").Pool
        pool = Pool(processes=2)
        r = pool.map_async(_boom, [1, 2])
        with pytest.raises(ValueError, match="boom"):
            r.get(timeout=30)
        seen = [r.successful()]
        got, errors = threading.Event(), []
        pool.apply_async(_boom, (0,), error_callback=lambda e: (
            errors.append(isinstance(e, ValueError)), got.set()))
        got.wait(30)
        done = threading.Event()
        values = []
        pool.map_async(_sq, [2, 3], callback=lambda v: (
            values.append(v), done.set()))
        done.wait(30)
        pool.close()
        with pytest.raises(ValueError):
            pool.map(_sq, [1])
        pool.join()
        return seen, errors, values

    assert both(run) == [([False], [True], [[4, 9]])] * 2


def test_pool_bounds_concurrency():
    """processes=2 really limits parallelism: at no instant do more than
    two chunk tasks overlap."""
    def run(mod):
        Pool = sub(mod, "util.multiprocessing").Pool
        with Pool(processes=2) as pool:
            pool.map(_sq, range(4))  # warm the workers
            spans = pool.map(_stamped_sleep, range(6), chunksize=1)
        return max(sum(1 for a, b in spans if a < t < b)
                   for t in {s for span in spans for s in span})

    assert all(overlap <= 2 for overlap in both(run))


def test_pool_join_needs_close():
    def run(mod):
        pool = sub(mod, "util.multiprocessing").Pool(processes=1)
        with pytest.raises(ValueError, match="still running"):
            pool.join()
        pool.terminate()
        pool.join()
        return True

    assert both(run) == [True, True]


# ------------------------------------------------------- ParallelIterator


def test_parallel_iterator_transforms():
    def run(mod):
        rit = sub(mod, "util.iter")
        it = rit.from_range(12, num_shards=3).for_each(lambda x: x * 2) \
            .filter(lambda x: x % 3 == 0)
        got = sorted(it.gather_sync())
        batches = list(rit.from_items(list(range(6)), num_shards=2)
                       .batch(2).gather_sync())
        flat = sorted(rit.from_items([[1, 2], [3], [4, 5]], num_shards=2)
                      .flatten().gather_async())
        return got, batches, flat, repr(it)

    ref, port = both(run)
    assert ref == port
    got, batches, flat, text = port
    assert got == sorted(x * 2 for x in range(12) if (x * 2) % 3 == 0)
    assert all(len(b) <= 2 for b in batches)
    assert sorted(x for b in batches for x in b) == list(range(6))
    assert flat == [1, 2, 3, 4, 5]
    assert text == "ParallelIterator[3 shards, 2 transforms]"


def test_parallel_iterator_union_take_and_sync_order():
    def run(mod):
        rit = sub(mod, "util.iter")
        a = rit.from_items([1, 2, 3], num_shards=1)
        b = rit.from_items([10, 20], num_shards=1)
        u = a.union(b)
        return (u.num_shards(), list(u.gather_sync(batch=1)), a.take(2),
                list(rit.from_iterators([[7, 8], [9]]).gather_sync()))

    # gather_sync is round-robin in shard order, one batch a round.
    assert both(run) == [(2, [1, 10, 2, 20, 3], [1, 2], [7, 8, 9])] * 2


# ----------------------------------------------------------------- joblib


def _inv(x):
    return 1 // x


def test_joblib_backend():
    import joblib

    def run(mod):
        sub(mod, "util.joblib").register_ray()
        # Registering binds the name to this package's backend; the
        # backend runs its batches on the package's runtime.
        with joblib.parallel_backend("ray", n_jobs=4):
            out = joblib.Parallel()(joblib.delayed(_sq)(i) for i in range(12))
        with joblib.parallel_backend("ray", n_jobs=2):
            with pytest.raises(ZeroDivisionError):
                joblib.Parallel()(joblib.delayed(_inv)(i) for i in [1, 0])
        return out

    assert both(run) == [[i * i for i in range(12)]] * 2


# ------------------------------------------------------------ internal_kv


def test_internal_kv():
    def run(mod):
        kv = sub(mod, "experimental.internal_kv")
        out = [kv._internal_kv_initialized(),
               kv._internal_kv_put("k1", b"v1"),            # fresh key
               kv._internal_kv_put("k1", b"v2"),            # existed
               kv._internal_kv_get("k1"),
               kv._internal_kv_put("k1", b"v3", overwrite=False),
               kv._internal_kv_get("k1")]
        kv._internal_kv_put("k2", "x")
        out += [sorted(kv._internal_kv_list("k")),
                kv._internal_kv_exists("k2"),
                kv._internal_kv_del("k1"),
                kv._internal_kv_get("k1"),
                kv._internal_kv_del("k", del_by_prefix=True)]
        return out

    assert both(run) == [[True, False, True, b"v2", True, b"v2",
                          [b"k1", b"k2"], True, 1, None, 1]] * 2


def test_internal_kv_mixed_key_types():
    """str and bytes keys interoperate through the GCS's normalisation."""
    def run(mod):
        kv = sub(mod, "experimental.internal_kv")
        gcs = mod._require_runtime().gcs
        gcs.call("kv_put", {"key": "__mix__:a", "value": b"1"})
        kv._internal_kv_put(b"__mix__:b", b"2")
        keys = sorted(gcs.call("kv_keys", {"prefix": "__mix__:"})["keys"])
        value = gcs.call("kv_get", {"key": "__mix__:a"})["value"]
        return keys, value, kv._internal_kv_del(b"__mix__:",
                                                del_by_prefix=True)

    assert both(run) == [([b"__mix__:a", b"__mix__:b"], b"1", 2)] * 2


def test_internal_kv_namespaces():
    def run(mod):
        kv = sub(mod, "experimental.internal_kv")
        kv._internal_kv_put("same", b"ns-a", namespace="a")
        kv._internal_kv_put("same", b"ns-b", namespace="b")
        out = [kv._internal_kv_get("same", namespace="a"),
               kv._internal_kv_get("same", namespace="b"),
               kv._internal_kv_get("same"),
               kv._internal_kv_list("sa", namespace="a")]
        kv._internal_kv_del("same", namespace="a")
        out.append(kv._internal_kv_exists("same", namespace="a"))
        out.append(kv._internal_kv_exists("same", namespace="b"))
        return out

    assert both(run) == [[b"ns-a", b"ns-b", None, [b"same"], False,
                          True]] * 2


# ---------------------------------------------------- dynamic resources


def _needs_widget():
    return "ran"


class Holder:
    def ping(self):
        return os.getpid()


def _node_totals(mod):
    return {r: v for n in mod.nodes() for r, v in n["Resources"].items()}


def test_dynamic_resources():
    """A task waiting on a resource no node has runs once set_resource
    makes it; the node's accelerator grant is untouched; capacity 0 removes
    it; built-in resources are refused."""
    def run(mod):
        dyn = sub(mod, "experimental")
        accel, option = ACCELERATOR[mod.__name__]
        holder = mod.remote(**{option: 1})(Holder).remote()
        mod.get(holder.ping.remote(), timeout=60)
        ref = mod.remote(resources={"widget": 1})(_needs_widget).remote()
        done, _ = mod.wait([ref], timeout=0.5)
        out = [bool(done)]
        dyn.set_resource("widget", 2)
        out.append(mod.get(ref, timeout=30))
        wait_for(lambda: _node_totals(mod).get("widget") == 2, 30,
                 "widget in the node view")
        # The holder's grant survives the node's new total.
        out.append(mod.available_resources().get(accel, 0.0))
        dyn.set_resource("widget", 0)
        wait_for(lambda: _node_totals(mod).get("widget", 0) == 0, 30,
                 "widget removed")
        with pytest.raises(Exception, match="built-in"):
            dyn.set_resource("CPU", 64)
        with pytest.raises(Exception, match="built-in"):
            dyn.set_resource(accel, 4)
        mod.kill(holder)
        return out

    assert both(run) == [[False, "ran", 0.0]] * 2


# --------------------------------------------------------------- tqdm_ray


def _crunch(pkg, n):
    tqdm_ray = importlib.import_module(f"{pkg}.experimental.tqdm_ray")
    out = 0
    for i in tqdm_ray.tqdm(range(n), desc=f"crunch-{pkg}",
                           flush_interval_s=0.0):
        out += i
    return out


def test_tqdm_ray_lines_reach_the_driver(capsys):
    def run(mod):
        return mod.get(mod.remote(_crunch).remote(mod.__name__, 50),
                       timeout=60)

    assert both(run) == [sum(range(50))] * 2
    # The worker's final line comes back through each driver's log stream.
    err = ""
    deadline = time.monotonic() + 30
    want = [f"[crunch-{m.__name__} pid=" for m in PACKAGES]
    while time.monotonic() < deadline:
        err += capsys.readouterr().err
        done = [ln for ln in err.splitlines() if "50/50 (100%)" in ln
                and ln.endswith(" done")]
        if all(any(w in ln for ln in done) for w in want):
            break
        time.sleep(0.05)
    for w in want:
        assert any(w in ln for ln in done), (w, err[-2000:])


@pytest.mark.parametrize("total", [10, None])
def test_tqdm_ray_local_lines(capsys, total):
    def run(mod):
        tqdm_ray = sub(mod, "experimental.tqdm_ray")
        with tqdm_ray.tqdm(total=total, desc="local",
                           flush_interval_s=0.0) as bar:
            for _ in range(10):
                bar.update()
            bar.set_description("renamed")
        lines = capsys.readouterr().out.splitlines()
        # Strip the pid and the rate: the rest is the package's format.
        return [ln.split("]", 1)[0].split(" pid=")[0] + " " +
                ln.split("]", 1)[1].split("[")[0].strip()
                + (" done" if ln.endswith("done") else "") for ln in lines]

    ref, port = both(run)
    assert ref == port
    last = "10/10 (100%)" if total else "10"
    assert port[-1] == f"[renamed {last} done"
    assert len(port) == 11


# -------------------------------------------------------------------- rpdb


def _buggy(pkg, x):
    rpdb = importlib.import_module(f"{pkg}.util.rpdb")
    secret = x * 10
    rpdb.set_trace(timeout_s=60)
    return secret


def _fails_then_debugged(pkg):
    rpdb = importlib.import_module(f"{pkg}.util.rpdb")
    try:
        local_value = 41  # noqa: F841 — read through the debugger
        raise KeyError("post-mortem")
    except KeyError:
        rpdb.post_mortem(timeout_s=60)
    return "survived"


def _attach_when_advertised(mod, commands, function):
    rpdb = sub(mod, "util.rpdb")
    entries = []
    wait_for(lambda: entries.extend(rpdb.list_breakpoints()) or entries,
             30, "breakpoint advertised")
    assert [e["function"] for e in entries] == [function]
    out = io.StringIO()
    rpdb.attach(entries[0], stdin=io.StringIO(commands), stdout=out)
    return out.getvalue(), entries[0]


def test_rpdb_breakpoint_attach_inspect_continue():
    def run(mod):
        ref = mod.remote(_buggy).remote(mod.__name__, 7)
        text, entry = _attach_when_advertised(mod, "p secret\nc\n", "_buggy")
        value = mod.get(ref, timeout=30)
        # The breakpoint unregisters once its session is over.
        return (value, "70" in text, entry["host"], sorted(entry),
                sub(mod, "util.rpdb").list_breakpoints())

    ref, port = both(run)
    assert ref == port == (70, True, "127.0.0.1",
                           ["filename", "function", "host", "id", "lineno",
                            "pid", "port", "ts"], [])


@pytest.mark.parametrize("command", ["c", "q"])
def test_rpdb_post_mortem(command):
    """The port alone: the JAX package's post-mortem session fails the
    task on `c` and `q` (its continue calls `set_continue`, which needs
    the frame a `set_trace` would have set: an AttributeError on
    `botframe`); the port's ends the session and the task goes on."""
    mod = ray_tpu_torch
    ref = mod.remote(_fails_then_debugged).remote(mod.__name__)
    text, entry = _attach_when_advertised(
        mod, f"p local_value + 1\n{command}\n", "post_mortem")
    assert (mod.get(ref, timeout=30), "42" in text, entry["filename"]) == \
        ("survived", True, "<post-mortem>")


def test_debug_cli_lists_attaches_and_continues(clusters):
    """`python -m <package> debug --list`, then `debug` with the commands
    on its stdin: the task prints what the session saw and finishes."""
    def run(mod):
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep +
                   os.environ.get("PYTHONPATH", ""))
        cli = [sys.executable, "-m", mod.__name__, "--address",
               clusters[mod.__name__], "debug"]
        ref = mod.remote(_buggy).remote(mod.__name__, 5)
        wait_for(lambda: sub(mod, "util.rpdb").list_breakpoints(), 30,
                 "breakpoint advertised")
        listed = json.loads(subprocess.run(
            cli + ["--list"], capture_output=True, text=True, timeout=60,
            env=env, check=True).stdout)
        attached = subprocess.run(cli, input="p secret + 1\nc\n",
                                  capture_output=True, text=True,
                                  timeout=60, env=env)
        return ([e["function"] for e in listed], attached.returncode,
                "51" in attached.stdout, "attaching to" in attached.stdout,
                mod.get(ref, timeout=30))

    assert both(run) == [(["_buggy"], 0, True, True, 50)] * 2


def test_primary_ip_is_the_reference_s():
    from ray_tpu.util.net import primary_ip as ref_ip
    from ray_tpu_torch.util.net import primary_ip

    assert primary_ip() == ref_ip()
    # The CLI resolves "auto" through it.
    from ray_tpu_torch.scripts.cluster_cli import resolve_bind_host

    assert resolve_bind_host("auto") == ref_ip()
    assert resolve_bind_host("10.1.2.3") == "10.1.2.3"


# ------------------------------------------------ the slice as a whole


CFG = dict(vocab_size=256, n_positions=64, n_embd=64, n_layer=2, n_head=4)
WINDOWS, BATCH = 8, 2


def mean_next_token_nll(logits, ids):
    """Each window's mean NLL of its next tokens, in float64, from float32
    logits [b, s, vocab] and the ids [b, s]."""
    logits = np.asarray(logits, np.float64)[:, :-1]
    top = logits.max(-1, keepdims=True)
    lse = np.log(np.exp(logits - top).sum(-1)) + top[..., 0]
    tgt = np.take_along_axis(logits, ids[:, 1:, None], -1)[..., 0]
    return (lse - tgt).mean(-1)


class TinyScorer:
    """A CPU actor of the port holding a tiny float32 GPT-2."""

    def __init__(self):
        import torch

        from ray_tpu_torch.models import gpt2

        torch.set_num_threads(1)
        self.model = gpt2.GPT2(gpt2.GPT2Config(**CFG, dtype=torch.float32),
                               device="cpu")

    def load(self, state):
        import torch

        self.model.load_state_dict(
            {k: torch.from_numpy(v) for k, v in state.items()})

    def score(self, ids):
        import torch

        with torch.no_grad():
            logits = self.model(torch.from_numpy(ids).long())
        return os.getpid(), mean_next_token_nll(logits.numpy(), ids)


def test_actor_pool_scores_a_tiny_gpt2_as_the_jax_model(monkeypatch):
    # The actors start (and import torch) while JAX makes the weights.
    actors = [ray_tpu_torch.remote(TinyScorer).remote() for _ in range(2)]

    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jgpt2
    from ray_tpu_torch.models import gpt2 as tgpt2
    from ray_tpu_torch.util.actor_pool import ActorPool

    monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")
    ids = np.random.default_rng(0).integers(
        0, CFG["vocab_size"], (WINDOWS, CFG["n_positions"]), dtype=np.int32)
    jmodel = jgpt2.GPT2(jgpt2.GPT2Config(**CFG, dtype=jnp.float32))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(ids[:BATCH]))
    state = {k: v.numpy() for k, v in tgpt2.params_from_jax(
        jax.tree.map(np.asarray, fnn.meta.unbox(params))).items()}

    loaded = [a.load.remote(state) for a in actors]
    want = mean_next_token_nll(
        np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(ids))), ids)
    ray_tpu_torch.get(loaded, timeout=60)
    pool = ActorPool(actors)
    batches = [ids[i:i + BATCH] for i in range(0, WINDOWS, BATCH)]
    out = list(pool.map(lambda a, b: a.score.remote(b), batches))
    unordered = list(pool.map_unordered(lambda a, b: a.score.remote(b),
                                        batches))
    for a in actors:
        ray_tpu_torch.kill(a)
    got = np.concatenate([scores for _, scores in out])
    assert len({pid for pid, _ in out}) == 2          # both actors scored
    assert sorted(s.tolist() for _, s in unordered) == \
        sorted(s.tolist() for _, s in out)

    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert np.all(np.abs(want - np.log(CFG["vocab_size"])) < 0.5)
