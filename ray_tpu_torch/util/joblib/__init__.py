"""joblib backend: `register_ray()` + `parallel_backend("ray")`.

Equivalent of the reference's `python/ray/util/joblib/`: joblib.Parallel
batches (scikit-learn's parallelism) execute as framework tasks, so an
unmodified `GridSearchCV(n_jobs=-1)` fans out over the cluster.
"""

from __future__ import annotations

from typing import Any, Callable, List


def register_ray() -> None:
    """Register the 'ray' joblib backend (reference register_ray)."""
    from joblib.parallel import register_parallel_backend

    register_parallel_backend("ray", _RayBackend)


try:
    from joblib._parallel_backends import MultiprocessingBackend
except Exception:  # pragma: no cover — joblib absent/renamed internals
    MultiprocessingBackend = object  # type: ignore[misc,assignment]


class _RayBackend(MultiprocessingBackend):
    """Each joblib batch (a list of zero-arg callables) runs as one task."""

    supports_timeout = True

    def configure(self, n_jobs: int = 1, parallel: Any = None,
                  prefer: Any = None, require: Any = None, **kwargs) -> int:
        import ray_tpu_torch

        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        n_jobs = self.effective_n_jobs(n_jobs)
        self.parallel = parallel
        return n_jobs

    def effective_n_jobs(self, n_jobs: int) -> int:
        import ray_tpu_torch

        cpus = max(1, int(ray_tpu_torch.cluster_resources().get("CPU", 1)))
        if n_jobs is None or n_jobs == 1:
            return 1
        if n_jobs < 0:
            return cpus
        return min(n_jobs, cpus)

    def apply_async(self, func: Callable[[], List[Any]], callback=None):
        import ray_tpu_torch

        @ray_tpu_torch.remote
        def run_batch(f):
            return f()

        ref = run_batch.remote(func)
        return _RayResult(ref, callback)

    # joblib >= 1.3 dispatches through submit(); same contract: the
    # callback receives the result value (or the exception) directly.
    def submit(self, func, callback=None):
        return self.apply_async(func, callback=callback)

    def retrieve_result_callback(self, out):
        if isinstance(out, BaseException):
            raise out
        return out

    def terminate(self):
        pass

    def abort_everything(self, ensure_ready: bool = True):
        if ensure_ready:
            self.configure(n_jobs=self.parallel.n_jobs,
                           parallel=self.parallel)


class _RayResult:
    def __init__(self, ref, callback):
        self._ref = ref
        self._callback = callback
        if callback is not None:
            import threading

            threading.Thread(target=self._notify, daemon=True).start()

    def _notify(self):
        import ray_tpu_torch

        try:
            out = ray_tpu_torch.get(self._ref)
        except BaseException as e:  # noqa: BLE001 — delivered to joblib
            out = e
        self._callback(out)

    def get(self, timeout=None):
        import ray_tpu_torch

        return ray_tpu_torch.get(self._ref, timeout=timeout)
