"""Drop-in `multiprocessing.Pool` on top of ray_tpu_torch tasks.

Equivalent of the reference's `python/ray/util/multiprocessing/pool.py:520`:
the same Pool surface (apply/apply_async/map/map_async/starmap/imap/
imap_unordered, context manager, close/terminate/join), with work units
submitted as framework tasks so a pool transparently spans every node in
the cluster instead of one host's forks.
"""

from ray_tpu_torch.util.multiprocessing.pool import AsyncResult, Pool

__all__ = ["Pool", "AsyncResult"]
