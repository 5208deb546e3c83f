"""Internal KV client: direct access to the GCS key-value store.

Equivalent of the reference's `python/ray/experimental/internal_kv.py`
(`_internal_kv_get/put/del/list/exists`) — the same store that backs
function distribution, serve controller state, and runtime_env packages.
"""

from __future__ import annotations

from typing import List, Optional


def _gcs():
    import ray_tpu_torch

    return ray_tpu_torch._require_runtime().gcs


def _key(k) -> bytes:
    return k.encode() if isinstance(k, str) else bytes(k)


def _internal_kv_initialized() -> bool:
    import ray_tpu_torch

    return ray_tpu_torch.is_initialized()


def _internal_kv_put(key, value, overwrite: bool = True,
                     namespace: str = "") -> bool:
    """Returns True if the key already existed (matching the reference)."""
    val = value.encode() if isinstance(value, str) else bytes(value)
    resp = _gcs().call("kv_put", {"namespace": namespace, "key": _key(key),
                                  "value": val, "overwrite": overwrite})
    return bool(resp.get("existed", not resp["added"]))


def _internal_kv_get(key, namespace: str = "") -> Optional[bytes]:
    return _gcs().call("kv_get", {"namespace": namespace,
                                  "key": _key(key)})["value"]


def _internal_kv_exists(key, namespace: str = "") -> bool:
    return _gcs().call("kv_exists", {"namespace": namespace,
                                     "key": _key(key)})["exists"]


def _internal_kv_del(key, del_by_prefix: bool = False,
                     namespace: str = "") -> int:
    return _gcs().call("kv_del", {"namespace": namespace, "key": _key(key),
                                  "prefix": del_by_prefix})["deleted"]


def _internal_kv_list(prefix, namespace: str = "") -> List[bytes]:
    return _gcs().call("kv_keys", {"namespace": namespace,
                                   "prefix": _key(prefix)})["keys"]
