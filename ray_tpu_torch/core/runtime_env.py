"""Runtime environments: working_dir / py_modules / env_vars per task.

Equivalent of the reference's runtime-env system
(`python/ray/_private/runtime_env/{working_dir,py_modules,packaging}.py`,
design doc `python/ray/runtime_env/ARCHITECTURE.md`), collapsed to the
framework's needs:

- **Packaging** (driver side): a local directory zips into a
  content-addressed blob stored once in the GCS KV
  (`kv://runtime_env/<sha>.zip`); the task spec carries only URIs.
- **Isolation** (raylet side): URIs become part of the worker's granted
  env (`RAY_TPU_TORCH_RUNTIME_ENV`), so the worker pool leases tasks only to
  workers built with the same environment — two tasks with different
  working_dirs never share a process.
- **Materialization** (worker side): at startup the worker fetches blobs
  it hasn't cached under `session_dir/runtime_env/<sha>/`, extracts,
  chdirs into the working_dir and prepends py_modules to sys.path.

- **pip / venv** (worker side): `{"pip": [...], "pip_wheelhouse": dir}`
  builds a venv from a LOCAL wheelhouse (`pip install --no-index
  --find-links`), offline by design — the target hosts have no package
  index. Venvs are cached per content hash (package list + wheelhouse
  manifest) under the session dir and activated by prepending their
  site-packages to sys.path; the pip spec rides the same
  `RAY_TPU_TORCH_RUNTIME_ENV` marker, so env-matched worker leasing keeps
  different pip environments in different processes. (The reference's
  pip plugin, `python/ray/_private/runtime_env/pip.py`, re-launches
  workers inside the venv and resolves from an index; both are
  unavailable/unwanted here.)

conda/container isolation is out of scope; `env_vars` pass through.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import sys
import zipfile
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

URI_PREFIX = "kv://runtime_env/"
_KV_NS = "runtime_env"
_EXCLUDE_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}
MAX_PACKAGE_BYTES = 256 * 1024 * 1024


def _zip_dir(path: str, prefix: str = "") -> bytes:
    """Zip a directory; `prefix` nests entries under `<prefix>/...` (used
    by py_modules so extraction recreates the importable package dir)."""
    buf = io.BytesIO()
    base = os.path.abspath(path)
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(base):
            dirs[:] = [d for d in dirs if d not in _EXCLUDE_DIRS]
            for f in files:
                full = os.path.join(root, f)
                rel = os.path.relpath(full, base)
                zf.write(full, os.path.join(prefix, rel) if prefix else rel)
    blob = buf.getvalue()
    if len(blob) > MAX_PACKAGE_BYTES:
        raise ValueError(
            f"runtime_env package {path!r} is {len(blob)} bytes "
            f"(max {MAX_PACKAGE_BYTES}); exclude large data directories")
    return blob


def _upload(gcs, blob: bytes) -> str:
    sha = hashlib.sha256(blob).hexdigest()[:32]
    uri = f"{URI_PREFIX}{sha}.zip"
    key = uri.encode()
    exists = gcs.call("kv_exists", {"namespace": _KV_NS, "key": key})
    if not exists.get("exists"):
        gcs.call("kv_put", {"namespace": _KV_NS, "key": key, "value": blob})
    return uri


def _normalize_pip(out: Dict[str, Any]) -> None:
    """Canonicalize the pip spec: {"pip": [...pkgs...]} (+ optional
    "pip_wheelhouse") or {"pip": {"packages": [...], "wheelhouse": ...}}
    into the dict form with an absolute wheelhouse path. Validated driver
    side so a typo'd wheelhouse fails at submission, not in a worker."""
    pip = out.get("pip")
    if pip is None:
        return
    if isinstance(pip, dict):
        packages = list(pip.get("packages") or [])
        wheelhouse = pip.get("wheelhouse") or out.pop("pip_wheelhouse", None)
    else:
        packages = list(pip)
        wheelhouse = out.pop("pip_wheelhouse", None)
    wheelhouse = wheelhouse or os.environ.get("RAY_TPU_TORCH_WHEELHOUSE")
    if not packages:
        out.pop("pip", None)
        return
    if not wheelhouse:
        raise ValueError(
            "runtime_env pip requires a wheelhouse (pip_wheelhouse=..., "
            "pip={'wheelhouse': ...} or RAY_TPU_TORCH_WHEELHOUSE): this "
            "environment installs offline from local wheels only")
    wheelhouse = os.path.abspath(wheelhouse)
    if not os.path.isdir(wheelhouse):
        raise ValueError(f"pip wheelhouse {wheelhouse!r} is not a directory")
    out["pip"] = {"packages": sorted(packages), "wheelhouse": wheelhouse}
    # Hash computed DRIVER-side and carried in the spec (hence in the
    # worker-pool env marker): rebuilding a wheel changes the marker, so
    # pooled workers on the stale venv are never re-leased for the new
    # env — they'd otherwise serve old code from their sys.path.
    out["pip"]["env_hash"] = pip_env_hash(out["pip"])


def env_hash(runtime_env: Optional[Dict[str, Any]]) -> str:
    """Stable short content hash identifying one runtime environment —
    THE `env_sig` that keys worker-lease compatibility end to end
    (direct_task lease keys, the raylet's granted-env marker, and the
    forge's per-env template selection all derive from this one value).
    Empty env -> "" so the no-runtime_env fast path stays marker-free.

    Canonicalization: list-valued keys sort (py_modules/preimports order
    must not fork worker pools); everything else goes through json with
    repr fallback, so an exotic value degrades to a stable string rather
    than raising mid-submission."""
    if not runtime_env:
        return ""
    canon: Dict[str, Any] = {}
    for k in sorted(runtime_env):
        v = runtime_env[k]
        if isinstance(v, (list, tuple, set)):
            canon[k] = sorted(str(x) for x in v)
        elif isinstance(v, dict):
            canon[k] = {str(kk): str(v[kk]) for kk in sorted(v)}
        else:
            canon[k] = v
    blob = json.dumps(canon, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _normalize_preimports(out: Dict[str, Any]) -> None:
    """Canonicalize {"preimports": [...module names...]}: the modules a
    job wants baked into its forge template so its workers fork warm.
    Validated at submission (a typo'd module name must fail the submit,
    not wedge a template on every node)."""
    pre = out.get("preimports")
    if pre is None:
        return
    mods = sorted({str(m).strip() for m in pre if str(m).strip()})
    for m in mods:
        if not all(seg.isidentifier() for seg in m.split(".")):
            raise ValueError(
                f"runtime_env preimports entry {m!r} is not a valid "
                "module path")
    if mods:
        out["preimports"] = mods
    else:
        out.pop("preimports", None)


def pip_env_hash(pip: Dict[str, Any]) -> str:
    """Content hash identifying one venv: the package list plus the
    wheelhouse manifest (path + file names + sizes + mtimes — mtime
    catches a rebuilt wheel whose byte size happens to match), so adding
    or rebuilding a wheel produces a fresh venv instead of stale-cache
    confusion."""
    h = hashlib.sha256()
    for p in pip["packages"]:
        h.update(p.encode())
        h.update(b"\0")
    wh = pip["wheelhouse"]
    h.update(wh.encode())
    try:
        for name in sorted(os.listdir(wh)):
            if name.endswith(".whl"):
                st = os.stat(os.path.join(wh, name))
                h.update(name.encode())
                h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())
    except OSError:
        pass
    return h.hexdigest()[:24]


def prepare(runtime_env: Optional[Dict[str, Any]], gcs
            ) -> Optional[Dict[str, Any]]:
    """Driver side: replace local paths with uploaded content URIs.
    Idempotent (URIs pass through untouched)."""
    if not runtime_env:
        return runtime_env
    out = dict(runtime_env)
    _normalize_pip(out)
    _normalize_preimports(out)
    wd = out.get("working_dir")
    if wd and not wd.startswith(URI_PREFIX):
        if not os.path.isdir(wd):
            raise ValueError(f"runtime_env working_dir {wd!r} is not a "
                             "directory")
        out["working_dir"] = _upload(gcs, _zip_dir(wd))
    mods = out.get("py_modules")
    if mods:
        uris: List[str] = []
        for m in mods:
            if isinstance(m, str) and m.startswith(URI_PREFIX):
                uris.append(m)
            elif isinstance(m, str) and os.path.isdir(m):
                # The module DIRECTORY itself is the importable package:
                # nest it so extraction recreates `<name>/...` on sys.path.
                name = os.path.basename(os.path.normpath(m))
                uris.append(_upload(gcs, _zip_dir(m, prefix=name)))
            else:
                raise ValueError(
                    f"py_modules entry {m!r} must be a directory")
        out["py_modules"] = uris
    return out


class EnvCache:
    """Memoizing prepare() shared by the driver runtime and ray:// client.

    A loop submitting N tasks with one runtime_env zips the directory
    once; entries re-validate every `revalidate_s` against the KV (the
    blob store LRU-evicts under memory pressure — a vanished package
    re-uploads instead of failing every later worker launch)."""

    def __init__(self, gcs, revalidate_s: float = 60.0):
        import threading
        import time as _time

        self._gcs = gcs
        self._revalidate_s = revalidate_s
        self._lock = threading.Lock()
        self._time = _time
        self._entries: Dict[str, Any] = {}  # key -> (prepared, checked_ts)

    def prepare(self, runtime_env: Optional[Dict[str, Any]]
                ) -> Optional[Dict[str, Any]]:
        if not runtime_env or not (runtime_env.get("working_dir")
                                   or runtime_env.get("py_modules")
                                   or runtime_env.get("pip")):
            return runtime_env
        key = repr(sorted((k, repr(v)) for k, v in runtime_env.items()))
        now = self._time.monotonic()
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and now - entry[1] < self._revalidate_s:
                return entry[0]
        prepared = entry[0] if entry is not None else None
        if prepared is None or not self._uris_exist(prepared) \
                or not self._pip_fresh(prepared):
            prepared = prepare(runtime_env, self._gcs)
        with self._lock:
            # Deliberate prepared-env cache: keys are distinct
            # runtime_env signatures (bounded by the workload's env
            # variety) and entries are revalidated, not per-request.
            # raylint: disable=RL011 — bounded by distinct runtime_envs
            self._entries[key] = (prepared, now)
        return prepared

    @staticmethod
    def _pip_fresh(prepared: Dict[str, Any]) -> bool:
        """Re-hash the wheelhouse at revalidation: a rebuilt wheel must
        produce a new env marker (and thus fresh workers/venvs) within
        one revalidate window."""
        pip = prepared.get("pip")
        if not pip or not isinstance(pip, dict):
            return True
        return pip.get("env_hash") == pip_env_hash(pip)

    def _uris_exist(self, prepared: Dict[str, Any]) -> bool:
        uris = [prepared.get("working_dir")] + list(
            prepared.get("py_modules") or [])
        for uri in uris:
            if uri and uri.startswith(URI_PREFIX):
                resp = self._gcs.call("kv_exists",
                                      {"namespace": _KV_NS,
                                       "key": uri.encode()})
                if not resp.get("exists"):
                    return False
        return True


def granted_env(runtime_env: Optional[Dict[str, Any]]) -> Dict[str, str]:
    """Raylet side: the env-var marker that isolates worker pools per
    runtime environment (URIs + pip spec — env_vars are granted
    separately)."""
    if not runtime_env:
        return {}
    uris = {k: runtime_env[k]
            for k in ("working_dir", "py_modules", "pip", "preimports")
            if runtime_env.get(k)}
    if not uris:
        return {}
    # The env_sig rides next to the marker so every layer (worker-pool
    # leasing, per-env forge templates, job reclaim) keys off ONE hash
    # instead of re-deriving its own flavor of "same environment".
    return {"RAY_TPU_TORCH_RUNTIME_ENV": json.dumps(uris, sort_keys=True),
            "RAY_TPU_TORCH_ENV_SIG": env_hash(runtime_env)}


def materialize(gcs, session_dir: str) -> None:
    """Worker side: fetch + extract this process's runtime env (from the
    RAY_TPU_TORCH_RUNTIME_ENV marker), chdir into the working_dir, prepend
    py_modules to sys.path. Runs once at worker startup."""
    marker = os.environ.get("RAY_TPU_TORCH_RUNTIME_ENV")
    if not marker:
        return
    uris = json.loads(marker)
    cache = os.path.join(session_dir, "runtime_env")
    os.makedirs(cache, exist_ok=True)

    def fetch(uri: str) -> str:
        import shutil
        import tempfile

        sha = uri[len(URI_PREFIX):-len(".zip")]
        dest = os.path.join(cache, sha)
        if not os.path.isdir(dest):
            blob = gcs.call("kv_get", {"namespace": _KV_NS,
                                       "key": uri.encode()})["value"]
            if blob is None:
                raise RuntimeError(f"runtime_env blob {uri} missing from "
                                   "GCS KV")
            # Unique staging dir + tolerate losing the rename race:
            # several workers with the same env extract concurrently.
            tmp = tempfile.mkdtemp(prefix=f"{sha}.", dir=cache)
            with zipfile.ZipFile(io.BytesIO(blob)) as zf:
                zf.extractall(tmp)
            try:
                os.rename(tmp, dest)
            except OSError:
                if not os.path.isdir(dest):
                    raise
                shutil.rmtree(tmp, ignore_errors=True)  # lost the race
        return dest

    pip = uris.get("pip")
    if pip:
        _activate_venv(_ensure_venv(pip, cache))
    # Preimports: forge-templated workers already hold these modules from
    # the template process; this covers the cold-spawn fallback so both
    # paths present an identical environment to user code.
    import importlib
    for mod in uris.get("preimports", []) or []:
        try:
            importlib.import_module(mod)
        except Exception:
            logger.warning("runtime_env: preimport %s failed", mod,
                           exc_info=True)
    for uri in uris.get("py_modules", []) or []:
        path = fetch(uri)
        if path not in sys.path:
            sys.path.insert(0, path)
    wd = uris.get("working_dir")
    if wd:
        path = fetch(wd)
        os.chdir(path)
        if path not in sys.path:
            sys.path.insert(0, path)
        logger.info("runtime_env: working_dir %s", path)


def _ensure_venv(pip: Dict[str, Any], cache: str) -> str:
    """Build (or reuse) the content-addressed venv for a pip spec.
    Creation is offline: `pip install --no-index --find-links
    <wheelhouse>`. Concurrent workers building the same env serialize on
    an fcntl lock; the finished venv is moved into place atomically so a
    crashed build never half-caches."""
    import fcntl
    import shutil
    import subprocess
    import tempfile

    env_hash = pip.get("env_hash") or pip_env_hash(pip)
    dest = os.path.join(cache, f"venv-{env_hash}")
    if os.path.isdir(dest):
        return dest
    if not os.path.isdir(pip["wheelhouse"]):
        # Wheelhouses are LOCAL paths, deliberately not shipped through
        # the GCS KV (they can dwarf the blob store): on multi-host
        # clusters they must exist at the same path on every node
        # (shared filesystem or baked into the image).
        raise RuntimeError(
            f"pip wheelhouse {pip['wheelhouse']!r} does not exist on "
            f"this node; wheelhouses must be present at the same path "
            f"on every node (shared FS or machine image)")
    os.makedirs(cache, exist_ok=True)
    lock_path = os.path.join(cache, f"venv-{env_hash}.lock")
    with open(lock_path, "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        if os.path.isdir(dest):  # another worker won the build
            return dest
        tmp = tempfile.mkdtemp(prefix=f"venv-{env_hash}.", dir=cache)
        try:
            # Activation is a sys.path prefix in the SAME interpreter
            # (the base environment stays visible underneath), so the
            # "venv" needs only a site-packages dir for pip --target —
            # no interpreter copy, no `python -m venv` subprocess.
            os.makedirs(_venv_site_packages(tmp), exist_ok=True)
            subprocess.run(
                [sys.executable, "-m", "pip", "install", "--no-index",
                 "--find-links", pip["wheelhouse"],
                 "--target", _venv_site_packages(tmp),
                 *pip["packages"]],
                check=True, capture_output=True, timeout=600)
            os.rename(tmp, dest)
        except subprocess.CalledProcessError as e:
            shutil.rmtree(tmp, ignore_errors=True)
            raise RuntimeError(
                f"runtime_env pip install failed for {pip['packages']}: "
                f"{(e.stderr or b'').decode(errors='replace')[-800:]}"
            ) from None
        except subprocess.TimeoutExpired:
            shutil.rmtree(tmp, ignore_errors=True)
            raise RuntimeError(
                f"runtime_env pip install timed out for {pip['packages']}"
            ) from None
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)
            if not os.path.isdir(dest):
                raise
    return dest


def _venv_site_packages(venv_dir: str) -> str:
    return os.path.join(
        venv_dir, "lib",
        f"python{sys.version_info.major}.{sys.version_info.minor}",
        "site-packages")


def _activate_venv(venv_dir: str) -> None:
    """In-process activation: the venv's site-packages gets import
    priority. (The reference re-launches the worker under the venv's
    interpreter; this framework's workers materialize envs after spawn,
    before any user import, which the sys.path prefix covers.)"""
    site = _venv_site_packages(venv_dir)
    if site not in sys.path:
        sys.path.insert(0, site)
    os.environ["VIRTUAL_ENV"] = venv_dir
    logger.info("runtime_env: venv %s", venv_dir)
