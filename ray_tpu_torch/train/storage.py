"""Pluggable URI storage for checkpoints and experiment sync.

Equivalent of the reference's cloud storage seam under AIR/Tune
(`python/ray/air/checkpoint.py:65` dict<->dir<->URI morphs,
`python/ray/tune/syncer.py` experiment sync), built without cloud SDKs:
`gs://` speaks the GCS JSON API and `s3://` speaks SigV4-signed S3 REST
through a pluggable per-scheme `transport`, so on a cloud VM the only
dependency is the metadata server; tests register a `memory://` backend
or inject a fake transport and verify the exact requests.

On cloud VMs this seam is what makes checkpoints durable: local disk dies
with the VM, so Train/Tune persist through here when `storage_path` is a
bucket URI. The port's copy of `ray_tpu/train/storage.py`.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import logging
import os
import threading
import time
import urllib.parse
from typing import Callable, Dict, List, Optional, Tuple, Type

logger = logging.getLogger(__name__)

Transport = Callable[..., bytes]  # (method, url, data=None, headers=None)


def parse_uri(uri: str) -> Tuple[str, str, str]:
    """-> (scheme, bucket, path). file:// has bucket ''."""
    parsed = urllib.parse.urlparse(uri)
    if not parsed.scheme:
        raise ValueError(f"not a URI: {uri!r}")
    if parsed.scheme == "file":
        return "file", "", (parsed.netloc + parsed.path)
    return parsed.scheme, parsed.netloc, parsed.path.lstrip("/")


class StorageBackend:
    """Byte-level verbs against one bucket; directory sync is layered on
    top by upload_dir/download_dir."""

    def __init__(self, bucket: str, transport: Optional[Transport] = None):
        self.bucket = bucket
        self.transport = transport or _urllib_transport

    def put(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, path: str) -> bytes:
        raise NotImplementedError

    def list(self, prefix: str) -> List[str]:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def exists_prefix(self, prefix: str) -> bool:
        return bool(self.list(prefix))


# --------------------------------------------------------------------------- #
# Registry
# --------------------------------------------------------------------------- #

_BACKENDS: Dict[str, Type[StorageBackend]] = {}
_TRANSPORTS: Dict[str, Transport] = {}
_CACHE: Dict[Tuple[str, str], StorageBackend] = {}
_LOCK = threading.Lock()


def register_backend(scheme: str, backend_cls: Type[StorageBackend]):
    with _LOCK:
        _BACKENDS[scheme] = backend_cls
        _CACHE.clear()


def set_transport(scheme: str, transport: Optional[Transport]):
    """Inject a fake transport for a scheme (tests); None restores real."""
    with _LOCK:
        if transport is None:
            _TRANSPORTS.pop(scheme, None)
        else:
            _TRANSPORTS[scheme] = transport
        _CACHE.clear()


def get_backend(uri: str) -> Tuple[StorageBackend, str]:
    """-> (backend, path-within-bucket) for a non-file URI."""
    scheme, bucket, path = parse_uri(uri)
    with _LOCK:
        cls = _BACKENDS.get(scheme)
        if cls is None:
            raise ValueError(
                f"no storage backend for scheme {scheme!r} "
                f"(registered: {sorted(_BACKENDS)})")
        key = (scheme, bucket)
        backend = _CACHE.get(key)
        if backend is None:
            backend = cls(bucket, transport=_TRANSPORTS.get(scheme))
            _CACHE[key] = backend
    return backend, path


def is_cloud_uri(uri: str) -> bool:
    try:
        scheme, _, _ = parse_uri(uri)
    except ValueError:
        return False
    return scheme != "file"


# --------------------------------------------------------------------------- #
# Directory sync
# --------------------------------------------------------------------------- #


def upload_dir(local_dir: str, uri: str) -> str:
    """Mirror a local directory to the URI prefix (stale remote files under
    the prefix are replaced, not pruned — sync is additive like the
    reference's default syncer)."""
    scheme, _, path = parse_uri(uri)
    if scheme == "file":
        import shutil

        if os.path.abspath(local_dir) != os.path.abspath(path):
            os.makedirs(path, exist_ok=True)
            shutil.copytree(local_dir, path, dirs_exist_ok=True)
        return uri
    backend, prefix = get_backend(uri)
    base = os.path.abspath(local_dir)
    for root, _dirs, files in os.walk(base):
        for f in files:
            full = os.path.join(root, f)
            rel = os.path.relpath(full, base)
            with open(full, "rb") as fh:
                backend.put(_join(prefix, rel), fh.read())
    return uri


def download_dir(uri: str, local_dir: str) -> str:
    scheme, _, path = parse_uri(uri)
    if scheme == "file":
        import shutil

        if os.path.abspath(path) != os.path.abspath(local_dir):
            os.makedirs(local_dir, exist_ok=True)
            shutil.copytree(path, local_dir, dirs_exist_ok=True)
        return local_dir
    backend, prefix = get_backend(uri)
    names = backend.list(prefix)
    if not names:
        raise FileNotFoundError(f"nothing stored under {uri}")
    for name in names:
        rel = name[len(prefix):].lstrip("/") if prefix else name
        dest = os.path.join(local_dir, rel)
        os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
        with open(dest, "wb") as fh:
            fh.write(backend.get(name))
    return local_dir


def delete_prefix(uri: str) -> None:
    scheme, _, path = parse_uri(uri)
    if scheme == "file":
        import shutil

        shutil.rmtree(path, ignore_errors=True)
        return
    backend, prefix = get_backend(uri)
    for name in backend.list(prefix):
        backend.delete(name)


def uri_exists(uri: str) -> bool:
    scheme, _, path = parse_uri(uri)
    if scheme == "file":
        return os.path.exists(path)
    backend, prefix = get_backend(uri)
    return backend.exists_prefix(prefix)


def _join(prefix: str, rel: str) -> str:
    rel = rel.replace(os.sep, "/")
    return f"{prefix.rstrip('/')}/{rel}" if prefix else rel


# --------------------------------------------------------------------------- #
# Default transport + GCP auth
# --------------------------------------------------------------------------- #


def _urllib_transport(method: str, url: str, data: Optional[bytes] = None,
                      headers: Optional[Dict[str, str]] = None) -> bytes:
    import urllib.request

    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.read()


_gcp_token_lock = threading.Lock()
_gcp_token: Dict[str, object] = {"token": None, "expiry": 0.0}


def _gcp_access_token(transport: Transport) -> str:
    with _gcp_token_lock:
        if _gcp_token["token"] and time.time() < _gcp_token["expiry"] - 60:
            return _gcp_token["token"]  # type: ignore[return-value]
    raw = transport(
        "GET",
        "http://metadata.google.internal/computeMetadata/v1/instance/"
        "service-accounts/default/token",
        None, {"Metadata-Flavor": "Google"})
    payload = json.loads(raw)
    with _gcp_token_lock:
        _gcp_token["token"] = payload["access_token"]
        _gcp_token["expiry"] = time.time() + payload.get("expires_in", 3600)
    return payload["access_token"]


class GCSBackend(StorageBackend):
    """gs:// via the GCS JSON API (storage/v1), metadata-server auth."""

    API = "https://storage.googleapis.com"

    def _headers(self) -> Dict[str, str]:
        return {"Authorization":
                f"Bearer {_gcp_access_token(self.transport)}"}

    def put(self, path: str, data: bytes) -> None:
        name = urllib.parse.quote(path, safe="")
        self.transport(
            "POST",
            f"{self.API}/upload/storage/v1/b/{self.bucket}/o"
            f"?uploadType=media&name={name}",
            data, {**self._headers(),
                   "Content-Type": "application/octet-stream"})

    def get(self, path: str) -> bytes:
        name = urllib.parse.quote(path, safe="")
        return self.transport(
            "GET", f"{self.API}/storage/v1/b/{self.bucket}/o/{name}?alt=media",
            None, self._headers())

    def list(self, prefix: str) -> List[str]:
        out: List[str] = []
        page = ""
        while True:
            url = (f"{self.API}/storage/v1/b/{self.bucket}/o"
                   f"?prefix={urllib.parse.quote(prefix, safe='')}" + page)
            resp = json.loads(self.transport("GET", url, None,
                                             self._headers()))
            out.extend(item["name"] for item in resp.get("items", []))
            token = resp.get("nextPageToken")
            if not token:
                return out
            page = f"&pageToken={token}"

    def delete(self, path: str) -> None:
        name = urllib.parse.quote(path, safe="")
        self.transport("DELETE",
                       f"{self.API}/storage/v1/b/{self.bucket}/o/{name}",
                       None, self._headers())


class S3Backend(StorageBackend):
    """s3:// via SigV4-signed REST (env creds, no SDK)."""

    def __init__(self, bucket: str, transport: Optional[Transport] = None):
        super().__init__(bucket, transport)
        self.region = os.environ.get("AWS_REGION", "us-east-1")
        self.endpoint = os.environ.get(
            "AWS_ENDPOINT_URL",
            f"https://{bucket}.s3.{self.region}.amazonaws.com")

    def _sign(self, method: str, path: str, payload: bytes,
              query: str = "") -> Dict[str, str]:
        access = os.environ.get("AWS_ACCESS_KEY_ID", "")
        secret = os.environ.get("AWS_SECRET_ACCESS_KEY", "")
        host = urllib.parse.urlparse(self.endpoint).netloc
        amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        datestamp = amz_date[:8]
        payload_hash = hashlib.sha256(payload).hexdigest()
        canonical = "\n".join([
            method, "/" + urllib.parse.quote(path), query,
            f"host:{host}\nx-amz-content-sha256:{payload_hash}\n"
            f"x-amz-date:{amz_date}\n",
            "host;x-amz-content-sha256;x-amz-date", payload_hash])
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        to_sign = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                             hashlib.sha256(canonical.encode()).hexdigest()])

        def _h(key: bytes, msg: str) -> bytes:
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k = _h(_h(_h(_h(("AWS4" + secret).encode(), datestamp),
                     self.region), "s3"), "aws4_request")
        sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
        return {
            "x-amz-date": amz_date,
            "x-amz-content-sha256": payload_hash,
            "Authorization": (
                f"AWS4-HMAC-SHA256 Credential={access}/{scope}, "
                "SignedHeaders=host;x-amz-content-sha256;x-amz-date, "
                f"Signature={sig}"),
        }

    def put(self, path: str, data: bytes) -> None:
        self.transport("PUT", f"{self.endpoint}/{urllib.parse.quote(path)}",
                       data, self._sign("PUT", path, data))

    def get(self, path: str) -> bytes:
        return self.transport(
            "GET", f"{self.endpoint}/{urllib.parse.quote(path)}",
            None, self._sign("GET", path, b""))

    def list(self, prefix: str) -> List[str]:
        import re

        out: List[str] = []
        token = None
        while True:
            # Query params must stay sorted for the SigV4 canonical form.
            parts = [("list-type", "2"),
                     ("prefix", urllib.parse.quote(prefix, safe=""))]
            if token is not None:
                parts.insert(0, ("continuation-token",
                                 urllib.parse.quote(token, safe="")))
            query = "&".join(f"{k}={v}" for k, v in sorted(parts))
            raw = self.transport(
                "GET", f"{self.endpoint}/?{query}", None,
                self._sign("GET", "", b"", query=query)).decode()
            out.extend(re.findall(r"<Key>([^<]+)</Key>", raw))
            if "<IsTruncated>true</IsTruncated>" not in raw:
                return out
            m = re.search(
                r"<NextContinuationToken>([^<]+)</NextContinuationToken>",
                raw)
            if m is None:
                return out  # truncated but no token: avoid spinning
            token = m.group(1)

    def delete(self, path: str) -> None:
        self.transport("DELETE",
                       f"{self.endpoint}/{urllib.parse.quote(path)}",
                       None, self._sign("DELETE", path, b""))


class MemoryBackend(StorageBackend):
    """memory:// — process-global store for tests."""

    _buckets: Dict[str, Dict[str, bytes]] = {}
    _mlock = threading.Lock()

    def _store(self) -> Dict[str, bytes]:
        with self._mlock:
            return self._buckets.setdefault(self.bucket, {})

    def put(self, path: str, data: bytes) -> None:
        self._store()[path] = bytes(data)

    def get(self, path: str) -> bytes:
        return self._store()[path]

    def list(self, prefix: str) -> List[str]:
        return sorted(k for k in self._store() if k.startswith(prefix))

    def delete(self, path: str) -> None:
        self._store().pop(path, None)

    @classmethod
    def clear(cls):
        with cls._mlock:
            cls._buckets.clear()


register_backend("gs", GCSBackend)
register_backend("s3", S3Backend)
register_backend("memory", MemoryBackend)
