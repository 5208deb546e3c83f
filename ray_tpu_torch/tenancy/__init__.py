"""ray_tpu_torch.tenancy — the multi-tenant QoS plane over serve.

PAPER.md's L4 Serve stack multiplexes hundreds of applications per
cluster; this package is the native equivalent for the model zoo
(ROADMAP item 3): named tenants with priority tiers and quotas, per-
tenant token-bucket admission plus weighted fair queueing at the proxy,
and the controller-side registry the routing table pushes to every
router (quotas are enforced where requests arrive, never polled).

Layering (docs/MULTITENANCY.md has the full contract):

- `registry`   — TenantSpec / tier defaults; lives in the serve
  controller, checkpointed with it, pushed to proxies inside the
  routing table.
- `admission`  — proxy-side enforcement: TokenBucket (RPS + burst,
  over-quota answers a fast 429 with retry-after), per-tenant in-flight
  caps, and a WfqScheduler (virtual-time weighted fair queueing) that
  orders waiters when replica capacity is contended, so a hot tenant
  queues behind its own weight instead of starving other tiers.
"""

from ray_tpu_torch.tenancy.admission import (
    QuotaExceeded,
    TenantAdmission,
    TokenBucket,
    WfqScheduler,
)
from ray_tpu_torch.tenancy.registry import TIER_WEIGHTS, TenantSpec

__all__ = [
    "QuotaExceeded",
    "TIER_WEIGHTS",
    "TenantAdmission",
    "TenantSpec",
    "TokenBucket",
    "WfqScheduler",
]
