"""Tenant registry types: who owns a deployment and at what QoS.

A tenant is a named principal with a priority tier, a request-rate
quota, and an in-flight cap. The authoritative registry lives in the
serve controller (checkpointed with it — quotas survive a controller
crash); proxies receive each deployment's tenant QoS inside the pushed
routing-table entry and enforce it locally in `tenancy.admission`.
Registration is explicit (`serve.register_tenant`) so a deploy naming
an unknown tenant fails fast instead of silently running unmetered.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Dict, Optional

# Priority tiers and their default WFQ weights: under contention a gold
# tenant's queued requests drain 8x as often as a bronze tenant's. A
# spec may override the weight directly; the tier remains the label the
# bench's per-tier p99 budgets key on.
TIER_WEIGHTS: Dict[str, int] = {"gold": 8, "silver": 4, "bronze": 1}


@dataclass
class TenantSpec:
    """One tenant's identity + QoS contract.

    rps_limit / burst feed the proxy token bucket (0 = unmetered);
    max_inflight caps the tenant's concurrently executing requests per
    proxy (0 = uncapped); weight orders the fair queue when replica
    capacity is contended (defaults to the tier's weight).
    """

    name: str
    tier: str = "bronze"
    weight: int = 0                 # 0 = use the tier default
    rps_limit: float = 0.0          # sustained requests/s (0 = unmetered)
    burst: float = 0.0              # bucket depth (0 = 1s worth of rps)
    max_inflight: int = 0           # per-proxy concurrent cap (0 = none)

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if self.tier not in TIER_WEIGHTS:
            raise ValueError(
                f"unknown tier {self.tier!r} (one of {sorted(TIER_WEIGHTS)})")
        if self.weight <= 0:
            self.weight = TIER_WEIGHTS[self.tier]
        if self.rps_limit and self.burst <= 0:
            self.burst = max(1.0, self.rps_limit)

    def qos(self) -> Dict[str, Any]:
        """The wire form pushed inside routing-table entries (plain
        dict: the table crosses pickle + msgpack boundaries)."""
        return asdict(self)

    @staticmethod
    def from_qos(d: Optional[Dict[str, Any]]) -> Optional["TenantSpec"]:
        if not d:
            return None
        return TenantSpec(**d)
