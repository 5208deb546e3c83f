"""Dashboard: HTTP visibility into the cluster.

Equivalent of the reference's dashboard head (`dashboard/head.py:71`)
reduced to its API surface: JSON state routes + Prometheus metrics + a
single-page HTML overview, served by a thread on the head node. The heavy
React frontend is out of scope by design — the routes carry the same
information.

Routes:
    /                  HTML overview (nodes, actors, jobs, resources)
    /metrics           Prometheus text exposition (aggregated cluster-wide)
    /api/nodes         node table
    /api/actors        actor table
    /api/jobs          driver jobs + submitted jobs
    /api/cluster_resources   totals/availability
"""

from ray_tpu_torch.dashboard.dashboard import DashboardServer

__all__ = ["DashboardServer"]
