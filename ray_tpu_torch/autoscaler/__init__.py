"""Autoscaler: reconcile cluster size with resource demand.

The port's counterpart of `ray_tpu.autoscaler`, the equivalent of the
reference's StandardAutoscaler (`autoscaler/_private/autoscaler.py:172`) +
ResourceDemandScheduler: a control loop reads the aggregated demand signal
from the GCS (queued task shapes + explicit request_resources bundles),
bin-packs it against current capacity, and asks a NodeProvider to launch
or terminate worker nodes. `GCEGPUNodeProvider` launches GCE A3 VMs (H100
cards) where the JAX package launches TPU VMs.
"""

from ray_tpu_torch.autoscaler.autoscaler import (
    AutoscalerConfig,
    LocalNodeProvider,
    NodeProvider,
    StandardAutoscaler,
    request_resources,
)
from ray_tpu_torch.autoscaler.gcp import (
    FakeGPUTransport,
    GCEGPUConfig,
    GCEGPUNodeProvider,
)

__all__ = ["AutoscalerConfig", "NodeProvider", "LocalNodeProvider",
           "StandardAutoscaler", "request_resources",
           "GCEGPUConfig", "GCEGPUNodeProvider", "FakeGPUTransport"]
