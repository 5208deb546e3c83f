"""ray_tpu_torch.chaos — bounded-recovery tools (counterpart of
`ray_tpu.chaos`).

Only `deadline` is ported so far (`TransitionWatch`, which the Serve
controller uses to fail stuck state transitions loudly). The seeded
fault schedule, injectors, runner and hang watchdog come with ROADMAP M11.
"""

from ray_tpu_torch.chaos.deadline import (  # noqa: F401
    StuckTransitionError,
    TransitionWatch,
)

__all__ = ["StuckTransitionError", "TransitionWatch"]
