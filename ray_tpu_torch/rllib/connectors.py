"""Observation connector pipeline: env-to-module preprocessing.

Equivalent of the reference's agent connectors (`rllib/connectors/agent/`):
composable transforms applied inside the rollout worker between the raw env
observation and the module input. The port's copy of
`ray_tpu/rllib/connectors.py` (numpy only). Observations stay uint8 through
the sample batch, over the wire and onto the learner's card (4x smaller than
float32); normalization to [0,1] happens on the device inside the CNN
module.

The Atari recipe (reference `atari_wrappers.py` / AtariPreprocessing):
GrayscaleResize(84, 84) >> FrameStack(4).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


class Connector:
    """One observation transform. Stateful connectors (FrameStack) track
    per-env state and must reset rows when episodes end."""

    def output_shape(self, input_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        return input_shape

    def output_dtype(self, input_dtype) -> np.dtype:
        return input_dtype

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def reset_rows(self, rows: np.ndarray, first_obs: np.ndarray) -> None:
        """Episode boundary for `rows`; `first_obs` is the already-
        transformed-by-upstream first observation of the new episode."""


class GrayscaleResize(Connector):
    """[B, H, W, C] (or [B, H, W]) uint8 -> [B, h, w] uint8.

    Grayscale via luma weights; resize by area-mean when the factor is an
    integer (the Atari 210x160 -> 84x84 path uses index sampling), else
    nearest-index sampling — pure numpy, no cv2 dependency.
    """

    def __init__(self, h: int = 84, w: int = 84):
        self.h, self.w = h, w
        self._row_idx = None
        self._col_idx = None

    def output_shape(self, input_shape):
        return (self.h, self.w)

    def output_dtype(self, input_dtype):
        return np.uint8

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        if obs.ndim == 4:  # [B, H, W, C] -> luma
            gray = (obs[..., 0] * 0.299 + obs[..., 1] * 0.587
                    + obs[..., 2] * 0.114) if obs.shape[-1] == 3 \
                else obs.mean(axis=-1)
        else:
            gray = obs
        B, H, W = gray.shape
        if H % self.h == 0 and W % self.w == 0:
            fh, fw = H // self.h, W // self.w
            out = gray.reshape(B, self.h, fh, self.w, fw).mean(axis=(2, 4))
        else:
            if self._row_idx is None or len(self._row_idx) != self.h:
                self._row_idx = (np.arange(self.h) * H // self.h)
                self._col_idx = (np.arange(self.w) * W // self.w)
            out = gray[:, self._row_idx][:, :, self._col_idx]
        return out.astype(np.uint8)


class FrameStack(Connector):
    """[B, h, w] -> [B, h, w, k]: the last k frames along a new channel
    axis (nature-DQN temporal context). New episodes start with the first
    frame repeated k times."""

    def __init__(self, k: int = 4):
        self.k = k
        self._stack: Optional[np.ndarray] = None

    def output_shape(self, input_shape):
        return tuple(input_shape) + (self.k,)

    def peek(self, obs: np.ndarray) -> np.ndarray:
        """The stack __call__ WOULD produce, without committing — used for
        the true-final-obs bootstrap at episode ends."""
        if self._stack is None or self._stack.shape[:-1] != obs.shape:
            return np.repeat(obs[..., None], self.k, axis=-1)
        return np.concatenate([self._stack[..., 1:], obs[..., None]], axis=-1)

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        self._stack = self.peek(obs)
        return self._stack.copy()

    def reset_rows(self, rows, first_obs):
        if self._stack is not None and rows.size:
            self._stack[rows] = np.repeat(
                first_obs[rows][..., None], self.k, axis=-1)


class ConnectorPipeline(Connector):
    """Ordered composition of connectors."""

    def __init__(self, connectors: Sequence[Connector]):
        self.connectors: List[Connector] = list(connectors)

    def output_shape(self, input_shape):
        for c in self.connectors:
            input_shape = c.output_shape(input_shape)
        return input_shape

    def output_dtype(self, input_dtype):
        for c in self.connectors:
            input_dtype = c.output_dtype(input_dtype)
        return input_dtype

    def __call__(self, obs):
        for c in self.connectors:
            obs = c(obs)
        return obs

    # Episode-boundary handling for stateful stages lives in
    # ConnectorVectorEnv (the one component that knows auto-reset timing);
    # a second reset path here would drift from it.


def atari_connectors(h: int = 84, w: int = 84, stack: int = 4
                     ) -> ConnectorPipeline:
    """The standard Atari preprocessing stack (reference
    `tuned_examples/ppo/atari-ppo.yaml` env_config)."""
    return ConnectorPipeline([GrayscaleResize(h, w), FrameStack(stack)])
