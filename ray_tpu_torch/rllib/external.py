"""External env support: policy server + client.

Equivalent of the reference's external-agent API
(`rllib/env/policy_server_input.py`, `rllib/env/policy_client.py`,
`rllib/env/external_env.py`): a simulator that CANNOT be stepped by the
framework (a game server, a hardware rig, a browser session) connects
over HTTP, asks the current policy for actions, and logs rewards; the
server assembles complete episodes into SampleBatch-shaped transition
batches that feed replay-based training (DQN) or, with the logged
logp/value heads, on-policy postprocessing.

The port of `ray_tpu/rllib/external.py`. Inference runs the module's net
on the device the server is given (`device=`: the card unless "cpu" is
asked for), and the wire protocol is plain JSON over stdlib HTTP, so
clients need nothing from this framework beyond `PolicyClient`.
"""

from __future__ import annotations

import copy
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.rl_module import make_generator

logger = logging.getLogger(__name__)


class _EpisodeState:
    __slots__ = ("obs", "action", "logp", "value", "transitions", "total",
                 "pending_reward", "last_active")

    def __init__(self):
        self.obs = None
        self.action = None
        self.logp = 0.0
        self.value = 0.0
        self.transitions: List[Dict[str, Any]] = []
        self.total = 0.0
        # Rewards logged after an action but before the NEXT observation
        # arrives: held here until the transition they belong to is
        # created (at the next get_action / end_episode).
        self.pending_reward = 0.0
        self.last_active = time.monotonic()


class PolicyServer:
    """Serves get_action/log_returns over HTTP; collects episodes.

    `module` is an RLModule (DiscretePolicyModule etc.); weights refresh
    via `set_weights` (e.g. from a learner between iterations). Complete
    episodes accumulate until `sample_batch()` drains them.
    """

    # Episodes with no traffic for this long are abandoned (crashed
    # simulator) and evicted; returns history is ring-bounded.
    EPISODE_TTL_S = 600.0
    MAX_RETURNS_KEPT = 1000

    def __init__(self, module, host: str = "127.0.0.1", port: int = 0,
                 explore: bool = True, seed: int = 0, device=None):
        from collections import deque

        self.module = module
        self.net = module.build(device, seed)
        self._gen = make_generator(next(self.net.parameters()).device,
                                   seed + 17)
        self._explore = explore
        self._lock = threading.Lock()
        self._episodes: Dict[str, _EpisodeState] = {}
        self._complete: List[Dict[str, Any]] = []
        self._episode_returns = deque(maxlen=self.MAX_RETURNS_KEPT)
        self._eid = 0
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 — http.server API
                length = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                    resp = server._dispatch(req)
                    code = 200
                except Exception as e:  # noqa: BLE001 — surface to client
                    resp = {"error": f"{type(e).__name__}: {e}"}
                    code = 400
                body = json.dumps(resp).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request stderr spam
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.address = (f"http://{self._httpd.server_address[0]}:"
                        f"{self._httpd.server_address[1]}")
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="policy-server",
            daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ protocol

    def _dispatch(self, req: Dict[str, Any]) -> Dict[str, Any]:
        cmd = req.get("command")
        if cmd == "start_episode":
            with self._lock:
                self._evict_stale_locked()
                self._eid += 1
                eid = f"ep{self._eid}"
                self._episodes[eid] = _EpisodeState()
            return {"episode_id": eid}
        if cmd == "get_action":
            return self._get_action(req["episode_id"],
                                    np.asarray(req["observation"],
                                               np.float32))
        if cmd == "log_returns":
            with self._lock:
                ep = self._episodes[req["episode_id"]]
                ep.last_active = time.monotonic()  # still alive: no TTL
                ep.total += float(req["reward"])
                ep.pending_reward += float(req["reward"])
            return {}
        if cmd == "end_episode":
            return self._end_episode(
                req["episode_id"],
                np.asarray(req["observation"], np.float32),
                bool(req.get("terminated", True)))
        raise ValueError(f"unknown command {cmd!r}")

    def _evict_stale_locked(self):
        now = time.monotonic()
        for eid, ep in list(self._episodes.items()):
            if now - ep.last_active > self.EPISODE_TTL_S:
                del self._episodes[eid]  # abandoned simulator

    def _get_action(self, eid: str, obs: np.ndarray) -> Dict[str, Any]:
        with self._lock:
            ep = self._episodes[eid]
            ep.last_active = time.monotonic()
            # A key of this request's own from the server's stream (the
            # reference's key split), so inference runs outside the lock.
            key = int(torch.randint(2 ** 62, (1,), generator=self._gen,
                                    device=self._gen.device))
            net = self.net
        batch_obs = obs[None, ...]
        if self._explore:
            out = self.module.forward_exploration(
                net, batch_obs, make_generator(self._gen.device, key))
            action, logp, value = out["actions"], out["logp"], out["vf"]
        else:
            out = self.module.forward_inference(net, batch_obs)
            action, value = out["actions"], out["vf"]
            logp = torch.zeros(1)
        action, logp, value = (x.cpu().numpy() for x in (action, logp,
                                                          value))
        action = int(np.asarray(action)[0])
        with self._lock:
            # The lock was released for inference: a concurrent
            # end_episode may have finalized this episode — appending to
            # the popped object would silently drop the step.
            if self._episodes.get(eid) is not ep:
                raise KeyError(
                    f"episode {eid} ended while an action request was "
                    f"in flight")
            if ep.obs is not None:
                # The previous step's transition completes now that we
                # know its successor observation and the rewards logged
                # in between.
                ep.transitions.append({
                    "obs": ep.obs, "action": ep.action, "logp": ep.logp,
                    "vf": ep.value, "reward": ep.pending_reward,
                    "next_obs": obs, "done": False})
                ep.pending_reward = 0.0
            ep.obs = obs
            ep.action = action
            ep.logp = float(np.asarray(logp)[0])
            ep.value = float(np.asarray(value)[0])
        return {"action": action}

    def _end_episode(self, eid: str, final_obs: np.ndarray,
                     terminated: bool) -> Dict[str, Any]:
        with self._lock:
            ep = self._episodes.pop(eid)
            if ep.obs is not None:
                ep.transitions.append({
                    "obs": ep.obs, "action": ep.action, "logp": ep.logp,
                    "vf": ep.value, "reward": ep.pending_reward,
                    "next_obs": final_obs, "done": terminated})
            if ep.transitions:
                self._complete.append(self._episode_to_batch(ep))
                self._episode_returns.append(ep.total)
        return {"episodes_collected": len(self._complete)}

    @staticmethod
    def _episode_to_batch(ep: _EpisodeState) -> Dict[str, np.ndarray]:
        from ray_tpu_torch.rllib import sample_batch as sb

        t = ep.transitions
        return {
            sb.OBS: np.stack([x["obs"] for x in t]),
            sb.ACTIONS: np.asarray([x["action"] for x in t], np.int32),
            sb.REWARDS: np.asarray([x["reward"] for x in t], np.float32),
            sb.LOGP: np.asarray([x["logp"] for x in t], np.float32),
            sb.VF_PREDS: np.asarray([x["vf"] for x in t], np.float32),
            "next_obs": np.stack([x["next_obs"] for x in t]),
            sb.DONES: np.asarray([x["done"] for x in t], np.float32),
        }

    # ------------------------------------------------------------- training

    def set_weights(self, weights) -> None:
        """Load a learner's state dict into a fresh copy of the net and
        swap it in, so a request in flight finishes on the weights it
        started with."""
        net = copy.deepcopy(self.net)
        net.load_state_dict(weights)
        with self._lock:
            self.net = net

    def sample_batch(self) -> Optional[Dict[str, np.ndarray]]:
        """Drain collected episodes into one concatenated batch (None if
        nothing complete yet)."""
        with self._lock:
            eps, self._complete = self._complete, []
        if not eps:
            return None
        return {k: np.concatenate([e[k] for e in eps]) for k in eps[0]}

    def episode_returns(self) -> List[float]:
        with self._lock:
            return list(self._episode_returns)

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()


class PolicyClient:
    """External-simulator side (reference `policy_client.py`): no
    framework dependencies beyond stdlib — a simulator anywhere on the
    network drives episodes against the server's current policy."""

    def __init__(self, address: str, timeout_s: float = 30.0):
        self.address = address.rstrip("/")
        self.timeout_s = timeout_s

    def _call(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            self.address, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as resp:
                out = json.loads(resp.read())
        except urllib.error.HTTPError as e:
            # The server's diagnostic rides the error body; surface it
            # instead of a bare "HTTP Error 400".
            try:
                detail = json.loads(e.read()).get("error", str(e))
            except Exception:  # noqa: BLE001
                detail = str(e)
            raise RuntimeError(f"policy server error: {detail}") from None
        if "error" in out:
            raise RuntimeError(out["error"])
        return out

    def start_episode(self) -> str:
        return self._call({"command": "start_episode"})["episode_id"]

    def get_action(self, episode_id: str, observation) -> int:
        return self._call({
            "command": "get_action", "episode_id": episode_id,
            "observation": np.asarray(observation).tolist()})["action"]

    def log_returns(self, episode_id: str, reward: float) -> None:
        self._call({"command": "log_returns", "episode_id": episode_id,
                    "reward": float(reward)})

    def end_episode(self, episode_id: str, observation,
                    terminated: bool = True) -> None:
        self._call({"command": "end_episode", "episode_id": episode_id,
                    "observation": np.asarray(observation).tolist(),
                    "terminated": terminated})
