"""APPO: asynchronous PPO on the IMPALA machinery.

The port of `ray_tpu/rllib/appo.py` (the reference's
`rllib/algorithms/appo/appo.py`: APPOConfig extends ImpalaConfig;
`appo_torch_policy.py` loss): IMPALA's async sampling + V-trace off-policy
correction, with PPO's clipped surrogate computed against the behavior
policy and a slow-moving TARGET policy network providing the V-trace/KL
anchor — the piece that keeps the surrogate stable when rollouts lag many
updates behind. The target is a frozen copy of the learner's net on the
same device, refreshed by `sync_target`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig, IMPALALearner
from ray_tpu_torch.rllib.learner import target_copy


@dataclass
class APPOConfig(IMPALAConfig):
    clip_param: float = 0.4            # reference APPOConfig default
    use_kl_loss: bool = False
    kl_coeff: float = 1.0
    # Learner updates between target-network syncs (reference
    # target_update_frequency).
    target_update_frequency: int = 1

    def build(self) -> "APPO":
        return APPO(self)


class APPOLearner(IMPALALearner):
    """V-trace advantages + PPO clip, anchored on a target policy."""

    def __init__(self, module, config, seed: int = 0, **kw):
        super().__init__(module, config, seed=seed, **kw)
        self.target_net = target_copy(self.net)
        self._updates_since_sync = 0

    def compute_loss(self, net, batch):
        cfg = self.config
        heads = self._fragment_forward(net, batch)
        cur_logp, vf, entropy = heads["logp"], heads["vf"], heads["entropy"]

        # Target-policy heads anchor the V-trace correction and the KL
        # (reference: vtrace runs on the target model's action
        # distribution; appo_torch_policy.py).
        with torch.no_grad():
            tgt_heads = self._fragment_forward(self.target_net, batch)
        tgt_logp = tgt_heads["logp"]

        vs, pg_adv = self._vtrace_advantages(tgt_logp, batch, vf,
                                             heads["vf_ext"])

        # PPO clip against the BEHAVIOR policy's logp (what generated
        # the samples), with V-trace-corrected advantages.
        ratio = torch.exp(cur_logp - batch[sb.LOGP])
        surrogate = torch.minimum(
            pg_adv * ratio,
            pg_adv * torch.clamp(ratio, 1 - cfg.clip_param,
                                 1 + cfg.clip_param))
        policy_loss = -torch.mean(surrogate)
        vf_loss = 0.5 * torch.mean((vs - vf) ** 2)
        mean_entropy = torch.mean(entropy)
        loss = policy_loss + cfg.vf_loss_coeff * vf_loss \
            - cfg.entropy_coeff * mean_entropy
        # Analytic KL(target || current) over full action distributions
        # (a sampled tgt_logp - cur_logp estimator is NOT a KL: its
        # gradient is a flat likelihood bonus on sampled actions and it
        # can go negative).
        if "logits" in heads and "logits" in tgt_heads:
            cur_all = torch.log_softmax(heads["logits"], dim=-1)
            tgt_all = torch.log_softmax(tgt_heads["logits"], dim=-1)
            kl = torch.mean(torch.sum(
                tgt_all.exp() * (tgt_all - cur_all), dim=-1))
        else:  # modules without full distributions: report, don't train
            kl = torch.mean(tgt_logp - cur_logp)
        if cfg.use_kl_loss and "logits" in heads:
            loss = loss + cfg.kl_coeff * kl
        return loss, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                      "entropy": mean_entropy, "kl": kl,
                      "mean_ratio": torch.mean(ratio)}

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        metrics = super().update(batch)
        if not metrics:
            return metrics
        self._updates_since_sync += 1
        if self._updates_since_sync >= self.config.target_update_frequency:
            self.sync_target()
        return metrics

    def sync_target(self):
        self.target_net.load_state_dict(self.net.state_dict())
        self._updates_since_sync = 0

    def get_state(self):
        state = super().get_state()
        state["target_params"] = {
            k: v.detach().to("cpu", copy=True)
            for k, v in self.target_net.state_dict().items()}
        return state

    def set_state(self, state):
        super().set_state(state)
        self.target_net.load_state_dict(
            state.get("target_params", state["params"]))


class APPO(IMPALA):
    """Reference `appo.py`: the IMPALA training loop, APPO learner."""

    learner_cls = APPOLearner
