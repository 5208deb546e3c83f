"""The PyTorch port's RLlib end to end on the CPU: PPO, IMPALA, APPO and DQN
with rollout workers in actors of the port's runtime, the learner group in
its local, remote and two-learner (gloo) forms, the external-env policy
server, and BC from experiences written and read back through Data.

One module-scoped `ray_tpu_torch.init` serves every test; each algorithm
runs with `device="cpu"`, tiny widths and a few iterations. Workers fork
from a template that preimports torch.
"""

import functools

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib import (APPO, BC, DQN, IMPALA, PPO, APPOConfig,
                                 BCConfig, CartPoleVectorEnv, DQNConfig,
                                 IMPALAConfig, IMPALALearner, PolicyClient,
                                 PolicyServer, PPOConfig, WorkerSet,
                                 atari_connectors, read_batches,
                                 rows_to_batch, write_batches)
from ray_tpu_torch.rllib.connectors import FrameStack
from ray_tpu_torch.rllib.dqn import DQNLearner, QModule
from ray_tpu_torch.rllib.learner import LearnerGroup
from ray_tpu_torch.rllib.ppo import PPOLearner
from ray_tpu_torch.rllib.rl_module import DiscretePolicyModule, SpecDict
from ray_tpu_torch.rllib.rollout import RolloutWorker

SMALL = dict(num_rollout_workers=1, num_envs_per_worker=4,
             rollout_fragment_length=32, hidden=(16, 16), device="cpu")


@pytest.fixture(scope="module", autouse=True)
def runtime():
    ray_tpu_torch.init(num_cpus=4, _system_config={
        "worker_forge_preimports": "ray_tpu_torch.core.worker,numpy,torch"})
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    ray_tpu_torch.shutdown()


def _finite(m, *keys):
    for k in keys:
        assert np.isfinite(m[k]), (k, m)


def test_ppo_cartpole_trains_saves_and_restores(tmp_path):
    cfg = dict(SMALL, num_sgd_iter=2, sgd_minibatch_size=64)
    algo = PPO(PPOConfig(**cfg))
    try:
        for i in range(3):
            m = algo.train()
            _finite(m, "total_loss", "policy_loss", "vf_loss", "entropy",
                    "grad_norm")
            # 128 rows: 2 minibatches of 64 an epoch, 2 epochs (unless the
            # KL guard stops an epoch early).
            assert m["sgd_steps"] in (2, 4)
            assert m["timesteps_total"] == 128 * (i + 1)
        assert m["episode_reward_mean"] is not None
        w = algo.workers.workers[0]
        assert ray_tpu_torch.get(w.cuda_visible_devices.remote()) == ""
        path = algo.save(str(tmp_path / "ckpt"))
        weights = algo.get_weights()
        assert all(v.device.type == "cpu" for v in weights.values())
    finally:
        algo.stop()
    again = PPO(PPOConfig(**cfg))
    try:
        again.restore(path)
        assert again.iteration == 3
        for k, v in weights.items():
            assert torch.equal(again.get_weights()[k], v), k
        _finite(again.train(), "total_loss")
    finally:
        again.stop()


def test_ppo_catch_with_frame_stack():
    algo = PPO(PPOConfig(
        env="Catch", connectors=[FrameStack(2)], num_sgd_iter=1,
        sgd_minibatch_size=64, **dict(SMALL, rollout_fragment_length=21)))
    try:
        spec = algo.workers.env_spec()
        assert spec["obs_shape"] == (21, 21, 2)
        for _ in range(2):
            m = algo.train()
            _finite(m, "total_loss")
        assert m["episode_reward_mean"] is not None
    finally:
        algo.stop()


@pytest.mark.parametrize("algo_cls,cfg_cls", [(IMPALA, IMPALAConfig),
                                              (APPO, APPOConfig)])
def test_impala_and_appo_cartpole(algo_cls, cfg_cls):
    algo = algo_cls(cfg_cls(fragments_per_batch=1, replay_fragments=1,
                            updates_per_iteration=3, **SMALL))
    try:
        for i in range(2):
            m = algo.train()
            _finite(m, "total_loss", "vf_loss", "entropy")
            assert m["updates"] == 3 * (i + 1)
            assert m["learner_sps"] > 0
    finally:
        algo.stop()


def test_dqn_smoke_with_target_sync():
    algo = DQN(DQNConfig(learning_starts=64, train_batch_size=32,
                         updates_per_iteration=4,
                         target_network_update_freq=64,
                         buffer_capacity=1000, **SMALL))
    try:
        ms = [algo.train() for _ in range(3)]
        assert ms[0]["updates"] == 4 and ms[-1]["buffer_size"] == 384
        for m in ms:
            _finite(m, "td_loss", "q_mean", "grad_norm")
        assert ms[-1]["epsilon"] < 1.0
        assert algo._last_target_sync > 0
        weights = algo.learner_group.get_weights()
        assert "epsilon" in weights
    finally:
        algo.stop()


def test_rollout_worker_final_obs_and_layout():
    w = RolloutWorker("CartPole-v1", n_envs=4, seed=0, hidden=(16, 16),
                      device="cpu")
    batch = w.sample(40)
    assert batch["obs"].shape == (160, 4) and batch["obs"].dtype == np.float32
    assert batch["actions"].dtype == np.int64
    assert batch["_next_vf"].shape == (160,)
    assert tuple(batch["_shape"]) == (40, 4)
    atari = RolloutWorker("Catch", n_envs=2, seed=0, device="cpu",
                          connectors=atari_connectors(42, 42, 4))
    b = atari.sample(22)
    assert b["obs"].shape == (44, 42, 42, 4) and b["obs"].dtype == np.uint8
    assert len(b["_final_obs_at"]) == len(b["_final_obs"]) > 0


def _ppo_batch(rng, n):
    return {
        "obs": rng.standard_normal((n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n),
        "logp": np.log(np.full(n, 0.5, np.float32)),
        "advantages": rng.standard_normal(n).astype(np.float32),
        "vf_preds": rng.standard_normal(n).astype(np.float32),
        "value_targets": rng.standard_normal(n).astype(np.float32),
    }


def _ppo_learner():
    return PPOLearner(DiscretePolicyModule(SpecDict(4, 2), hidden=(16, 16)),
                      PPOConfig(device="cpu"), seed=0)


def _impala_learner():
    # Standardized advantages: the two ranks must use the whole batch's
    # mean and deviation, not their halves'.
    return IMPALALearner(DiscretePolicyModule(SpecDict(4, 2),
                                              hidden=(16, 16)),
                         IMPALAConfig(device="cpu"), seed=0)


def _fragment(rng, T=6, B=4):
    dones = (rng.random((T, B)) < 0.2).astype(np.float32)
    return {
        "obs": rng.standard_normal((T, B, 4)).astype(np.float32),
        "last_obs": rng.standard_normal((1, B, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, (T, B)),
        "rewards": rng.standard_normal((T, B)).astype(np.float32),
        "logp": np.log(rng.uniform(0.2, 0.8, (T, B))).astype(np.float32),
        "dones": dones, "terminateds": dones,
        "behavior_next_vf": rng.standard_normal((T, B)).astype(np.float32),
    }


@pytest.mark.parametrize("algo", ["ppo", "impala"])
def test_two_gloo_learners_equal_one(algo):
    # float32 sums over two halves then an all-reduce differ from one sum
    # over the whole batch in order only: 1e-5 on the metrics, and 1e-6
    # on parameters moved by Adam steps of ~3e-4 (IMPALA's lr 5e-4).
    if algo == "ppo":
        factory = _ppo_learner
        batches = [_ppo_batch(np.random.default_rng(i), 64)
                   for i in range(2)]
    else:
        factory = _impala_learner
        batches = [_fragment(np.random.default_rng(i)) for i in range(2)]
    group = LearnerGroup(factory, mode="remote", num_learners=2)
    try:
        one = factory()
        for b in batches:
            got, want = group.update(b), one.update(b)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           atol=1e-5, err_msg=k)
        if algo == "ppo":
            stacked = {k: np.stack([b[k][:32] for b in batches])
                       for k in batches[0]}
            got, want = group.update_many(stacked), one.update_many(stacked)
            np.testing.assert_allclose(got["total_loss"], want["total_loss"],
                                       rtol=1e-5, atol=1e-5)
        for k, v in one.get_weights().items():
            np.testing.assert_allclose(group.get_weights()[k].numpy(),
                                       v.numpy(), rtol=0, atol=1e-6,
                                       err_msg=k)
        # Both ranks hold the same weights after the updates.
        ranks = group._sharded_group.call_all("get_weights")
        for k in ranks[0]:
            assert torch.equal(ranks[0][k], ranks[1][k]), k
    finally:
        group.shutdown()


def _dqn_learner(weights):
    """The port's DQN learner on `weights` (the reference's, carried), its
    target network synced to them as the reference's starts."""
    learner = DQNLearner(QModule(SpecDict(4, 2), hidden=(16, 16)),
                         DQNConfig(device="cpu"), seed=0)
    learner.set_weights(weights)
    learner.sync_target()
    return learner


def test_two_gloo_dqn_learners_equal_the_reference():
    """`update_dqn` over a sharded group of 2 gloo learners against the
    reference's `DQNLearner(num_devices=1)` on the same batch and weights,
    as tests/test_rllib_learner_dp.py::test_dqn_learner_dp_parity holds
    its dp 4 learner: td_loss within 1e-4, the |TD| rows (concatenated
    back in rank order) and the weights within rtol 1e-4 / atol 1e-5."""
    import flax.linen as fnn
    import jax

    from ray_tpu.rllib import dqn as j_dqn
    from ray_tpu.rllib.rl_module import SpecDict as JSpecDict

    n, obs = 32, 4
    rng = np.random.default_rng(5)
    batch = {
        "obs": rng.standard_normal((n, obs)).astype(np.float32),
        "next_obs": rng.standard_normal((n, obs)).astype(np.float32),
        "actions": rng.integers(0, 2, n).astype(np.int32),
        "rewards": rng.standard_normal(n).astype(np.float32),
        "dones": (rng.random(n) < 0.1).astype(np.float32),
    }
    jl = j_dqn.DQNLearner(j_dqn.QModule(JSpecDict(obs, 2), hidden=(16, 16)),
                          j_dqn.DQNConfig(), seed=0, num_devices=1)
    weights = QModule.params_from_jax(
        jax.tree.map(np.asarray, fnn.meta.unbox(jl.params)))
    group = LearnerGroup(functools.partial(_dqn_learner, weights),
                         mode="remote", num_learners=2)
    try:
        want, want_td = jl.update_dqn(batch)
        got, got_td = group.call("update_dqn", batch)
        assert abs(got["td_loss"] - want["td_loss"]) < 1e-4
        np.testing.assert_allclose(got_td, np.asarray(want_td), rtol=1e-4,
                                   atol=1e-5)
        want_w = QModule.params_from_jax(
            jax.tree.map(np.asarray, fnn.meta.unbox(jl.params)))
        got_w = group.get_weights()
        assert got_w.keys() == want_w.keys()
        for k, w in want_w.items():
            np.testing.assert_allclose(got_w[k].numpy(), w.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
        ranks = group._sharded_group.call_all("get_weights")
        for k in ranks[0]:
            assert torch.equal(ranks[0][k], ranks[1][k]), k
    finally:
        group.shutdown()


def test_worker_set_replaces_a_dead_worker():
    ws = WorkerSet("CartPole-v1", num_workers=2, n_envs=2, hidden=(16, 16),
                   device="cpu")
    try:
        ws.sync_weights(_ppo_learner().get_weights())
        dead = ws.workers[1]
        ray_tpu_torch.kill(dead)
        frags = ws.sample(8)
        assert len(frags) == 2
        assert all(f["obs"].shape == (16, 4) for f in frags)
        assert ws.workers[1] is not dead
    finally:
        ws.shutdown()


def test_remote_learner_and_its_device_rule():
    group = LearnerGroup(_ppo_learner, mode="remote")
    try:
        m = group.update(_ppo_batch(np.random.default_rng(3), 32))
        _finite(m, "total_loss")
    finally:
        group.shutdown()

    def wants_the_card():
        return PPOLearner(DiscretePolicyModule(SpecDict(4, 2)),
                          PPOConfig(), seed=0)

    # The actor was granted no GPU: asking for the card raises there.
    with pytest.raises(Exception, match="holds no GPU"):
        LearnerGroup(wants_the_card, mode="remote")


def test_ppo_without_cuda_or_cpu_request_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default learner takes it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PPO(PPOConfig(**dict(SMALL, device=None)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PPO(PPOConfig(**{k: v for k, v in SMALL.items() if k != "device"}))


def test_rollout_workers_without_cuda_or_cpu_request_raise(monkeypatch):
    # Rollout workers go on the card unless "cpu" is asked for (the
    # algorithms ask for it, `rollout_platform="cpu"`): without CUDA a
    # worker raises, a worker the runtime granted no card raises, and a
    # WorkerSet on a cluster without GPUs raises before it starts one.
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default worker takes it")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RolloutWorker("CartPole-v1", n_envs=2, hidden=(8,))
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(RuntimeError, match="holds no GPU"):
        RolloutWorker("CartPole-v1", n_envs=2, hidden=(8,))
    with pytest.raises(RuntimeError, match="too few GPUs"):
        WorkerSet("CartPole-v1", num_workers=2, n_envs=2, hidden=(8,))


def test_policy_server_round_trips():
    module = DiscretePolicyModule(SpecDict(4, 2), hidden=(16, 16))
    server = PolicyServer(module, explore=True, seed=0, device="cpu")
    greedy = PolicyServer(module, explore=False, seed=0, device="cpu")
    try:
        client = PolicyClient(server.address)
        rng = np.random.default_rng(0)
        for _ in range(3):
            eid = client.start_episode()
            obs = rng.standard_normal(4).astype(np.float32)
            for _ in range(5):
                assert client.get_action(eid, obs) in (0, 1)
                obs = rng.standard_normal(4).astype(np.float32)
                client.log_returns(eid, 1.0)
            client.end_episode(eid, obs, terminated=True)
        batch = server.sample_batch()
        assert batch["obs"].shape == (15, 4) and batch["dones"].sum() == 3
        np.testing.assert_allclose(batch["rewards"], np.ones(15))
        assert server.episode_returns() == [5.0, 5.0, 5.0]
        assert server.sample_batch() is None
        with pytest.raises(RuntimeError):
            client.get_action("nonexistent-episode", [0, 0, 0, 0])
        # Greedy serving answers the module's own argmax, and follows
        # set_weights.
        gclient = PolicyClient(greedy.address)
        obs = np.full(4, 0.5, np.float32)
        eid = gclient.start_episode()
        want = module.forward_inference(greedy.net, obs[None])["actions"]
        assert gclient.get_action(eid, obs) == int(want[0])
        zero = {k: torch.zeros_like(v)
                for k, v in greedy.net.state_dict().items()}
        zero["pi.bias"] = torch.tensor([0.0, 1.0])
        greedy.set_weights(zero)
        assert gclient.get_action(eid, obs) == 1
        gclient.end_episode(eid, obs)
    finally:
        server.stop()
        greedy.stop()


def _cartpole_batches(n_batches, rows, seed=0):
    env = CartPoleVectorEnv(1, seed=seed)
    rng = np.random.default_rng(seed)
    obs = env.reset()
    out = []
    for _ in range(n_batches):
        cols = {"obs": [], "actions": [], "rewards": [], "dones": []}
        for _ in range(rows):
            action = rng.integers(0, 2, size=1)
            cols["obs"].append(obs[0])
            cols["actions"].append(action[0])
            obs, reward, done, _ = env.step(action)
            cols["rewards"].append(reward[0])
            cols["dones"].append(done[0])
        out.append({"obs": np.asarray(cols["obs"], np.float32),
                    "actions": np.asarray(cols["actions"], np.int64),
                    "rewards": np.asarray(cols["rewards"], np.float32),
                    "dones": np.asarray(cols["dones"], bool)})
    return out


def test_bc_trains_from_experiences_written_through_data(tmp_path):
    batches = _cartpole_batches(3, 40)
    files = write_batches(str(tmp_path), batches)
    assert len(files) == 1 and files[0].endswith(".json")
    ds = read_batches(str(tmp_path))
    back = rows_to_batch(ds.take_all())
    for k, v in back.items():
        want = np.concatenate([b[k] for b in batches])
        assert v.dtype == want.dtype, k
        np.testing.assert_array_equal(v, want)
    algo = BC(BCConfig(obs_dim=4, n_actions=2, hidden=(16, 16),
                       device="cpu"))
    m = algo.train_on_dataset(ds, epochs=2, batch_size=32)
    _finite(m, "nll", "entropy", "grad_norm", "total_loss")
    assert algo.iteration == 2
    assert set(algo.get_policy_weights()) == set(
        algo.learner.net.state_dict())
