"""The PyTorch port's RLlib against the JAX package's, on the CPU.

Inputs come from numpy seeds. Weights are made by the JAX side from a seed
and carried into the port (`params_from_jax`); the port's learners run with
`device="cpu"`. The JAX side runs on the CPU (`JAX_PLATFORMS=cpu`).

Tolerances: the host-side pieces (GAE, connectors, envs, replay draws) are
numpy code that the port copies, so they must agree exactly. Nets are
float32 at widths up to 512 (3,136 inputs to the Nature CNN's dense layer):
logits, values, log-probabilities, entropies and losses differ only in
summation order, 1e-5 (1e-4 through the Nature CNN's 3,136-term sums).
After one update each parameter has moved by Adam's first step, about lr
(3e-4) times sign(g): it is held to 1e-6, which a flipped sign (2 lr) or
a lost clip would break by two orders. Greedy actions must be equal, with
the test first asserting that the reference's top two logits are at least
1e-6 apart in every row (a near tie could go either way; the policy head's
0.01-scaled init keeps logits near 1e-2, where the two frameworks' sums
part by under 1e-8). Sampled actions
are never compared: the two frameworks draw from different streams.
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib import appo as j_appo
from ray_tpu.rllib import connectors as j_conn
from ray_tpu.rllib import dqn as j_dqn
from ray_tpu.rllib import env as j_env
from ray_tpu.rllib import impala as j_impala
from ray_tpu.rllib import offline as j_off
from ray_tpu.rllib import ppo as j_ppo
from ray_tpu.rllib import replay_buffers as j_rb
from ray_tpu.rllib import rl_module as j_rlm
from ray_tpu.rllib import sample_batch as j_sb
from ray_tpu_torch.rllib import appo as t_appo
from ray_tpu_torch.rllib import connectors as t_conn
from ray_tpu_torch.rllib import dqn as t_dqn
from ray_tpu_torch.rllib import env as t_env
from ray_tpu_torch.rllib import impala as t_impala
from ray_tpu_torch.rllib import offline as t_off
from ray_tpu_torch.rllib import ppo as t_ppo
from ray_tpu_torch.rllib import replay_buffers as t_rb
from ray_tpu_torch.rllib import rl_module as t_rlm
from ray_tpu_torch.rllib import sample_batch as t_sb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
PARAM_TOL = 1e-6
TIE_GAP = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, fnn.meta.unbox(tree))


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=what)


def _assert_no_near_ties(logits):
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    assert np.all(top2[..., 1] - top2[..., 0] > TIE_GAP), \
        "the reference's top two logits nearly tie"


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _state_close(got_state, want_state, tol=PARAM_TOL):
    assert set(got_state) == set(want_state)
    for name, want in want_state.items():
        _close(got_state[name], want.numpy(), tol, name)


# --------------------------------------------------------------------------
# Host-side pieces: copies of the reference, held exactly.
# --------------------------------------------------------------------------


def test_rllib_port_has_the_reference_modules():
    ref = {n for n in os.listdir(os.path.join(ROOT, "ray_tpu", "rllib"))
           if n.endswith(".py")}
    port = {n for n in os.listdir(os.path.join(ROOT, "ray_tpu_torch",
                                               "rllib")) if n.endswith(".py")}
    assert port == ref
    assert len(port) == 15


def test_gae_standardize_and_minibatches_match_reference():
    rng = np.random.default_rng(0)
    T, n = 17, 5
    rewards = rng.standard_normal((T, n)).astype(np.float32)
    values = rng.standard_normal((T, n)).astype(np.float32)
    next_values = rng.standard_normal((T, n)).astype(np.float32)
    dones = rng.random((T, n)) < 0.2
    truncs = dones & (rng.random((T, n)) < 0.5)
    for gamma, lam in ((0.99, 0.95), (0.9, 1.0)):
        want = j_sb.compute_gae(rewards, values, dones, truncs, next_values,
                                gamma, lam)
        got = t_sb.compute_gae(rewards, values, dones, truncs, next_values,
                               gamma, lam)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    x = rng.standard_normal(100).astype(np.float32)
    np.testing.assert_array_equal(t_sb.standardize(x), j_sb.standardize(x))
    batch = {"obs": rng.standard_normal((103, 3)).astype(np.float32),
             "actions": rng.integers(0, 4, 103)}
    got = t_sb.stack_minibatches(
        t_sb.shuffle_batch(batch, np.random.default_rng(1)), 25)
    want = j_sb.stack_minibatches(
        j_sb.shuffle_batch(batch, np.random.default_rng(1)), 25)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    assert got[0]["obs"].shape == (4, 25, 3) and len(got[1]["obs"]) == 3


def test_grayscale_resize_and_frame_stack_match_reference():
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, (3, 210, 160, 3), dtype=np.uint8)
              for _ in range(4)]
    for h, w in ((84, 84), (105, 80)):  # index sampling, then area mean
        got = t_conn.GrayscaleResize(h, w)(frames[0])
        want = j_conn.GrayscaleResize(h, w)(frames[0])
        assert got.dtype == np.uint8 and got.shape == (3, h, w)
        np.testing.assert_array_equal(got, want)
    tp, jp = t_conn.atari_connectors(), j_conn.atari_connectors()
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(tp(f), jp(f))
        if i == 1:  # an episode restarts in row 1
            rows = np.array([1])
            first = t_conn.GrayscaleResize()(f)
            tp.connectors[-1].reset_rows(rows, first)
            jp.connectors[-1].reset_rows(rows, first)
            np.testing.assert_array_equal(tp.connectors[-1]._stack,
                                          jp.connectors[-1]._stack)
    gray = t_conn.GrayscaleResize()(frames[0])
    np.testing.assert_array_equal(tp.connectors[-1].peek(gray),
                                  jp.connectors[-1].peek(gray))
    assert tp.output_shape((210, 160, 3)) == (84, 84, 4)


@pytest.mark.parametrize("name", ["CartPole", "Catch", "CatchAtari"])
def test_env_trajectories_match_reference(name):
    def make(mod):
        if name == "CartPole":
            return mod.CartPoleVectorEnv(n_envs=4, seed=3,
                                         max_episode_steps=25)
        if name == "Catch":
            return mod.CatchVectorEnv(n_envs=4, seed=3, shaped=True)
        conn = (t_conn if mod is t_env else j_conn).atari_connectors()
        return mod.make_env("Catch", n_envs=4, seed=3,
                            connectors=[conn.connectors[0].__class__(42, 42),
                                        conn.connectors[1]])

    tenv, jenv = make(t_env), make(j_env)
    np.testing.assert_array_equal(tenv.reset(), jenv.reset())
    actions = np.random.default_rng(4).integers(0, tenv.n_actions, (60, 4))
    ends = 0
    for a in actions:
        got, want = tenv.step(a), jenv.step(a)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)
        assert set(got[3]) == set(want[3])
        for k in want[3]:
            np.testing.assert_array_equal(got[3][k], want[3][k])
        ends += int(want[2].sum())
    assert ends > 0  # episodes ended (and auto-reset) inside the run


def test_prioritized_replay_draws_match_reference():
    rng = np.random.default_rng(5)
    batches = [{"obs": rng.standard_normal((40, 3)).astype(np.float32),
                "actions": rng.integers(0, 2, 40)} for _ in range(3)]
    tb = t_rb.PrioritizedReplayBuffer(100, alpha=0.6, beta=0.4, seed=7)
    jb = j_rb.PrioritizedReplayBuffer(100, alpha=0.6, beta=0.4, seed=7)
    for b in batches:
        tb.add(b)
        jb.add(b)
        got, want = tb.sample(16), jb.sample(16)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        prios = rng.random(16) * 3
        tb.update_priorities(got["_batch_indices"], prios)
        jb.update_priorities(want["_batch_indices"], prios)
    assert len(tb) == len(jb) == 100


def _raw_fragment(rng, T=6, n=3):
    dones = rng.random((T, n)) < 0.25
    truncs = dones & (rng.random((T, n)) < 0.5)
    at = np.flatnonzero(dones.reshape(-1))
    return {
        "obs": rng.standard_normal((T * n, 4)).astype(np.float32),
        "_last_obs": rng.standard_normal((n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, T * n),
        "rewards": rng.standard_normal(T * n).astype(np.float32),
        "dones": dones.reshape(-1), "truncateds": truncs.reshape(-1),
        "logp": rng.standard_normal(T * n).astype(np.float32),
        "vf_preds": rng.standard_normal(T * n).astype(np.float32),
        "_next_vf": rng.standard_normal(T * n).astype(np.float32),
        "_shape": np.array([T, n]),
        "_final_obs_at": at,
        "_final_obs": rng.standard_normal((len(at), 4)).astype(np.float32),
    }


def test_algorithms_host_postprocessing_matches_reference():
    # PPO's GAE postprocessing, IMPALA's time-major fragments and DQN's
    # (s, a, r, s', done) transitions with the true final observations:
    # numpy code of the algorithms, held exactly.
    import types

    frag = _raw_fragment(np.random.default_rng(14))
    assert frag["truncateds"].any() and (frag["dones"]
                                         & ~frag["truncateds"]).any()
    cfg = types.SimpleNamespace(gamma=0.97, lambda_=0.9)
    cases = [(t_ppo.PPO._postprocess, j_ppo.PPO._postprocess, cfg),
             (t_impala.IMPALA._to_time_major, j_impala.IMPALA._to_time_major,
              None),
             (t_dqn.DQN._transitions, j_dqn.DQN._transitions, None)]
    for port_fn, ref_fn, config in cases:
        this = types.SimpleNamespace(config=config)
        got = port_fn(this, {k: v.copy() for k, v in frag.items()})
        want = ref_fn(this, {k: v.copy() for k, v in frag.items()})
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_tuned_examples_match_reference():
    import dataclasses

    from ray_tpu.rllib import tuned_examples as j_tuned
    from ray_tpu_torch.rllib import tuned_examples as t_tuned

    assert t_tuned.atari_available() == j_tuned.atari_available()
    assert set(t_tuned.TUNED_EXAMPLES) == set(j_tuned.TUNED_EXAMPLES)
    for name, want in j_tuned.TUNED_EXAMPLES.items():
        got = t_tuned.TUNED_EXAMPLES[name]
        assert (got.algo, got.stop_reward, got.max_timesteps) == (
            want.algo, want.stop_reward, want.max_timesteps)
        g, w = got.config_builder(), want.config_builder()
        # Every field of the reference's config, plus the learner's device
        # (the card by default).
        fields = {f.name for f in dataclasses.fields(w)}
        assert {f.name for f in dataclasses.fields(g)} == fields | {"device"}
        assert all(getattr(g, f) == getattr(w, f) for f in fields), name
        assert g.device == "cuda"


# --------------------------------------------------------------------------
# Modules with carried weights.
# --------------------------------------------------------------------------


def _carry_module(spec, hidden=(16, 16), seed=0):
    if len(spec.shape()) >= 2:
        jmod = j_rlm.ConvPolicyModule(j_rlm.SpecDict(*spec.__dict__.values()))
        tmod = t_rlm.ConvPolicyModule(spec)
    else:
        jmod = j_rlm.DiscretePolicyModule(
            j_rlm.SpecDict(*spec.__dict__.values()), hidden=hidden)
        tmod = t_rlm.DiscretePolicyModule(spec, hidden=hidden)
    params = jmod.init_params(jax.random.PRNGKey(seed))
    net = tmod.build("cpu", seed=seed)
    net.load_state_dict(t_rlm.params_from_jax(_np_tree(params)))
    return jmod, params, tmod, net


@pytest.mark.parametrize("shape,dtype", [
    ((4,), np.float32),              # the MLP
    ((21, 21), np.uint8),            # the shallow stack, one channel
    ((21, 21, 3), np.uint8),         # the shallow stack, three channels
    ((84, 84, 4), np.uint8),         # the Nature CNN at Atari width
])
def test_module_forwards_match_reference(shape, dtype):
    spec = t_rlm.SpecDict(int(np.prod(shape)), 4,
                          shape if len(shape) > 1 else ())
    jmod, params, tmod, net = _carry_module(spec)
    rng = np.random.default_rng(6)
    obs = (rng.integers(0, 256, (16,) + shape).astype(dtype)
           if dtype == np.uint8 else rng.standard_normal((16,) + shape)
           .astype(dtype))
    actions = rng.integers(0, 4, 16)
    want = jmod.forward_train(params, {"obs": jnp.asarray(obs),
                                       "actions": jnp.asarray(actions)})
    got = tmod.forward_train(net, _torch_batch({"obs": obs,
                                                "actions": actions}))
    tol = 1e-4 if shape == (84, 84, 4) else TOL
    for k in ("logits", "vf", "logp", "entropy"):
        _close(got[k], want[k], tol, k)
    _assert_no_near_ties(want["logits"])
    greedy = tmod.forward_inference(net, obs)
    np.testing.assert_array_equal(greedy["actions"].numpy(),
                                  np.asarray(jmod.forward_inference(
                                      params, jnp.asarray(obs))["actions"]))
    _close(greedy["vf"], want["vf"], tol, "vf")
    explored = tmod.forward_exploration(net, obs,
                                        t_rlm.make_generator("cpu", 0))
    again = tmod.forward_exploration(net, obs, t_rlm.make_generator("cpu", 0))
    assert torch.equal(explored["actions"], again["actions"])
    logp_all = torch.log_softmax(got["logits"], -1).detach()
    _close(explored["logp"], logp_all.gather(
        -1, explored["actions"][:, None])[:, 0], TOL, "logp of the draw")


def test_learner_takes_uint8_frames_and_the_card_by_default():
    # (The flatten order is held by the module test above: the shallow
    # stack's torso reads 7 x 7 x 32 activations, so a (C, h, w) flatten
    # against the reference's (h, w, C) kernel would not match.)
    spec = t_rlm.SpecDict(21 * 21 * 3, 3, (21, 21, 3))
    learner = t_ppo.PPOLearner(t_rlm.ConvPolicyModule(spec),
                               t_ppo.PPOConfig(device="cpu"))
    assert learner.net.torso.in_features == 7 * 7 * 32
    obs = np.zeros((2, 21, 21, 3), np.uint8)
    assert learner._to_device({"obs": obs})["obs"].dtype == torch.uint8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_ppo.PPOLearner(t_rlm.ConvPolicyModule(spec), t_ppo.PPOConfig())


# --------------------------------------------------------------------------
# Learners: losses, metrics and updates.
# --------------------------------------------------------------------------


def _ppo_batch(rng, n, obs_dim=4, n_actions=2):
    return {
        "obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, n_actions, n),
        "logp": np.log(rng.uniform(0.2, 0.8, n)).astype(np.float32),
        "advantages": rng.standard_normal(n).astype(np.float32),
        "vf_preds": rng.standard_normal(n).astype(np.float32),
        "value_targets": (3 * rng.standard_normal(n)).astype(np.float32),
    }


def _ppo_pair(**over):
    jcfg, tcfg = j_ppo.PPOConfig(), t_ppo.PPOConfig(device="cpu")
    for k, v in over.items():
        setattr(jcfg, k, v)
        setattr(tcfg, k, v)
    spec = t_rlm.SpecDict(4, 2)
    jmod, _, tmod, _ = _carry_module(spec)
    jl = j_ppo.PPOLearner(jmod, jcfg, seed=0)
    tl = t_ppo.PPOLearner(tmod, tcfg, seed=0)
    tl.set_weights(t_rlm.params_from_jax(_np_tree(jl.params)))
    return jl, tl


@pytest.mark.parametrize("grad_clip", [0.05, 100.0])  # clipped, not clipped
def test_ppo_learner_loss_and_update_match_reference(grad_clip):
    jl, tl = _ppo_pair(grad_clip=grad_clip, vf_clip_param=0.5)
    batch = _ppo_batch(np.random.default_rng(8), 64)
    jloss, jm = jl.compute_loss(jl.params, jax.tree.map(jnp.asarray, batch))
    tloss, tm = tl.compute_loss(tl.net, _torch_batch(batch))
    _close(tloss, jloss, TOL, "loss")
    for k in jm:
        _close(tm[k], jm[k], TOL, k)
    # Two updates: Adam's first step is blind to a common scale of the
    # gradient, its second sees the ratio of the two steps' (clipped)
    # gradients.
    for b in (batch, _ppo_batch(np.random.default_rng(18), 64)):
        want = jl.update(b)
        got = tl.update(b)
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], TOL, k)
        assert (want["grad_norm"] > grad_clip) == (grad_clip < 1)
        _state_close(tl.get_weights(),
                     t_rlm.params_from_jax(_np_tree(jl.params)))


def test_ppo_update_many_matches_reference():
    jl, tl = _ppo_pair()
    rng = np.random.default_rng(9)
    stacked, rest = t_sb.stack_minibatches(_ppo_batch(rng, 3 * 32 + 5), 32)
    assert len(stacked["obs"]) == 3
    want = jl.update_many(stacked)
    got = tl.update_many(stacked)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], TOL, k)
    _state_close(tl.get_weights(), t_rlm.params_from_jax(_np_tree(jl.params)))
    # The ragged tail trains as one ordinary update, as in PPO.
    _close(tl.update(rest)["total_loss"], jl.update(rest)["total_loss"])


def _fragment(rng, T=7, B=3, obs_dim=4):
    dones = np.zeros((T, B), np.float32)
    truncs = np.zeros((T, B), np.float32)
    dones[2, 0] = dones[4, 1] = dones[6, 2] = 1.0   # inside and at the tail
    truncs[4, 1] = 1.0                               # a truncation
    return {
        "obs": rng.standard_normal((T, B, obs_dim)).astype(np.float32),
        "last_obs": rng.standard_normal((1, B, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, 2, (T, B)),
        "rewards": rng.standard_normal((T, B)).astype(np.float32),
        "logp": np.log(rng.uniform(0.2, 0.8, (T, B))).astype(np.float32),
        "dones": dones,
        "terminateds": np.maximum(dones - truncs, 0.0),
        "behavior_next_vf": rng.standard_normal((T, B)).astype(np.float32),
    }


def test_vtrace_matches_reference_with_ends_inside_the_fragment():
    rng = np.random.default_rng(10)
    frag = _fragment(rng, T=9, B=4)
    args = dict(
        behavior_logp=frag["logp"],
        target_logp=np.log(rng.uniform(0.1, 0.9, (9, 4))).astype(np.float32),
        rewards=frag["rewards"], terminateds=frag["terminateds"],
        dones=frag["dones"],
        values=rng.standard_normal((9, 4)).astype(np.float32),
        next_values=rng.standard_normal((9, 4)).astype(np.float32))
    for clip_rho, clip_c in ((1.0, 1.0), (2.0, 0.5)):
        want = j_impala.vtrace_returns(
            **{k: jnp.asarray(v) for k, v in args.items()}, gamma=0.97,
            clip_rho_threshold=clip_rho, clip_c_threshold=clip_c)
        got = t_impala.vtrace_returns(
            **{k: torch.from_numpy(v) for k, v in args.items()}, gamma=0.97,
            clip_rho_threshold=clip_rho, clip_c_threshold=clip_c)
        for g, w, name in zip(got, want, ("vs", "pg_advantages")):
            assert not g.requires_grad
            _close(g, w, TOL, name)


@pytest.mark.parametrize("algo", ["impala", "appo"])
def test_impala_and_appo_losses_and_updates_match_reference(algo):
    jmod_spec = t_rlm.SpecDict(4, 2)
    jmod, _, tmod, _ = _carry_module(jmod_spec)
    if algo == "impala":
        jl = j_impala.IMPALALearner(jmod, j_impala.IMPALAConfig(), seed=0)
        tl = t_impala.IMPALALearner(tmod, t_impala.IMPALAConfig(device="cpu"))
    else:
        over = dict(target_update_frequency=100, use_kl_loss=True)
        jl = j_appo.APPOLearner(jmod, j_appo.APPOConfig(**over), seed=0)
        tl = t_appo.APPOLearner(tmod, t_appo.APPOConfig(device="cpu", **over))
        # A target net other than the learner's, so the anchor shows.
        other = jmod.init_params(jax.random.PRNGKey(1))
        jl.target_params = other
        tl.target_net.load_state_dict(t_rlm.params_from_jax(_np_tree(other)))
    tl.set_weights(t_rlm.params_from_jax(_np_tree(jl.params)))
    batch = _fragment(np.random.default_rng(11))
    jb = jax.tree.map(jnp.asarray, batch)
    if algo == "impala":
        jloss, jm = jl.compute_loss(jl.params, jb)
    else:
        jloss, jm = jl._appo_loss(jl.params, jl.target_params, jb)
    tloss, tm = tl.compute_loss(tl.net, _torch_batch(batch))
    _close(tloss, jloss, TOL, "loss")
    assert set(tm) == set(jm)
    for k in jm:
        _close(tm[k], jm[k], TOL, k)
    want, got = jl.update(batch), tl.update(batch)
    for k in want:
        _close(got[k], want[k], TOL, k)
    _state_close(tl.get_weights(), t_rlm.params_from_jax(_np_tree(jl.params)))
    if algo == "appo":  # the target stays until sync_target
        _state_close(
            {k: v for k, v in tl.get_state()["target_params"].items()},
            t_rlm.params_from_jax(_np_tree(jl.target_params)))
        tl.sync_target()
        _state_close(tl.get_state()["target_params"], tl.get_weights(), 0.0)


@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_loss_and_update_match_reference(double_q):
    spec = t_rlm.SpecDict(4, 3)
    jmod = j_dqn.QModule(j_rlm.SpecDict(4, 3), hidden=(16, 16))
    tmod = t_dqn.QModule(spec, hidden=(16, 16))
    jl = j_dqn.DQNLearner(jmod, j_dqn.DQNConfig(double_q=double_q), seed=0)
    tl = t_dqn.DQNLearner(tmod, t_dqn.DQNConfig(double_q=double_q,
                                                device="cpu"))
    tl.set_weights(t_dqn.QModule.params_from_jax(_np_tree(jl.params)))
    # A target network other than the online one.
    other = jmod.init_params(jax.random.PRNGKey(1))
    jl.target_net = other["net"]
    tl.target_net.load_state_dict(t_dqn.QModule.params_from_jax(
        _np_tree(other)))
    rng = np.random.default_rng(12)
    n = 48
    batch = {
        "obs": rng.standard_normal((n, 4)).astype(np.float32),
        "next_obs": rng.standard_normal((n, 4)).astype(np.float32),
        "actions": rng.integers(0, 3, n),
        "rewards": rng.standard_normal(n).astype(np.float32),
        "dones": rng.random(n) < 0.3,
        "weights": rng.uniform(0.2, 1.0, n).astype(np.float32),
    }
    _assert_no_near_ties(jmod.q_values(jl.params["net"],
                                       jnp.asarray(batch["next_obs"])))
    jloss, (jtd, jq) = jl._td_loss(jl.params, jl.target_net,
                                   jax.tree.map(jnp.asarray, batch))
    tloss, ttd, tq = tl._td_loss(tl.net, _torch_batch(batch))
    _close(tloss, jloss, TOL, "loss")
    _close(ttd, jtd, TOL, "td")
    _close(tq, jq, TOL, "q_mean")
    want, want_td = jl.update_dqn(batch)
    got, got_td = tl.update_dqn(batch)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], TOL, k)
    _close(got_td, want_td, TOL, "|td|")
    _state_close(tl.get_weights(),
                 t_dqn.QModule.params_from_jax(_np_tree(jl.params)))


def test_dqn_exploration_follows_epsilon_in_the_weights():
    tmod = t_dqn.QModule(t_rlm.SpecDict(4, 3), hidden=(16, 16))
    net = tmod.build("cpu", seed=0)
    obs = np.random.default_rng(13).standard_normal((256, 4)).astype(
        np.float32)
    greedy = tmod.forward_inference(net, obs)["actions"]
    for eps, lo, hi in ((0.0, 1.0, 1.0), (1.0, 0.2, 0.5)):
        weights = net.state_dict()
        weights["epsilon"] = torch.tensor(eps)
        net.load_state_dict(weights)
        out = tmod.forward_exploration(net, obs,
                                       t_rlm.make_generator("cpu", 1))
        same = (out["actions"] == greedy).float().mean().item()
        assert lo <= same <= hi, (eps, same)
        assert torch.equal(out["logp"], torch.zeros(256))


# --------------------------------------------------------------------------
# Offline IO and BC
# --------------------------------------------------------------------------


class _Rows:
    """What `iter_learner_batches` reads of a Dataset: its rows."""

    def __init__(self, rows):
        self.rows = rows

    def take_all(self):
        return list(self.rows)


def _experience(rng, n, obs_dim=4, n_actions=2):
    return {"obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
            "actions": rng.integers(0, n_actions, n),
            "rewards": rng.standard_normal(n).astype(np.float32),
            "dones": rng.uniform(size=n) < 0.1,
            "logp": np.log(rng.uniform(0.2, 0.8, n)).astype(np.float32)}


@pytest.mark.parametrize("seed", [0, 5])
def test_bc_rows_and_learner_batches_match_reference(seed):
    # Row conversion is the reference's numpy code and the shuffled
    # minibatch order comes from the same seeded permutation: both exact.
    batch = _experience(np.random.default_rng(3), 50)
    rows = t_off.batch_to_rows(batch)
    assert rows == j_off.batch_to_rows(batch)
    for k, v in t_off.rows_to_batch(rows).items():
        want = j_off.rows_to_batch(rows)[k]
        assert v.dtype == want.dtype, k
        np.testing.assert_array_equal(v, want)
    got = list(t_off.iter_learner_batches(_Rows(rows), 16, seed=seed))
    want = list(j_off.iter_learner_batches(_Rows(rows), 16, seed=seed))
    assert [len(b["obs"]) for b in got] == [16, 16, 16, 2]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_bc_learner_loss_and_update_match_reference():
    jcfg = j_off.BCConfig(obs_dim=4, n_actions=2, hidden=(16, 16))
    tcfg = t_off.BCConfig(obs_dim=4, n_actions=2, hidden=(16, 16),
                          device="cpu")
    spec = t_rlm.SpecDict(4, 2)
    jmod, _, tmod, _ = _carry_module(spec)
    jl = j_off.BCLearner(jmod, jcfg, seed=0)
    tl = t_off.BCLearner(tmod, tcfg, seed=0)
    tl.set_weights(t_rlm.params_from_jax(_np_tree(jl.params)))
    exp = _experience(np.random.default_rng(4), 64)
    batch = {"obs": exp["obs"], "actions": exp["actions"]}
    jloss, jm = jl.compute_loss(jl.params, jax.tree.map(jnp.asarray, batch))
    tloss, tm = tl.compute_loss(tl.net, _torch_batch(batch))
    _close(tloss, jloss, TOL, "loss")
    for k in jm:
        _close(tm[k], jm[k], TOL, k)
    want = jl.update(batch)
    got = tl.update(batch)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], TOL, k)
    _state_close(tl.get_weights(), t_rlm.params_from_jax(_np_tree(jl.params)))
