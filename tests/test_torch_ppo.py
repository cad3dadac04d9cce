"""PPO and A2C of the port against the JAX package's, on the CPU.

- ``envs/classic.py``'s CartPole against ``gymnasium.make("CartPole-v1")``,
  bit for bit, and the episode statistics and velocity mask of ``make_env``;
- the agent's forward from converted parameters, ``policy_output``, the
  losses and GAE against the JAX functions on the same numpy inputs;
- one PPO train phase against the JAX ``make_train_phase`` program with the
  same permutations, and one A2C train phase against the JAX update rebuilt
  from the JAX package's functions (its ``train_phase`` is local to ``main``);
- the CLI: ``exp=ppo`` and ``exp=a2c`` train, resume and evaluate, and a
  checkpoint written by the JAX package's code resumes in the port.

Tolerances: 1e-6 where both sides compute the same float32 expression
(reductions in another order cost a few ulps of values of order 1); 1e-5
for parameters after a train phase (eight Adam updates of size ~lr = 1e-3
through different matmul kernels).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import numpy_tree

ATOL = 1e-6
PARAM_ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(ours, theirs, atol=ATOL, rtol=0.0):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    np.testing.assert_allclose(ours, np.asarray(theirs), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------------
# CartPole
# ---------------------------------------------------------------------------------
def _balance(obs):
    return int(obs[2] + 0.5 * obs[3] > 0)


@pytest.mark.parametrize(
    "seed,policy", [(0, "fixed"), (7, "fixed"), (123, "fixed"), (3, "balance")], ids=["0", "7", "123", "balance"]
)
def test_cartpole_steps_bitwise_like_gymnasium(seed, policy):
    """500 steps (a fixed random action sequence; or a balancing controller
    that reaches the 500-step truncation), resets without a seed in between:
    observations, rewards and flags are bitwise equal."""
    import gymnasium as gym

    from sheeprl_tpu_torch.envs.classic import make

    ours, theirs = make("CartPole-v1"), gym.make("CartPole-v1")
    o1, _ = ours.reset(seed=seed)
    o2, _ = theirs.reset(seed=seed)
    actions = np.random.default_rng(seed).integers(0, 2, 500)
    truncations = 0
    for t in range(500):
        assert o1.dtype == o2.dtype == np.float32 and np.array_equal(o1, o2)
        action = int(actions[t]) if policy == "fixed" else _balance(o2)
        o1, r1, term1, trunc1, _ = ours.step(action)
        o2, r2, term2, trunc2, _ = theirs.step(action)
        assert (r1, term1, trunc1) == (r2, term2, trunc2) and type(r1) is type(r2)
        truncations += trunc2
        if term2 or trunc2:
            o1, _ = ours.reset()
            o2, _ = theirs.reset()
    assert truncations == (1 if policy == "balance" else 0)


def test_make_env_gives_gymnasium_episode_statistics_and_masks():
    """The port's vector env over ``make_env`` against gymnasium's SAME_STEP
    vector env over the JAX package's ``make_env``: observations (velocities
    masked) and the final infos' episode returns and lengths."""
    import gymnasium as gym

    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.utils.env import make_env as jax_make_env
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs.vector import SyncVectorEnv, episode_stats
    from sheeprl_tpu_torch.utils.env import make_env

    ov = ["exp=ppo", "fabric.accelerator=cpu", "env.capture_video=False", "env.mask_velocities=True"]
    cfg, cfg_jax = compose(ov), jax_compose(ov)
    ours = SyncVectorEnv([make_env(cfg, 10 + i, 0, vector_env_idx=i) for i in range(3)])
    theirs = gym.vector.SyncVectorEnv(
        [jax_make_env(cfg_jax, 10 + i, 0, vector_env_idx=i) for i in range(3)],
        autoreset_mode=gym.vector.AutoresetMode.SAME_STEP,
    )
    o1, _ = ours.reset(seed=4)
    o2, _ = theirs.reset(seed=4)
    rng = np.random.default_rng(5)
    episodes = 0
    for _ in range(120):
        np.testing.assert_array_equal(o1["state"], o2["state"])
        assert not o1["state"][:, [1, 3]].any()
        action = rng.integers(0, 2, 3)
        o1, r1, t1, u1, i1 = ours.step(action)
        o2, r2, t2, u2, i2 = theirs.step(action)
        for a, b in zip((r1, t1, u1), (r2, t2, u2)):
            np.testing.assert_array_equal(a, b)
        (rews1, lens1), (rews2, lens2) = episode_stats(i1, 3), episode_stats(i2, 3)
        np.testing.assert_array_equal(rews1, rews2)
        np.testing.assert_array_equal(lens1, lens2)
        episodes += len(rews2)
    assert episodes >= 10


# ---------------------------------------------------------------------------------
# the agent, its distributions, the losses, GAE
# ---------------------------------------------------------------------------------
CASES = {
    "cartpole": (["exp=ppo"], (2,), False),
    "discrete-pixels": (
        ["exp=ppo", "env=dummy", "env.id=discrete_dummy", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]",
         "algo.layer_norm=True"],
        (2,), False,
    ),
    "multidiscrete": (["exp=ppo", "env=dummy", "env.id=multidiscrete_dummy", "algo.mlp_keys.encoder=[state]"], (2, 2), False),
    "continuous": (["exp=ppo", "env=dummy", "env.id=continuous_dummy", "algo.mlp_keys.encoder=[state]"], (2,), True),
    "a2c": (["exp=a2c"], (2,), False),
}


@functools.lru_cache(maxsize=None)
def _jax_ppo(case: str, extra=()):
    """The JAX agent, params (numpy), config and observation space of a case."""
    from sheeprl_tpu.algos.ppo.agent import build_agent as jax_build_agent
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
    from sheeprl_tpu.utils.env import make_env as jax_make_env

    ov, actions_dim, is_continuous = CASES[case]
    cfg = jax_compose([*ov, "fabric.accelerator=cpu", "env.capture_video=False", *extra])
    space = jax_make_env(cfg, 0, 0)().observation_space
    fabric = JaxFabric(devices=1, accelerator="cpu")
    fabric._setup()
    agent, params = jax_build_agent(fabric, actions_dim, is_continuous, cfg, space, jax.random.PRNGKey(1))
    return agent, numpy_tree(params), cfg, space


def _pair(case: str, extra=()):
    """(jax agent, params, torch agent loaded from them, jax cfg, torch cfg)."""
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric

    jagent, params, cfg_jax, space = _jax_ppo(case, tuple(extra))
    ov, actions_dim, is_continuous = CASES[case]
    cfg = compose([*ov, "fabric.accelerator=cpu", "env.capture_video=False", *extra])
    agent = build_agent(Fabric(accelerator="cpu"), actions_dim, is_continuous, cfg, space, 0, params)
    return jagent, params, agent, cfg_jax, cfg


def _obs(rng, space, batch):
    return {
        k: (rng.integers(0, 256, (*batch, *s.shape)).astype(np.float32) if len(s.shape) > 1
            else rng.standard_normal((*batch, *s.shape)).astype(np.float32))
        for k, s in space.spaces.items()
    }


@pytest.mark.parametrize("case", list(CASES))
def test_agent_forward_matches_from_converted_params(case):
    from sheeprl_tpu.algos.ppo.utils import normalize_obs as jax_normalize
    from sheeprl_tpu_torch.algos.ppo.utils import normalize_obs
    from sheeprl_tpu_torch.interop.flax_to_torch import ppo_to_flax

    jagent, params, agent, cfg_jax, cfg = _pair(case)
    cnn, keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder)
    obs = {k: v for k, v in _obs(np.random.default_rng(0), _jax_ppo(case)[3], (5,)).items() if k in keys}
    j_outs, j_values = jagent.apply({"params": params}, jax_normalize({k: jnp.asarray(v) for k, v in obs.items()}, cnn, keys))
    outs, values = agent(normalize_obs({k: _t(v) for k, v in obs.items()}, cnn, keys))
    assert len(outs) == len(j_outs)
    for a, b in zip(outs, j_outs):
        _close(a, b)
    _close(values, j_values)
    # and back: the port's tree is the JAX package's
    assert jax.tree_util.tree_structure(ppo_to_flax(agent)) == jax.tree_util.tree_structure(params)


@pytest.mark.parametrize("actions_dim,is_continuous", [((3,), False), ((2, 3), False), ((2,), True)],
                         ids=["discrete", "multidiscrete", "continuous"])
def test_policy_output_logprob_and_entropy(actions_dim, is_continuous):
    """Log-probs and entropies of given actions, and a sample drawn with the
    same noise the JAX key gives (Gumbel-max, a reparameterised normal)."""
    from sheeprl_tpu.algos.ppo.agent import policy_output as jax_policy_output
    from sheeprl_tpu_torch.algos.ppo.agent import policy_output

    rng = np.random.default_rng(3)
    n = 6
    heads = [2 * sum(actions_dim)] if is_continuous else list(actions_dim)
    outs = [rng.standard_normal((n, h)).astype(np.float32) for h in heads]
    values = rng.standard_normal((n, 1)).astype(np.float32)
    if is_continuous:
        actions = rng.standard_normal((n, sum(actions_dim))).astype(np.float32)
    else:
        actions = np.concatenate([np.eye(d, dtype=np.float32)[rng.integers(0, d, n)] for d in actions_dim], -1)
    theirs = jax_policy_output([jnp.asarray(o) for o in outs], jnp.asarray(values), jax.random.PRNGKey(0),
                               actions_dim, is_continuous, actions=jnp.asarray(actions))
    ours = policy_output([_t(o) for o in outs], _t(values), actions_dim, is_continuous, actions=_t(actions))
    for k in ("logprob", "entropy", "actions", "values"):
        _close(ours[k], theirs[k])
    # sampling: the noise the JAX key draws, given to the port
    key = jax.random.PRNGKey(4)
    theirs = jax_policy_output([jnp.asarray(o) for o in outs], jnp.asarray(values), key, actions_dim, is_continuous)
    if is_continuous:
        noise = np.asarray(jax.random.normal(key, (n, sum(actions_dim))))
    else:
        keys = jax.random.split(key, len(actions_dim))
        noise = np.concatenate([np.asarray(jax.random.gumbel(k, (n, d))) for k, d in zip(keys, actions_dim)], -1)
    ours = policy_output([_t(o) for o in outs], _t(values), actions_dim, is_continuous, noise=_t(noise))
    for k in ("actions", "logprob", "entropy"):
        _close(ours[k], theirs[k], atol=1e-5 if is_continuous else ATOL)
    greedy = policy_output([_t(o) for o in outs], _t(values), actions_dim, is_continuous, greedy=True)
    theirs = jax_policy_output([jnp.asarray(o) for o in outs], jnp.asarray(values), key, actions_dim, is_continuous, greedy=True)
    _close(greedy["actions"], theirs["actions"])


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_ppo_and_a2c_losses(reduction):
    """Within 1e-6, absolute or relative: a sum of 16 terms of order 1 is
    ~25, where one float32 ulp is 1.9e-6."""
    from sheeprl_tpu.algos.a2c import loss as jax_a2c
    from sheeprl_tpu.algos.ppo import loss as jax_ppo
    from sheeprl_tpu_torch.algos.a2c import loss as a2c
    from sheeprl_tpu_torch.algos.ppo import loss as ppo

    rng = np.random.default_rng(5)
    new_lp, old_lp, adv, new_v, old_v, ret, ent = (rng.standard_normal((16, 1)).astype(np.float32) for _ in range(7))
    j = {k: jnp.asarray(v) for k, v in dict(new_lp=new_lp, old_lp=old_lp, adv=adv, new_v=new_v, old_v=old_v, ret=ret, ent=ent).items()}
    _close(ppo.policy_loss(_t(new_lp), _t(old_lp), _t(adv), 0.2, reduction),
           jax_ppo.policy_loss(j["new_lp"], j["old_lp"], j["adv"], 0.2, reduction), rtol=ATOL)
    for clip_vloss in (False, True):
        _close(ppo.value_loss(_t(new_v), _t(old_v), _t(ret), 0.2, clip_vloss, reduction),
               jax_ppo.value_loss(j["new_v"], j["old_v"], j["ret"], 0.2, clip_vloss, reduction), rtol=ATOL)
    _close(ppo.entropy_loss(_t(ent), reduction), jax_ppo.entropy_loss(j["ent"], reduction), rtol=ATOL)
    _close(a2c.policy_loss(_t(new_lp), _t(adv), reduction), jax_a2c.policy_loss(j["new_lp"], j["adv"], reduction), rtol=ATOL)
    _close(a2c.value_loss(_t(new_v), _t(ret), reduction), jax_a2c.value_loss(j["new_v"], j["ret"], reduction), rtol=ATOL)


def test_gae_and_the_small_helpers():
    from sheeprl_tpu.utils.utils import gae as jax_gae
    from sheeprl_tpu.utils.utils import normalize_tensor as jax_normalize_tensor
    from sheeprl_tpu.utils.utils import polynomial_decay as jax_polynomial_decay
    from sheeprl_tpu_torch.utils.utils import gae, normalize_tensor, polynomial_decay

    rng = np.random.default_rng(6)
    T, B = 12, 3
    rewards, values = rng.standard_normal((T, B, 1)).astype(np.float32), rng.standard_normal((T, B, 1)).astype(np.float32)
    dones = (rng.uniform(size=(T, B, 1)) < 0.2).astype(np.float32)
    next_value = rng.standard_normal((B, 1)).astype(np.float32)
    theirs = jax_gae(jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(dones), jnp.asarray(next_value), T, 0.99, 0.95)
    ours = gae(_t(rewards), _t(values), _t(dones), _t(next_value), T, 0.99, 0.95)
    for a, b in zip(ours, theirs):
        _close(a, b)
    mask = (rng.uniform(size=(T, B, 1)) < 0.7).astype(np.float32)
    _close(normalize_tensor(_t(rewards)), jax_normalize_tensor(jnp.asarray(rewards)))
    _close(normalize_tensor(_t(rewards), mask=_t(mask)), jax_normalize_tensor(jnp.asarray(rewards), mask=jnp.asarray(mask)))
    for step in (0, 3, 10, 11):
        assert polynomial_decay(step, initial=0.2, final=0.0, max_decay_steps=10) == jax_polynomial_decay(
            step, initial=0.2, final=0.0, max_decay_steps=10
        )


# ---------------------------------------------------------------------------------
# train phases
# ---------------------------------------------------------------------------------
# 2 envs x 8 steps = 16 rows in minibatches of 4: 2 epochs x 4 minibatches
PHASE = ["env.num_envs=2", "algo.rollout_steps=8", "algo.per_rank_batch_size=4", "algo.update_epochs=2"]


def _rollout(rng, space, actions_dim, T=8, E=2, with_logprobs=True):
    data = {k: v for k, v in _obs(rng, space, (T, E)).items()}
    data["actions"] = np.concatenate([np.eye(d, dtype=np.float32)[rng.integers(0, d, (T, E))] for d in actions_dim], -1)
    data["values"] = rng.standard_normal((T, E, 1)).astype(np.float32)
    data["rewards"] = rng.standard_normal((T, E, 1)).astype(np.float32)
    data["dones"] = (rng.uniform(size=(T, E, 1)) < 0.15).astype(np.float32)
    if with_logprobs:
        data["logprobs"] = -rng.uniform(0.1, 1.5, (T, E, 1)).astype(np.float32)
    return data, rng.standard_normal((E, 1)).astype(np.float32)


@pytest.mark.parametrize(
    "extra",
    [
        [],
        ["algo.normalize_advantages=True", "algo.clip_vloss=True", "algo.max_grad_norm=0.5", "algo.anneal_lr=True",
         "algo.ent_coef=0.01"],
    ],
    ids=["defaults", "clip-normalize-anneal"],
)
def test_ppo_train_phase_matches_make_train_phase(extra):
    from sheeprl_tpu.algos.ppo.ppo import _build_optimizer, make_train_phase
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
    from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainer, build_optimizer
    from sheeprl_tpu_torch.interop.flax_to_torch import ppo_to_flax

    jagent, params, agent, cfg_jax, cfg = _pair("cartpole", tuple(PHASE + extra))
    total_iters = 4
    tx = _build_optimizer(cfg_jax, total_iters)
    fabric = JaxFabric(devices=1, accelerator="cpu")
    fabric._setup()
    obs_keys = list(cfg_jax.algo.mlp_keys.encoder)
    train_phase = make_train_phase(jagent, cfg_jax, fabric, tx, (2,), False, [], obs_keys, 2)
    data, next_values = _rollout(np.random.default_rng(7), _jax_ppo("cartpole")[3], (2,))
    key = jax.random.PRNGKey(8)
    clip_coef, ent_coef = 0.2, float(cfg.algo.ent_coef)
    new_params, _, losses, _ = train_phase(params, tx.init(params), {k: jnp.asarray(v) for k, v in data.items()},
                                           jnp.asarray(next_values), key, clip_coef, ent_coef)
    perms = [torch.from_numpy(np.asarray(jax.random.permutation(k, 16)).astype(np.int64))
             for k in jax.random.split(key, 2)]
    optimizer, schedule = build_optimizer(cfg, agent, total_iters)
    trainer = PPOTrainer(agent, optimizer, cfg, schedule)
    assert (trainer.num_minibatches, trainer.batch_size) == (4, 4)
    ours = trainer.train_phase({k: _t(v) for k, v in data.items()}, _t(next_values), perms, clip_coef, ent_coef)
    _close(ours, losses, atol=PARAM_ATOL)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ppo_to_flax(agent)),
                            jax.tree_util.tree_leaves(numpy_tree(new_params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL, err_msg=jax.tree_util.keystr(path))


def test_a2c_train_phase_matches_the_jax_update():
    """The JAX A2C update (GAE, the summed losses over the whole rollout, the
    clip + RMSprop chain), rebuilt from the JAX package's own functions."""
    import optax

    from sheeprl_tpu.algos.a2c.loss import policy_loss as jax_pg
    from sheeprl_tpu.algos.a2c.loss import value_loss as jax_vl
    from sheeprl_tpu.algos.ppo.agent import policy_output as jax_policy_output
    from sheeprl_tpu.config import instantiate as jax_instantiate
    from sheeprl_tpu.utils.utils import gae as jax_gae
    from sheeprl_tpu_torch.algos.a2c.a2c import A2CTrainer
    from sheeprl_tpu_torch.config import instantiate
    from sheeprl_tpu_torch.interop.flax_to_torch import ppo_to_flax

    jagent, params, agent, cfg_jax, cfg = _pair("a2c", ("env.num_envs=2",))
    T = int(cfg.algo.rollout_steps)
    data, next_values = _rollout(np.random.default_rng(9), _jax_ppo("a2c", ("env.num_envs=2",))[3], (2,), T=T,
                                 with_logprobs=False)
    tx = optax.chain(optax.clip_by_global_norm(cfg_jax.algo.max_grad_norm), jax_instantiate(cfg_jax.algo.optimizer))

    @jax.jit
    def jax_train_phase(params, opt_state, data, next_values):
        returns, advantages = jax_gae(data["rewards"], data["values"], data["dones"], next_values, T,
                                      cfg_jax.algo.gamma, cfg_jax.algo.gae_lambda)
        batch = {k: v.reshape(-1, *v.shape[2:]) for k, v in data.items()}

        def loss_fn(params):
            outs, values = jagent.apply({"params": params}, {"state": batch["state"]})
            out = jax_policy_output(outs, values, jax.random.PRNGKey(0), (2,), False, actions=batch["actions"])
            pg = jax_pg(out["logprob"], advantages.reshape(-1, 1), "sum")
            vl = jax_vl(out["values"], returns.reshape(-1, 1), "sum")
            return pg + vl, (pg, vl)

        grads, (pg, vl) = jax.grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), jnp.stack([pg, vl])

    new_params, losses = jax_train_phase(params, tx.init(params), {k: jnp.asarray(v) for k, v in data.items()},
                                         jnp.asarray(next_values))
    trainer = A2CTrainer(agent, instantiate(cfg.algo.optimizer, agent.parameters()), cfg)
    ours = trainer.train_phase({k: _t(v) for k, v in data.items()}, _t(next_values))
    _close(ours, losses, atol=PARAM_ATOL)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ppo_to_flax(agent)),
                            jax.tree_util.tree_leaves(numpy_tree(new_params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL, err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------------
PPO_TINY = ["exp=ppo", "fabric.accelerator=cpu", "env.capture_video=False", *PHASE, "checkpoint.every=16",
            "metric.log_every=16", "root_dir=tiny", "run_name=run"]
A2C_TINY = ["exp=a2c", "fabric.accelerator=cpu", "env.capture_video=False", "env.num_envs=2", "checkpoint.every=20",
            "metric.log_every=20", "root_dir=tiny", "run_name=run"]


@pytest.mark.parametrize("algo", ["ppo", "a2c"])
def test_cli_trains_resumes_and_evaluates(algo, tmp_path, capsys):
    """Train (logging every scalar), resume from the last checkpoint into
    version_1 with its optimizer state, then evaluate it."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from sheeprl_tpu_torch.__main__ import main
    from sheeprl_tpu_torch.cli import run

    tiny = PPO_TINY if algo == "ppo" else A2C_TINY
    first = run(tiny + ["algo.total_steps=32" if algo == "ppo" else "algo.total_steps=40"])
    ckpt = tmp_path / first["checkpoint"]
    assert first["train_phases"] == (2 if algo == "ppo" else 4) and ckpt.is_file()
    assert all(np.isfinite(v) for v in first["metrics"].values()) and first["test_reward"] is not None
    ea = EventAccumulator(str(tmp_path / first["log_dir"]))
    ea.Reload()
    tags = set(ea.Tags()["scalars"])
    assert {"Loss/policy_loss", "Loss/value_loss", "Time/sps_train", "Time/sps_env_interaction",
            "Test/cumulative_reward"} <= tags
    assert ("Loss/entropy_loss" in tags) == (algo == "ppo")
    resumed = run(tiny + ["algo.total_steps=64" if algo == "ppo" else "algo.total_steps=60",
                          f"checkpoint.resume_from={ckpt}"])
    assert resumed["log_dir"].endswith("version_1") and resumed["train_phases"] == (2 if algo == "ppo" else 2)
    capsys.readouterr()
    assert main(["evaluation", f"checkpoint_path={ckpt}", "fabric.accelerator=cpu"]) == 0
    assert "Test - Reward:" in capsys.readouterr().out


def test_a_jax_ppo_checkpoint_resumes_in_the_port(tmp_path):
    """A run dir written by the JAX package's code (its config.yaml, and a
    checkpoint holding Flax params and the optax clip + Adam + schedule state
    after one update) resumes in the port: the agent and the optimizer's
    moments and schedule count come back, then it trains."""
    import optax
    import yaml

    from sheeprl_tpu.algos.ppo.ppo import _build_optimizer
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
    from sheeprl_tpu_torch.cli import run

    extra = ["algo.anneal_lr=True", "algo.max_grad_norm=0.5"]
    cfg_jax = jax_compose(PPO_TINY + extra + ["algo.total_steps=32"])
    _, params, _, _ = _jax_ppo("cartpole")
    tx = _build_optimizer(cfg_jax, 2)
    grads = jax.tree_util.tree_map(lambda x: np.ones_like(x), params)
    updates, opt_state = jax.jit(tx.update)(grads, tx.init(params), params)
    params = numpy_tree(optax.apply_updates(params, updates))
    run_dir = tmp_path / "jax_run" / "version_0"
    ckpt = run_dir / "checkpoint" / "ckpt_16_0.ckpt"
    jax_save_checkpoint(str(ckpt), {"agent": params, "optimizer": opt_state, "iter_num": 1, "batch_size": 4,
                                    "last_log": 16, "last_checkpoint": 16})
    (run_dir / "config.yaml").write_text(yaml.safe_dump(cfg_jax.as_dict()))
    resumed = run(PPO_TINY + extra + ["algo.total_steps=32", f"checkpoint.resume_from={ckpt}"])
    assert resumed["train_phases"] == 1 and resumed["policy_steps"] == 32
    assert all(np.isfinite(v) for v in resumed["metrics"].values())
