"""The port's optimizers against optax, and optax states carried into them.

- ``rmsprop`` is ``optax.rmsprop`` (eps inside the square root), plain,
  centered and with momentum, step for step; ``torch.optim.RMSprop`` is not.
- An optax state of the JAX package, written to a checkpoint by the JAX
  package's own ``save_checkpoint``, is converted on load: after one more
  update from identical gradients, the port's parameters equal the JAX ones.
  Cases: Dreamer-V3's three clipped Adam optimizers, PPO's
  clip + Adam chain with and without ``anneal_lr``, A2C's clip + RMSprop.

Gradients and parameters are made with numpy from a seed; both sides run in
float32 on the CPU.
"""

from __future__ import annotations

import jax
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from sheeprl_tpu_torch.optim import RMSprop, rmsprop
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_helpers import numpy_tree, paired_agents

SHAPES = [(5, 3), (3,), (2, 2, 4)]


def _grads(rng, shapes, scale=1.0):
    return [(scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]


# -- rmsprop ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "kw",
    [
        dict(centered=False, momentum=0.0),
        dict(centered=True, momentum=0.0),
        dict(centered=False, momentum=0.9),
        dict(centered=True, momentum=0.9, weight_decay=0.01),
    ],
    ids=["plain", "centered", "momentum", "centered-momentum-decay"],
)
def test_rmsprop_is_optax_rmsprop(kw):
    """Five steps from the same gradients, A2C's lr 1e-3 and eps 1e-4 (where
    the two eps rules differ most: nu starts at 0). Tolerance 1e-6: float32
    rsqrt and fused multiply-adds may round differently on each side."""
    from sheeprl_tpu.optim import rmsprop as jax_rmsprop

    rng = np.random.default_rng(0)
    init = _grads(rng, SHAPES)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = rmsprop(params, lr=1e-3, alpha=0.99, eps=1e-4, **kw)
    tx = jax_rmsprop(lr=1e-3, alpha=0.99, eps=1e-4, **kw)
    jparams = [jax.numpy.asarray(p) for p in init]
    state = tx.init(jparams)
    for _ in range(5):
        grads = _grads(rng, SHAPES)
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        updates, state = tx.update([jax.numpy.asarray(g) for g in grads], state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, j in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), rtol=0, atol=1e-6)


def test_torch_rmsprop_is_another_function():
    """``torch.optim.RMSprop`` divides by ``sqrt(nu) + eps``: its first step at
    A2C's settings is ~10x the optax step for a gradient of 1e-3, so it must
    not stand in for the port's ``rmsprop``."""
    g = np.full((4,), 1e-3, np.float32)
    ours = torch.nn.Parameter(torch.zeros(4))
    theirs = torch.nn.Parameter(torch.zeros(4))
    opt, torch_opt = RMSprop([ours], lr=1e-3, alpha=0.99, eps=1e-4), torch.optim.RMSprop([theirs], lr=1e-3, alpha=0.99, eps=1e-4)
    for p, o in ((ours, opt), (theirs, torch_opt)):
        p.grad = torch.from_numpy(g.copy())
        o.step()
    tx = optax.rmsprop(1e-3, decay=0.99, eps=1e-4)
    updates, _ = tx.update(jax.numpy.asarray(g), tx.init(jax.numpy.zeros(4)))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(updates), rtol=1e-6)
    assert abs(float(theirs.detach()[0]) / float(ours.detach()[0])) > 5


# -- optax states into torch -------------------------------------------------------------
def _jax_step(tx, params, grads, state):
    updates, state = jax.jit(tx.update)(grads, state, params)
    return numpy_tree(optax.apply_updates(params, updates)), state


def _via_checkpoint(tmp_path, state):
    """``state`` written by the JAX package's checkpoint code, read by the port's."""
    path = str(tmp_path / "ckpt_0_0.ckpt")
    jax_save_checkpoint(path, {"optimizer": state})
    return load_checkpoint(path)["optimizer"]


def _assert_trees_close(ours, theirs, atol):
    flat_ours = jax.tree_util.tree_leaves_with_path(ours)
    flat_theirs = dict(jax.tree_util.tree_leaves_with_path(theirs))
    assert len(flat_ours) == len(flat_theirs)
    for path, leaf in flat_ours:
        np.testing.assert_allclose(leaf, flat_theirs[path], rtol=0, atol=atol, err_msg=jax.tree_util.keystr(path))


def test_dreamer_v3_optax_states_resume_in_the_port(tmp_path):
    """The three DV3 optimizers (clip + Adam each): one JAX update, the state
    through a checkpoint into ``DV3Trainer.load_opt_state``, then one more
    update on each side from the same gradients. Parameters within 1e-6:
    Adam's update is ~lr = 1e-4 per weight, computed in float32 on both."""
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import build_optimizers as jax_build_optimizers
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, build_optimizers
    from sheeprl_tpu_torch.interop.flax_to_torch import agent_to_flax, dv3_group_to_torch, load_flax_params

    _, params, agent, cfg_jax, cfg_torch = paired_agents("discrete")
    world_tx, actor_tx, critic_tx, opt_state = jax_build_optimizers(cfg_jax, params)
    txs = {"world_model": world_tx, "actor": actor_tx, "critic": critic_tx}
    rng = np.random.default_rng(1)

    def grads_like(tree):
        return jax.tree_util.tree_map(lambda x: rng.standard_normal(x.shape).astype(np.float32), tree)

    states = {}
    for name, tx in txs.items():
        params[name], states[name] = _jax_step(tx, params[name], grads_like(params[name]), opt_state[name])
    load_flax_params(agent, params)
    trainer = DV3Trainer(agent, cfg_torch, build_optimizers(cfg_torch, agent))
    trainer.load_opt_state(_via_checkpoint(tmp_path, states))
    for name, tx in txs.items():
        grads = grads_like(params[name])
        params[name], _ = _jax_step(tx, params[name], grads, states[name])
        trainer.apply_grads(name, dv3_group_to_torch(agent, name)(grads))
    ours = agent_to_flax(agent)
    for name in txs:
        _assert_trees_close(ours[name], params[name], atol=1e-6)


def _ppo_pair(extra):
    from sheeprl_tpu.algos.ppo.agent import build_agent as jax_build_agent
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
    from sheeprl_tpu.utils.env import make_env as jax_make_env
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric

    ov = ["fabric.accelerator=cpu", "env.capture_video=False", *extra]
    cfg_jax, cfg = jax_compose(ov), compose(ov)
    env = jax_make_env(cfg_jax, 0, 0)()
    fabric = JaxFabric(devices=1, accelerator="cpu")
    fabric._setup()
    _, params = jax_build_agent(fabric, (2,), False, cfg_jax, env.observation_space, jax.random.PRNGKey(0))
    params = numpy_tree(params)
    agent = build_agent(Fabric(accelerator="cpu"), (2,), False, cfg, env.observation_space, 0, params)
    return params, agent, cfg_jax, cfg


@pytest.mark.parametrize(
    "extra",
    [
        ["exp=ppo", "algo.max_grad_norm=0.5"],
        ["exp=ppo", "algo.max_grad_norm=0.5", "algo.anneal_lr=True"],
        ["exp=a2c"],
    ],
    ids=["ppo-clip-adam", "ppo-clip-adam-anneal", "a2c-clip-rmsprop"],
)
def test_ppo_and_a2c_optax_states_resume_in_the_port(extra, tmp_path):
    """PPO's clip + Adam chain (with the linear schedule's count) and A2C's
    clip + RMSprop: one JAX update, the state through a checkpoint into the
    trainer's optimizer, one more update each from the same gradients, large
    enough that the clip acts. Parameters within 1e-6."""
    from sheeprl_tpu.algos.ppo.ppo import _build_optimizer
    from sheeprl_tpu_torch.algos.a2c.a2c import A2CTrainer
    from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainer, build_optimizer
    from sheeprl_tpu_torch.config import instantiate
    from sheeprl_tpu_torch.interop.flax_to_torch import load_ppo_params, ppo_to_flax, ppo_to_torch
    from sheeprl_tpu_torch.interop.optax_to_torch import load_optimizer_state

    params, agent, cfg_jax, cfg = _ppo_pair(extra)
    total_iters = 3
    is_ppo = cfg.algo.name == "ppo"
    if is_ppo:
        tx = _build_optimizer(cfg_jax, total_iters)
    else:
        tx = optax.chain(optax.clip_by_global_norm(cfg_jax.algo.max_grad_norm), instantiate(cfg_jax.algo.optimizer))
    rng = np.random.default_rng(2)

    def grads_like(tree):
        return jax.tree_util.tree_map(lambda x: 3 * rng.standard_normal(x.shape).astype(np.float32), tree)

    params, state = _jax_step(tx, params, grads_like(params), tx.init(params))
    load_ppo_params(agent, params)
    if is_ppo:
        optimizer, schedule = build_optimizer(cfg, agent, total_iters)
        trainer = PPOTrainer(agent, optimizer, cfg, schedule)
    else:
        trainer = A2CTrainer(agent, instantiate(cfg.algo.optimizer, agent.parameters()), cfg)
    load_optimizer_state(trainer.optimizer, _via_checkpoint(tmp_path, state), ppo_to_torch(agent))
    if "algo.anneal_lr=True" in extra:
        assert trainer.optimizer.param_groups[0]["schedule_count"] == 1
    grads = grads_like(params)
    params, _ = _jax_step(tx, params, grads, state)
    trainer.apply(ppo_to_torch(agent)(grads))
    _assert_trees_close(ppo_to_flax(agent), params, atol=1e-6)


def test_optax_states_that_do_not_fit_are_refused(tmp_path):
    """An optax state never loads into an optimizer of another kind or shape."""
    from sheeprl_tpu_torch.interop.flax_to_torch import ppo_to_torch
    from sheeprl_tpu_torch.interop.optax_to_torch import load_optimizer_state

    params, agent, _, _ = _ppo_pair(["exp=ppo"])
    adam_state = _via_checkpoint(tmp_path, optax.adam(1e-3).init(params))
    with pytest.raises(ValueError, match="cannot load into RMSprop"):
        load_optimizer_state(RMSprop(agent.parameters()), adam_state, ppo_to_torch(agent))
    small = dict(params, critic={k: v for k, v in params["critic"].items() if k != "Dense_2"})
    with pytest.raises(ValueError):
        load_optimizer_state(torch.optim.Adam(agent.parameters()), _via_checkpoint(tmp_path, optax.adam(1e-3).init(small)),
                             ppo_to_torch(agent))
    with pytest.raises(ValueError, match="neither"):
        load_optimizer_state(torch.optim.Adam(agent.parameters()), {"count": 1}, ppo_to_torch(agent))
