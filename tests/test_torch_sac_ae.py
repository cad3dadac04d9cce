"""SAC-AE of the port against the JAX package's, on the CPU.

- a train phase against the jitted JAX ``train_phase`` from the same
  parameters, replay block and draws (derived from the JAX key in the order
  the JAX phase splits it: ``split(key, G)``, then ``k_critic, k_actor, k_rec
  = split(k, 3)`` per step): one step at ``cum`` 1, where the target EMA's,
  the actor's and the decoder's gates are shut (only the critic moves; the
  other optimizers' states stay as they were), and two from ``cum`` 0, where
  all open and then shut;
- the CLI: ``exp=sac_ae`` trains, resumes into version_1 and evaluates, and
  its metric log holds the reconstruction loss;
- a checkpoint written by the JAX package's code (its params and its five
  optax states after one update) resumes and evaluates in the port.

The blocks are held in ``test_torch_sac_ae_agent.py``. Tolerances: mean
losses 1e-5 relative (float32 means over the block, the reconstruction over
every pixel); parameters within 2 learning rates (Adam's first step moves
each weight by about its learning rate whatever the gradient's size, so a
gradient within rounding of 0 may step either way) and all but 0.1% within
1e-5; the Adam(W) moments 1e-4 relative to each tensor's largest entry, their
counts equal.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import numpy_tree
from test_torch_sac_ae_agent import SAC_AE_SMALL, jax_sac_ae, port_sac_ae

# the decoder's gate every 2 steps too, so that a step shuts all three
GATES = ("algo.decoder.per_rank_update_freq=2",)
LR = 1e-3
MOMENT_RTOL = 1e-4


def _adam(state):
    """The Adam link (count, mu, nu) of an optax chain state."""
    for node in jax.tree_util.tree_leaves(state, is_leaf=lambda n: hasattr(n, "mu")):
        if hasattr(node, "mu"):
            return node
    raise AssertionError("no Adam state")


@functools.lru_cache(maxsize=None)
def _jax_phase():
    from sheeprl_tpu.algos.sac_ae.sac_ae import build_optimizers, make_train_phase

    jagent, _, cfg = jax_sac_ae(GATES)
    txs = build_optimizers(cfg)
    return make_train_phase(jagent, cfg, txs, target_entropy=-2.0), txs


def _block(rng, G: int, B: int) -> dict:
    def obs(prefix=""):
        return {prefix + "rgb": rng.integers(0, 256, (G, B, 3, 3, 24, 24)).astype(np.uint8),
                prefix + "state": rng.standard_normal((G, B, 5)).astype(np.float32)}

    return {**obs(), **obs("next_"), "actions": rng.uniform(-1, 1, (G, B, 2)).astype(np.float32),
            "rewards": rng.standard_normal((G, B, 1)).astype(np.float32),
            "terminated": (rng.uniform(size=(G, B, 1)) < 0.2).astype(np.float32)}


def _noise(key, G: int, B: int) -> dict:
    steps = [jax.random.split(k, 3) for k in jax.random.split(key, G)]
    return {
        "critic": torch.from_numpy(np.stack([np.asarray(jax.random.normal(kc, (B, 2))) for kc, _, _ in steps])),
        "actor": torch.from_numpy(np.stack([np.asarray(jax.random.normal(ka, (B, 2))) for _, ka, _ in steps])),
        "rec": {"rgb": torch.from_numpy(np.stack([np.asarray(jax.random.uniform(kr, (B, 9, 24, 24)))
                                                  for _, _, kr in steps]))},
    }


@pytest.mark.parametrize("G,cum", [(1, 1), (2, 0)], ids=["gates-shut", "gates-open-then-shut"])
def test_train_phase_matches_the_jitted_phase(G, cum):
    from sheeprl_tpu.algos.sac_ae.sac_ae import init_opt_state
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import SACAETrainer, build_optimizers
    from sheeprl_tpu_torch.interop.flax_to_torch import sac_ae_group_to_torch, sac_ae_to_flax

    _, params, _ = jax_sac_ae(GATES)
    params = jax.tree_util.tree_map(np.copy, params)
    for head in ("Dense_0", "Dense_1"):  # the pre-squash samples stay off tanh's saturated tail
        params["actor"][head]["kernel"] *= 0.1
    train_phase, txs = _jax_phase()
    B = 4
    data = _block(np.random.default_rng(10 + cum), G, B)
    key = jax.random.PRNGKey(12 + cum)
    jparams = jax.tree_util.tree_map(jnp.array, params)
    new_params, opt_state, losses, _ = train_phase(jparams, init_opt_state(txs, jparams),
                                                   {k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(cum),
                                                   np.asarray(key))
    agent, cfg = port_sac_ae(GATES, params=params)
    trainer = SACAETrainer(agent, build_optimizers(cfg, agent), cfg, -2.0)
    assert isinstance(trainer.optimizers["decoder"], torch.optim.AdamW)
    ours = trainer.train_phase({k: torch.from_numpy(v) for k, v in data.items()}, cum, _noise(key, G, B))
    np.testing.assert_allclose(ours.numpy(), np.asarray(losses), rtol=1e-5, atol=1e-6)

    mine, theirs = sac_ae_to_flax(agent), numpy_tree(new_params)
    flat_mine = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(mine)])
    flat_theirs = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(theirs)])
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(theirs)
    assert np.abs(flat_mine - flat_theirs).max() <= 2 * LR
    assert np.mean(np.abs(flat_mine - flat_theirs) <= 1e-5) > 0.999
    if G == 1:
        # only the critic stepped: the actor, alpha, decoder and targets as they were
        for k in ("actor", "actor_cnn_fc", "log_alpha", "decoder", "target"):
            np.testing.assert_array_equal(np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(mine[k])]),
                                          np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(params[k])]))
    for name, opt in trainer.optimizers.items():
        adam = _adam(opt_state[name])
        group = [p for g in opt.param_groups for p in g["params"]]
        if int(adam.count) == 0:
            assert all(not opt.state[p] for p in group), name  # a shut gate took no step
            continue
        for key_, moments in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            for p, ref in zip(group, sac_ae_group_to_torch(agent, name)(numpy_tree(moments))):
                ref = ref.numpy()
                tol = MOMENT_RTOL * max(float(np.abs(ref).max(initial=0.0)), 1e-12)
                np.testing.assert_allclose(opt.state[p][key_].numpy(), ref, atol=tol, rtol=0, err_msg=name)
        assert all(float(opt.state[p]["step"]) == int(adam.count) for p in group), name


# the dummy env's 64 x 64 frames in stacks of 3, 2 envs, 16 policy steps of prefill
SAC_AE_TINY = [o for o in SAC_AE_SMALL if not o.startswith("env.screen_size")] + [
    "env.num_envs=2", "algo.learning_starts=16", "checkpoint.every=32", "buffer.size=256", "root_dir=tiny",
    "run_name=run",
]


def test_cli_trains_resumes_and_evaluates(tmp_path, capsys):
    """Train 48 steps, resume from the last checkpoint into version_1 with its
    buffer and optimizer states (it waits learning_starts again, then
    trains), evaluate it; the event file holds every SAC-AE loss."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from sheeprl_tpu_torch.__main__ import main
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    first = run(SAC_AE_TINY + ["algo.total_steps=48"])
    ckpt = tmp_path / first["checkpoint"]
    # learning starts at iteration 8: the governor counts 16 - 7 * 2 policy
    # steps and takes 2 gradient steps, then 2 an iteration for 16 more
    assert first["iterations"] == 24 and first["gradient_steps"] == 2 * 17 and ckpt.is_file()
    assert all(np.isfinite(v) for v in first["metrics"].values()) and first["test_reward"] is not None
    ea = EventAccumulator(str(tmp_path / first["log_dir"]))
    ea.Reload()
    assert {"Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss", "Loss/reconstruction_loss",
            "Test/cumulative_reward"} <= set(ea.Tags()["scalars"])
    state = load_checkpoint(str(ckpt))
    assert sorted(state["opt_state"]) == ["actor", "alpha", "critic", "decoder", "encoder"]
    assert state["rb"]["rgb"].shape[-4:] == (3, 3, 64, 64) and state["rb"]["next_rgb"].dtype == np.uint8
    resumed = run(SAC_AE_TINY + ["algo.total_steps=80", f"checkpoint.resume_from={ckpt}"])
    assert resumed["log_dir"].endswith("version_1") and resumed["policy_steps"] == 80
    assert resumed["gradient_steps"] > 0 and all(np.isfinite(v) for v in resumed["metrics"].values())
    capsys.readouterr()
    assert main(["evaluation", f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "env.capture_video=False"]) == 0
    assert "Test - Reward:" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="bf16"):
        run(SAC_AE_TINY + ["algo.total_steps=48", "fabric.precision=bf16-mixed"])


def test_a_jax_checkpoint_resumes_and_evaluates_in_the_port(tmp_path, capsys):
    """A run dir written by the JAX package's code: its config.yaml and a
    checkpoint with Flax params and the five optax states after one update
    each (the decoder's AdamW among them), without a replay buffer. The port
    loads every optimizer's moments and count, resumes and trains, and
    evaluates it."""
    import optax
    import yaml

    from sheeprl_tpu.algos.sac_ae.sac_ae import actor_group, build_optimizers as jax_optimizers
    from sheeprl_tpu.algos.sac_ae.sac_ae import critic_group, encoder_group, init_opt_state
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
    from sheeprl_tpu_torch.__main__ import main
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import SACAETrainer, build_optimizers
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.interop.flax_to_torch import sac_ae_group_to_torch
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    cfg_jax = jax_compose(SAC_AE_TINY + ["algo.total_steps=32", "buffer.checkpoint=False"])
    # the agent at the dummy env's spaces: stacks of 64 x 64 frames, a 10-vector
    from sheeprl_tpu.algos.sac_ae.agent import build_agent as jax_build
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
    from test_torch_sac_ae_agent import sac_ae_spaces

    fabric = JaxFabric(devices=1, accelerator="cpu")
    fabric._setup()
    _, params = jax_build(fabric, cfg_jax, *sac_ae_spaces(64, 10), jax.random.PRNGKey(4))
    params = numpy_tree(params)
    txs = jax_optimizers(cfg_jax)
    opt_state = init_opt_state(txs, params)
    views = {"critic": critic_group, "actor": actor_group, "encoder": encoder_group,
             "alpha": lambda p: p["log_alpha"], "decoder": lambda p: p["decoder"]}
    for group, view in views.items():
        tree = view(params)
        grads = jax.tree_util.tree_map(lambda x: np.full_like(x, 0.1), tree)
        _, opt_state[group] = jax.jit(txs[group].update)(grads, opt_state[group], tree)
    run_dir = tmp_path / "jax_run" / "version_0"
    ckpt = run_dir / "checkpoint" / "ckpt_32_0.ckpt"
    state = {"agent": params, "opt_state": opt_state, "ratio": {"_ratio": 1.0, "_prev": 18, "_pretrain_steps": 0},
             "iter_num": 16, "batch_size": 4, "last_log": 32, "last_checkpoint": 32}
    jax_save_checkpoint(str(ckpt), state)
    (run_dir / "config.yaml").write_text(yaml.safe_dump(cfg_jax.as_dict()))

    from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric

    cfg = compose(SAC_AE_TINY)
    agent = build_agent(Fabric(accelerator="cpu"), cfg, *sac_ae_spaces(64, 10), 0, params)
    trainer = SACAETrainer(agent, build_optimizers(cfg, agent), cfg, -2.0)
    trainer.load_opt_state(load_checkpoint(str(ckpt))["opt_state"])
    for name, opt in trainer.optimizers.items():
        adam = _adam(opt_state[name])
        group = [p for g in opt.param_groups for p in g["params"]]
        for p, mu in zip(group, sac_ae_group_to_torch(agent, name)(numpy_tree(adam.mu))):
            np.testing.assert_array_equal(opt.state[p]["exp_avg"].numpy(), mu.numpy())
        assert all(float(opt.state[p]["step"]) == 1 for p in group)
    resumed = run(SAC_AE_TINY + ["algo.total_steps=64", "buffer.checkpoint=False", "buffer.prefetch.enabled=False",
                                 f"checkpoint.resume_from={ckpt}"])
    assert resumed["policy_steps"] == 64 and resumed["gradient_steps"] > 0
    assert all(np.isfinite(v) for v in resumed["metrics"].values())
    capsys.readouterr()
    assert main(["evaluation", f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "env.capture_video=False"]) == 0
    assert "Test - Reward:" in capsys.readouterr().out
