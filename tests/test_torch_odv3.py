"""The port's Offline Dreamer (Dreamer-V3 with a concept-bottleneck world model)
against the JAX package's, on the CPU.

- the CEM (per-concept context and prob layers, the prob-weighted embedding,
  the residual) and ``cbm_loss`` with the same Bernoulli concept targets (the
  JAX package draws them from its key: the reference's placeholder; the port
  takes them as an argument and is fed JAX's draw);
- the imagination rollout with the CEM at every step, its noise derived in
  the JAX rollout's order (``fold_in(k, 1)`` for each step's action);
- one train step against the jitted JAX ``train_step`` of
  ``make_offline_train_phase``, with ``use_cbm`` true and false;
- the CEM at bf16, held three ways (``tests/test_torch_bf16_agent.py``);
- the port's CLI: train, resume and evaluate.

Tolerances as ``tests/test_torch_dv3_train.py`` states them: forward values
1e-5; metrics 1e-4 absolute and relative; parameters within 2 learning rates
and all but 0.1% within 1e-5.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dv3_train import B, HORIZON, SCREEN, T, TRAIN, _batch, _close, _close_trees, _torch_batch
from test_torch_helpers import (
    ACTIONS,
    filled,
    jax_imagination_noise,
    jax_scan_noise,
    numpy_tree,
    overrides,
)

ATOL = 1e-5
GRAD_ATOL = 1e-4
CBM = ["algo.world_model.cbm_model.n_concepts=3", "algo.world_model.cbm_model.concept_bins=[2,2,2]",
       "algo.world_model.cbm_model.emb_size=4"]


def _overrides(use_cbm: bool = True) -> list:
    base = [o for o in overrides("discrete", TRAIN) if not o.startswith("exp=")]
    return ["exp=offline_dreamer", *base, *CBM, f"algo.world_model.cbm_model.use_cbm={use_cbm}"]


@functools.lru_cache(maxsize=None)
def _jax(use_cbm: bool = True):
    """The JAX agent, params (zero leaves filled), config and observation space."""
    from sheeprl_tpu.algos.offline_dreamer.agent import build_agent as jax_build
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
    from sheeprl_tpu.utils.env import make_env as jax_make_env

    cfg = jax_compose(_overrides(use_cbm))
    env = jax_make_env(cfg, 0, 0)()
    obs_space = env.observation_space
    env.close()
    fabric = JaxFabric(devices=1, accelerator="cpu")
    fabric._setup()
    agent, params = jax_build(fabric, *ACTIONS["discrete"], cfg, obs_space, jax.random.PRNGKey(3))
    return agent, filled(numpy_tree(params)), cfg, obs_space


def _port(use_cbm: bool = True, precision: str = "32-true"):
    from sheeprl_tpu_torch.algos.offline_dreamer.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric

    _, params, _, obs_space = _jax(use_cbm)
    cfg = compose(_overrides(use_cbm))
    fabric = Fabric(accelerator="cpu", precision=precision)
    return build_agent(fabric, *ACTIONS["discrete"], cfg, obs_space, 3, params), cfg


def _latents(agent, seed: int = 0, rows=(T, B)):
    return np.random.default_rng(seed).standard_normal((*rows, agent.latent_state_size)).astype(np.float32)


def test_cem_and_cbm_loss_match_jax():
    from sheeprl_tpu.algos.offline_dreamer.loss import cbm_loss as jax_cbm_loss
    from sheeprl_tpu_torch.algos.offline_dreamer.loss import cbm_loss

    jagent, params, _, _ = _jax()
    tagent, _ = _port()
    wm = params["world_model"]
    x, noise = _latents(jagent, 1), _latents(jagent, 2)
    apply = jax.jit(lambda p, v: jagent.cem.apply({"params": p}, v))
    ref, ref_rand = apply(wm["cem"], x), apply(wm["cem"], noise)
    out, out_rand = tagent.apply_cem(torch.from_numpy(x)), tagent.apply_cem(torch.from_numpy(noise))
    for o, r, name in zip(out, ref, ("latent", "logits", "concept embeddings", "residual")):
        assert tuple(o.shape) == r.shape, name
        _close(o, r, ATOL)
    assert out[0].shape[-1] == 6 + 4 * 4

    key = jax.random.PRNGKey(4)
    loss, c_loss = jax.jit(lambda a, b, c, d, e, k: jax_cbm_loss(jagent.cem, a, b, c, d, e, k))(
        ref[1], ref[2], ref[3], ref_rand[2], ref_rand[3], key
    )
    targets = np.asarray(jax.random.bernoulli(key, 0.5, ref[1].shape), np.float32)
    tloss, tc_loss = cbm_loss(tagent.cem, out[1], out[2], out[3], out_rand[2], out_rand[3], torch.from_numpy(targets))
    _close(tloss, loss, ATOL)
    _close(tc_loss, c_loss, ATOL)


def test_imagination_and_player_with_the_cem_match_jax():
    """The rollout reads the CEM latent at every step; so does the player
    (``PlayerDV3`` over an ``ODV3Agent`` against the JAX ``PlayerODV3``),
    each step's noise split from the JAX key as ``PlayerODV3`` splits it."""
    from sheeprl_tpu.algos.offline_dreamer.agent import PlayerODV3
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerDV3
    from test_torch_helpers import jax_categorical_noise, random_obs

    jagent, params, _, _ = _jax()
    tagent, _ = _port()
    n = 3
    jplayer, tplayer = PlayerODV3(jagent, n, ["rgb"], ["state"]), PlayerDV3(tagent, n, ["rgb"], ["state"])
    jplayer.init_states(params)
    tplayer.init_states()
    key, rng = jax.random.PRNGKey(11), np.random.default_rng(12)
    for _ in range(2):
        obs = random_obs(rng, (n,), image=(3, SCREEN, SCREEN))
        _, k_repr, k_act = jax.random.split(key, 3)
        shape = (n, jagent.stochastic_size, jagent.discrete_size)
        noise = {"repr": torch.from_numpy(np.asarray(jax.random.gumbel(k_repr, shape)).reshape(n, -1)),
                 "act": torch.from_numpy(jax_categorical_noise(k_act, n, jagent.actions_dim))}
        actions, key = jplayer.get_actions(params, obs, key)
        _close(tplayer.get_actions({k: torch.from_numpy(v) for k, v in obs.items()}, noise), actions, ATOL)
        _close(tplayer.recurrent_state, jplayer.recurrent_state, ATOL)

    rng = np.random.default_rng(6)
    N = T * B
    idx = rng.integers(0, jagent.discrete_size, (N, jagent.stochastic_size))
    z0 = np.eye(jagent.discrete_size, dtype=np.float32)[idx].reshape(N, -1)
    h0 = np.tanh(rng.standard_normal((N, jagent.recurrent_state_size))).astype(np.float32)
    key = jax.random.PRNGKey(7)
    latents, actions = jax.jit(
        lambda wm, actor, z, h, k: jagent.imagination_scan(wm, actor, z, h, k, HORIZON)
    )(params["world_model"], params["actor"], z0, h0, key)
    trans, act = jax_imagination_noise(key, jagent, N, HORIZON)
    tlatents, tactions = tagent.imagination_scan(
        torch.from_numpy(z0), torch.from_numpy(h0), HORIZON, torch.from_numpy(trans), torch.from_numpy(act)
    )
    assert tuple(tlatents.shape) == latents.shape == (HORIZON + 1, N, 6 + 4 * 4)
    _close(tlatents, latents, ATOL)
    _close(tactions, actions, ATOL)


@pytest.mark.parametrize("use_cbm", [True, False], ids=["cbm", "no-cbm"])
def test_train_step_matches_the_jax_phase(use_cbm):
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import build_optimizers as jax_build_optimizers
    from sheeprl_tpu.algos.dreamer_v3.utils import init_moments
    from sheeprl_tpu.algos.offline_dreamer.offline_dreamer import make_offline_train_phase
    from sheeprl_tpu_torch.algos.offline_dreamer.offline_dreamer import make_trainer
    from sheeprl_tpu_torch.interop.flax_to_torch import agent_to_flax

    jagent, params, cfg_jax, _ = _jax(use_cbm)
    world_tx, actor_tx, critic_tx, opt_state = jax_build_optimizers(cfg_jax, params)
    train_step = make_offline_train_phase(jagent, cfg_jax, world_tx, actor_tx, critic_tx).train_step
    tagent, cfg = _port(use_cbm)
    trainer = make_trainer(tagent, cfg)
    assert ("cem" in tagent.world_model) == use_cbm
    batch = _batch("discrete", seed=3)
    key = jax.random.PRNGKey(24)
    copy = jax.tree_util.tree_map(jnp.array, (params, opt_state))
    new_params, _, moments, metrics = train_step(*copy, init_moments(), batch, jnp.asarray(0), np.asarray(key))

    # k_world, k_img = split(k); the world loss: k_scan, k_hook = split(k_world);
    # the hook: k_rand, k_concepts = split(k_hook)
    k_world, k_img = jax.random.split(jnp.asarray(key))
    k_scan, k_hook = jax.random.split(k_world)
    trans, act = jax_imagination_noise(k_img, jagent, T * B, HORIZON)
    noise = {"posterior": torch.from_numpy(jax_scan_noise(k_scan, T, B, jagent)),
             "transition": torch.from_numpy(trans), "action": torch.from_numpy(act)}
    if use_cbm:
        k_rand, k_concepts = jax.random.split(k_hook)
        bins = sum(jagent.cem.concept_bins)
        noise["hook"] = {
            "random_latent": torch.from_numpy(np.array(jax.random.normal(k_rand, (T, B, jagent.latent_state_size)))),
            "concepts": torch.from_numpy(np.asarray(jax.random.bernoulli(k_concepts, 0.5, (T, B, bins)), np.float32)),
        }
    ours = trainer.train_step(_torch_batch(batch), 0, noise)
    assert sorted(ours) == sorted(metrics)
    assert ("Loss/concept_loss" in ours) == use_cbm
    for name, value in metrics.items():
        _close(ours[name], value, GRAD_ATOL)
    _close(trainer.moments["low"], moments["low"], ATOL)
    _close(trainer.moments["high"], moments["high"], ATOL)
    mine, theirs = agent_to_flax(tagent), numpy_tree(new_params)
    _close_trees(mine, theirs, 2 * 1e-4)
    flat_mine = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(mine)])
    flat_theirs = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(theirs)])
    assert np.mean(np.abs(flat_mine - flat_theirs) <= 1e-5) > 0.999


def test_cem_at_bf16():
    """The JAX CEM at bf16 is the module with ``dtype`` bf16, as the JAX
    build makes it under a bf16 precision."""
    jf32, params, _, _ = _jax(True)
    cem_bf16 = jf32.cem.clone(dtype=jnp.bfloat16)
    tagent, _ = _port(True, "bf16-mixed")
    x = _latents(jf32, 5)
    wm = params["world_model"]
    ref = cem_bf16.apply({"params": wm["cem"]}, jnp.asarray(x, jnp.bfloat16))
    ref32 = jf32.cem.apply({"params": wm["cem"]}, x)
    out = tagent.apply_cem(torch.from_numpy(x).to(torch.bfloat16))
    for o, r, r32, name in zip(out, ref, ref32, ("latent", "logits", "concept embeddings", "residual")):
        assert o.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16, name
        d_port = float(np.mean(np.abs(o.detach().float().numpy() - np.asarray(r, np.float32))))
        d_ref = float(np.mean(np.abs(np.asarray(r, np.float32) - np.asarray(r32))))
        assert d_port < d_ref, (name, d_port, d_ref)


CLI_TINY = [o for o in _overrides(True) if not o.startswith(("env.screen_size", "algo.horizon"))] + [
    f"env.screen_size={SCREEN}", "env.num_envs=2", "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=2",
    "algo.learning_starts=4", "algo.replay_ratio=0.5", "algo.horizon=3", "buffer.size=64", "buffer.memmap=False",
    "checkpoint.every=4", "root_dir=tiny", "run_name=run", "env.capture_video=False",
]


def _jax_checkpoint(run_dir):
    """A checkpoint as the JAX package writes one: its params (with
    ``world_model/cem``), the optax states of its three groups after one
    update, Moments, counters, and its config.yaml beside."""
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import build_optimizers as jax_build_optimizers
    from sheeprl_tpu.algos.dreamer_v3.utils import init_moments
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.utils.checkpoint import save_checkpoint
    from sheeprl_tpu.utils.utils import Ratio, save_configs

    _, params, _, _ = _jax(True)
    cfg = jax_compose([o for o in CLI_TINY if not o.startswith(("root_dir", "run_name"))])
    txs = jax_build_optimizers(cfg, params)
    rng = np.random.default_rng(8)
    opt_state = {}
    for name, tx in zip(("world_model", "actor", "critic"), txs[:3]):
        grads = jax.tree_util.tree_map(lambda x: rng.standard_normal(x.shape).astype(np.float32), params[name])
        opt_state[name] = jax.jit(tx.update)(grads, txs[3][name], params[name])[1]
    ratio = Ratio(0.5)
    ratio(8)
    save_configs(cfg, str(run_dir))
    ckpt = run_dir / "checkpoint" / "ckpt_8_0.ckpt"
    save_checkpoint(str(ckpt), {"agent": params, "opt_state": opt_state, "moments": init_moments(),
                                "ratio": ratio.state_dict(), "iter_num": 4, "batch_size": 2, "last_log": 0,
                                "last_checkpoint": 8})
    return ckpt


def test_cli_trains_resumes_and_evaluates(tmp_path, capsys):
    """``exp=offline_dreamer`` through the port's entry points at bf16-mixed:
    train, resume from the last checkpoint (its ``world_model/cem`` and the
    three optimizers), evaluate; then a checkpoint the JAX package wrote
    resumes with its optax states converted, and evaluates."""
    from sheeprl_tpu_torch.__main__ import main
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    args = CLI_TINY + ["fabric.precision=bf16-mixed"]
    first = run(args + ["algo.total_steps=12"])
    ckpt = tmp_path / first["checkpoint"]
    assert first["gradient_steps"] >= 2 and all(np.isfinite(v) for v in first["metrics"].values())
    assert "Loss/concept_loss" in first["metrics"]
    assert sorted(load_checkpoint(str(ckpt))["agent"]["world_model"]["cem"]) == [
        "context_0", "context_1", "context_2", "context_3", "prob_0", "prob_1", "prob_2"]
    resumed = run(args + ["algo.total_steps=20", f"checkpoint.resume_from={ckpt}"])
    assert resumed["log_dir"].endswith("version_1") and resumed["gradient_steps"] >= 1
    capsys.readouterr()
    assert main(["evaluation", f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "env.capture_video=False"]) == 0
    assert "Test - Reward:" in capsys.readouterr().out

    jax_ckpt = _jax_checkpoint(tmp_path / "jax_run" / "version_0")
    # the JAX config turns the replay prefetch thread on, which the port refuses
    from_jax = run(CLI_TINY + ["algo.total_steps=16", f"checkpoint.resume_from={jax_ckpt}",
                               "buffer.prefetch.enabled=False"])
    assert from_jax["policy_steps"] == 16 and from_jax["gradient_steps"] >= 1
    assert all(np.isfinite(v) for v in from_jax["metrics"].values())
    assert main(["evaluation", f"checkpoint_path={jax_ckpt}", "fabric.accelerator=cpu",
                 "env.capture_video=False"]) == 0
