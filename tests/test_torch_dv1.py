"""The port's Dreamer-V1 against the JAX package's, on the CPU.

- the Gaussian stochastic state, its KL, the world-model loss and Dreamer-V1's
  λ-returns;
- both RSSM scans (no ``is_first`` masking, Gaussian samples from standard
  normal noise) and the player, with the noise derived from the JAX key in
  JAX's split order;
- one gradient step (the actor trained through the imagined dynamics)
  against the jitted JAX ``train_step``, discrete and continuous actions;
- ``run``, resume, ``evaluation`` and ``serve`` through the entry points, and
  no LN-GRU launch anywhere (the cell has no LayerNorm); a checkpoint of the
  JAX package resumes (optax.adam states converted), evaluates and serves.

Tolerances as in ``tests/test_torch_dv2_train.py``: forward values 1e-5,
metrics 1e-4, parameters within 2 learning rates and all but 0.1% within
1e-5.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dv2_agent import _actor_noise, _scale_actor_heads
from test_torch_dv2_train import GRAD_ATOL, close_trees, dreamer_batch
from test_torch_helpers import jax_dreamer, numpy_tree, port_dreamer, random_obs

ATOL = 1e-5
T, B, HORIZON = 4, 2, 3
TRAIN = ("algo.horizon=3", "algo.world_model.clip_gradients=1.0", "algo.actor.clip_gradients=1.0")


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(ours, theirs, atol=ATOL):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=atol, rtol=atol)


def test_gaussian_state_kl_loss_and_lambda_values():
    from sheeprl_tpu.algos.dreamer_v1 import agent as jagent_mod
    from sheeprl_tpu.algos.dreamer_v1 import loss as jloss
    from sheeprl_tpu.algos.dreamer_v1 import utils as jutils
    from sheeprl_tpu_torch.algos.dreamer_v1 import agent as tagent_mod
    from sheeprl_tpu_torch.algos.dreamer_v1 import loss as tloss
    from sheeprl_tpu_torch.algos.dreamer_v1 import utils as tutils

    rng = np.random.default_rng(0)
    mean_std = rng.standard_normal((5, 3, 8)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    (jm, js), jz = jagent_mod.gaussian_state(mean_std, 0.1, key)
    (tm, ts), tz = tagent_mod.gaussian_state(_t(mean_std), 0.1, _t(jax.random.normal(key, (5, 3, 4))))
    for a, b in ((tm, jm), (ts, js), (tz, jz)):
        _close(a, b)
    post, prior = mean_std, rng.standard_normal((5, 3, 8)).astype(np.float32)
    (pm, ps), _ = tagent_mod.gaussian_state(_t(post), 0.1)
    (qm, qs), _ = tagent_mod.gaussian_state(_t(prior), 0.1)
    (jpm, jps), _ = jagent_mod.gaussian_state(post, 0.1, key)
    (jqm, jqs), _ = jagent_mod.gaussian_state(prior, 0.1, key)
    _close(tagent_mod.normal_kl(pm, ps, qm, qs), jagent_mod.normal_kl(jpm, jps, jqm, jqs))
    obs_lp = {"rgb": rng.standard_normal((5, 3)).astype(np.float32)}
    reward_lp, cont_lp = (rng.standard_normal((5, 3)).astype(np.float32) for _ in range(2))
    kw = dict(kl_free_nats=0.5, kl_regularizer=0.7, continue_scale_factor=2.0)
    theirs = jloss.reconstruction_loss(obs_lp, reward_lp, jpm, jps, jqm, jqs, continue_log_prob=cont_lp, **kw)
    ours = tloss.reconstruction_loss({"rgb": _t(obs_lp["rgb"])}, _t(reward_lp), pm, ps, qm, qs,
                                     continue_log_prob=_t(cont_lp), **kw)
    for a, b in zip(ours, theirs):
        _close(a, b)
    r, v, c = (rng.standard_normal((6, 3, 1)).astype(np.float32) for _ in range(3))
    _close(tutils.compute_lambda_values(_t(r), _t(v), _t(c), 6, 0.9), jutils.compute_lambda_values(r, v, c, 6, 0.9))


def test_scans_and_player_match():
    from sheeprl_tpu.algos.dreamer_v1.agent import PlayerDV1 as JaxPlayer
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import PlayerDV2

    for kind in ("discrete", "continuous"):
        jagent, params, _, _ = jax_dreamer("dreamer_v1", kind)
        params = _scale_actor_heads(params, 0.1)
        tagent, _ = port_dreamer("dreamer_v1", kind, params=params)
        assert not tagent.world_model["recurrent_model"].cell.layer_norm
        S = tagent.stochastic_size
        rng = np.random.default_rng(3)
        wm = params["world_model"]
        embedded = rng.standard_normal((T, B, tagent.encoder.out_dim)).astype(np.float32)
        actions = rng.uniform(-1, 1, (T, B, 2)).astype(np.float32)
        key = jax.random.PRNGKey(7)
        theirs = jagent.dynamic_scan(wm, embedded, actions, key)
        noise = np.stack([np.asarray(jax.random.normal(k, (B, S))) for k in jax.random.split(key, T)])
        ours = tagent.dynamic_scan(_t(embedded), _t(actions), _t(noise))
        for a, b in zip(ours, theirs):
            _close(a, b)
        z0, h0 = np.asarray(theirs[1]).reshape(T * B, -1), np.asarray(theirs[0]).reshape(T * B, -1)
        key = jax.random.PRNGKey(8)
        latents, acts = jagent.imagination_scan(wm, params["actor"], z0, h0, key, HORIZON)
        steps = jax.random.split(key, HORIZON)
        trans = np.stack([np.asarray(jax.random.normal(k, (T * B, S))) for k in steps])
        act = np.stack([_actor_noise(jax.random.fold_in(k, 1), jagent, T * B) for k in steps])
        ours_l, ours_a = tagent.imagination_scan(_t(z0), _t(h0), HORIZON, _t(trans), _t(act))
        _close(ours_l, latents)
        _close(ours_a, acts)

        n = 3
        jp, tp = JaxPlayer(jagent, n, ("rgb",), ("state",)), PlayerDV2(tagent, n, ("rgb",), ("state",))
        jp.init_states(params)
        tp.init_states()
        key = jax.random.PRNGKey(11)
        for step in range(4):
            if step == 2:
                jp.init_states(params, [0])
                tp.init_states([0])
            obs = random_obs(rng, (n,))
            _, k_repr, k_act, _ = jax.random.split(key, 4)
            noise = {"repr": _t(jax.random.normal(k_repr, (n, S))), "act": _t(_actor_noise(k_act, jagent, n))}
            theirs_a, key = jp.get_actions(params, obs, key)
            _close(tp.get_actions({k: _t(v) for k, v in obs.items()}, noise), theirs_a)
            _close(tp.recurrent_state, jp.recurrent_state)
            _close(tp.stochastic_state, jp.stochastic_state)


@functools.lru_cache(maxsize=None)
def _jax_step(kind: str):
    from sheeprl_tpu.algos.dreamer_v1.dreamer_v1 import make_train_phase
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import build_optimizers

    agent, params, cfg, _ = jax_dreamer("dreamer_v1", kind, TRAIN)
    world_tx, actor_tx, critic_tx, opt_state = build_optimizers(cfg, params)
    return make_train_phase(agent, cfg, world_tx, actor_tx, critic_tx).train_step, opt_state


@pytest.mark.parametrize("kind", ["discrete", "continuous"])
def test_train_step_matches_the_jitted_step(kind):
    from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import make_trainer
    from sheeprl_tpu_torch.interop.flax_to_torch import dv2_to_flax

    jagent, params, _, _ = jax_dreamer("dreamer_v1", kind, TRAIN)
    params = _scale_actor_heads(params, 0.1)
    train_step, opt_state = _jax_step(kind)
    tagent, cfg = port_dreamer("dreamer_v1", kind, TRAIN, params=params)
    trainer = make_trainer(tagent, cfg)
    batch = dreamer_batch(kind, seed=4)
    key = jax.random.PRNGKey(40)
    copy = jax.tree_util.tree_map(jnp.array, (params, opt_state))
    new_params, _, metrics = train_step(*copy, batch, np.asarray(key))
    k_world, k_img = jax.random.split(jnp.asarray(key))
    S = tagent.stochastic_size
    steps = jax.random.split(k_img, HORIZON)
    noise = {
        "posterior": np.stack([np.asarray(jax.random.normal(k, (B, S))) for k in jax.random.split(k_world, T)]),
        "transition": np.stack([np.asarray(jax.random.normal(k, (T * B, S))) for k in steps]),
        "action": np.stack([_actor_noise(jax.random.fold_in(k, 1), jagent, T * B) for k in steps]),
    }
    ours = trainer.train_step({k: torch.from_numpy(v.copy()) for k, v in batch.items()}, 0,
                              {k: _t(v) for k, v in noise.items()})
    assert sorted(ours) == sorted(metrics)
    for name, value in metrics.items():
        _close(ours[name], value, atol=GRAD_ATOL)
    mine, theirs = dv2_to_flax(tagent), numpy_tree(new_params)
    assert "target_critic" not in mine
    close_trees(mine, theirs, 2 * 6e-4)
    flat_mine = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(mine)])
    flat_theirs = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(theirs)])
    assert np.mean(np.abs(flat_mine - flat_theirs) <= 1e-5) > 0.999


def test_cli_trains_resumes_evaluates_and_serves(tmp_path, capsys):
    """Dreamer-V1 on the continuous dummy env (the TruncatedNormal actor)
    through ``run``, a resume, ``evaluation`` and ``serve``; the LN-GRU
    kernel's counter stays at 0 (the CPU takes the plain math, and Dreamer-V1's
    cell has no LayerNorm to run it anyway)."""
    import json

    from sheeprl_tpu_torch.__main__ import main
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.ops import LN_GRU
    from test_torch_dv2_cli import tiny_run

    LN_GRU.zero_launches()
    args = tiny_run("dreamer_v1", "continuous_dummy")
    first = run(args + ["algo.total_steps=16"])
    ckpt = tmp_path / first["checkpoint"]
    assert first["gradient_steps"] >= 2 and all(np.isfinite(v) for v in first["metrics"].values())
    resumed = run(args + ["algo.total_steps=24", f"checkpoint.resume_from={ckpt}"])
    assert resumed["log_dir"].endswith("version_1") and resumed["policy_steps"] == 24
    capsys.readouterr()
    assert main(["evaluation", f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "env.capture_video=False"]) == 0
    assert "Test - Reward:" in capsys.readouterr().out
    log_dir = tmp_path / "serve"
    assert main(["serve", f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "serve.sessions=2", "serve.slots=2",
                 "serve.max_session_steps=6", "serve.greedy=False", f"serve.log_dir={log_dir}"]) == 0
    summary = json.loads((log_dir / "summary.json").read_text())
    assert summary["sessions_completed"] == 2
    assert LN_GRU.launches == 0


def test_a_jax_checkpoint_resumes_evaluates_and_serves(tmp_path, capsys):
    """A Dreamer-V1 checkpoint of the JAX package (Flax params without a
    target critic, optax.adam states after one update) resumes with its
    optimizer states converted, evaluates and serves."""
    from sheeprl_tpu_torch.__main__ import main
    from sheeprl_tpu_torch.cli import run
    from test_torch_dv2_cli import jax_run, tiny_run

    ckpt, _ = jax_run(tmp_path / "jax_run" / "version_0", "dreamer_v1", "continuous_dummy")
    resumed = run(tiny_run("dreamer_v1", "continuous_dummy") + [
        "algo.total_steps=24", f"checkpoint.resume_from={ckpt}", "buffer.prefetch.enabled=False"])
    assert resumed["policy_steps"] == 24 and resumed["gradient_steps"] >= 1
    assert all(np.isfinite(v) for v in resumed["metrics"].values())
    capsys.readouterr()
    assert main(["evaluation", f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "env.capture_video=False"]) == 0
    assert "Test - Reward:" in capsys.readouterr().out
    assert main(["serve", f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "serve.sessions=2", "serve.slots=2",
                 "serve.max_session_steps=6", f"serve.log_dir={tmp_path / 'serve'}"]) == 0
