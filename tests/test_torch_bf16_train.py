"""Dreamer-V3 training, resume and serving at the bf16 policies, on the CPU.

- the policy: ``Fabric(precision="bf16-*")`` computes in bf16 and keeps
  float32 parameters, as the JAX package does (its ``param_dtype`` has no
  caller); the model-free families refuse bf16 as not yet ported;
- one gradient step of the port at bf16 against the JAX ``train_step`` at
  bf16, on the same parameters, batch and bf16 noise (drawn from the JAX key
  in the JAX code's split order), the JAX step at float32 beside them;
- a checkpoint the JAX package writes under ``fabric.precision=bf16-true``
  resumes, evaluates and serves in the port at bf16;
- the port's own CLI trains, resumes and evaluates at ``bf16-mixed``.

The step's bar: each loss and gradient norm of the port within 5% of JAX's
bf16 value, and the port's losses closer to JAX's bf16 losses than JAX's
bf16 losses are to its float32 ones (summed relative distance). Block by
block the port rounds where JAX rounds (``test_torch_bf16_agent.py``: the
single-step blocks agree bit for bit with JAX's eager bf16), but the JAX step
is one XLA program, which may keep float32 between the bf16 ops it fuses, so
some elements land on the neighbouring bf16 value (2^-9 relative). Those
flips pass through the posterior scan, the sums over T x B and, for the
gradient norms, back through every layer; the policy loss, a small
difference of larger terms, feels them most: 1.6% on this step, 0.8-3.8%
on three other batches and keys. 5% leaves that a margin, while a step that
computed a block in float32 lands at JAX's own bf16-to-float32 distance
(the policy loss 290% away, the actor's gradient norm 47%), which the second
bar rules out.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import ACTIONS, overrides

T, B, HORIZON = 4, 2, 3
SCREEN = 16
TRAIN = [
    "algo.horizon=3",
    "algo.world_model.clip_gradients=1.0",
    "algo.actor.clip_gradients=1.0",
    f"env.screen_size={SCREEN}",
]
STEP_RTOL = 0.05

CLI_TINY = [
    "exp=dreamer_v3",
    "env=dummy",
    "env.id=discrete_dummy",
    "fabric.accelerator=cpu",
    "env.capture_video=False",
    "env.num_envs=2",
    f"env.screen_size={SCREEN}",
    "algo.per_rank_batch_size=2",
    "algo.per_rank_sequence_length=2",
    "algo.learning_starts=4",
    "algo.replay_ratio=0.5",
    "algo.horizon=3",
    "algo.dense_units=8",
    "algo.mlp_layers=1",
    "algo.world_model.discrete_size=4",
    "algo.world_model.stochastic_size=4",
    "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.recurrent_model.recurrent_state_size=8",
    "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.transition_model.hidden_size=8",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.cnn_keys.decoder=[rgb]",
    "algo.mlp_keys.encoder=[state]",
    "algo.mlp_keys.decoder=[state]",
    "buffer.size=64",
    "buffer.memmap=False",
    "checkpoint.every=4",
    "root_dir=tiny",
    "run_name=run",
]


def test_fabric_bf16_policy_keeps_float32_parameters():
    from sheeprl_tpu_torch.parallel.fabric import Fabric

    for precision in ("bf16-true", "bf16-mixed"):
        fabric = Fabric(accelerator="cpu", precision=precision)
        assert fabric.precision == precision
        assert fabric.compute_dtype == torch.bfloat16 and fabric.param_dtype == torch.float32
    fabric = Fabric(accelerator="cpu")
    assert fabric.compute_dtype == fabric.param_dtype == torch.float32
    with pytest.raises(ValueError, match="fabric.precision"):
        Fabric(accelerator="cpu", precision="16-mixed")


def test_model_free_families_refuse_bf16():
    """PPO, A2C, SAC and DroQ run at bf16 in the JAX package; in the port
    they are not yet ported at bf16 and say so, in training and evaluation."""
    from sheeprl_tpu_torch.cli import run, unported_precision
    from sheeprl_tpu_torch.config import dotdict

    for exp in ("ppo", "a2c", "sac", "droq"):
        with pytest.raises(NotImplementedError, match=f"bf16-true for {exp}: bf16 is not yet ported"):
            run([f"exp={exp}", "fabric.accelerator=cpu", "fabric.precision=bf16-true"])
        unported_precision(dotdict({"algo": {"name": exp}, "fabric": {"precision": "32-true"}}))
    unported_precision(dotdict({"algo": {"name": "dreamer_v3"}, "fabric": {"precision": "bf16-mixed"}}))


# ---------------------------------------------------------------------------------
# one gradient step against the JAX train_step
# ---------------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_steps():
    """The jitted JAX ``train_step`` at bf16 and at float32, the float32
    parameters (zero leaves filled, so every bias shows) and optax state."""
    from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jax_build
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import build_optimizers, make_train_phase
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
    from sheeprl_tpu.utils.env import make_env as jax_make_env

    cfg = jax_compose(overrides("discrete", TRAIN))
    env = jax_make_env(cfg, 0, 0)()
    obs_space = env.observation_space
    env.close()
    steps, params = {}, None
    for precision in ("bf16-true", "32-true"):
        fabric = JaxFabric(devices=1, accelerator="cpu", precision=precision)
        fabric._setup()
        agent, p = jax_build(fabric, *ACTIONS["discrete"], cfg, obs_space, jax.random.PRNGKey(3), params)
        if params is None:
            rng = np.random.default_rng(11)
            params = jax.tree_util.tree_map(
                lambda x: (0.1 * rng.standard_normal(x.shape)).astype(np.float32) if not np.any(x) else np.asarray(x),
                p,
            )
        world_tx, actor_tx, critic_tx, opt_state = build_optimizers(cfg, params)
        steps[precision] = (agent, make_train_phase(agent, cfg, world_tx, actor_tx, critic_tx).train_step)
    return steps, params, opt_state, obs_space


def _bf16_noise(key, jagent, params) -> dict:
    """One JAX ``train_step``'s draws at bf16, in its split order:
    ``k_world, k_img = split(k)``, the world loss splits ``k_world`` once more
    and the scan splits that per step; imagination takes ``k0`` for the first
    action, then per step the prior's key and ``fold_in(k, 1)`` for the
    action. Categorical draws take bf16 Gumbel noise, as
    ``jax.random.categorical`` draws it over bf16 logits."""
    bf = jnp.bfloat16
    shape = (jagent.stochastic_size, jagent.discrete_size)

    def gumbel(k, rows):
        return np.asarray(jax.random.gumbel(k, (rows, *shape), bf).astype(jnp.float32)).reshape(rows, -1)

    def actor(k):
        keys = jax.random.split(k, len(jagent.actions_dim))
        return np.concatenate(
            [np.asarray(jax.random.gumbel(kk, (T * B, d), bf).astype(jnp.float32)) for kk, d in zip(keys, jagent.actions_dim)],
            -1,
        )

    k_world, k_img = jax.random.split(jnp.asarray(key))
    k_scan, _ = jax.random.split(k_world)
    k0, kscan = jax.random.split(k_img)
    step_keys = jax.random.split(kscan, HORIZON)
    noise = {
        "posterior": np.stack([gumbel(k, B) for k in jax.random.split(k_scan, T)]),
        "transition": np.stack([gumbel(k, T * B) for k in step_keys]),
        "action": np.stack([actor(k0)] + [actor(jax.random.fold_in(k, 1)) for k in step_keys]),
    }
    return {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in noise.items()}


def _batch(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    is_first = np.zeros((T, B, 1), np.float32)
    is_first[2, 1] = 1.0
    terminated = np.zeros((T, B, 1), np.float32)
    terminated[1, 1] = 1.0
    return {
        "rgb": rng.integers(0, 256, (T, B, 3, SCREEN, SCREEN)).astype(np.uint8),
        "state": rng.standard_normal((T, B, 10)).astype(np.float32),
        "actions": np.eye(2, dtype=np.float32)[rng.integers(0, 2, (T, B))],
        "rewards": rng.standard_normal((T, B, 1)).astype(np.float32),
        "terminated": terminated,
        "truncated": np.zeros((T, B, 1), np.float32),
        "is_first": is_first,
    }


def test_train_step_losses_and_gradient_norms():
    """The world, actor and critic losses, the KL and entropy metrics and the
    three groups' gradient norms of one step; the parameters stay float32."""
    from sheeprl_tpu.algos.dreamer_v3.utils import init_moments as jinit_moments
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, build_optimizers
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric

    steps, params, opt_state, obs_space = _jax_steps()
    cfg = compose(overrides("discrete", TRAIN))
    agent = build_agent(Fabric(accelerator="cpu", precision="bf16-mixed"), *ACTIONS["discrete"], cfg, obs_space, 3, params)
    trainer = DV3Trainer(agent, cfg, build_optimizers(cfg, agent))
    batch = _batch()
    key = jax.random.PRNGKey(21)
    metrics = {}
    for precision, (jagent, train_step) in steps.items():
        copy = jax.tree_util.tree_map(jnp.array, (params, opt_state))
        metrics[precision] = train_step(*copy, jinit_moments(), batch, jnp.asarray(0), np.asarray(key))[3]
    ours = trainer.train_step({k: torch.from_numpy(v) for k, v in batch.items()}, 0, _bf16_noise(key, steps["bf16-true"][0], params))
    assert all(p.dtype == torch.float32 for p in agent.parameters())
    assert sorted(ours) == sorted(metrics["bf16-true"])
    jbf = {k: float(np.asarray(v, np.float32)) for k, v in metrics["bf16-true"].items()}
    j32 = {k: float(np.asarray(v, np.float32)) for k, v in metrics["32-true"].items()}
    mine = {k: float(v.float()) for k, v in ours.items()}
    for name in jbf:
        assert np.isfinite(mine[name]), name
        assert abs(mine[name] - jbf[name]) <= STEP_RTOL * max(abs(jbf[name]), 1e-3), (name, mine[name], jbf[name])
    losses = [k for k in jbf if k.startswith("Loss/")]
    d_port = sum(abs(mine[k] - jbf[k]) / max(abs(jbf[k]), 1e-3) for k in losses)
    d_ref = sum(abs(jbf[k] - j32[k]) / max(abs(jbf[k]), 1e-3) for k in losses)
    assert d_port < d_ref, (d_port, d_ref)


# ---------------------------------------------------------------------------------
# checkpoints and the entry points
# ---------------------------------------------------------------------------------
def test_a_jax_bf16_checkpoint_resumes_evaluates_and_serves(tmp_path, capsys):
    """The JAX package trains a tiny DV3 at ``bf16-true`` (a dry run: one
    iteration, its gradient steps, a checkpoint without the replay buffer);
    the port resumes from it at bf16 (its config names the policy), then
    evaluates and serves it at bf16."""
    from sheeprl_tpu.cli import run as jax_run
    from sheeprl_tpu_torch.__main__ import main
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.serve.main import serve_main
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    jax_args = [a for a in CLI_TINY if not a.startswith("algo.per_rank_sequence_length")]
    jax_run(jax_args + [
        "dry_run=True", "env.sync_env=True", "fabric.precision=bf16-true", "metric.log_level=0",
        "buffer.checkpoint=False", "algo.per_rank_sequence_length=1", "root_dir=jax_bf16",
    ])
    ckpt = next((tmp_path / "logs" / "runs" / "jax_bf16").rglob("ckpt_*_0.ckpt"))
    state = load_checkpoint(str(ckpt))
    assert all(np.asarray(x).dtype == np.float32 for x in jax.tree_util.tree_leaves(state["agent"]))

    resumed = run(CLI_TINY + ["algo.total_steps=16", f"checkpoint.resume_from={ckpt}", "dry_run=False",
                              "buffer.prefetch.enabled=False", "root_dir=jax_bf16"])
    assert resumed["log_dir"].endswith("version_1") and resumed["gradient_steps"] >= 1
    assert all(np.isfinite(v) for v in resumed["metrics"].values())
    new_ckpt = tmp_path / resumed["checkpoint"]
    assert "precision: bf16-true" in (new_ckpt.parent.parent / "config.yaml").read_text()

    capsys.readouterr()
    assert main(["evaluation", f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "env.capture_video=False"]) == 0
    assert "Test - Reward:" in capsys.readouterr().out
    rc = serve_main([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "serve.sessions=2", "serve.slots=2",
                     "serve.max_session_steps=6", f"serve.log_dir={tmp_path / 'serve'}"])
    assert rc == 0


def test_cli_trains_resumes_and_evaluates_at_bf16(tmp_path, capsys):
    """The port's own run at ``bf16-mixed``: train, resume from the last
    checkpoint (its float32 layout), evaluate; serving the checkpoint at
    bf16 keeps the JAX table's carry dtypes."""
    from sheeprl_tpu_torch.__main__ import main
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.serve.main import build_serve_cfg
    from sheeprl_tpu_torch.serve.policy import resolve_serve_policy
    from sheeprl_tpu_torch.serve.slots import SlotTable
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    args = CLI_TINY + ["fabric.precision=bf16-mixed"]
    first = run(args + ["algo.total_steps=12"])
    ckpt = tmp_path / first["checkpoint"]
    assert first["gradient_steps"] >= 2 and all(np.isfinite(v) for v in first["metrics"].values())
    leaves = jax.tree_util.tree_leaves(load_checkpoint(str(ckpt))["agent"])
    assert all(np.asarray(x).dtype == np.float32 for x in leaves)

    resumed = run(args + ["algo.total_steps=20", f"checkpoint.resume_from={ckpt}"])
    assert resumed["log_dir"].endswith("version_1") and resumed["gradient_steps"] >= 1
    capsys.readouterr()
    assert main(["evaluation", f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "env.capture_video=False"]) == 0
    assert "Test - Reward:" in capsys.readouterr().out

    cfg = build_serve_cfg([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu"])
    fabric = Fabric(accelerator="cpu", precision=cfg.fabric.precision)
    table = SlotTable(resolve_serve_policy(fabric, cfg, load_checkpoint(str(ckpt))), 2)
    obs = {k: spec.zeros(2) for k, spec in table.policy.obs_spec.items()}
    table.step(obs, np.array([True, True]))
    assert {k: v.dtype for k, v in table.states.items()} == {
        "action": torch.float32, "h": torch.float32, "z": torch.bfloat16
    }
