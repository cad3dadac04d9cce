"""Dreamer-V2 through the port's entry points, on the CPU.

- the port's own run trains (sequential buffer), resumes into version_1,
  evaluates and serves; bf16 is refused by name;
- a checkpoint the JAX package wrote (Flax params, ``optax.adamw`` states of
  its three groups after one update, its counters and config.yaml) resumes
  with its optimizer states converted, evaluates and serves;
- the serving step against the JAX package's ``step_slot`` over ticks from
  fresh carries (greedy, the posterior's Gumbel noise from each slot's JAX
  key), and hot reload of a Dreamer-V2 tree: another seed's tree is staged
  and applied, a wider one is refused.

Tolerances: the serving step's recurrent state 1e-5 after 3 ticks (the
forward bar of ``tests/test_torch_dv2_agent.py``), its actions equal.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

from test_torch_helpers import dreamer_overrides, jax_dreamer, port_dreamer

RUN = [
    "env.capture_video=False", "env.num_envs=2", "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=4",
    "algo.learning_starts=8", "algo.replay_ratio=0.5", "algo.horizon=3", "algo.per_rank_pretrain_steps=1",
    "buffer.size=64", "buffer.memmap=False", "checkpoint.every=8", "metric.log_level=0", "root_dir=tiny",
    "run_name=run",
]


def tiny_run(algo: str, env_id: str = "discrete_dummy") -> list:
    """A short run of ``algo`` at the small widths on a dummy env."""
    kind = {"discrete_dummy": "discrete", "continuous_dummy": "continuous"}[env_id]
    return dreamer_overrides(algo, kind) + RUN


def _evaluates(ckpt, capsys) -> None:
    from sheeprl_tpu_torch.__main__ import main

    capsys.readouterr()
    assert main(["evaluation", f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "env.capture_video=False"]) == 0
    assert "Test - Reward:" in capsys.readouterr().out


def _serves(ckpt, log_dir) -> dict:
    from sheeprl_tpu_torch.__main__ import main

    assert main(["serve", f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "serve.sessions=3", "serve.slots=2",
                 "serve.max_session_steps=6", f"serve.log_dir={log_dir}"]) == 0
    summary = json.loads((log_dir / "summary.json").read_text())
    assert summary["sessions_completed"] == 3
    return summary


def test_cli_trains_resumes_evaluates_and_serves(tmp_path, capsys):
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    first = run(tiny_run("dreamer_v2") + ["algo.total_steps=16"])
    ckpt = tmp_path / first["checkpoint"]
    assert first["gradient_steps"] >= 2 and all(np.isfinite(v) for v in first["metrics"].values())
    state = load_checkpoint(str(ckpt))
    assert sorted(state["agent"]) == ["actor", "critic", "target_critic", "world_model"]
    assert sorted(state["opt_state"]) == ["actor", "critic", "world_model"] and "moments" not in state and "rb" in state
    resumed = run(tiny_run("dreamer_v2") + ["algo.total_steps=24", f"checkpoint.resume_from={ckpt}"])
    assert resumed["log_dir"].endswith("version_1") and resumed["policy_steps"] == 24 and resumed["iterations"] == 4
    _evaluates(ckpt, capsys)
    _serves(ckpt, tmp_path / "serve")
    with pytest.raises(NotImplementedError, match="bf16"):
        run(tiny_run("dreamer_v2") + ["algo.total_steps=16", "fabric.precision=bf16-mixed"])
    # the exp's own env group composes, and refuses to build without its package
    with pytest.raises(NotImplementedError, match="ale_py"):
        run([o for o in tiny_run("dreamer_v2") if o not in ("env=dummy", "env.id=discrete_dummy")] +
            ["algo.total_steps=16"])


def test_an_exploration_actor_acts_until_learning_starts(tmp_path):
    """``main(..., exploration_actor=...)`` (Plan2Explore's finetuning hook of
    the JAX loop): when the player acts before learning starts, as in a
    resumed run's wait, it acts with that actor, and with the agent's after."""
    import copy

    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import main
    from sheeprl_tpu_torch.cli import resume_from_checkpoint, run, setup_metrics
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric

    first = run(tiny_run("dreamer_v2") + ["algo.total_steps=16"])
    tagent, _ = port_dreamer("dreamer_v2", "discrete")

    class Counting(torch.nn.Module):
        def __init__(self, actor):
            super().__init__()
            self.actor, self.calls = actor, 0

        def forward(self, latent):
            self.calls += 1
            return self.actor(latent)

    explorer = Counting(copy.deepcopy(tagent.actor))
    args = tiny_run("dreamer_v2") + ["algo.total_steps=32", f"checkpoint.resume_from={tmp_path / first['checkpoint']}"]
    cfg = resume_from_checkpoint(compose(args), overrides=args)
    setup_metrics(cfg)
    summary = main(Fabric(accelerator="cpu"), cfg, exploration_actor=explorer)
    # iterations 9 to 16; learning starts at iteration 9 + 8 / 2 envs = 13, so
    # the explorer acts in 9-13 (the JAX loop's iter_num <= learning_starts)
    assert summary["player_calls"] == 8 and explorer.calls == 5 and summary["gradient_steps"] >= 1


def jax_run(run_dir, algo: str = "dreamer_v2", env_id: str = "discrete_dummy"):
    """A Dreamer-V2 (or V1) checkpoint as the JAX package writes one: its
    params, the optax states of its three groups (adamw for DV2's weight
    decay, adam for DV1) with one update taken, its counters, and its
    config.yaml beside."""
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import build_optimizers
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.utils.checkpoint import save_checkpoint
    from sheeprl_tpu.utils.utils import Ratio, save_configs

    kind = {"discrete_dummy": "discrete", "continuous_dummy": "continuous"}[env_id]
    _, params, _, _ = jax_dreamer(algo, kind)
    cfg = jax_compose([o for o in tiny_run(algo, env_id) if not o.startswith(("root_dir", "run_name"))])
    world_tx, actor_tx, critic_tx, opt_state = build_optimizers(cfg, params)
    rng = np.random.default_rng(5)
    for name, tx in (("world_model", world_tx), ("actor", actor_tx), ("critic", critic_tx)):
        grads = jax.tree_util.tree_map(lambda x: rng.standard_normal(x.shape).astype(np.float32), params[name])
        opt_state[name] = jax.jit(tx.update)(grads, opt_state[name], params[name])[1]
    ratio = Ratio(0.5, pretrain_steps=1)
    ratio(8)
    state = {"agent": params, "opt_state": opt_state, "ratio": ratio.state_dict(), "iter_num": 4, "batch_size": 2,
             "last_log": 0, "last_checkpoint": 8}
    save_configs(cfg, str(run_dir))
    ckpt = run_dir / "checkpoint" / "ckpt_8_0.ckpt"
    save_checkpoint(str(ckpt), state)
    return ckpt, opt_state


def test_a_jax_checkpoint_resumes_evaluates_and_serves(tmp_path, capsys):
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import make_trainer
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
    from test_torch_dv2_train import adam_mu

    ckpt, opt_state = jax_run(tmp_path / "jax_run" / "version_0")
    # the three optax.adamw chains load into the port's AdamWs
    tagent, cfg = port_dreamer("dreamer_v2", "discrete")
    trainer = make_trainer(tagent, cfg)
    trainer.load_opt_state(load_checkpoint(str(ckpt))["opt_state"])
    for name, opt in trainer.optimizers.items():
        params = [p for g in opt.param_groups for p in g["params"]]
        mus = trainer.group_to_torch(name)(jax.tree_util.tree_map(np.asarray, adam_mu(opt_state[name])))
        assert all(float(opt.state[p]["step"]) == 1 for p in params)
        for p, mu in zip(params, mus):
            np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(), mu.numpy(), rtol=0, atol=0)
    # the JAX config turns the replay prefetch thread on, which the port refuses
    resumed = run(tiny_run("dreamer_v2") + ["algo.total_steps=24", f"checkpoint.resume_from={ckpt}",
                                            "buffer.prefetch.enabled=False"])
    assert resumed["policy_steps"] == 24 and resumed["iterations"] == 8 and resumed["gradient_steps"] >= 1
    assert all(np.isfinite(v) for v in resumed["metrics"].values())
    _evaluates(ckpt, capsys)
    _serves(ckpt, tmp_path / "serve")


def test_serve_step_matches_jax_and_reloads_a_dv2_tree(tmp_path):
    from sheeprl_tpu.algos.dreamer_v2.serve import get_serve_policy as jax_serve_policy
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.serve.policy import resolve_serve_policy
    from sheeprl_tpu_torch.serve.reload import WeightStager, params_aval_mismatch

    _, params, cfg_jax, _ = jax_dreamer("dreamer_v2", "discrete")
    _, cfg = port_dreamer("dreamer_v2", "discrete")
    cfg["serve"] = {"greedy": True}
    cfg_jax["serve"] = {"greedy": True}
    policy = resolve_serve_policy(Fabric(accelerator="cpu"), cfg, {"agent": params})
    jfabric = JaxFabric(devices=1, accelerator="cpu")
    jfabric._setup()
    jpolicy = jax_serve_policy(jfabric, cfg_jax, {"agent": params})
    assert policy.meta["family"] == jpolicy.meta["family"] == "dreamer_v2"
    slots = 2
    carry = policy.init_slots(slots)
    jcarries = [jpolicy.init_slot(jpolicy.params, jax.random.PRNGKey(100 + i)) for i in range(slots)]
    rng = np.random.default_rng(6)
    for _ in range(3):
        obs = {"rgb": rng.integers(0, 256, (slots, 3, 64, 64)).astype(np.uint8),
               "state": rng.standard_normal((slots, 10)).astype(np.float32)}
        repr_noise = []
        for i in range(slots):
            _, k_repr, _ = jax.random.split(jcarries[i]["key"], 3)
            repr_noise.append(np.asarray(jax.random.gumbel(k_repr, (4, 4))).reshape(-1))
        actions, carry = policy.step_slots(carry, {k: torch.from_numpy(v) for k, v in obs.items()},
                                           {"repr": torch.from_numpy(np.stack(repr_noise))})
        for i in range(slots):
            j_action, jcarries[i] = jpolicy.step_slot(jpolicy.params, jcarries[i], {k: v[i] for k, v in obs.items()})
            assert int(actions[i]) == int(np.asarray(j_action))
            np.testing.assert_allclose(carry["h"][i].numpy(), np.asarray(jcarries[i]["h"]), rtol=1e-5, atol=1e-5)

    # hot reload: the stager takes a Dreamer-V2 tree of the serving layout
    stager = WeightStager(policy)
    other = jax.tree_util.tree_map(lambda x: (x + 0.5).astype(np.float32), params)
    assert params_aval_mismatch(stager.layout, other) is None
    stager.stage(other).apply(policy.module)
    np.testing.assert_allclose(policy.module.critic.head.bias.detach().numpy(), other["critic"]["Dense_0"]["bias"])
    _, wider, _, _ = jax_dreamer("dreamer_v2", "discrete", ("algo.dense_units=16",))
    assert "shape" in params_aval_mismatch(stager.layout, wider)
