"""Plan2Explore (Dreamer-V3) through the port's entry points, on the CPU.

- the port's own exploration run trains, checkpoints (with its replay
  buffer) and resumes; a finetuning run starts from its checkpoint with the
  buffer (``buffer.load_from_exploration``), acts with the exploration actor
  until learning starts and with the task actor after, and resumes; both
  checkpoints evaluate;
- an exploration checkpoint the JAX package wrote (Flax params, optax states,
  Moments, its config.yaml) finetunes in the port, resumes the exploration
  with its optimizer states converted, and evaluates; one that carries the
  JAX package's replay buffer is refused by name when finetuning would load it.
"""

from __future__ import annotations

import numpy as np
import pytest

from test_torch_dv3_train import SCREEN, TRAIN
from test_torch_helpers import jax_p2e, p2e_overrides

SMALL = [o for o in p2e_overrides() if not o.startswith(("exp=", "metric."))]
RUN = [
    "env.capture_video=False", "env.num_envs=2", f"env.screen_size={SCREEN}", "algo.per_rank_batch_size=2",
    "algo.per_rank_sequence_length=2", "algo.replay_ratio=0.5", "algo.horizon=3", "buffer.size=64",
    "buffer.memmap=False", "checkpoint.every=4", "root_dir=tiny",
]
EXPLORATION = ["exp=p2e_dv3_exploration", *SMALL, *RUN, "algo.learning_starts=4", "run_name=expl"]
FINETUNING = ["exp=p2e_dv3_finetuning", *SMALL, *RUN, "algo.learning_starts=8", "run_name=ft"]


def _evaluates(ckpt, capsys) -> None:
    from sheeprl_tpu_torch.__main__ import main

    capsys.readouterr()
    assert main(["evaluation", f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "env.capture_video=False"]) == 0
    assert "Test - Reward:" in capsys.readouterr().out


def test_exploration_then_finetuning_resume_and_evaluate(tmp_path, capsys):
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    first = run(EXPLORATION + ["algo.total_steps=12"])
    expl_ckpt = tmp_path / first["checkpoint"]
    assert first["gradient_steps"] >= 2 and "actor_switch" not in first
    metrics = first["metrics"]
    for name in ("Loss/ensemble_loss", "Loss/policy_loss_exploration", "Rewards/intrinsic_intrinsic",
                 "Loss/value_loss_exploration_extrinsic", "Grads/critic_exploration_intrinsic"):
        assert np.isfinite(metrics[name]), name
    state = load_checkpoint(str(expl_ckpt))
    assert sorted(state["opt_state"]) == sorted(
        ["world_model", "actor_task", "critic_task", "actor_exploration", "ensembles",
         "critic_exploration_intrinsic", "critic_exploration_extrinsic"])
    assert sorted(state["moments"]["exploration"]) == ["extrinsic", "intrinsic"] and "rb" in state
    resumed = run(EXPLORATION + ["algo.total_steps=20", f"checkpoint.resume_from={expl_ckpt}"])
    assert resumed["log_dir"].endswith("version_1") and resumed["gradient_steps"] >= 1

    ft = run(FINETUNING + ["algo.total_steps=12", f"checkpoint.exploration_ckpt_path={expl_ckpt}",
                           "buffer.load_from_exploration=True"])
    # learning starts at iteration 8 / 2 envs = 4: the exploration actor acted
    # in iterations 1-4, the task actor from iteration 5
    assert ft["actor_switch"] == {"iteration": 4, "player_calls_before": 4}
    assert ft["player_calls"] == 6 and ft["gradient_steps"] >= 1
    assert "Loss/policy_loss" in ft["metrics"]
    ft_ckpt = tmp_path / ft["checkpoint"]
    assert sorted(load_checkpoint(str(ft_ckpt))["opt_state"]) == ["actor", "critic", "world_model"]
    # the checkpoint group is this launch's on a resume: it names the exploration run again
    ft_resumed = run(FINETUNING + ["algo.total_steps=16", f"checkpoint.resume_from={ft_ckpt}",
                                   f"checkpoint.exploration_ckpt_path={expl_ckpt}"])
    assert ft_resumed["log_dir"].endswith("version_1") and ft_resumed["policy_steps"] == 16
    _evaluates(expl_ckpt, capsys)
    _evaluates(ft_ckpt, capsys)


def _jax_exploration_run(run_dir, with_buffer: bool = False):
    """An exploration checkpoint as the JAX package writes one: its params,
    the optax states of its seven groups (one update taken), its Moments and
    counters, and its config.yaml beside."""
    import jax

    from sheeprl_tpu.algos.dreamer_v3.utils import init_moments
    from sheeprl_tpu.algos.p2e_dv3.p2e_dv3_exploration import build_txs
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.utils.checkpoint import save_checkpoint
    from sheeprl_tpu.utils.utils import Ratio, save_configs

    _, _, params, _, _ = jax_p2e(tuple(TRAIN))
    cfg = jax_compose(p2e_overrides() + [o for o in RUN if not o.startswith("root_dir")] + ["algo.learning_starts=4"])
    rng = np.random.default_rng(5)
    opt_state = {}
    for name, tx in build_txs(cfg).items():
        group = params["critics_exploration"][name[len("critic_exploration_"):]]["module"] \
            if name.startswith("critic_exploration_") else params[name]
        grads = jax.tree_util.tree_map(lambda x: rng.standard_normal(x.shape).astype(np.float32), group)
        opt_state[name] = jax.jit(tx.update)(grads, tx.init(group), group)[1]
    ratio = Ratio(0.5)
    ratio(8)
    state = {
        "agent": params, "opt_state": opt_state,
        "moments": {"task": init_moments(), "exploration": {k: init_moments() for k in params["critics_exploration"]}},
        "ratio": ratio.state_dict(), "iter_num": 4, "batch_size": 2, "last_log": 0, "last_checkpoint": 8,
    }
    if with_buffer:
        from sheeprl_tpu.data.buffers import EnvIndependentReplayBuffer

        state["rb"] = EnvIndependentReplayBuffer(8, n_envs=2, obs_keys=("rgb", "state"))
    save_configs(cfg, str(run_dir))
    ckpt = run_dir / "checkpoint" / "ckpt_8_0.ckpt"
    save_checkpoint(str(ckpt), state)
    return ckpt


def test_a_jax_exploration_checkpoint_finetunes_resumes_and_evaluates(tmp_path, capsys):
    from sheeprl_tpu_torch.cli import run

    ckpt = _jax_exploration_run(tmp_path / "jax_expl" / "version_0")
    ft = run(FINETUNING + ["algo.total_steps=12", f"checkpoint.exploration_ckpt_path={ckpt}"])
    assert ft["actor_switch"]["iteration"] == 4 and ft["gradient_steps"] >= 1
    assert all(np.isfinite(v) for v in ft["metrics"].values())
    # the JAX config turns the replay prefetch thread on, which the port refuses
    resumed = run(EXPLORATION + ["algo.total_steps=16", f"checkpoint.resume_from={ckpt}",
                                 "buffer.prefetch.enabled=False"])
    assert resumed["policy_steps"] == 16 and resumed["iterations"] == 4 and resumed["gradient_steps"] >= 1
    assert all(np.isfinite(v) for v in resumed["metrics"].values())
    _evaluates(ckpt, capsys)


def test_a_jax_replay_buffer_is_refused_when_finetuning_loads_it(tmp_path):
    from sheeprl_tpu_torch.cli import run

    ckpt = _jax_exploration_run(tmp_path / "jax_expl" / "version_0", with_buffer=True)
    with pytest.raises(NotImplementedError, match="replay buffer of the JAX package"):
        run(FINETUNING + ["algo.total_steps=12", f"checkpoint.exploration_ckpt_path={ckpt}",
                          "buffer.load_from_exploration=True"])
