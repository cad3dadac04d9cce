"""Plan2Explore on Dreamer-V1 and V2 through the port's entry points, on the CPU.

- the port's own exploration run trains, checkpoints (the P2E layout, six
  optimizer states) and resumes into version_1; a finetuning run starts from
  its checkpoint (P2E-DV2 with the exploration buffer,
  ``buffer.load_from_exploration``, P2E-DV1 without), acts with the
  exploration actor until learning starts and with the task actor after,
  writes checkpoints in the backbone's layout, and resumes; every checkpoint
  evaluates, the finetuning ones as Plan2Explore's and as the backbone's;
- checkpoints the JAX package wrote: a P2E exploration checkpoint (Flax
  params, the six optax states after one update, its config.yaml) resumes
  with its optimizer states converted, finetunes and evaluates; a P2E-DV2
  finetuning checkpoint in Dreamer-V2's layout evaluates and resumes.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from test_torch_dv2_cli import RUN, _evaluates
from test_torch_helpers import dreamer_overrides
from test_torch_p2e_dv import KIND, jax_p2e_dv


def tiny(v: int, phase: str, run_name: str) -> list:
    """A short P2E-DV run at the small widths on a dummy env, 3 members."""
    base = dreamer_overrides(f"dreamer_v{v}", KIND[v]) + [o for o in RUN if not o.startswith("run_name")]
    return [f"exp=p2e_dv{v}_{phase}", *[o for o in base if not o.startswith("exp=")], "algo.ensembles.n=3",
            f"run_name={run_name}"]


DV_LAYOUT = {1: ["actor", "critic", "world_model"], 2: ["actor", "critic", "target_critic", "world_model"]}
P2E_LAYOUT = {1: ["actor_exploration", "actor_task", "critic_exploration", "critic_task", "ensembles",
                  "world_model"]}
P2E_LAYOUT[2] = sorted(P2E_LAYOUT[1] + ["target_critic_exploration", "target_critic_task"])
GROUPS = ["actor_exploration", "actor_task", "critic_exploration", "critic_task", "ensembles", "world_model"]


@pytest.mark.parametrize("v,from_buffer", [(1, False), (2, True)], ids=["p2e_dv1", "p2e_dv2-load_from_exploration"])
def test_cli_explores_finetunes_resumes_and_evaluates(v, from_buffer, tmp_path, capsys):
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    expl = run(tiny(v, "exploration", "expl") + ["algo.total_steps=16"])
    expl_ckpt = tmp_path / expl["checkpoint"]
    assert expl["gradient_steps"] >= 2 and all(np.isfinite(x) for x in expl["metrics"].values())
    assert {"Loss/ensemble_loss", "Rewards/intrinsic", "Loss/policy_loss_exploration"} <= set(expl["metrics"])
    state = load_checkpoint(str(expl_ckpt))
    assert sorted(state["agent"]) == P2E_LAYOUT[v] and sorted(state["opt_state"]) == GROUPS and "rb" in state
    resumed = run(tiny(v, "exploration", "expl") + ["algo.total_steps=24", f"checkpoint.resume_from={expl_ckpt}"])
    assert resumed["log_dir"].endswith("version_1") and resumed["policy_steps"] == 24

    finetuning = tiny(v, "finetuning", "ft") + [f"checkpoint.exploration_ckpt_path={expl_ckpt}",
                                                f"buffer.load_from_exploration={from_buffer}"]
    ft = run(finetuning + ["algo.total_steps=12"])
    # learning starts at iteration 8 / 2 envs = 4: the exploration actor acted
    # in iterations 1-4, the task actor from iteration 5
    assert ft["actor_switch"] == {"iteration": 4, "player_calls_before": 4}
    assert ft["player_calls"] == 6 and ft["gradient_steps"] >= 1 and "Loss/policy_loss" in ft["metrics"]
    ft_ckpt = tmp_path / ft["checkpoint"]
    ft_state = load_checkpoint(str(ft_ckpt))
    assert sorted(ft_state["agent"]) == DV_LAYOUT[v] and sorted(ft_state["opt_state"]) == ["actor", "critic",
                                                                                           "world_model"]
    # with the exploration buffer each env's ring holds the exploration run's
    # rows (8 iterations) before its own (6), without it fewer than those
    expl_rows = [b._pos for b in state["rb"].buffer]
    ft_rows = [b._pos for b in ft_state["rb"].buffer]
    assert all((f > e) == from_buffer for f, e in zip(ft_rows, expl_rows)), (ft_rows, expl_rows)
    ft_resumed = run(finetuning + ["algo.total_steps=16", f"checkpoint.resume_from={ft_ckpt}"])
    assert ft_resumed["log_dir"].endswith("version_1") and ft_resumed["policy_steps"] == 16
    assert ft_resumed["actor_switch"] is None
    for ckpt in (expl_ckpt, ft_ckpt):
        _evaluates(ckpt, capsys)


def jax_p2e_run(run_dir, v: int):
    """A P2E-DV exploration checkpoint as the JAX package writes one: its
    params, the six optax states with one update taken, its counters, and its
    config.yaml beside (no replay buffer)."""
    from sheeprl_tpu.algos.p2e_dv1.p2e_dv1_exploration import build_txs
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.utils.checkpoint import save_checkpoint
    from sheeprl_tpu.utils.utils import Ratio, save_configs

    _, _, params, _, _ = jax_p2e_dv(v)
    cfg = jax_compose(tiny(v, "exploration", "jax") + ["buffer.checkpoint=False"])
    txs = build_txs(cfg)
    rng = np.random.default_rng(5)
    opt_state = {}
    for name, tx in txs.items():
        grads = jax.tree_util.tree_map(lambda x: rng.standard_normal(x.shape).astype(np.float32), params[name])
        opt_state[name] = jax.jit(tx.update)(grads, tx.init(params[name]), params[name])[1]
    ratio = Ratio(0.5, pretrain_steps=1)
    ratio(8)
    state = {"agent": params, "opt_state": opt_state, "ratio": ratio.state_dict(), "iter_num": 4, "batch_size": 2,
             "last_log": 0, "last_checkpoint": 8}
    save_configs(cfg, str(run_dir))
    ckpt = run_dir / "checkpoint" / "ckpt_8_0.ckpt"
    save_checkpoint(str(ckpt), state)
    return ckpt, opt_state


@pytest.mark.parametrize("v", [1, 2], ids=["p2e_dv1", "p2e_dv2"])
def test_jax_checkpoints_resume_finetune_and_evaluate(v, tmp_path, capsys):
    import importlib

    from sheeprl_tpu.utils.checkpoint import save_checkpoint
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
    from test_torch_dv2_train import adam_mu
    from test_torch_p2e_dv import port_p2e_dv

    ckpt, opt_state = jax_p2e_run(tmp_path / "jax_expl" / "version_0", v)
    # the six optax chains load into the port's optimizers
    tagent, cfg = port_p2e_dv(v)
    trainer = importlib.import_module(f"sheeprl_tpu_torch.algos.p2e_dv{v}.p2e_dv{v}_exploration").make_trainer(tagent,
                                                                                                               cfg)
    trainer.load_opt_state(load_checkpoint(str(ckpt))["opt_state"])
    for name, opt in trainer.optimizers.items():
        params = [p for g in opt.param_groups for p in g["params"]]
        mus = trainer.group_to_torch(name)(jax.tree_util.tree_map(np.asarray, adam_mu(opt_state[name])))
        assert all(float(opt.state[p]["step"]) == 1 for p in params)
        for p, mu in zip(params, mus):
            np.testing.assert_array_equal(opt.state[p]["exp_avg"].numpy(), mu.numpy())
    # the JAX config turns the replay prefetch thread on, which the port refuses
    resumed = run(tiny(v, "exploration", "jax") + ["algo.total_steps=24", f"checkpoint.resume_from={ckpt}",
                                                   "buffer.prefetch.enabled=False"])
    assert resumed["policy_steps"] == 24 and resumed["gradient_steps"] >= 1
    ft = run(tiny(v, "finetuning", "ft") + ["algo.total_steps=12", f"checkpoint.exploration_ckpt_path={ckpt}"])
    assert ft["actor_switch"] == {"iteration": 4, "player_calls_before": 4} and ft["gradient_steps"] >= 1
    _evaluates(ckpt, capsys)
    if v == 2:
        # a JAX finetuning run checkpoints Dreamer-V2's layout and optimizers:
        # it evaluates, and resumes in the port
        from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import build_optimizers
        from sheeprl_tpu.config import compose as jax_compose
        from sheeprl_tpu.utils.utils import save_configs

        agent = load_checkpoint(str(ckpt))["agent"]
        dv2 = {"world_model": agent["world_model"], "actor": agent["actor_task"], "critic": agent["critic_task"],
               "target_critic": agent["target_critic_task"]}
        finetuning = tiny(v, "finetuning", "jax_ft") + [f"checkpoint.exploration_ckpt_path={ckpt}",
                                                        "buffer.checkpoint=False"]
        cfg_ft = jax_compose(finetuning)
        *_, dv2_opt = build_optimizers(cfg_ft, dv2)
        ft_dir = tmp_path / "jax_ft" / "version_0"
        save_configs(cfg_ft, str(ft_dir))
        ft_ckpt = ft_dir / "checkpoint" / "ckpt_8_0.ckpt"
        save_checkpoint(str(ft_ckpt), {"agent": dv2, "opt_state": dv2_opt, "ratio": {"_ratio": 0.5, "_prev": 8,
                                                                                    "_pretrain_steps": 1},
                                       "iter_num": 4, "batch_size": 2, "last_log": 0, "last_checkpoint": 8})
        _evaluates(ft_ckpt, capsys)
        ft_resumed = run(finetuning + ["algo.total_steps=24", f"checkpoint.resume_from={ft_ckpt}",
                                       "buffer.prefetch.enabled=False"])
        assert ft_resumed["policy_steps"] == 24 and ft_resumed["gradient_steps"] >= 1
