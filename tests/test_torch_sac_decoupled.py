"""Decoupled SAC of the port (``algos/sac/sac_decoupled.py``) against the JAX
package's, on the CPU.

- two learner rounds (the target EMA's gate open in the first, shut in the
  second): the JAX ``_trainer_loop`` and the port's learner, each driven in a
  thread through two depth-1 queues, from the same parameters and blocks; the
  port's normal noise is the JAX learner's, drawn from ``PRNGKey(seed + 1)`` in
  the order it splits it;
- the CLI: ``exp=sac_decoupled`` trains, resumes from a mid-run checkpoint
  (with its replay buffer and ``Ratio``), evaluates and serves; a checkpoint of
  the JAX learner's state resumes; and a decoupled run trains as the coupled
  run of the same config does.

Tolerances as ``test_torch_sac.py``'s: 1e-5 for parameters and mean losses
after a round of three gradient steps (each three Adam updates of size ~lr,
through different matmul kernels), 1e-6 for Adam's moments.
"""

from __future__ import annotations

import functools
import queue
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import SAC_TINY, f32, jax_sac, losses_close, optax_states_close, port_sac, replay_block
from test_torch_helpers import trees_close, unsaturated

ATOL = 1e-6
PARAM_ATOL = 1e-5
# target_network_frequency 8 over 4 envs: the EMA runs on every third iteration
EMA_GATE = ("env.num_envs=4", "algo.critic.target_network_frequency=8")
ITERS, G, B = (3, 4), 3, 8


@functools.lru_cache(maxsize=None)
def _jax_rounds():
    """The JAX learner's initial params, config, blocks and replies to two
    rounds (the optimizers' states asked for in the second)."""
    from sheeprl_tpu.algos.sac.sac_decoupled import _trainer_loop
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric

    actor, critic, params, cfg = jax_sac("sac_decoupled", EMA_GATE)
    params = unsaturated(params)
    fabric = JaxFabric(devices=1, accelerator="cpu")
    fabric._setup()
    rng = np.random.default_rng(4)
    blocks = [replay_block(rng, (G, B)) for _ in ITERS]
    data_q, params_q, error = queue.Queue(maxsize=1), queue.Queue(maxsize=1), {}
    thread = threading.Thread(target=_trainer_loop, daemon=True,
                              args=(fabric, cfg, actor, critic, jax.tree_util.tree_map(jnp.asarray, params), -1.0,
                                    data_q, params_q, error))
    thread.start()
    replies = []
    for block, iter_num, want in zip(blocks, ITERS, (False, True)):
        data_q.put((block, iter_num, want))
        reply = params_q.get(timeout=300)
        assert reply is not None, error
        replies.append(reply)
    data_q.put(None)
    assert params_q.get(timeout=60) is None
    thread.join(timeout=60)
    return cfg, params, blocks, replies


def _jax_noise(seed: int):
    """Per round ``key, train_key = split(key)``; the phase splits
    ``train_key`` into G step keys, each into the critic's and the actor's draw."""
    key = jax.random.PRNGKey(seed + 1)
    for _ in ITERS:
        key, train_key = jax.random.split(key)
        eps = [jax.random.split(k) for k in jax.random.split(train_key, G)]
        yield {
            "critic": torch.stack([f32(jax.random.normal(kc, (B, 1))) for kc, _ in eps]),
            "actor": torch.stack([f32(jax.random.normal(ka, (B, 1))) for _, ka in eps]),
        }


@pytest.mark.timeout(300)
def test_two_learner_rounds_match_the_jax_trainer_loop():
    from sheeprl_tpu_torch.algos.sac.sac import SACTrainer, build_optimizers
    from sheeprl_tpu_torch.algos.sac.sac_decoupled import SACLearner
    from sheeprl_tpu_torch.interop.flax_to_torch import sac_to_flax
    from sheeprl_tpu_torch.parallel.decoupled import LearnerThread

    cfg_jax, params, blocks, theirs = _jax_rounds()
    agent, cfg = port_sac("sac_decoupled", EMA_GATE, params=params)
    learner = SACLearner(SACTrainer(agent, build_optimizers(cfg, agent), cfg, -1.0, 4), int(cfg.seed))
    assert learner.trainer.target_period == 3
    noise = _jax_noise(int(cfg.seed))
    learner.draw = lambda G_, B_: next(noise)
    view, _ = port_sac("sac_decoupled", EMA_GATE, params=params)
    replies = []
    with LearnerThread(learner, "sac-learner-test") as channel:
        for block, iter_num, want, (j_params, j_opt, j_losses, _) in zip(blocks, ITERS, (False, True), theirs):
            replies.append(channel.exchange({k: f32(v) for k, v in block.items()}, iter_num, want))
            state, opt_state, losses = replies[-1]
            view.load_state_dict(state)
            trees_close(sac_to_flax(view), j_params, atol=PARAM_ATOL)
            losses_close(losses, j_losses)
            assert (opt_state is None) == (j_opt is None)
        assert channel.close() is None
    assert not channel.thread.is_alive()
    # the optimizers' states as the reply carried them
    fresh = SACTrainer(view, build_optimizers(cfg, view), cfg, -1.0, 4)
    fresh.load_opt_state(opt_state)
    optax_states_close(fresh, theirs[1][1], atol=ATOL)
    # the first reply is a copy taken at its round
    view.load_state_dict(replies[0][0])
    trees_close(sac_to_flax(view), theirs[0][0], atol=PARAM_ATOL)


TINY = ["exp=sac_decoupled", *SAC_TINY[1:]]


@pytest.mark.timeout(300)
def test_cli_trains_resumes_from_a_mid_run_checkpoint_evaluates_and_serves(tmp_path, capsys):
    """64 steps (learning starts at iteration 8, checkpoints every 32 steps);
    the run resumed from the first checkpoint, with its buffer and governor,
    writes the last checkpoint and not the first; evaluation and serving take
    the checkpoint."""
    import json

    from sheeprl_tpu_torch.__main__ import main
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    first = run(TINY + ["algo.total_steps=64"])
    # Ratio's first call takes 11 gradient steps, then 2 per iteration (as the coupled loop)
    assert first["iterations"] == 32 and first["gradient_steps"] == 11 + 2 * 24
    ckpt_dir = tmp_path / first["log_dir"] / "checkpoint"
    assert sorted(p.name for p in ckpt_dir.glob("*.ckpt")) == ["ckpt_32_0.ckpt", "ckpt_64_0.ckpt"]
    state = load_checkpoint(str(ckpt_dir / "ckpt_32_0.ckpt"))
    assert state["rb"]._pos == 16 and sorted(state["opt_state"]) == ["actor", "alpha", "critic"]
    resumed = run(TINY + ["algo.total_steps=64", f"checkpoint.resume_from={ckpt_dir / 'ckpt_32_0.ckpt'}"])
    assert resumed["log_dir"].endswith("version_1") and resumed["gradient_steps"] > 0
    names = sorted(p.name for p in (tmp_path / resumed["log_dir"] / "checkpoint").glob("*.ckpt"))
    assert names == ["ckpt_64_0.ckpt"]
    last = tmp_path / resumed["checkpoint"]
    capsys.readouterr()
    assert main(["evaluation", f"checkpoint_path={last}", "fabric.accelerator=cpu", "env.capture_video=False"]) == 0
    assert "Test - Reward:" in capsys.readouterr().out
    log_dir = tmp_path / "serve"
    assert main(["serve", f"checkpoint_path={last}", "fabric.accelerator=cpu", "serve.sessions=2", "serve.slots=2",
                 f"serve.log_dir={log_dir}"]) == 0
    assert json.loads((log_dir / "summary.json").read_text())["sessions_completed"] == 2


@pytest.mark.timeout(300)
def test_a_jax_sac_decoupled_checkpoint_resumes(tmp_path):
    """A checkpoint of the JAX learner's state after its second round (Flax
    params, the three optax Adam states), without a replay buffer, with the
    JAX config of ``exp=sac_decoupled`` beside it: the channel trainer loads
    them into the learner's optimizers as they were, and the resumed run
    trains."""
    import yaml

    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
    from sheeprl_tpu_torch.algos.sac.sac import build_optimizers
    from sheeprl_tpu_torch.algos.sac.sac_decoupled import ChannelTrainer
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    _, _, _, replies = _jax_rounds()
    j_params, j_opt = jax.tree_util.tree_map(np.asarray, replies[1][0]), replies[1][1]
    cfg_jax = jax_compose(TINY + ["algo.total_steps=48", "buffer.checkpoint=False"])
    run_dir = tmp_path / "jax_run" / "version_0"
    ckpt = run_dir / "checkpoint" / "ckpt_32_0.ckpt"
    jax_save_checkpoint(str(ckpt), {"agent": j_params, "opt_state": j_opt,
                                    "ratio": {"_ratio": 1.0, "_prev": 24, "_pretrain_steps": 0},
                                    "iter_num": 16, "batch_size": 8, "last_log": 32, "last_checkpoint": 32})
    (run_dir / "config.yaml").write_text(yaml.safe_dump(cfg_jax.as_dict()))
    state = load_checkpoint(str(ckpt))
    agent, cfg = port_sac("sac_decoupled", params=state["agent"])
    trainer = ChannelTrainer(agent, build_optimizers(cfg, agent), cfg, -1.0, 2)
    trainer.load_opt_state(state["opt_state"])
    optax_states_close(trainer.learner_trainer, j_opt, atol=0.0)
    assert trainer.close() is None
    # the JAX package's config turns its prefetch thread on; the port refuses it
    resumed = run(TINY + ["algo.total_steps=80", "buffer.checkpoint=False", "buffer.prefetch.enabled=False",
                          f"checkpoint.resume_from={ckpt}"])
    assert resumed["policy_steps"] == 80 and resumed["gradient_steps"] > 0
    assert all(np.isfinite(v) for v in resumed["metrics"].values())


@pytest.mark.timeout(300)
def test_a_decoupled_run_trains_as_the_coupled_run():
    """The same config under ``exp=sac`` and ``exp=sac_decoupled``: the same
    gradient steps, losses and final checkpoint, bit for bit (the learner's
    generator is seeded as the coupled loop's train generator), its
    optimizers' states with the parameters beside them."""
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    runs = {exp: run([f"exp={exp}", *SAC_TINY[1:-2], "algo.total_steps=48", f"root_dir={exp}", "run_name=r"])
            for exp in ("sac", "sac_decoupled")}
    coupled, decoupled = runs["sac"], runs["sac_decoupled"]
    assert decoupled["gradient_steps"] == coupled["gradient_steps"] > 0
    assert decoupled["metrics"] == coupled["metrics"]
    ours, theirs = (load_checkpoint(r["checkpoint"]) for r in (decoupled, coupled))
    trees_close(ours["agent"], theirs["agent"], atol=0.0)
    assert sorted(ours["opt_state"]) == sorted(theirs["opt_state"]) == ["actor", "alpha", "critic"]
    for name, opt in theirs["opt_state"].items():
        assert ours["opt_state"][name]["param_groups"] == opt["param_groups"]
        for i, state in opt["state"].items():
            for k, v in state.items():
                np.testing.assert_array_equal(ours["opt_state"][name]["state"][i][k], v, err_msg=f"{name} {i} {k}")
