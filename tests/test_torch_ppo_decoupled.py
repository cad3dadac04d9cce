"""Decoupled PPO of the port (``algos/ppo/ppo_decoupled.py``) against the JAX
package's, on the CPU.

- two learner rounds: the JAX ``_trainer_loop`` and the port's learner, each
  driven in a thread through two depth-1 queues as the ``main`` of its
  package drives it, from the same parameters and blocks; the port's
  permutations are the JAX learner's, drawn from ``PRNGKey(seed + 1)`` in the
  order it splits it;
- the CLI: ``exp=ppo_decoupled`` trains, resumes from a mid-run checkpoint,
  evaluates and serves; a checkpoint of the JAX learner's state resumes;
- a learner that raises ends the run with its exception, and no thread stays.

Tolerance 1e-5 for the act view, the Adam moments and the mean losses after
two rounds (2 epochs x 4 minibatches each, so 16 Adam updates of size ~lr
through different matmul kernels: float32 rounding, not a different update).
"""

from __future__ import annotations

import functools
import queue
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import numpy_tree

ATOL = 1e-5
# 2 envs x 8 steps = 16 rows in minibatches of 4: 2 epochs x 4 minibatches, 4 iterations
PHASE = ["env.num_envs=2", "algo.rollout_steps=8", "algo.per_rank_batch_size=4", "algo.update_epochs=2",
         "algo.anneal_lr=True", "algo.max_grad_norm=0.5", "algo.total_steps=64"]
BASE = ["exp=ppo_decoupled", "fabric.accelerator=cpu", "env.capture_video=False"]
ROWS, EPOCHS, TOTAL_ITERS = 16, 2, 4


def _blocks(space, n=2):
    rng = np.random.default_rng(5)
    blocks = []
    for _ in range(n):
        block = {"state": rng.standard_normal((ROWS, *space["state"].shape)).astype(np.float32)}
        block["actions"] = np.eye(2, dtype=np.float32)[rng.integers(0, 2, ROWS)]
        for k in ("values", "rewards", "returns", "advantages"):
            block[k] = rng.standard_normal((ROWS, 1)).astype(np.float32)
        block["dones"] = (rng.uniform(size=(ROWS, 1)) < 0.15).astype(np.float32)
        block["logprobs"] = -rng.uniform(0.1, 1.5, (ROWS, 1)).astype(np.float32)
        blocks.append(block)
    return blocks


@functools.lru_cache(maxsize=None)
def _jax_rounds():
    """The JAX learner's agent, initial params, config, blocks and its
    replies to two rounds (the optimizer state asked for in the second)."""
    from sheeprl_tpu.algos.ppo.agent import build_agent as jax_build_agent
    from sheeprl_tpu.algos.ppo.ppo_decoupled import _trainer_loop
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
    from sheeprl_tpu.utils.env import make_env as jax_make_env

    cfg = jax_compose(BASE + PHASE)
    space = jax_make_env(cfg, 0, 0)().observation_space
    fabric = JaxFabric(devices=1, accelerator="cpu")
    fabric._setup()
    agent, params = jax_build_agent(fabric, (2,), False, cfg, space, jax.random.PRNGKey(1))
    params = numpy_tree(params)
    blocks = _blocks(space)
    data_q, params_q, error = queue.Queue(maxsize=1), queue.Queue(maxsize=1), {}
    thread = threading.Thread(target=_trainer_loop, daemon=True,
                              args=(fabric, cfg, agent, jax.tree_util.tree_map(jnp.asarray, params), data_q, params_q,
                                    error))
    thread.start()
    replies = []
    for block, want in zip(blocks, (False, True)):
        data_q.put((block, 0.2, 0.01, want))
        reply = params_q.get(timeout=300)
        assert reply is not None, error
        replies.append(jax.tree_util.tree_map(np.asarray, reply))
    data_q.put(None)
    assert params_q.get(timeout=60) is None
    thread.join(timeout=60)
    return cfg, space, params, blocks, replies


def _jax_permutations(seed: int, rounds: int):
    """The JAX learner's: ``key, train_key = split(key)`` per round, then
    ``split(train_key, update_epochs)``, one permutation per epoch key."""
    key = jax.random.PRNGKey(seed + 1)
    out = []
    for _ in range(rounds):
        key, train_key = jax.random.split(key)
        out.append([torch.from_numpy(np.asarray(jax.random.permutation(k, ROWS)).astype(np.int64))
                    for k in jax.random.split(train_key, EPOCHS)])
    return out


def _port_agent(space, params):
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.parallel.fabric import Fabric

    cfg = compose(BASE + PHASE)
    port_space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, space["state"].shape)})
    return build_agent(Fabric(accelerator="cpu"), (2,), False, cfg, port_space, 0, params), cfg


def trees_close(ours, theirs, atol=ATOL):
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours), jax.tree_util.tree_leaves(theirs)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol, err_msg=jax.tree_util.keystr(path))


def as_loaded(tree):
    """``tree`` as the port loads it from a checkpoint the JAX package wrote
    (its optax links become inert objects)."""
    import tempfile

    from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/state.ckpt"
        jax_save_checkpoint(path, {"tree": tree})
        return load_checkpoint(path)["tree"]


def optimizer_close(snap, optax_state, agent, build, to_torch, atol=ATOL):
    """The port's optimizer snapshot against an optax state loaded into a
    fresh optimizer of the same parameters (``interop/optax_to_torch.py``)."""
    from sheeprl_tpu_torch.interop.optax_to_torch import load_optimizer_state

    fresh = build(agent)
    load_optimizer_state(fresh, as_loaded(optax_state), to_torch(agent))
    theirs = fresh.state_dict()["state"]
    assert sorted(snap["state"]) == sorted(theirs)
    for i, state in theirs.items():
        for k, v in state.items():
            np.testing.assert_allclose(np.asarray(snap["state"][i][k]), np.asarray(v), rtol=0, atol=atol,
                                       err_msg=f"param {i} {k}")


@pytest.mark.timeout(300)
def test_two_learner_rounds_match_the_jax_trainer_loop():
    from sheeprl_tpu_torch.algos.ppo.ppo import build_optimizer
    from sheeprl_tpu_torch.algos.ppo.ppo_decoupled import PPOLearner
    from sheeprl_tpu_torch.interop.flax_to_torch import ppo_to_flax, ppo_to_torch
    from sheeprl_tpu_torch.parallel.decoupled import LearnerThread

    cfg_jax, space, params, blocks, theirs = _jax_rounds()
    agent, cfg = _port_agent(space, params)
    learner = PPOLearner(cfg, agent, TOTAL_ITERS)
    perms = iter(_jax_permutations(int(cfg.seed), 2))
    learner.draw = lambda: next(perms)
    view, _ = _port_agent(space, params)
    replies = []
    with LearnerThread(learner, "ppo-learner-test") as channel:
        for block, want, (j_params, j_opt, j_losses, _) in zip(blocks, (False, True), theirs):
            replies.append(channel.exchange({k: torch.from_numpy(v) for k, v in block.items()}, 0.2, 0.01, want))
            params_t, opt_state, losses = replies[-1]
            view.load_state_dict(params_t)
            trees_close(ppo_to_flax(view), j_params)
            np.testing.assert_allclose(losses.numpy(), j_losses, rtol=0, atol=ATOL)
            assert (opt_state is None) == (j_opt is None)
        assert channel.close() is None
    assert not channel.thread.is_alive()
    optimizer_close(opt_state, theirs[1][1], view, lambda a: build_optimizer(cfg, a, TOTAL_ITERS)[0], ppo_to_torch)
    # the first reply is a copy taken at its round: the second round left it as it was
    view.load_state_dict(replies[0][0])
    trees_close(ppo_to_flax(view), theirs[0][0])


TINY = BASE + PHASE[:4] + ["checkpoint.every=16", "metric.log_every=16", "root_dir=dec", "run_name=run"]


@pytest.mark.timeout(300)
def test_cli_trains_resumes_from_a_mid_run_checkpoint_evaluates_and_serves(tmp_path, capsys):
    """48 steps (3 rounds, a checkpoint after each); the run resumed from the
    first checkpoint trains rounds 2 and 3 into version_1 and writes the last
    checkpoint, not the first; evaluation and serving take the checkpoint."""
    import json

    from sheeprl_tpu_torch.__main__ import main
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    first = run(TINY + ["algo.total_steps=48"])
    assert first["train_phases"] == 3 and all(np.isfinite(v) for v in first["metrics"].values())
    ckpt_dir = tmp_path / first["log_dir"] / "checkpoint"
    assert sorted(p.name for p in ckpt_dir.glob("*.ckpt")) == ["ckpt_16_0.ckpt", "ckpt_32_0.ckpt", "ckpt_48_0.ckpt"]
    state = load_checkpoint(str(ckpt_dir / "ckpt_16_0.ckpt"))
    assert state["iter_num"] == 1 and set(state["optimizer"]) == {"state", "param_groups"}
    resumed = run(TINY + ["algo.total_steps=48", f"checkpoint.resume_from={ckpt_dir / 'ckpt_16_0.ckpt'}"])
    assert resumed["log_dir"].endswith("version_1") and resumed["train_phases"] == 2
    names = sorted(p.name for p in (tmp_path / resumed["log_dir"] / "checkpoint").glob("*.ckpt"))
    assert names == ["ckpt_32_0.ckpt", "ckpt_48_0.ckpt"]
    capsys.readouterr()
    last = tmp_path / resumed["checkpoint"]
    assert main(["evaluation", f"checkpoint_path={last}", "fabric.accelerator=cpu"]) == 0
    assert "Test - Reward:" in capsys.readouterr().out
    log_dir = tmp_path / "serve"
    assert main(["serve", f"checkpoint_path={last}", "fabric.accelerator=cpu", "serve.sessions=2", "serve.slots=2",
                 "serve.max_session_steps=20", f"serve.log_dir={log_dir}"]) == 0
    assert json.loads((log_dir / "summary.json").read_text())["sessions_completed"] == 2


@pytest.mark.timeout(300)
def test_a_jax_ppo_decoupled_checkpoint_resumes(tmp_path):
    """A checkpoint of the JAX learner's state after its second round (Flax
    params, the optax clip + Adam + schedule state) with the JAX config of
    ``exp=ppo_decoupled`` beside it: the learner's optimizer takes the
    optimizer state as it was (as ``run_on_policy`` loads it), and the
    resumed run trains."""
    import yaml

    from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
    from sheeprl_tpu_torch.algos.ppo.ppo import build_optimizer
    from sheeprl_tpu_torch.algos.ppo.ppo_decoupled import PPOLearner
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.interop.flax_to_torch import ppo_to_torch
    from sheeprl_tpu_torch.interop.optax_to_torch import load_optimizer_state
    from sheeprl_tpu_torch.parallel.decoupled import optimizer_snapshot
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    cfg_jax, space, _, _, replies = _jax_rounds()
    j_params, j_opt = replies[1][0], replies[1][1]
    run_dir = tmp_path / "jax_run" / "version_0"
    ckpt = run_dir / "checkpoint" / "ckpt_32_0.ckpt"
    jax_save_checkpoint(str(ckpt), {"agent": j_params, "optimizer": j_opt, "iter_num": 2, "batch_size": 4,
                                    "last_log": 32, "last_checkpoint": 32})
    (run_dir / "config.yaml").write_text(yaml.safe_dump(cfg_jax.as_dict()))
    state = load_checkpoint(str(ckpt))
    agent, cfg = _port_agent(space, state["agent"])
    learner = PPOLearner(cfg, agent, TOTAL_ITERS)
    load_optimizer_state(learner.trainer.optimizer, state["optimizer"], ppo_to_torch(agent))
    optimizer_close(optimizer_snapshot(learner.trainer.optimizer), j_opt, agent,
                     lambda a: build_optimizer(cfg, a, TOTAL_ITERS)[0], ppo_to_torch, atol=0.0)
    resumed = run(BASE + ["algo.total_steps=64", f"checkpoint.resume_from={ckpt}"])
    assert resumed["train_phases"] == 2 and resumed["policy_steps"] == 64
    assert all(np.isfinite(v) for v in resumed["metrics"].values())


@pytest.mark.timeout(120)
def test_a_learner_that_raises_ends_the_run_with_its_exception(monkeypatch):
    """The learner raises in its second round: the player raises that
    exception (not a hang, not another error) and no learner thread stays."""
    from sheeprl_tpu_torch.algos.ppo import ppo_decoupled
    from sheeprl_tpu_torch.cli import run

    boom = RuntimeError("learner failed in round 2")
    real_round = ppo_decoupled.PPOLearner.round
    rounds = []

    def failing_round(self, *message):
        rounds.append(1)
        if len(rounds) == 2:
            raise boom
        return real_round(self, *message)

    monkeypatch.setattr(ppo_decoupled.PPOLearner, "round", failing_round)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as raised:
        run(TINY + ["algo.total_steps=48"])
    assert raised.value is boom and time.monotonic() - t0 < 60
    assert not [t for t in threading.enumerate() if t.name == "ppo-learner" and t.is_alive()]
