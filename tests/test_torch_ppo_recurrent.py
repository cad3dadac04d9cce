"""Recurrent PPO's train loop of the port against the live JAX loop, on the CPU.

The JAX loop's GAE, chunking and ``train_phase`` are local to its ``main``,
so the JAX side here is the loop itself: ``sheeprl_tpu.cli.run`` trains a
small ``exp=ppo_recurrent`` on CartPole-v1 for two iterations (12-step
episodes, so that its rollouts hold terminations and truncations), with
three recorders patched into its module for the run only: the replay buffer
records what the loop reads from it, ``gae`` its inputs and outputs, and the
telemetry asks for every train program, so that the loop hands over the
jitted ``train_phase``, its padded block, its key and the state after it.

- the port's GAE and :func:`chunk_sequences` on the recorded rollouts give
  the recorded returns and advantages (1e-6) and the loop's padded block and
  mask exactly;
- the port's second train phase, from the state after the first (the
  parameters, and the optax state through a checkpoint and the port's
  converter), on the loop's block, with the permutations of the loop's key in
  its split order: the losses, every parameter and Adam's moments within
  1e-5 (``test_torch_ppo.py::PARAM_ATOL``), Adam's count equal; with the
  defaults and with normalized advantages, clipped values, an annealed
  learning rate and both RNN MLPs;
- a block of two real sequences among sixteen through the live jitted phase
  and the port's: a minibatch drawn from padding alone makes no update, so
  Adam's count and the schedule count only the others.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from test_torch_helpers import numpy_tree, optax_links

PARAM_ATOL = 1e-5
LIVE = [
    "exp=ppo_recurrent", "fabric.accelerator=cpu", "env.capture_video=False", "env.sync_env=True",
    "env.num_envs=2", "env.max_episode_steps=12", "algo.rollout_steps=16", "algo.per_rank_sequence_length=4",
    "algo.per_rank_num_batches=4", "algo.update_epochs=2", "algo.total_steps=64", "algo.rnn.lstm.hidden_size=8",
    "algo.dense_units=16", "algo.encoder.dense_units=16", "algo.encoder.mlp_features_dim=16",
    "metric.log_level=0", "checkpoint.save_last=False", "algo.run_test=False", "buffer.memmap=False",
]
CASES = {
    "defaults": [],
    "normalize-clip-anneal-mlps": [
        "algo.normalize_advantages=True", "algo.clip_vloss=True", "algo.anneal_lr=True", "algo.ent_coef=0.01",
        "algo.rnn.pre_rnn_mlp.apply=True", "algo.rnn.post_rnn_mlp.apply=True",
    ],
}


class _Telemetry:
    """The loop's telemetry, asking for every train program."""

    def __init__(self, inner, record):
        self._inner, self._record = inner, record

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def wants_program(self, name):
        return name == "train_phase"

    def register_program(self, name, fn, args, **_):
        params, opt_state, seqs, key, clip_coef, ent_coef = args
        self._record["phases"].append({"fn": fn, "params": numpy_tree(params), "opt_state": opt_state,
                                       "seqs": {k: np.array(v) for k, v in seqs.items()}, "key": np.asarray(key),
                                       "clip_coef": float(clip_coef), "ent_coef": float(ent_coef)})

    def observe_train(self, units, losses):
        self._record["losses"].append(np.asarray(losses))
        return self._inner.observe_train(units, losses)


@functools.lru_cache(maxsize=None)
def _live(case: str):
    """Two iterations of the JAX loop (module docstring), recorded."""
    import sheeprl_tpu.algos.ppo_recurrent.ppo_recurrent as jax_rppo
    from sheeprl_tpu.cli import run as jax_run

    record = {"phases": [], "losses": [], "gae": [], "buffers": []}

    class Buffer(jax_rppo.ReplayBuffer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.reads = {}
            record["buffers"].append(self)

        def __getitem__(self, key):
            value = super().__getitem__(key)
            self.reads[key] = np.array(value)
            return value

    real_gae, real_telemetry = jax_rppo.gae, jax_rppo.build_telemetry

    def recorded_gae(rewards, values, dones, next_values, *args):
        out = real_gae(rewards, values, dones, next_values, *args)
        record["gae"].append({"reads": dict(record["buffers"][-1].reads), "next_values": np.asarray(next_values),
                              "args": args, "out": [np.asarray(o) for o in out]})
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_rppo, "ReplayBuffer", Buffer)
        mp.setattr(jax_rppo, "gae", recorded_gae)
        mp.setattr(jax_rppo, "build_telemetry", lambda *a, **k: _Telemetry(real_telemetry(*a, **k), record))
        jax_run([*LIVE, *CASES[case], f"root_dir=live_{case}", "run_name=run"])
    assert len(record["phases"]) == 2 and len(record["gae"]) == 2
    return record


def _port(case: str, params):
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import RecurrentPPOTrainer, build_optimizer
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.utils.env import make_env

    cfg = compose([*LIVE, *CASES[case]])
    space = make_env(cfg, 0, 0)().observation_space
    agent = build_agent(Fabric(accelerator="cpu"), (2,), False, cfg, space, 0, params)
    optimizer, schedule = build_optimizer(cfg, agent, 2)
    return RecurrentPPOTrainer(agent, optimizer, cfg, schedule)


def _load_opt_state(trainer, opt_state, tmp_path):
    """The JAX optax state into the port's optimizer, through a checkpoint."""
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
    from sheeprl_tpu_torch.interop.flax_to_torch import ppo_recurrent_to_torch
    from sheeprl_tpu_torch.interop.optax_to_torch import load_optimizer_state
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    path = str(tmp_path / "opt.ckpt")
    jax_save_checkpoint(path, {"optimizer": opt_state})
    load_optimizer_state(trainer.optimizer, load_checkpoint(path)["optimizer"], ppo_recurrent_to_torch(trainer.agent))


def _perms(key, n: int, epochs: int):
    return [torch.from_numpy(np.asarray(jax.random.permutation(k, n)).astype(np.int64))
            for k in jax.random.split(key, epochs)]


def _check_state(trainer, params, opt_state):
    """The port's parameters, Adam moments and counts against the JAX state."""
    from sheeprl_tpu_torch.interop.flax_to_torch import ppo_recurrent_to_flax, ppo_recurrent_to_torch

    ours = ppo_recurrent_to_flax(trainer.agent)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours), jax.tree_util.tree_leaves(numpy_tree(params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL, err_msg=jax.tree_util.keystr(path))
    links = optax_links(opt_state)
    adam = links["ScaleByAdamState"]
    for key, moments in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        for p, theirs in zip(trainer.params, ppo_recurrent_to_torch(trainer.agent)(numpy_tree(moments))):
            np.testing.assert_allclose(trainer.optimizer.state[p][key].numpy(), theirs, rtol=0, atol=PARAM_ATOL)
    assert all(float(trainer.optimizer.state[p]["step"]) == int(adam.count) for p in trainer.params)
    if "ScaleByScheduleState" in links:
        assert trainer.optimizer.param_groups[0]["schedule_count"] == int(links["ScaleByScheduleState"].count)
    return int(adam.count)


@pytest.mark.timeout(600)
def test_gae_and_chunking_match_the_jax_loop():
    from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import chunk_sequences
    from sheeprl_tpu_torch.utils.utils import gae

    record = _live("defaults")
    lengths = []
    for it, (g, phase) in enumerate(zip(record["gae"], record["phases"])):
        reads = {k: v.astype(np.float32) for k, v in g["reads"].items()}
        returns, advantages = gae(*(torch.from_numpy(reads[k]) for k in ("rewards", "values", "dones")),
                                  torch.from_numpy(g["next_values"]), *g["args"])
        np.testing.assert_allclose(returns.numpy(), g["out"][0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(advantages.numpy(), g["out"][1], rtol=0, atol=1e-6)
        seqs = chunk_sequences({**reads, "returns": g["out"][0], "advantages": g["out"][1]}, 4, 4)
        assert sorted(seqs) == sorted(phase["seqs"]), it
        for k, v in phase["seqs"].items():
            np.testing.assert_array_equal(seqs[k], v, err_msg=f"iteration {it}: {k}")
        lengths.extend(seqs["mask"].sum(axis=(0, 2)).tolist())
        assert reads["dones"].sum() > 0
    # episodes end inside the chunks, so some chunks are shorter than the sequence
    assert 0 < min(v for v in lengths if v > 0) < 4 and max(lengths) == 4 and min(lengths) == 0


@pytest.mark.timeout(600)
@pytest.mark.parametrize("case", list(CASES))
def test_train_phase_matches_the_live_jax_phase(case, tmp_path):
    record = _live(case)
    first, second = record["phases"]
    trainer = _port(case, first["params"])
    _load_opt_state(trainer, first["opt_state"], tmp_path)
    perms = _perms(second["key"], second["seqs"]["mask"].shape[1], 2)
    losses = trainer.train_phase(second["seqs"], perms, second["clip_coef"], second["ent_coef"])
    np.testing.assert_allclose(losses.numpy(), record["losses"][1], rtol=0, atol=PARAM_ATOL)
    assert _check_state(trainer, second["params"], second["opt_state"]) <= 2 * 2 * 4  # 2 phases, 2 epochs x 4


@pytest.mark.timeout(600)
def test_a_minibatch_of_padding_makes_no_update(tmp_path):
    """Two real sequences among 16: minibatches of 4, and the key below draws
    at least one minibatch of padding alone in each of the two epochs."""
    record = _live("defaults")
    first, second = record["phases"]
    n, real = 16, 2
    seqs = {}
    for k, v in second["seqs"].items():
        block = np.zeros((v.shape[0], n, *v.shape[2:]), np.float32)
        block[:, :real] = v[:, :real]
        seqs[k] = block
    assert seqs["mask"][:, :real].sum() > 0
    key = jax.random.PRNGKey(3)
    perms = _perms(key, n, 2)
    skipped = sum(not (perm.reshape(4, 4) < real).any(dim=1)[j] for perm in perms for j in range(4))
    assert 2 <= skipped < 8
    params, opt_state, losses, _ = first["fn"](first["params"], first["opt_state"], seqs, key,
                                               second["clip_coef"], second["ent_coef"])
    trainer = _port("defaults", first["params"])
    _load_opt_state(trainer, first["opt_state"], tmp_path)
    ours = trainer.train_phase(seqs, perms, second["clip_coef"], second["ent_coef"])
    np.testing.assert_allclose(ours.numpy(), np.asarray(losses), rtol=0, atol=PARAM_ATOL)
    count = _check_state(trainer, params, opt_state)
    assert count == 2 * 4 + 2 * 4 - int(skipped)  # the first phase's updates and this one's real minibatches
