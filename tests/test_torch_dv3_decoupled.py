"""Decoupled Dreamer-V3 of the port (``algos/dreamer_v3/dreamer_v3_decoupled.py``)
against the JAX package's, on the CPU.

- two learner rounds: the JAX ``_trainer_loop`` and the port's learner, each
  driven in a thread through two depth-1 queues, from the same parameters and
  blocks; the port's noise is the JAX step keys' (``split(train_key, G)``, each
  split as ``train_step`` splits it);
- the CLI: ``exp=dreamer_v3_decoupled`` trains with a checkpoint deferred past
  the prefill, resumes from a mid-run checkpoint, evaluates and serves, and
  trains as ``exp=dreamer_v3`` of the same config does, bit for bit (the JAX
  package's inline and thread-mode runs of its tiny config end with the same
  parameters too); a checkpoint of the JAX learner's final state resumes;
- a checkpoint deferred to a round holds that round's state, not a later one;
- a learner that raises ends the run with its exception, and no thread stays.

Tolerances are the coupled family's (``test_torch_dv3_train.py``), not 1e-5
everywhere: Adam's first steps move a weight by about its learning rate
whatever its gradient's size, so a gradient within rounding of 0 may step
either way. Parameters agree to 2 lr and all but a few to 1e-5; the mean
metrics and the Adam moments, whose sums run over many terms, to 1e-4
relative to each tensor's largest entry; the Moments to 1e-5.
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

from test_torch_dv3_train import B, GRAD_ATOL, TRAIN, T, _batch, _close_trees, _pair, _step_noise
from test_torch_helpers import numpy_tree, overrides
from test_torch_ppo_decoupled import as_loaded

G, LR = 2, 2 * 1e-4


def _blocks():
    return [{k: np.stack([_batch("discrete", seed=2 * r + g)[k] for g in range(G)]) for k in _batch("discrete")}
            for r in range(2)]


def _torch_block(block):
    return {k: torch.from_numpy(v.copy()) for k, v in block.items()}


@functools.lru_cache(maxsize=None)
def _jax_rounds():
    """The JAX learner's replies to two rounds (the whole state asked for in
    the second) and to the sentinel, with the train keys it was sent."""
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import build_optimizers, make_train_phase
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3_decoupled import _trainer_loop
    from sheeprl_tpu.algos.dreamer_v3.utils import init_moments
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric

    jagent, params, _, cfg_jax, _ = _pair("discrete")
    world_tx, actor_tx, critic_tx, opt_state = build_optimizers(cfg_jax, params)
    train_phase = make_train_phase(jagent, cfg_jax, world_tx, actor_tx, critic_tx)
    fabric = JaxFabric(devices=1, accelerator="cpu")
    fabric._setup()
    copies = [jax.tree_util.tree_map(jnp.array, t) for t in (params, opt_state, init_moments())]
    data_q, params_q, error = queue.Queue(maxsize=1), queue.Queue(maxsize=1), {}
    thread = threading.Thread(target=_trainer_loop, daemon=True,
                              args=(fabric, cfg_jax, train_phase, *copies, data_q, params_q, error))
    thread.start()
    keys = [np.asarray(jax.random.PRNGKey(30 + r)) for r in range(2)]
    replies = []
    for r, (block, want) in enumerate(zip(_blocks(), (False, True))):
        data_q.put((block, r * G, keys[r], want, True))
        reply = params_q.get(timeout=300)
        assert reply is not None, error
        replies.append(reply)
    data_q.put(None)
    final = params_q.get(timeout=120)
    thread.join(timeout=60)
    return keys, replies, final


def _learner():
    """The port's learner on a fresh agent loaded from the JAX parameters."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, build_optimizers
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3_decoupled import DV3Learner

    jagent, params, agent, _, cfg = _pair("discrete")
    return DV3Learner(DV3Trainer(agent, cfg, build_optimizers(cfg, agent))), jagent, params, cfg


@pytest.mark.timeout(600)
def test_two_learner_rounds_match_the_jax_trainer_loop():
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, build_optimizers
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3_decoupled import load_act_view
    from sheeprl_tpu_torch.interop.flax_to_torch import agent_to_flax
    from sheeprl_tpu_torch.parallel.decoupled import LearnerThread

    keys, theirs, _ = _jax_rounds()
    learner, jagent, params0, cfg = _learner()
    noise = iter([_step_noise(k, jagent, params0) for key in keys for k in jax.random.split(jnp.asarray(key), G)])
    learner.trainer.draw_noise = lambda T_, B_, generator: next(noise)
    view = _pair("discrete")[2]
    generator = torch.Generator().manual_seed(0)
    with LearnerThread(learner, "dv3-learner-test") as channel:
        for r, (block, want) in enumerate(zip(_blocks(), (False, True))):
            act, full, metrics, _ = channel.exchange(_torch_block(block), r * G, generator.get_state(), want)
            j_act, j_full, j_metrics = theirs[r]
            load_act_view(view, act)
            mine = agent_to_flax(view)
            _close_trees({k: mine[k] for k in j_act}, numpy_tree(j_act), LR)
            flat_mine = np.concatenate([np.ravel(x) for k in j_act for x in jax.tree_util.tree_leaves(mine[k])])
            flat_theirs = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(numpy_tree(j_act))])
            assert np.mean(np.abs(flat_mine - flat_theirs) <= 1e-5) > 0.999
            assert sorted(metrics) == sorted(j_metrics)
            for name, value in j_metrics.items():
                np.testing.assert_allclose(metrics[name], np.asarray(value), atol=GRAD_ATOL, rtol=GRAD_ATOL,
                                           err_msg=name)
            assert (full is None) == (j_full is None)
        final = channel.close()
    assert not channel.thread.is_alive()
    j_params, j_opt, j_moments = theirs[1][1]
    _close_trees(full["agent"], numpy_tree(j_params), LR)
    for k in ("low", "high"):
        np.testing.assert_allclose(full["moments"][k].numpy(), np.asarray(j_moments[k]), atol=1e-5, rtol=1e-5)
    # the optimizers' states as the reply carried them, against optax's loaded alike
    ours, ref = _pair("discrete")[2], _pair("discrete")[2]
    mine_t, theirs_t = (DV3Trainer(a, cfg, build_optimizers(cfg, a)) for a in (ours, ref))
    mine_t.load_opt_state(full["opt_state"])
    theirs_t.load_opt_state(as_loaded(j_opt))
    for name, opt in mine_t.optimizers.items():
        for i, state in theirs_t.optimizers[name].state_dict()["state"].items():
            for k, v in state.items():
                mine_v = np.asarray(opt.state_dict()["state"][i][k])
                tol = GRAD_ATOL * max(1.0, float(np.abs(np.asarray(v)).max(initial=0.0)))
                np.testing.assert_allclose(mine_v, np.asarray(v), atol=tol, rtol=GRAD_ATOL, err_msg=f"{name} {i} {k}")
    # no round since the second: the sentinel's state is the second round's
    _close_trees(final["agent"], full["agent"], 0.0)


DV3_CLI = overrides("discrete", TRAIN + [
    "env.num_envs=2", "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=2", "algo.learning_starts=8",
    "algo.replay_ratio=0.5", "buffer.size=64", "buffer.memmap=False", "checkpoint.every=4",
])


def _ckpts(tmp_path, summary):
    return sorted(p.name for p in (tmp_path / summary["log_dir"] / "checkpoint").glob("*.ckpt"))


@pytest.mark.timeout(300)
def test_cli_trains_defers_resumes_evaluates_serves_and_matches_the_coupled_run(tmp_path, capsys):
    """16 steps: the checkpoint due during the prefill (step 4) waits for the
    first round (step 8). The coupled run of the same config writes it at
    step 4, and every checkpoint both write holds the same state. The run
    resumed from step 8 (with its replay buffer) writes 12 and 16, not 8;
    evaluation and serving take the checkpoint."""
    import json

    from sheeprl_tpu_torch.__main__ import main
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    args = [a for a in DV3_CLI if not a.startswith("exp=")] + ["algo.total_steps=16", "run_name=r"]
    decoupled = run(["exp=dreamer_v3_decoupled", "root_dir=dec"] + args)
    coupled = run(["exp=dreamer_v3", "root_dir=cpl"] + args)
    assert _ckpts(tmp_path, coupled) == ["ckpt_12_0.ckpt", "ckpt_16_0.ckpt", "ckpt_4_0.ckpt", "ckpt_8_0.ckpt"]
    assert _ckpts(tmp_path, decoupled) == ["ckpt_12_0.ckpt", "ckpt_16_0.ckpt", "ckpt_8_0.ckpt"]
    assert decoupled["gradient_steps"] == coupled["gradient_steps"] > 0
    assert decoupled["metrics"] == coupled["metrics"]
    for name in _ckpts(tmp_path, decoupled):
        ours, theirs = (load_checkpoint(str(tmp_path / s["log_dir"] / "checkpoint" / name))
                        for s in (decoupled, coupled))
        _close_trees(ours["agent"], theirs["agent"], 0.0)
        assert ours["iter_num"] == theirs["iter_num"] and set(ours) == set(theirs)

    mid = tmp_path / decoupled["log_dir"] / "checkpoint" / "ckpt_8_0.ckpt"
    # a resumed run waits learning_starts again: none here, so it trains at once
    resumed = run(["exp=dreamer_v3_decoupled", "root_dir=dec"] + args
                  + ["algo.learning_starts=0", f"checkpoint.resume_from={mid}"])
    assert resumed["log_dir"].endswith("version_1") and resumed["gradient_steps"] > 0
    assert _ckpts(tmp_path, resumed) == ["ckpt_12_0.ckpt", "ckpt_16_0.ckpt"]
    last = tmp_path / resumed["checkpoint"]
    capsys.readouterr()
    assert main(["evaluation", f"checkpoint_path={last}", "fabric.accelerator=cpu", "env.capture_video=False"]) == 0
    assert "Test - Reward:" in capsys.readouterr().out
    log_dir = tmp_path / "serve"
    assert main(["serve", f"checkpoint_path={last}", "fabric.accelerator=cpu", "serve.sessions=2", "serve.slots=2",
                 "serve.max_session_steps=6", f"serve.log_dir={log_dir}"]) == 0
    assert json.loads((log_dir / "summary.json").read_text())["sessions_completed"] == 2


@pytest.mark.timeout(600)
def test_a_jax_dreamer_v3_decoupled_checkpoint_resumes(tmp_path):
    """A checkpoint of the JAX learner's final state (Flax params, the three
    optax Adam states, the Moments) with the JAX config of
    ``exp=dreamer_v3_decoupled`` beside it: the port's learner loads the
    optimizers' states and Moments as they were, and the resumed run trains."""
    import yaml

    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, build_optimizers
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    _, _, (j_params, j_opt, j_moments) = _jax_rounds()
    cfg_jax = jax_compose(["exp=dreamer_v3_decoupled"] + [a for a in DV3_CLI if not a.startswith("exp=")]
                          + ["algo.total_steps=8", "buffer.checkpoint=False"])
    run_dir = tmp_path / "jax_run" / "version_0"
    ckpt = run_dir / "checkpoint" / "ckpt_8_0.ckpt"
    jax_save_checkpoint(str(ckpt), {"agent": numpy_tree(j_params), "opt_state": j_opt, "moments": j_moments,
                                    "ratio": {"_ratio": 0.5, "_prev": 8, "_pretrain_steps": 0}, "iter_num": 4,
                                    "batch_size": 2, "last_log": 8, "last_checkpoint": 8})
    (run_dir / "config.yaml").write_text(yaml.safe_dump(cfg_jax.as_dict()))
    state = load_checkpoint(str(ckpt))
    _, _, agent, _, cfg = _pair("discrete")
    trainer = DV3Trainer(agent, cfg, build_optimizers(cfg, agent))
    trainer.load_opt_state(state["opt_state"])
    reference = DV3Trainer(agent, cfg, build_optimizers(cfg, agent))
    reference.load_opt_state(as_loaded(j_opt))
    for name, opt in trainer.optimizers.items():
        assert str(opt.state_dict()) == str(reference.optimizers[name].state_dict())
    resumed = run([a for a in DV3_CLI if not a.startswith("exp=")]
                  + ["exp=dreamer_v3_decoupled", "algo.total_steps=24", "buffer.prefetch.enabled=False",
                     f"checkpoint.resume_from={ckpt}"])
    assert resumed["policy_steps"] == 24 and resumed["gradient_steps"] > 0
    assert all(np.isfinite(v) for v in resumed["metrics"].values())


@pytest.mark.timeout(300)
def test_a_deferred_checkpoint_holds_its_rounds_state():
    """The channel trainer beside the coupled trainer on the same blocks and
    generator: the whole state shipped with round 1 is what
    ``checkpoint_state`` gives after round 2 (which shipped none), bit for
    bit, and it differs from the state after round 2; ``close`` gives that."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, build_optimizers
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3_decoupled import ChannelTrainer
    from sheeprl_tpu_torch.parallel.decoupled import optimizer_snapshot

    _, _, agent, _, cfg = _pair("discrete")
    _, _, twin, _, _ = _pair("discrete")
    channel = ChannelTrainer(agent, cfg)
    inline = DV3Trainer(twin, cfg, build_optimizers(cfg, twin))
    g_channel, g_inline = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    blocks = [_torch_block(b) for b in _blocks()]
    try:
        channel.train(blocks[0], 0, g_channel, want_full_state=True)
        inline.train(blocks[0], 0, g_inline)
        after_first = {"agent": inline.agent_state(),
                       "opt_state": {n: optimizer_snapshot(o) for n, o in inline.optimizers.items()}}
        channel.train(blocks[1], G, g_channel, want_full_state=False)
        inline.train(blocks[1], G, g_inline)
        deferred = channel.checkpoint_state()
        _close_trees(deferred["agent"], after_first["agent"], 0.0)
        for name, snap in after_first["opt_state"].items():
            assert str(deferred["opt_state"][name]) == str(snap)
        after_second = inline.agent_state()
        assert any(not np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(deferred["agent"]),
                                                              jax.tree_util.tree_leaves(after_second)))
        assert torch.equal(g_channel.get_state(), g_inline.get_state())
    finally:
        final = channel.close()
    _close_trees(final["agent"], after_second, 0.0)


@pytest.mark.timeout(120)
def test_a_learner_that_raises_ends_the_run_with_its_exception(monkeypatch):
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer
    from sheeprl_tpu_torch.cli import run

    boom = FloatingPointError("non-finite world-model loss")
    real_train = DV3Trainer.train
    rounds = []

    def failing_train(self, *args, **kwargs):
        rounds.append(threading.current_thread().name)
        if len(rounds) == 2:
            raise boom
        return real_train(self, *args, **kwargs)

    monkeypatch.setattr(DV3Trainer, "train", failing_train)
    args = [a for a in DV3_CLI if not a.startswith("exp=")] + ["exp=dreamer_v3_decoupled", "algo.total_steps=16"]
    t0 = time.monotonic()
    with pytest.raises(FloatingPointError) as raised:
        run(args)
    assert raised.value is boom and rounds == ["dv3-learner", "dv3-learner"] and time.monotonic() - t0 < 60
    assert not [t for t in threading.enumerate() if t.name == "dv3-learner" and t.is_alive()]


@pytest.mark.timeout(120)
def test_kernel_launch_counts_lose_no_update_across_threads():
    """The player's and the learner's threads both count LN-GRU launches: 8
    threads counting at once, with the interpreter switching threads every
    microsecond, lose no count."""
    import sys

    from sheeprl_tpu_torch.ops import LN_GRU

    threads, calls = 8, 20_000
    interval = sys.getswitchinterval()
    LN_GRU.zero_launches()
    try:
        sys.setswitchinterval(1e-6)
        workers = [threading.Thread(target=lambda: [LN_GRU.count_launch("float32") for _ in range(calls)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
        assert LN_GRU.launches == threads * calls == LN_GRU.launches_by_dtype["float32"]
    finally:
        sys.setswitchinterval(interval)
        LN_GRU.zero_launches()
