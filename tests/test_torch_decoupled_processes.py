"""The decoupled entries as two processes on the CPU: ``python -m
sheeprl_tpu_torch`` launched twice with ``SHEEPRL_COORDINATOR``,
``SHEEPRL_GANG_PROCESSES=2`` and ``SHEEPRL_GANG_RANK`` 0 (the player, which
opens the store) and 1 (the learner), each single-threaded, at tiny widths.

- ``ppo_decoupled``, ``sac_decoupled`` and ``dreamer_v3_decoupled`` end with
  every checkpoint bit for bit the one their thread mode writes at the same
  config: parameters, optimizer states, Moments and counters. The thread mode
  is held to the JAX ``_trainer_loop`` (``test_torch_{ppo,sac,dv3}_decoupled.py``),
  so this ties the two-process mode to the JAX package. The player's run
  summary reports both processes' kernel launches (none on the CPU, where the
  wrappers run their plain versions);
- the learner process builds the player's initial parameters, bit for bit:
  each entry's learner (``build_learner``, what the learner process runs)
  against the agent the player's loop builds and hands its trainer.

``test_torch_decoupled_process_paths.py`` holds the resume and crash paths.
"""

from __future__ import annotations

import copy
import json
import re

import pytest

from test_torch_dv3_decoupled import DV3_CLI
from test_torch_helpers import assert_checkpoints_equal, two_process_run
from test_torch_ppo_decoupled import TINY as PPO_TINY
from test_torch_sac_decoupled import TINY as SAC_TINY

# each entry's config and the checkpoints its run writes
RUNS = {
    "ppo": (PPO_TINY + ["algo.total_steps=48"], ["ckpt_16_0.ckpt", "ckpt_32_0.ckpt", "ckpt_48_0.ckpt"]),
    "sac": (SAC_TINY + ["algo.total_steps=64"], ["ckpt_32_0.ckpt", "ckpt_64_0.ckpt"]),
    "dv3": (["exp=dreamer_v3_decoupled", *(a for a in DV3_CLI if not a.startswith("exp=")), "algo.total_steps=16",
             "root_dir=dec", "run_name=r"],
            ["ckpt_12_0.ckpt", "ckpt_16_0.ckpt", "ckpt_8_0.ckpt"]),
}


def learner_report(player_log: str) -> dict:
    found = re.search(r"^\[sheeprl\] learner process: (\{.*\})$", player_log, re.MULTILINE)
    assert found, player_log[-3000:]
    return json.loads(found.group(1))


def _ckpts(run_dir):
    return sorted(p.name for p in (run_dir / "checkpoint").glob("*.ckpt"))


@pytest.mark.timeout(180)
@pytest.mark.parametrize("entry", sorted(RUNS))
def test_a_two_process_run_writes_the_thread_modes_checkpoints(entry, tmp_path):
    from sheeprl_tpu_torch.cli import run

    args, names = RUNS[entry]
    threaded = run(args)
    rcs, logs, _ = two_process_run(args, tmp_path / "two")
    assert rcs == [0, 0], logs[0][-3000:] + logs[1][-3000:]
    ours, theirs = tmp_path / "two" / threaded["log_dir"], tmp_path / threaded["log_dir"]
    assert _ckpts(ours) == _ckpts(theirs) == names
    for name in names:
        assert_checkpoints_equal(ours / "checkpoint" / name, theirs / "checkpoint" / name)
    report = learner_report(logs[0])
    assert report["rounds"] >= 2 and 0 <= report["handoff_share"] <= 1
    assert report["launches"] == {"player": {"ln_gru_step": 0}, "learner": {"ln_gru_step": 0}}


class _Built(Exception):
    """Stops the player's loop once it has built its trainer."""


@pytest.mark.timeout(120)
def test_the_learner_process_builds_the_players_initial_parameters():
    """Each entry's player loop, in one process, up to its trainer: the agent
    it hands the trainer is the one it acts with. The learner process builds
    its own with ``build_learner`` from the same config; the two agents'
    parameters are equal bit for bit (the learner draws from the seed before
    anything else, as the player does)."""
    import importlib

    import torch

    from sheeprl_tpu_torch.cli import check_configs, setup_metrics
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric

    modules = {"ppo": "ppo.ppo_decoupled", "sac": "sac.sac_decoupled", "dv3": "dreamer_v3.dreamer_v3_decoupled"}
    for entry, (args, _) in sorted(RUNS.items()):
        module = importlib.import_module(f"sheeprl_tpu_torch.algos.{modules[entry]}")
        cfg = compose(args)
        check_configs(cfg)
        setup_metrics(cfg)
        built = {}

        class Recording(module.ChannelTrainer):
            def __init__(self, agent, *rest, channel=None):
                built["player"] = {k: v.detach().clone() for k, v in agent.state_dict().items()}
                raise _Built

        real = module.ChannelTrainer
        module.ChannelTrainer = Recording
        try:
            with pytest.raises(_Built):
                module.main(Fabric(accelerator="cpu"), copy.deepcopy(cfg))
        finally:
            module.ChannelTrainer = real
        learner = module.build_learner(Fabric(accelerator="cpu"), compose(args))
        ours = learner.trainer.agent.state_dict()
        assert sorted(ours) == sorted(built["player"]), entry
        for name, value in built["player"].items():
            assert torch.equal(ours[name], value), (entry, name)
