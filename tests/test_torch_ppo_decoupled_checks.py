"""The CLI's checks of the decoupled algorithms (``cli.check_topology``), on
the CPU: the JAX CLI's refusals of a topology a decoupled algorithm does not
take, with the JAX messages' sense; the two-process launch a decoupled
algorithm takes once the store is open, and the port's refusals, by name, of
every other launch of more than one process."""

from __future__ import annotations

import pytest

DECOUPLED = ["ppo_decoupled", "sac_decoupled", "dreamer_v3_decoupled"]


@pytest.mark.parametrize("algo", DECOUPLED)
def test_a_decoupled_algorithm_refuses_what_the_jax_cli_refuses(algo, monkeypatch):
    """``single_device``, no actor, ``devices < 1`` and a 2-D mesh are
    refused; the coupled algorithm of the family takes ``single_device``."""
    from sheeprl_tpu_torch.cli import check_configs
    from sheeprl_tpu_torch.config import compose

    assert callable(check_configs(compose([f"exp={algo}"])))
    with pytest.raises(ValueError, match="is decoupled and is not supported by the single_device strategy"):
        check_configs(compose([f"exp={algo}", "fabric.strategy=single_device"]))
    with pytest.raises(ValueError, match="fabric.devices >= 1"):
        check_configs(compose([f"exp={algo}", "fabric.devices=0"]))
    with pytest.raises(ValueError, match="1-D data meshes"):
        check_configs(compose([f"exp={algo}", "+fabric.mesh_shape=[2,2]"]))
    monkeypatch.setenv("SHEEPRL_NUM_ACTORS", "0")
    with pytest.raises(ValueError, match="at least one actor"):
        check_configs(compose([f"exp={algo}"]))
    monkeypatch.delenv("SHEEPRL_NUM_ACTORS")
    coupled = algo.replace("_decoupled", "")
    assert callable(check_configs(compose([f"exp={coupled}", "fabric.strategy=single_device"])))


COUPLED = ["ppo", "sac", "dreamer_v3"]


@pytest.mark.parametrize(
    "env,override,names,algos",
    [
        ({"WORLD_SIZE": "2"}, None, "a launch with 2 processes", DECOUPLED),
        # a gang of a decoupled algorithm runs (tests/test_torch_gang.py); of a
        # coupled one it is data-parallel training
        ({}, "resilience.distributed.gang.processes=2", "resilience.distributed.gang.processes >= 2 of .* coupled",
         COUPLED),
        ({}, "buffer.backend=service", "buffer.backend=service", DECOUPLED),
    ],
    ids=["two-processes", "gang", "service"],
)
def test_a_launch_of_more_than_one_process_is_refused_by_name(env, override, names, algos, monkeypatch):
    from sheeprl_tpu_torch.cli import check_configs
    from sheeprl_tpu_torch.config import compose

    for key, value in env.items():
        monkeypatch.setenv(key, value)
    for algo in algos:
        with pytest.raises(NotImplementedError, match=names):
            check_configs(compose([f"exp={algo}", *([override] if override else [])]))


@pytest.fixture
def store_up(monkeypatch):
    """This process as the player of a two-process launch whose store is open
    (``__main__`` opens it from these variables)."""
    from sheeprl_tpu_torch.parallel import distributed

    monkeypatch.setenv("SHEEPRL_COORDINATOR", "127.0.0.1:0")
    monkeypatch.setenv("SHEEPRL_GANG_PROCESSES", "2")
    monkeypatch.setattr(distributed, "_store", object())
    monkeypatch.setattr(distributed, "_world", 2)
    monkeypatch.setattr(distributed, "_rank", 0)


def test_a_decoupled_algorithm_takes_two_processes_once_the_store_is_open(store_up):
    from sheeprl_tpu_torch.cli import check_configs
    from sheeprl_tpu_torch.config import compose

    for algo in DECOUPLED:
        assert callable(check_configs(compose([f"exp={algo}"])))


def test_every_other_launch_of_more_than_one_process_stays_refused(store_up, monkeypatch):
    """With the store open: a coupled algorithm (data-parallel training),
    three processes (a learner slice), a gang of three and the service (a gang
    of two is how a gang's children run); without it:
    a coordinator whose store this process did not open, and torchrun's
    ``WORLD_SIZE`` with no coordinator."""
    from sheeprl_tpu_torch.cli import check_configs
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel import distributed

    for exp in ("ppo", "sac", "dreamer_v3", "ppo_recurrent", "ppo_anakin"):
        with pytest.raises(NotImplementedError, match=f"2 processes of {exp}: a coupled algorithm .* \\(DDP\\)"):
            check_configs(compose([f"exp={exp}"]))
    for override, names in (("resilience.distributed.gang.processes=3", "resilience.distributed.gang.processes >= 2"),
                            ("buffer.backend=service", "buffer.backend=service")):
        for algo in DECOUPLED:
            with pytest.raises(NotImplementedError, match=names):
                check_configs(compose([f"exp={algo}", override]))
    monkeypatch.setenv("SHEEPRL_GANG_PROCESSES", "3")
    monkeypatch.setattr(distributed, "_world", 3)
    with pytest.raises(NotImplementedError, match="3 processes of ppo_decoupled: .* learner slice"):
        check_configs(compose(["exp=ppo_decoupled"]))
    monkeypatch.setenv("SHEEPRL_GANG_PROCESSES", "2")
    monkeypatch.setattr(distributed, "_store", None)
    with pytest.raises(NotImplementedError, match="no store is open in this process"):
        check_configs(compose(["exp=sac_decoupled"]))
    monkeypatch.delenv("SHEEPRL_COORDINATOR")
    monkeypatch.delenv("SHEEPRL_GANG_PROCESSES")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="a launch with 2 processes without SHEEPRL_COORDINATOR"):
        check_configs(compose(["exp=dreamer_v3_decoupled"]))
