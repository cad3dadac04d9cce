"""The CLI's checks of the decoupled algorithms (``cli.check_topology``), on
the CPU: the JAX CLI's refusals of a topology a decoupled algorithm does not
take, with the JAX messages' sense, and the port's refusals of what it runs
only in one process."""

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


@pytest.mark.parametrize(
    "env,override,names",
    [
        ({"WORLD_SIZE": "2"}, None, "a launch with 2 processes"),
        ({}, "resilience.distributed.gang.processes=2", "resilience.distributed.gang.processes >= 2"),
        ({}, "buffer.backend=service", "buffer.backend=service"),
    ],
    ids=["two-processes", "gang", "service"],
)
def test_a_launch_of_more_than_one_process_is_refused_by_name(env, override, names, monkeypatch):
    from sheeprl_tpu_torch.cli import check_configs
    from sheeprl_tpu_torch.config import compose

    for key, value in env.items():
        monkeypatch.setenv(key, value)
    for algo in DECOUPLED:
        with pytest.raises(NotImplementedError, match=names):
            check_configs(compose([f"exp={algo}", *([override] if override else [])]))
