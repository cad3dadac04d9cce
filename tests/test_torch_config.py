"""The port's config tree and dummy environments against the JAX package's.

The port's composer resolves the same overrides to the same values as
``sheeprl_tpu.config.compose``, apart from the ``_target_``/``cls`` paths
(which name the port's modules), the ``fabric`` group (the torch runtime) and
the timestamped run name. For the same seeds ``make_env`` gives the same
spaces and observation streams as the JAX package's.
"""

from __future__ import annotations

import numpy as np
import pytest

from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.utils.env import make_env as jax_make_env
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.utils.env import make_env
from test_torch_helpers import overrides

BASE = ["exp=dreamer_v3", "env=dummy"]


# the port's own defaults for what it has not ported yet: the replay
# prefetch thread
PORT_DEFAULTS = {"buffer.prefetch.enabled": False}


def _strip(node, path=""):
    """Drop what legitimately differs: targets, the fabric group, timestamps,
    and the port's defaults for what is not yet ported."""
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            p = f"{path}.{k}" if path else k
            if k in ("_target_", "cls") or p in ("fabric", "run_name", "hydra", *PORT_DEFAULTS):
                continue
            out[k] = _strip(v, p)
        return out
    if isinstance(node, list):
        return [_strip(v, path) for v in node]
    return node


@pytest.mark.parametrize(
    "extra",
    [
        [],
        ["algo=dreamer_v3_XS", "env.id=continuous_dummy"],
        ["algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]", "seed=7"],
        ["algo=dreamer_v3_L", "env.frame_stack=2", "+algo.extra_key=1"],
    ],
    ids=["S", "XS-continuous", "keys", "L-framestack"],
)
def test_composer_resolves_like_the_jax_package(extra):
    # a fixed run name: the default one reads the clock, and the logger's name
    # copies it, so two compositions a second boundary apart would differ
    pinned = BASE + extra + ["run_name=composer_test"]
    ours = compose(pinned).as_dict()
    theirs = jax_compose(pinned).as_dict()
    assert _strip(ours) == _strip(theirs)
    for path, value in PORT_DEFAULTS.items():
        group, key = path.rsplit(".", 1)
        node = ours
        for part in group.split("."):
            node = node[part]
        assert node[key] == value, path
    assert ours["fabric"]["_target_"] == "sheeprl_tpu_torch.parallel.fabric.Fabric"
    assert ours["algo"]["actor"]["cls"] == "sheeprl_tpu_torch.algos.dreamer_v3.agent.Actor"
    assert ours["env"]["wrapper"]["_target_"] == "sheeprl_tpu_torch.utils.env.get_dummy_env"


def test_every_port_target_points_at_the_port():
    cfg = compose(BASE).as_dict()
    targets = []

    def walk(node):
        if isinstance(node, dict):
            for k, v in node.items():
                if k in ("_target_", "cls"):
                    targets.append(v)
                walk(v)

    walk(cfg)
    assert targets and all(t.startswith("sheeprl_tpu_torch.") for t in targets)


@pytest.mark.parametrize("kind", ["discrete", "multidiscrete", "continuous"])
@pytest.mark.parametrize("extra", [[], ["env.frame_stack=2", "env.action_repeat=2", "env.max_episode_steps=3"]])
def test_make_env_matches_the_jax_package(kind, extra):
    ov = overrides(kind, extra)
    ours = make_env(compose(ov), 5, 0)()
    theirs = jax_make_env(jax_compose(ov), 5, 0)()
    assert sorted(ours.observation_space.keys()) == sorted(theirs.observation_space.keys())
    for k in ours.observation_space.keys():
        assert ours.observation_space[k].shape == theirs.observation_space[k].shape
        assert ours.observation_space[k].dtype == theirs.observation_space[k].dtype
    assert ours.action_space.shape == theirs.action_space.shape
    o1, _ = ours.reset(seed=5)
    o2, _ = theirs.reset(seed=5)
    for _ in range(8):
        for k in o2:
            np.testing.assert_array_equal(o1[k], o2[k])
        action = theirs.action_space.sample()
        o1, r1, t1, u1, _ = ours.step(action)
        o2, r2, t2, u2, _ = theirs.step(action)
        assert (r1, bool(t1), bool(u1)) == (r2, bool(t2), bool(u2))
        if t2 or u2:
            o1, _ = ours.reset(seed=5)
            o2, _ = theirs.reset(seed=5)


def test_make_env_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        make_env(compose(overrides("discrete", ["env.reward_as_observation=True"])), 0, 0)()
