"""Shared builders for the parity tests of the PyTorch port (no tests here).

Both packages run on the CPU in float32. Inputs are made with numpy from a
seed and handed to both; parameters are made by the JAX package and carried
into the port through ``sheeprl_tpu_torch.interop.flax_to_torch``.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Sequence, Tuple

import jax
import numpy as np
import torch

# the suite runs several pytest workers on one machine, and every worker
# imports this module while collecting: one intra-op thread per worker keeps
# the port's CPU tests from crowding the timing-sensitive tests beside them
torch.set_num_threads(1)

# the same for the subprocesses the port's tests start
SUBPROCESS_ENV = {"OMP_NUM_THREADS": "1"}

# the small Dreamer-V3 widths of tests/test_serve/test_policies.py
DV3_SMALL = [
    "exp=dreamer_v3",
    "env=dummy",
    "env.id=discrete_dummy",
    "env.capture_video=False",
    "fabric.accelerator=cpu",
    "metric.log_level=0",
    "algo.dense_units=8",
    "algo.mlp_layers=1",
    "algo.world_model.discrete_size=4",
    "algo.world_model.stochastic_size=4",
    "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.recurrent_model.recurrent_state_size=8",
    "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.transition_model.hidden_size=8",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.cnn_keys.decoder=[rgb]",
    "algo.mlp_keys.encoder=[state]",
    "algo.mlp_keys.decoder=[state]",
]

ENV_IDS = {
    "discrete": "discrete_dummy",
    "multidiscrete": "multidiscrete_dummy",
    "continuous": "continuous_dummy",
}
ACTIONS = {
    "discrete": ((2,), False),
    "multidiscrete": ((2, 2), False),
    "continuous": ((2,), True),
}


def overrides(kind: str = "discrete", extra: Sequence[str] = ()) -> list:
    return [o for o in DV3_SMALL if not o.startswith("env.id=")] + [f"env.id={ENV_IDS[kind]}", *extra]


def f32(x) -> torch.Tensor:
    """A float32 tensor of a numpy or JAX array."""
    return torch.from_numpy(np.array(x, dtype=np.float32))


def close(ours, theirs, atol: float = 1e-6) -> None:
    """``ours`` (a tensor or an array) within ``atol`` of ``theirs``."""
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    np.testing.assert_allclose(ours, np.asarray(theirs), rtol=0, atol=atol)


def numpy_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


@functools.lru_cache(maxsize=None)
def _jax_agent(kind: str, extra: Tuple[str, ...], seed: int):
    """The JAX side of ``paired_agents``, built once per worker process (its
    jitted init is the expensive part); callers must not mutate it."""
    from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jax_build
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
    from sheeprl_tpu.utils.env import make_env as jax_make_env

    cfg_jax = jax_compose(overrides(kind, extra))
    env = jax_make_env(cfg_jax, 0, 0)()
    obs_space = env.observation_space
    env.close()
    actions_dim, is_continuous = ACTIONS[kind]
    fabric = JaxFabric(devices=1, accelerator="cpu")
    fabric._setup()
    jax_agent, params = jax_build(
        fabric, actions_dim, is_continuous, cfg_jax, obs_space, jax.random.PRNGKey(seed)
    )
    return jax_agent, numpy_tree(params), cfg_jax, obs_space


def paired_agents(kind: str = "discrete", extra: Sequence[str] = (), seed: int = 3) -> Tuple:
    """(jax_agent, jax_params, torch_agent, cfg_jax, cfg_torch) at the small
    widths, a fresh torch agent loaded from the JAX parameters. ``jax_params``
    is the caller's own copy: a test that steps it leaves the cached tree, and
    the tests after it on the same worker, as they were."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric

    jax_agent, params, cfg_jax, obs_space = _jax_agent(kind, tuple(extra), seed)
    params = jax.tree_util.tree_map(np.copy, params)
    actions_dim, is_continuous = ACTIONS[kind]
    cfg_torch = compose(overrides(kind, extra))
    torch_agent = build_agent(
        Fabric(accelerator="cpu"), actions_dim, is_continuous, cfg_torch, obs_space, seed, params
    )
    return jax_agent, params, torch_agent, cfg_jax, cfg_torch


def random_obs(rng: np.random.Generator, batch: Tuple[int, ...], image=(3, 64, 64), state=(10,)):
    """Normalized encoder inputs: rgb in [-0.5, 0.5], a standard-normal state."""
    return {
        "rgb": (rng.integers(0, 256, (*batch, *image)) / 255.0 - 0.5).astype(np.float32),
        "state": rng.standard_normal((*batch, *state)).astype(np.float32),
    }


# SAC and DroQ at small widths: hidden 16, batch 8, 2 envs, Pendulum-v1
SAC_SMALL = [
    "exp=sac", "env.id=Pendulum-v1", "fabric.accelerator=cpu", "env.capture_video=False", "algo.hidden_size=16",
    "algo.per_rank_batch_size=8", "env.num_envs=2", "buffer.memmap=False", "buffer.size=256",
]


def sac_spaces():
    """Pendulum's spaces in gymnasium's classes, which both packages read."""
    import gymnasium as gym

    obs = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (3,), np.float32)})
    return obs, gym.spaces.Box(-2.0, 2.0, (1,), np.float32)


@functools.lru_cache(maxsize=None)
def jax_sac(algo: str = "sac", extra=()):
    """The JAX actor, critic, params (numpy) and config, built once per worker."""
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric

    if algo == "droq":
        from sheeprl_tpu.algos.droq.agent import build_agent
    else:
        from sheeprl_tpu.algos.sac.agent import build_agent
    cfg = jax_compose([f"exp={algo}", *SAC_SMALL[1:], *extra])
    fabric = JaxFabric(devices=1, accelerator="cpu")
    fabric._setup()
    actor, critic, params = build_agent(fabric, cfg, *sac_spaces(), jax.random.PRNGKey(3))
    return actor, critic, numpy_tree(params), cfg


def port_sac(algo: str = "sac", extra=(), params=None):
    """The port's agent and config, loaded from the JAX parameters."""
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric

    if algo == "droq":
        from sheeprl_tpu_torch.algos.droq.agent import build_agent
    else:
        from sheeprl_tpu_torch.algos.sac.agent import build_agent
    cfg = compose([f"exp={algo}", *SAC_SMALL[1:], *extra])
    params = jax_sac(algo, tuple(extra))[2] if params is None else params
    return build_agent(Fabric(accelerator="cpu"), cfg, *sac_spaces(), 0, params), cfg


def trees_close(ours, theirs, atol):
    """Two params trees (the port's converted one, a JAX one): the same
    structure, every leaf within ``atol``."""
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours), jax.tree_util.tree_leaves(numpy_tree(theirs))):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=jax.tree_util.keystr(path))
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(numpy_tree(theirs))


def replay_block(rng: np.random.Generator, leading, obs_dim: int = 3, act_dim: int = 1):
    """A SAC replay sample shaped ``[*leading, ...]``, a fifth of it terminal."""
    return {
        "observations": rng.standard_normal((*leading, obs_dim)).astype(np.float32),
        "next_observations": rng.standard_normal((*leading, obs_dim)).astype(np.float32),
        "actions": rng.uniform(-2, 2, (*leading, act_dim)).astype(np.float32),
        "rewards": rng.standard_normal((*leading, 1)).astype(np.float32),
        "terminated": (rng.uniform(size=(*leading, 1)) < 0.2).astype(np.float32),
    }


def optax_states_close(trainer, opt_state, atol):
    """The torch Adams' moments against optax's, group by group."""
    from sheeprl_tpu_torch.interop.flax_to_torch import sac_group_to_torch

    for group, opt in trainer.optimizers.items():
        adam = opt_state[group][0]
        params = [p for g in opt.param_groups for p in g["params"]]
        for key, moments in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            for p, theirs in zip(params, sac_group_to_torch(trainer.agent, group)(numpy_tree(moments))):
                np.testing.assert_allclose(opt.state[p][key].numpy(), theirs, rtol=0, atol=atol)
        assert all(float(opt.state[p]["step"]) == int(adam.count) for p in params)


def optax_links(opt_state) -> dict:
    """Class name -> link state of an optax chain's (nested) state."""
    found = {}

    def walk(node):
        if isinstance(node, (tuple, list)) and not hasattr(node, "_fields"):
            for child in node:
                walk(child)
        else:
            found[type(node).__name__] = node

    walk(opt_state)
    return found


def unsaturated(params):
    """The params with the actor's mean and log-std heads scaled by 0.1, so
    that the pre-squash samples of a train phase stay near N(0, 1), where the
    two libraries' float32 tanh agree to the log-prob's 1e-6 (the saturated
    tail is held to its own bar in ``test_squash_logprob_where_tanh_saturates``)."""
    params = jax.tree_util.tree_map(np.copy, params)
    for head in ("Dense_0", "Dense_1"):
        params["actor"][head]["kernel"] *= 0.1
    return params


def losses_close(ours, theirs):
    """Mean losses: 1e-5 relative (a float32 mean over the block) or 1e-6."""
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-6)


# 24-step episodes, so that a 64-step run ends some
SAC_TINY = SAC_SMALL + [
    "algo.learning_starts=16", "checkpoint.every=32", "metric.log_every=32", "env.max_episode_steps=24",
    "root_dir=tiny", "run_name=run",
]


# Plan2Explore at the small widths: the DV3 overrides under the exploration
# exp, with 3 ensemble members
def p2e_overrides(extra: Sequence[str] = ()) -> list:
    base = [o for o in overrides("discrete", extra) if not o.startswith("exp=")]
    return ["exp=p2e_dv3_exploration", "algo.ensembles.n=3", *base]


def filled(params, seed: int = 11):
    """``params`` with every all-zero leaf (biases, LayerNorm shifts, the
    zero-initialised reward and critic heads, the initial state) drawn from
    N(0, 0.1^2), so that each of them shows in a comparison."""
    rng = np.random.default_rng(seed)

    def fill(x):
        x = np.asarray(x)
        return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype) if not np.any(x) else x

    return jax.tree_util.tree_map(fill, params)


@functools.lru_cache(maxsize=None)
def jax_p2e(extra: Tuple[str, ...] = (), precision: str = "32-true"):
    """The JAX P2E agent, its ensemble module, params (numpy, zero leaves
    filled: the init does not depend on the precision), config and
    observation space, built once per worker."""
    from sheeprl_tpu.algos.p2e_dv3.agent import build_agent as jax_build
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
    from sheeprl_tpu.utils.env import make_env as jax_make_env

    cfg = jax_compose(p2e_overrides(extra))
    env = jax_make_env(cfg, 0, 0)()
    obs_space = env.observation_space
    env.close()
    fabric = JaxFabric(devices=1, accelerator="cpu", precision=precision)
    fabric._setup()
    agent, ensembles, params = jax_build(fabric, *ACTIONS["discrete"], cfg, obs_space, jax.random.PRNGKey(3))
    if precision != "32-true":
        params = jax_p2e(extra)[2]
    else:
        params = filled(numpy_tree(params))
    return agent, ensembles, params, cfg, obs_space


def port_p2e(extra: Sequence[str] = (), precision: str = "32-true", params=None):
    """The port's P2E agent and config, loaded from the JAX parameters."""
    from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric

    _, _, jparams, _, obs_space = jax_p2e(tuple(extra))
    cfg = compose(p2e_overrides(extra))
    params = jparams if params is None else params
    agent = build_agent(Fabric(accelerator="cpu", precision=precision), *ACTIONS["discrete"], cfg, obs_space, 3, params)
    return agent, cfg


def jax_categorical_noise(key, rows: int, widths: Sequence[int], dtype=None) -> np.ndarray:
    """The Gumbel noise ``jax.random.categorical`` draws over ``len(widths)``
    heads of [rows, w] logits from ``key`` split per head."""
    keys = jax.random.split(key, len(widths))
    return np.concatenate(
        [np.asarray(jax.random.gumbel(k, (rows, w), dtype or np.float32), np.float32) for k, w in zip(keys, widths)], -1
    )


def jax_imagination_noise(key, agent, rows: int, horizon: int, dtype=None):
    """What a JAX ``imagination_scan`` over discrete actions draws from
    ``key``: ``k0, kscan = split(key)``; the first action from ``k0``; per
    step key ``k`` of ``split(kscan, horizon)`` the prior sample from ``k``
    and the action from ``fold_in(k, 1)``. Returns (transition, action) noise."""
    shape = (rows, agent.stochastic_size, agent.discrete_size)
    k0, kscan = jax.random.split(key)
    steps = jax.random.split(kscan, horizon)
    trans = [np.asarray(jax.random.gumbel(k, shape, dtype or np.float32), np.float32).reshape(rows, -1) for k in steps]
    act = [jax_categorical_noise(k0, rows, agent.actions_dim, dtype)]
    act += [jax_categorical_noise(jax.random.fold_in(k, 1), rows, agent.actions_dim, dtype) for k in steps]
    return np.stack(trans), np.stack(act)


def jax_scan_noise(key, T: int, B: int, agent, dtype=None) -> np.ndarray:
    """A JAX ``dynamic_scan``'s posterior Gumbel noise: ``split(key, T)``,
    one [B, S, D] draw per step key."""
    shape = (B, agent.stochastic_size, agent.discrete_size)
    return np.stack(
        [np.asarray(jax.random.gumbel(k, shape, dtype or np.float32), np.float32).reshape(B, -1)
         for k in jax.random.split(key, T)]
    )


# Dreamer-V2 and V1 at small widths: dense 8, one layer, 4 x 4 latents (V2),
# recurrent 8, CNN x2 on the 64 x 64 frames their encoders take
def dreamer_overrides(algo: str = "dreamer_v2", kind: str = "discrete", extra: Sequence[str] = ()) -> list:
    base = [o for o in overrides(kind) if not o.startswith(("exp=", "algo.world_model.discrete_size"))]
    discrete = ["algo.world_model.discrete_size=4"] if algo == "dreamer_v2" else []
    return [f"exp={algo}", *base, *discrete, *extra]


@functools.lru_cache(maxsize=None)
def jax_dreamer(algo: str = "dreamer_v2", kind: str = "discrete", extra: Tuple[str, ...] = ()):
    """The JAX Dreamer-V1/V2 agent, its params (numpy, every zero leaf filled),
    config and observation space, built once per worker."""
    import importlib

    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
    from sheeprl_tpu.utils.env import make_env as jax_make_env

    build = importlib.import_module(f"sheeprl_tpu.algos.{algo}.agent").build_agent
    cfg = jax_compose(dreamer_overrides(algo, kind, extra))
    env = jax_make_env(cfg, 0, 0)()
    obs_space = env.observation_space
    env.close()
    fabric = JaxFabric(devices=1, accelerator="cpu")
    fabric._setup()
    agent, params = build(fabric, *ACTIONS[kind], cfg, obs_space, jax.random.PRNGKey(3))
    return agent, filled(numpy_tree(params)), cfg, obs_space


def port_dreamer(algo: str = "dreamer_v2", kind: str = "discrete", extra: Sequence[str] = (), params=None):
    """The port's Dreamer-V1/V2 agent and config, loaded from the JAX parameters."""
    import importlib

    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric

    build = importlib.import_module(f"sheeprl_tpu_torch.algos.{algo}.agent").build_agent
    _, jparams, _, obs_space = jax_dreamer(algo, kind, tuple(extra))
    cfg = compose(dreamer_overrides(algo, kind, extra))
    params = jparams if params is None else params
    return build(Fabric(accelerator="cpu"), *ACTIONS[kind], cfg, obs_space, 3, params), cfg


REPO_ROOT = Path(__file__).resolve().parent.parent


def two_process_run(args: Sequence[str], cwd, player_extra: Sequence[str] = (), learner_extra: Sequence[str] = (),
                    timeout: float = 120.0):
    """``python -m sheeprl_tpu_torch *args`` as the two processes of a
    decoupled run on the CPU, each single-threaded, in ``cwd``: the player
    (rank 0) opens the store on a free port, and the learner (rank 1) is
    started on the port the player printed. Returns ``(return codes, logs,
    seconds)``; past ``timeout`` both are killed and the logs' tails raised."""
    import os
    import re
    import subprocess
    import sys
    import time

    cwd = Path(cwd)
    cwd.mkdir(parents=True, exist_ok=True)
    env = {k: v for k, v in os.environ.items() if k not in ("SHEEPRL_COORDINATOR", "SHEEPRL_GANG_RANK", "WORLD_SIZE")}
    env.update(SUBPROCESS_ENV, PYTHONPATH=str(REPO_ROOT), SHEEPRL_GANG_PROCESSES="2")
    paths = [cwd / f"rank{rank}.log" for rank in range(2)]
    procs = []

    def tails() -> str:
        return "\n".join(f"--- rank {i}:\n{p.read_text()[-3000:]}" for i, p in enumerate(paths) if p.exists())

    def start(rank: int, coordinator: str, extra: Sequence[str]):
        with open(paths[rank], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "sheeprl_tpu_torch", *args, *extra], cwd=str(cwd), stdout=log,
                stderr=subprocess.STDOUT, env={**env, "SHEEPRL_COORDINATOR": coordinator, "SHEEPRL_GANG_RANK": str(rank)},
            ))

    t0 = time.monotonic()
    try:
        start(0, "127.0.0.1:0", player_extra)
        port = None
        while port is None:
            found = re.search(r"coordinator listening on \S+:(\d+)", paths[0].read_text())
            port = found and found.group(1)
            if port is None and (procs[0].poll() is not None or time.monotonic() - t0 > timeout):
                raise AssertionError(f"the player opened no store:\n{tails()}")
            time.sleep(0.02)
        start(1, f"127.0.0.1:{port}", learner_extra)
        rcs = [p.wait(timeout=max(1.0, timeout - (time.monotonic() - t0))) for p in procs]
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise AssertionError(f"the two-process run did not end within {timeout} s:\n{tails()}")
    return rcs, [p.read_text() for p in paths], time.monotonic() - t0


def checkpoint_leaves(path) -> dict:
    """path -> value of every leaf of a checkpoint but its replay buffer."""
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from walk(v, f"{prefix}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                yield from walk(v, f"{prefix}/{i}")
        else:
            yield prefix, node

    return dict(walk({k: v for k, v in load_checkpoint(str(path)).items() if k != "rb"}, ""))


def assert_checkpoints_equal(ours, theirs) -> None:
    """Two checkpoints hold the same leaves, bit for bit."""
    a, b = checkpoint_leaves(ours), checkpoint_leaves(theirs)
    assert sorted(a) == sorted(b)
    for key, value in a.items():
        if isinstance(value, (torch.Tensor, np.ndarray)):
            x, y = np.asarray(value), np.asarray(b[key])
            assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), key
        else:
            assert value == b[key], key


def gang_run(args: Sequence[str], cwd, token: str, timeout: float = 150.0):
    """``python -m sheeprl_tpu_torch *args`` on the CPU in ``cwd``, single
    threaded: with ``resilience.distributed.gang.processes=2`` the process is
    the gang's supervisor, and its children run in sessions of their own.
    Returns ``(return code, seconds)``; past ``timeout`` the supervisor and
    every process whose command line holds ``token`` (the run's name) are
    killed and the gang logs' tails raised."""
    import os
    import signal
    import subprocess
    import sys
    import time

    cwd = Path(cwd)
    cwd.mkdir(parents=True, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("SHEEPRL_COORDINATOR", "SHEEPRL_GANG_RANK", "SHEEPRL_GANG_PROCESSES", "WORLD_SIZE")}
    env.update(SUBPROCESS_ENV, PYTHONPATH=str(REPO_ROOT))
    log = cwd / "supervisor.log"
    t0 = time.monotonic()
    with open(log, "w") as fh:
        proc = subprocess.Popen([sys.executable, "-m", "sheeprl_tpu_torch", *args], cwd=str(cwd), stdout=fh,
                                stderr=subprocess.STDOUT, env=env)
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        for pid in os.listdir("/proc"):
            try:
                if pid.isdigit() and token.encode() in Path(f"/proc/{pid}/cmdline").read_bytes():
                    os.kill(int(pid), signal.SIGKILL)
            except OSError:
                continue
        tails = "\n".join(f"--- {p.name}:\n{p.read_text()[-3000:]}" for p in sorted(cwd.rglob("*.log")))
        raise AssertionError(f"the gang did not end within {timeout} s:\n{tails}")
    return rc, time.monotonic() - t0
