"""Environment factory (port of ``sheeprl_tpu/utils/env.py::make_env`` for the
environments the port supports: the dummy envs and ``CartPole-v1``).

The pipeline is the JAX package's: instantiate ``cfg.env.wrapper``, action
repeat, velocity masking, a vector observation as a one-key dict,
the cnn-key pixel pipeline (resize / grayscale / channel-first), frame
stacking, a time limit and the episode statistics. Environments emit
observations over the port's own spaces (``envs/spaces.py``); gymnasium is not
needed. Options the port has not ported yet raise instead of being ignored,
but for ``env.capture_video``: the port has no video recorder, so it warns and
records nothing, as the JAX package does when it cannot record.
"""

from __future__ import annotations

import functools
import warnings
from typing import Any, Callable, Dict, Optional

import numpy as np

from sheeprl_tpu_torch.config import instantiate
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.wrappers import (
    ActionRepeat,
    DictObservation,
    FrameStack,
    InjectedEnvFault,
    MaskVelocityWrapper,
    RecordEpisodeStatistics,
    TimeLimit,
    Wrapper,
)


class _PixelPipeline(Wrapper):
    """Resize / grayscale / channel-first pipeline for the cnn keys. Frames that
    already have the configured size and colour pass through untouched; only a
    resize or a colour conversion needs ``cv2``."""

    def __init__(self, env: Any, cnn_keys, screen_size: int, grayscale: bool):
        super().__init__(env)
        self._cnn_keys = list(cnn_keys)
        self._screen_size = screen_size
        self._grayscale = grayscale
        self.observation_space = spaces.Dict(dict(env.observation_space.items()))
        for k in self._cnn_keys:
            self.observation_space[k] = spaces.Box(
                0, 255, (1 if grayscale else 3, screen_size, screen_size), np.uint8
            )

    def _observation(self, obs):
        for k in self._cnn_keys:
            current = obs[k]
            shape = current.shape
            is_3d = len(shape) == 3
            is_grayscale = not is_3d or shape[0] == 1 or shape[-1] == 1
            channel_first = not is_3d or shape[0] in (1, 3)
            if not is_3d:
                current = np.expand_dims(current, axis=0)
            if channel_first:
                current = np.transpose(current, (1, 2, 0))
            if current.shape[:-1] != (self._screen_size, self._screen_size):
                import cv2

                current = cv2.resize(
                    current, (self._screen_size, self._screen_size), interpolation=cv2.INTER_AREA
                )
            if self._grayscale and not is_grayscale:
                import cv2

                current = cv2.cvtColor(current, cv2.COLOR_RGB2GRAY)
            if current.ndim == 2:
                current = np.expand_dims(current, axis=-1)
                if not self._grayscale:
                    current = np.repeat(current, 3, axis=-1)
            obs[k] = current.transpose(2, 0, 1)
        return obs

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self._observation(obs), reward, terminated, truncated, info

    def reset(self, *, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        return self._observation(obs), info


@functools.cache
def _warn_no_video_recorder() -> None:
    """Once a process: the JAX package warns and goes on when it cannot record,
    and the port has no recorder at all, so this is always that path."""
    warnings.warn(
        "env.capture_video=True: sheeprl_tpu_torch has no video recorder, so no video is "
        "captured (set env.capture_video=False to silence this warning)"
    )


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to sheeprl_tpu_torch")


def make_env(
    cfg: Dict[str, Any],
    seed: int,
    rank: int,
    run_name: Optional[str] = None,
    prefix: str = "",
    vector_env_idx: int = 0,
) -> Callable[[], Any]:
    """Build a thunk creating a fully-wrapped env with dict observations."""

    def thunk() -> Any:
        backend = str(cfg.env.get("backend", "host") or "host").lower()
        if backend != "host":
            raise _not_ported(f"env.backend={backend}")
        instantiate_kwargs = {}
        if "seed" in cfg.env.wrapper:
            instantiate_kwargs["seed"] = seed
        if "rank" in cfg.env.wrapper:
            instantiate_kwargs["rank"] = rank + vector_env_idx
        env = instantiate(cfg.env.wrapper, **instantiate_kwargs)

        if cfg.env.action_repeat > 1:
            env = ActionRepeat(env, cfg.env.action_repeat)
        if cfg.env.get("mask_velocities", False):
            env = MaskVelocityWrapper(env, str(cfg.env.id))

        cnn_enc = cfg.algo.cnn_keys.encoder
        mlp_enc = cfg.algo.mlp_keys.encoder
        if not (isinstance(mlp_enc, list) and isinstance(cnn_enc, list) and len(cnn_enc + mlp_enc) > 0):
            raise ValueError(
                "`algo.cnn_keys.encoder` and `algo.mlp_keys.encoder` must be non-empty lists of "
                f"strings, got cnn={cnn_enc!r} and mlp={mlp_enc!r}"
            )
        obs_space = env.observation_space
        if isinstance(obs_space, spaces.Box) and len(obs_space.shape) < 2:
            # a vector observation
            if len(cnn_enc) > 0:
                raise _not_ported("rendering a vector-observation env into a cnn key")
            if len(mlp_enc) > 1:
                warnings.warn(
                    f"Multiple mlp keys specified but only one observation is allowed in "
                    f"{cfg.env.id}; keeping the first: {mlp_enc[0]}"
                )
            env = DictObservation(env, mlp_enc[0])
        if not isinstance(env.observation_space, spaces.Dict):
            raise _not_ported(f"an observation space like {obs_space!r}")
        if len(set(env.observation_space.keys()).intersection(set(mlp_enc + cnn_enc))) == 0:
            raise ValueError(
                f"The user-specified keys {mlp_enc + cnn_enc} are not a subset of the environment "
                f"observation keys {list(env.observation_space.keys())}; check your config."
            )

        env_cnn_keys = set(
            k for k, v in env.observation_space.items() if len(v.shape) in (2, 3)
        )
        cnn_keys = env_cnn_keys.intersection(set(cnn_enc))
        if cnn_keys:
            env = _PixelPipeline(env, cnn_keys, cfg.env.screen_size, cfg.env.grayscale)
        if cnn_keys and cfg.env.frame_stack > 1:
            if cfg.env.frame_stack_dilation <= 0:
                raise ValueError(
                    f"The frame stack dilation argument must be greater than zero, got: {cfg.env.frame_stack_dilation}"
                )
            env = FrameStack(env, cfg.env.frame_stack, cnn_keys, cfg.env.frame_stack_dilation)
        if cfg.env.actions_as_observation.num_stack > 0:
            raise _not_ported("env.actions_as_observation")
        if cfg.env.reward_as_observation:
            raise _not_ported("env.reward_as_observation")
        # the env_step fault raises from inside step(); the other kinds are
        # driven elsewhere (the training verbs refuse every kind, cli.py)
        if str(((cfg.get("resilience") or {}).get("fault") or {}).get("kind") or "").lower() == "env_step":
            env = InjectedEnvFault(env)

        if cfg.env.max_episode_steps and cfg.env.max_episode_steps > 0:
            env = TimeLimit(env, max_episode_steps=cfg.env.max_episode_steps)
        env = RecordEpisodeStatistics(env)
        if cfg.env.capture_video and rank == 0 and vector_env_idx == 0 and run_name is not None:
            _warn_no_video_recorder()
        return env

    return thunk


def get_dummy_env(id: str, **kwargs: Any) -> Any:
    """Build a fake env by id."""
    if "continuous" in id:
        from sheeprl_tpu_torch.envs.dummy import ContinuousDummyEnv

        return ContinuousDummyEnv(**kwargs)
    if "multidiscrete" in id:
        from sheeprl_tpu_torch.envs.dummy import MultiDiscreteDummyEnv

        return MultiDiscreteDummyEnv(**kwargs)
    if "discrete" in id:
        from sheeprl_tpu_torch.envs.dummy import DiscreteDummyEnv

        return DiscreteDummyEnv(**kwargs)
    raise ValueError(f"Unknown dummy env id: {id}")
