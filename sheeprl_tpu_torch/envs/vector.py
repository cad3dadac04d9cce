"""A synchronous vector env (the behaviour of ``gymnasium.vector.SyncVectorEnv``
with ``autoreset_mode=SAME_STEP``, over the port's own spaces).

``step`` steps every env in turn; an env whose episode ends is reset in the
same step, its last observation and info go to ``infos["final_obs"]`` (an
object array, ``None`` for the others) and ``infos["final_info"]``, and the
batched observation holds the reset one. Infos are batched as gymnasium does:
one array per key with a ``_key`` mask of the envs that reported it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from sheeprl_tpu_torch.envs import spaces


def _batched_space(space: spaces.Space, n: int) -> spaces.Space:
    if isinstance(space, spaces.Discrete):
        return spaces.MultiDiscrete([space.n] * n)
    if isinstance(space, spaces.MultiDiscrete):
        return spaces.MultiDiscrete(np.tile(space.nvec, (n, 1)))
    if isinstance(space, spaces.Box):
        return spaces.Box(
            np.broadcast_to(space.low, (n, *space.shape)),
            np.broadcast_to(space.high, (n, *space.shape)),
            dtype=space.dtype,
        )
    if isinstance(space, spaces.Dict):
        return spaces.Dict({k: _batched_space(v, n) for k, v in space.items()})
    raise NotImplementedError(f"no batched form of {space!r}")


class SyncVectorEnv:
    def __init__(self, env_fns: Sequence[Callable[[], Any]]):
        self.envs: List[Any] = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space
        self.observation_space = _batched_space(self.single_observation_space, self.num_envs)
        self.action_space = _batched_space(self.single_action_space, self.num_envs)
        self._env_obs: List[Any] = [None] * self.num_envs
        self._rewards = np.zeros((self.num_envs,), dtype=np.float64)
        self._terminations = np.zeros((self.num_envs,), dtype=np.bool_)
        self._truncations = np.zeros((self.num_envs,), dtype=np.bool_)

    def _concatenate(self) -> Dict[str, np.ndarray]:
        return {
            k: np.stack([np.asarray(obs[k], dtype=space.dtype) for obs in self._env_obs])
            for k, space in self.single_observation_space.items()
        }

    def _add_info(self, vector_infos: Dict[str, Any], env_info: Dict[str, Any], env_num: int) -> Dict[str, Any]:
        for key, value in env_info.items():
            if key == "final_obs":
                array = vector_infos.get("final_obs")
                if array is None:
                    array = np.full(self.num_envs, fill_value=None, dtype=object)
                array[env_num] = value
            elif isinstance(value, dict):
                array = self._add_info(vector_infos.get(key, {}), value, env_num)
            else:
                if key not in vector_infos:
                    if type(value) in (int, float, bool) or issubclass(type(value), np.number):
                        array = np.zeros(self.num_envs, dtype=type(value))
                    elif isinstance(value, np.ndarray):
                        array = np.zeros((self.num_envs, *value.shape), dtype=value.dtype)
                    else:
                        array = np.full(self.num_envs, fill_value=None, dtype=object)
                else:
                    array = vector_infos[key]
                array[env_num] = value
            mask = vector_infos.get(f"_{key}", np.zeros(self.num_envs, dtype=np.bool_))
            mask[env_num] = True
            vector_infos[key], vector_infos[f"_{key}"] = array, mask
        return vector_infos

    def reset(
        self, *, seed: Optional[int | Sequence[Optional[int]]] = None, options: Optional[Dict[str, Any]] = None
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        """Reset every env; an int seed gives env i the seed ``seed + i``."""
        if seed is None:
            seed = [None] * self.num_envs
        elif isinstance(seed, int):
            seed = [seed + i for i in range(self.num_envs)]
        self._terminations[:] = False
        self._truncations[:] = False
        infos: Dict[str, Any] = {}
        for i, (env, single_seed) in enumerate(zip(self.envs, seed)):
            self._env_obs[i], env_info = env.reset(seed=single_seed, options=options)
            infos = self._add_info(infos, env_info, i)
        return self._concatenate(), infos

    def step(self, actions) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray, np.ndarray, Dict[str, Any]]:
        actions = np.asarray(actions)
        infos: Dict[str, Any] = {}
        for i, env in enumerate(self.envs):
            (
                self._env_obs[i],
                self._rewards[i],
                self._terminations[i],
                self._truncations[i],
                env_info,
            ) = env.step(actions[i])
            if self._terminations[i] or self._truncations[i]:
                infos = self._add_info(infos, {"final_obs": self._env_obs[i], "final_info": env_info}, i)
                self._env_obs[i], env_info = env.reset()
            infos = self._add_info(infos, env_info, i)
        return (
            self._concatenate(),
            np.copy(self._rewards),
            np.copy(self._terminations),
            np.copy(self._truncations),
            infos,
        )

    def close(self) -> None:
        for env in self.envs:
            env.close()


def episode_stats(infos: Dict[str, Any], num_envs: int) -> Tuple[np.ndarray, np.ndarray]:
    """(returns, lengths) of the episodes that ended in one vector step, from
    the ``episode`` statistics of their final infos."""
    ep_info = infos.get("final_info", infos)
    if "episode" not in ep_info:
        return np.zeros(0), np.zeros(0)
    ep = ep_info["episode"]
    mask = ep.get("_r", ep_info.get("_episode", np.ones(num_envs, bool)))
    return np.asarray(ep["r"])[mask], np.asarray(ep["l"])[mask]
