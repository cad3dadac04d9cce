"""The gridworld family as batched tensors (port of
``sheeprl_tpu/envs/jax/gridworld.py``).

NxN navigation over a static wall layout (``empty`` or ``four_rooms``): the
agent starts at a random free cell, the goal at another free cell, the actions
are up/right/down/left, reaching the goal terminates with reward 1 and every
other step costs ``STEP_PENALTY``. The state is ``[..., 4]`` integers (agent
row and column, goal row and column); the observation is the one-hot agent
cell concatenated with the one-hot goal cell (``2 * N * N`` floats).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sheeprl_tpu_torch.envs.device.base import ActionSpec, DeviceEnv, EnvSpec

# dr, dc per action: 0=up 1=right 2=down 3=left
_MOVES = np.array([[-1, 0], [0, 1], [1, 0], [0, -1]], np.int64)


def _four_rooms_walls(size: int) -> np.ndarray:
    """A cross of walls with one door per arm."""
    walls = np.zeros((size, size), bool)
    mid = size // 2
    walls[mid, :] = True
    walls[:, mid] = True
    q1, q3 = mid // 2, mid + 1 + (size - mid - 1) // 2
    for r, c in ((mid, q1), (mid, q3), (q1, mid), (q3, mid)):
        walls[r, c] = False
    return walls


_LAYOUTS = {
    "empty": lambda size: np.zeros((size, size), bool),
    "four_rooms": _four_rooms_walls,
}


class GridWorld(DeviceEnv):
    STEP_PENALTY = 0.01

    def __init__(self, size: int = 8, layout: str = "empty"):
        if layout not in _LAYOUTS:
            raise ValueError(f"unknown gridworld layout {layout!r}; choose from {sorted(_LAYOUTS)}")
        if size < 5:
            raise ValueError(f"gridworld size must be >= 5, got {size}")
        self.size = int(size)
        self.layout = layout
        self._walls_np = _LAYOUTS[layout](self.size)
        self._free_np = np.argwhere(~self._walls_np).astype(np.int64)  # [F, 2] free cells, row-major
        self._tables: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}
        self.spec = EnvSpec(
            obs_shape=(2 * self.size * self.size,),
            action=ActionSpec(kind="discrete", num_actions=4),
            obs_low=0.0,
            obs_high=1.0,
        )

    def _on(self, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(walls [N, N], free cells [F, 2], moves [4, 2]) on ``device``."""
        device = torch.device(device)
        if device not in self._tables:
            self._tables[device] = (
                torch.from_numpy(self._walls_np).to(device),
                torch.from_numpy(self._free_np).to(device),
                torch.from_numpy(_MOVES).to(device),
            )
        return self._tables[device]

    def draw(self, batch: Sequence[int], generator: Optional[torch.Generator], device) -> torch.Tensor:
        _, free, _ = self._on(device)
        num_free = free.shape[0]
        agent = torch.randint(0, num_free, tuple(batch), generator=generator, device=device)
        # the goal drawn from the free cells other than the agent's, by
        # shifting the draw past the agent's index
        draw = torch.randint(0, num_free - 1, tuple(batch), generator=generator, device=device)
        goal = torch.where(draw >= agent, draw + 1, draw)
        return torch.cat([free[agent], free[goal]], dim=-1)

    def observe(self, state: torch.Tensor) -> torch.Tensor:
        n = self.size * self.size
        agent_idx = state[..., 0] * self.size + state[..., 1]
        goal_idx = state[..., 2] * self.size + state[..., 3]
        return torch.cat([F.one_hot(agent_idx, n), F.one_hot(goal_idx, n)], dim=-1).to(torch.float32)

    def step(self, state: torch.Tensor, action: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        walls, _, moves = self._on(state.device)
        agent, goal = state[..., :2], state[..., 2:]
        target = torch.clamp(agent + moves[action.long()], 0, self.size - 1)
        blocked = walls[target[..., 0], target[..., 1]]
        new_agent = torch.where(blocked[..., None], agent, target)
        done = torch.all(new_agent == goal, dim=-1)
        reward = torch.where(done, 1.0, -self.STEP_PENALTY).to(torch.float32)
        new_state = torch.cat([new_agent, goal], dim=-1)
        return new_state, self.observe(new_state), reward, done
