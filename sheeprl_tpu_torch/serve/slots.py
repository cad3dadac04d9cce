"""Device-resident session-slot table (port of ``sheeprl_tpu/serve/slots.py``).

Each concurrent session owns one row of a fixed-size table whose carry tensors
live on the device with a leading ``[S]`` slot axis. One batched step

    step(slot_obs, slot_mask) -> actions

advances every slot per tick at the fixed shape ``[S, ...]``: rows that have a
pending request take the new carry, every other row keeps its carry bit-exact
(a ``torch.where`` over the mask). Admission writes fresh carries into any
subset of rows between ticks.

Each slot also owns a ``torch.Generator`` on the device, seeded from its
session's seed at admission; a tick draws noise only for the rows it serves, so
a session's action stream is a pure function of (weights, seed, observations).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.serve.policy import ServePolicy, draw_noise

__all__ = ["SlotTable"]


class SlotTable:
    """S device-resident session slots. Host-side bookkeeping (which session
    holds which slot) is plain Python under a lock; the server serializes the
    device work through its tick loop."""

    def __init__(self, policy: ServePolicy, num_slots: int, base_seed: int = 0) -> None:
        if num_slots < 1:
            raise ValueError(f"serve.slots must be >= 1, got {num_slots}")
        self.policy = policy
        self.num_slots = int(num_slots)
        self.base_seed = int(base_seed)
        self.device = policy.device
        self.states: Dict[str, torch.Tensor] = policy.init_slots(self.num_slots)
        self.generators: List[torch.Generator] = [
            self._generator(self.base_seed + i) for i in range(self.num_slots)
        ]
        self._state_bytes = sum(t.numel() * t.element_size() for t in self.states.values())
        self._free: List[int] = list(range(self.num_slots))
        self._owner: Dict[int, Any] = {}
        self._lock = threading.Lock()

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    # -- host bookkeeping ----------------------------------------------------------

    @property
    def free_slots(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def active_slots(self) -> int:
        with self._lock:
            return len(self._owner)

    def try_admit(self, session: Any) -> Optional[int]:
        """Claim a free slot for ``session`` (its carry is stale until
        :meth:`attach` runs); None when the table is full."""
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop(0)
            self._owner[slot] = session
            return slot

    def evict(self, slot: int) -> None:
        """Release ``slot``; the next admission's :meth:`attach` overwrites its carry."""
        with self._lock:
            self._owner.pop(slot, None)
            if slot not in self._free:
                self._free.append(slot)

    # -- device work ---------------------------------------------------------------

    def attach(self, slot_seeds: Dict[int, int]) -> None:
        """Fresh carries and generators for ``slot_seeds``'s slots (slot -> seed)."""
        if not slot_seeds:
            return
        slots = sorted(slot_seeds)
        index = torch.tensor(slots, dtype=torch.long, device=self.device)
        fresh = self.policy.init_slots(len(slots))
        with torch.no_grad():
            for key, value in fresh.items():
                self.states[key].index_copy_(0, index, value)
        for slot in slots:
            self.generators[slot] = self._generator(slot_seeds[slot])

    def step(self, obs: Dict[str, np.ndarray], mask: np.ndarray) -> np.ndarray:
        """One serving tick: ``obs`` are ``[S, ...]`` host arrays (zeros in rows
        without a request), ``mask`` marks the rows with one. Returns the
        ``[S, ...]`` actions (rows outside the mask are meaningless)."""
        device = self.device
        obs_t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in obs.items()}
        gens = [g if m else None for g, m in zip(self.generators, mask)]
        noise = {
            name: draw_noise(spec, gens, device) for name, spec in self.policy.noise_spec.items()
        }
        actions, new_states = self.policy.step_slots(self.states, obs_t, noise)
        keep = torch.from_numpy(np.asarray(mask, dtype=np.bool_)).to(device)
        with torch.no_grad():
            for key, new in new_states.items():
                m = keep.reshape(-1, *([1] * (new.ndim - 1)))
                self.states[key] = torch.where(m, new, self.states[key])
        return actions.cpu().numpy()

    def state_bytes(self) -> int:
        """Device bytes the slot table's carries hold (constant after init)."""
        return self._state_bytes
