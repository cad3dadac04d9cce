"""The serving-side policy contract of the port: one batched step over slots.

Port of ``sheeprl_tpu/serve/policy.py``. The JAX package writes a policy as an
unbatched ``step_slot`` that its slot table vmaps; the port writes the batch
over slots out:

- ``init_slots(n) -> carry`` builds ``n`` fresh session carries, every leaf a
  ``[n, ...]`` tensor on ``device`` (for recurrent policies the O(1) per-step
  state: previous action, recurrent and stochastic latents);
- ``step_slots(carry, obs, noise) -> (actions, carry')`` advances every slot by
  one step. ``obs`` holds ``[S, ...]`` tensors in the dtypes the env emits (any
  normalization happens inside the step), ``noise`` one ``[S, size]`` tensor per
  entry of ``noise_spec``. The returned actions are env-facing;
- ``params_tree`` and ``load_params`` map the serving module to and from the
  checkpoint's ``agent`` tree, which hot reload (``serve/reload.py``) needs.

The noise is the session's own: the slot table draws each slot's rows from the
``torch.Generator`` it seeded from the session seed when the session attached,
so a session's action stream depends only on (weights, seed, observations) —
never on which other sessions share its batch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["NoiseSpec", "ObsSpec", "ServePolicy", "draw_noise", "resolve_serve_policy", "space_obs_spec"]


@dataclass(frozen=True)
class ObsSpec:
    """Per-session observation layout: ``shape`` without the slot axis, and the
    dtype the env emits (uint8 pixels move 4x fewer bytes than float32)."""

    shape: Tuple[int, ...]
    dtype: Any

    def zeros(self, num_slots: int) -> np.ndarray:
        return np.zeros((num_slots, *self.shape), dtype=self.dtype)


@dataclass(frozen=True)
class NoiseSpec:
    """``size`` values per slot and step: ``gumbel`` (standard Gumbel) or
    ``normal`` (standard normal), drawn in float32 and handed to the step in
    ``dtype`` (the policy's compute dtype, the dtype JAX draws it in)."""

    kind: str
    size: int
    dtype: torch.dtype = torch.float32


@dataclass
class ServePolicy:
    """A checkpointed policy in serving form (see the module docstring)."""

    algo: str
    device: torch.device
    init_slots: Callable[[int], Dict[str, torch.Tensor]]
    step_slots: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    noise_spec: Dict[str, NoiseSpec]
    obs_spec: Dict[str, ObsSpec]
    action_shape: Tuple[int, ...]
    action_dtype: Any = np.float32
    module: Optional[torch.nn.Module] = None
    meta: Dict[str, Any] = field(default_factory=dict)
    # hot reload (serve/reload.py): the family's checkpoint layout, read from a
    # module (``params_tree(module) -> tree``), and its loader
    # (``load_params(module, tree)``, copying a checkpoint's tree in place)
    params_tree: Optional[Callable[[torch.nn.Module], Any]] = None
    load_params: Optional[Callable[[torch.nn.Module, Any], None]] = None


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise from U[0, 1) samples (the transform
    ``jax.random.gumbel`` applies to its uniform bits)."""
    tiny = torch.finfo(u.dtype).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def draw_noise(
    spec: NoiseSpec, generators: Sequence[Optional[torch.Generator]], device: torch.device
) -> torch.Tensor:
    """``[len(generators), spec.size]`` noise; row i from ``generators[i]``, zeros
    where it is None (slots without a request this tick keep their stream)."""
    out = torch.zeros((len(generators), spec.size), dtype=torch.float32, device=device)
    for i, gen in enumerate(generators):
        if gen is None:
            continue
        if spec.kind == "normal":
            out[i].normal_(generator=gen)
        else:
            out[i].uniform_(generator=gen)
    if spec.kind == "gumbel":
        out = gumbel_from_uniform(out)
    elif spec.kind != "normal":
        raise ValueError(f"unknown noise kind {spec.kind!r}")
    return out.to(spec.dtype)


def space_obs_spec(observation_space, obs_keys: Sequence[str]) -> Dict[str, ObsSpec]:
    """ObsSpec dict for the policy's encoder keys from a dict observation space."""
    return {
        k: ObsSpec(tuple(int(s) for s in observation_space[k].shape), np.dtype(observation_space[k].dtype))
        for k in obs_keys
    }


def resolve_serve_policy(fabric, cfg, state) -> ServePolicy:
    """Build ``cfg.algo.name``'s serving policy; raises with the served set when
    the family has none."""
    from sheeprl_tpu_torch.utils.registry import SERVE_POLICIES, load_entrypoint

    return load_entrypoint(SERVE_POLICIES, cfg.algo.name, "serving policy")(fabric, cfg, state)
