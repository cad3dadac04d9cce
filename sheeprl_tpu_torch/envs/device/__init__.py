"""The device env plane: environments as batched tensors on the card (port
of ``sheeprl_tpu/envs/jax``).

The host plane (``envs/`` and ``utils/env.py``) steps numpy envs one vector
step at a time. This plane keeps the envs' state in tensors on a device, so
the Anakin loop (``algos/ppo/anakin.py``) steps thousands of envs and acts on
them without a host round trip. Select it with ``env.backend=jax`` (the JAX
package's name for the plane): the Anakin loops step it directly through
:func:`make_device_env`, every host loop through :class:`DeviceToGymEnv`.
"""

from sheeprl_tpu_torch.envs.device.base import ActionSpec, DeviceEnv, EnvSpec
from sheeprl_tpu_torch.envs.device.classic import CartPole, Pendulum
from sheeprl_tpu_torch.envs.device.factory import (
    DEVICE_ENV_IDS,
    DeviceToGymEnv,
    make_device_env,
    resolve_device_env,
)
from sheeprl_tpu_torch.envs.device.gridworld import GridWorld
from sheeprl_tpu_torch.envs.device.wrappers import AutoReset, AutoResetState

__all__ = [
    "ActionSpec",
    "AutoReset",
    "AutoResetState",
    "CartPole",
    "DEVICE_ENV_IDS",
    "DeviceEnv",
    "DeviceToGymEnv",
    "EnvSpec",
    "GridWorld",
    "Pendulum",
    "make_device_env",
    "resolve_device_env",
]
