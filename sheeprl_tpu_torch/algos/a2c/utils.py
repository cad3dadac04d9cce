"""A2C helpers (port of ``sheeprl_tpu/algos/a2c/utils.py``): PPO's, with A2C's
metric whitelist."""

from sheeprl_tpu_torch.algos.ppo.utils import normalize_obs, prepare_obs, test  # noqa: F401

AGGREGATOR_KEYS = {"Rewards/rew_avg", "Game/ep_len_avg", "Loss/value_loss", "Loss/policy_loss"}
MODELS_TO_REGISTER = {"agent"}
