"""Offline Dreamer support (port of ``sheeprl_tpu/algos/offline_dreamer/utils.py``):
the metric keys and the registered models; ``prepare_obs`` and ``test`` are
Dreamer-V3's."""

from __future__ import annotations

from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs, test  # noqa: F401 (shared with Dreamer-V3)

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/world_model_loss",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "Loss/concept_loss",
    "State/kl",
    "State/post_entropy",
    "State/prior_entropy",
    "Grads/world_model",
    "Grads/actor",
    "Grads/critic",
}
MODELS_TO_REGISTER = {"world_model", "actor", "critic", "target_critic", "moments"}
