"""Plan2Explore (Dreamer-V1) support (port of ``sheeprl_tpu/algos/p2e_dv1/utils.py``):
the metric keys and the registered models; ``prepare_obs`` and ``test`` are
Dreamer-V3's, as the JAX module takes Dreamer-V2's."""

from __future__ import annotations

from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs, test  # noqa: F401 (shared)

AGGREGATOR_KEYS = {
    # dreamer-native keys: the finetuning phase delegates to the dreamer train
    # program, which emits the unsuffixed names
    "Loss/policy_loss",
    "Loss/value_loss",
    "Grads/actor",
    "Grads/critic",
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/world_model_loss",
    "Loss/policy_loss_task",
    "Loss/value_loss_task",
    "Loss/policy_loss_exploration",
    "Loss/value_loss_exploration",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "Loss/ensemble_loss",
    "Rewards/intrinsic",
    "State/kl",
    "State/post_entropy",
    "State/prior_entropy",
    "Values_exploration/predicted_values",
    "Values_exploration/lambda_values",
    "Grads/world_model",
    "Grads/actor_task",
    "Grads/critic_task",
    "Grads/actor_exploration",
    "Grads/critic_exploration",
    "Grads/ensemble",
}
MODELS_TO_REGISTER = {
    "world_model",
    "ensembles",
    "actor_exploration",
    "critic_exploration",
    "actor_task",
    "critic_task",
}
