"""Plan2Explore (Dreamer-V3) support (port of ``sheeprl_tpu/algos/p2e_dv3/utils.py``):
the metric keys and the registered models; the Moments, ``prepare_obs`` and
``test`` are Dreamer-V3's."""

from __future__ import annotations

from sheeprl_tpu_torch.algos.dreamer_v3.utils import (  # noqa: F401 (shared with Dreamer-V3)
    init_moments,
    prepare_obs,
    test,
    update_moments,
)

AGGREGATOR_KEYS = {
    # finetuning trains with the Dreamer-V3 step, which logs the unsuffixed names
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
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "Loss/ensemble_loss",
    "State/kl",
    "State/post_entropy",
    "State/prior_entropy",
    "Grads/world_model",
    "Grads/actor_task",
    "Grads/critic_task",
    "Grads/actor_exploration",
    "Grads/ensemble",
    # the exploration critics' metrics carry the critic's name as a suffix
    "Loss/value_loss_exploration",
    "Grads/critic_exploration",
    "Rewards/intrinsic",
    "Values_exploration/predicted_values",
    "Values_exploration/lambda_values",
}
MODELS_TO_REGISTER = {
    "world_model",
    "ensembles",
    "actor_exploration",
    "critics_exploration",
    "actor_task",
    "critic_task",
    "target_critic_task",
    "moments_task",
    "moments_exploration",
}
