"""Plan2Explore on the Dreamer-V1 backbone, the finetuning phase (port of
``sheeprl_tpu/algos/p2e_dv1/p2e_dv1_finetuning.py``).

The run starts from an exploration checkpoint (of either package): the
models' settings come from the exploration run's config, the world model and
the task heads from its checkpoint, remapped onto Dreamer-V1's layout, and
with ``buffer.load_from_exploration`` its replay buffer too. The player acts
from the first iteration, with the exploration actor while
``algo.player.actor_type`` is ``exploration`` (the default) and the task
actor once learning starts; Dreamer-V1's own step trains the task heads and
the world model. Checkpoints hold Dreamer-V1's layout, as the JAX package's
do, so they resume here and evaluate as Plan2Explore's or Dreamer-V1's.
:func:`finetune` is the Dreamer-V2 backbone's too.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

from sheeprl_tpu_torch.algos.dreamer_v1 import dreamer_v1

# the exploration run's model settings, which finetuning must keep
EXPLORATION_ALGO_KEYS = ("gamma", "lmbda", "horizon", "dense_units", "mlp_layers", "dense_act", "cnn_act",
                         "world_model", "actor", "critic", "cnn_keys", "mlp_keys")


def dreamer_layout(agent_state: Dict[str, Any]) -> Dict[str, Any]:
    """A P2E-layout params tree remapped onto the Dreamer-V1/V2 layout (the
    world model and the task heads); a Dreamer-layout tree as it is."""
    if "actor_task" not in agent_state:
        return agent_state
    out = {"world_model": agent_state["world_model"], "actor": agent_state["actor_task"],
           "critic": agent_state["critic_task"]}
    if "target_critic_task" in agent_state:
        out["target_critic"] = agent_state["target_critic_task"]
    return out


def _exploration_actor(tree: Dict[str, Any], agent):
    """The exploration actor of a P2E checkpoint, on the agent's device: a
    copy of the task actor's module loaded with ``tree``."""
    import copy

    from sheeprl_tpu_torch.interop.flax_to_torch import module_from_flax

    actor = copy.deepcopy(agent.actor)
    module_from_flax(actor, tree, "actor_exploration")
    return actor


def finetune(fabric, cfg, exploration_cfg, main_fn: Callable, algo_keys: Sequence[str] = EXPLORATION_ALGO_KEYS):
    """Finetune with ``main_fn`` (the backbone's ``main``) from
    ``checkpoint.exploration_ckpt_path``, or resume a finetuning run from
    ``checkpoint.resume_from`` (module docstring)."""
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    for k in algo_keys:
        if k in exploration_cfg.algo:
            cfg.algo[k] = exploration_cfg.algo[k]
    cfg.env.clip_rewards = exploration_cfg.env.clip_rewards
    if cfg.buffer.get("load_from_exploration", False) and exploration_cfg.buffer.checkpoint:
        cfg.env.num_envs = exploration_cfg.env.num_envs
    exploration_state: Optional[Dict[str, Any]] = None
    exploration_actor = None
    if not cfg.checkpoint.resume_from:
        exploration_state = dict(load_checkpoint(cfg.checkpoint.exploration_ckpt_path))
        agent_state = exploration_state["agent"]
        if "actor_task" in agent_state and cfg.algo.player.actor_type == "exploration":
            tree = agent_state["actor_exploration"]
            exploration_actor = lambda agent: _exploration_actor(tree, agent)  # noqa: E731
        exploration_state["agent"] = dreamer_layout(agent_state)
    return main_fn(fabric, cfg, exploration_actor=exploration_actor, finetuning=True,
                   exploration_state=exploration_state)


def main(fabric, cfg: Dict[str, Any], exploration_cfg: Dict[str, Any]) -> Dict[str, Any]:
    return finetune(fabric, cfg, exploration_cfg, dreamer_v1.main)
