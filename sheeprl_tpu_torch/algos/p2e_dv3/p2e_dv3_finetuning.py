"""Plan2Explore on the Dreamer-V3 backbone, the finetuning phase (port of
``sheeprl_tpu/algos/p2e_dv3/p2e_dv3_finetuning.py``).

The run starts from an exploration checkpoint (of either package): the
models' settings come from the exploration run's config, the agent from its
checkpoint, and with ``buffer.load_from_exploration`` its replay buffer too.
The player acts from the first iteration with the actor
``algo.player.actor_type`` names (the exploration actor by default) and
switches to the task actor once learning starts; the task heads and the world
model train with the Dreamer-V3 step. Checkpoints keep the whole P2E layout,
so a finetuning checkpoint resumes, evaluates and finetunes again.
"""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, build_optimizers, run_dreamer
from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent, make_player

# the exploration run's model settings, which finetuning must keep
EXPLORATION_ALGO_KEYS = (
    "gamma", "lmbda", "horizon", "dense_units", "mlp_layers", "dense_act", "cnn_act", "unimix",
    "hafner_initialization", "world_model", "actor", "critic", "cnn_keys", "mlp_keys",
)


class FinetuneTrainer(DV3Trainer):
    """The Dreamer-V3 step on the P2E agent's world model and task heads; its
    checkpoints carry the whole P2E agent."""

    def agent_state(self) -> Dict[str, Any]:
        from sheeprl_tpu_torch.interop.flax_to_torch import p2e_to_flax

        return p2e_to_flax(self.agent)


def make_trainer(agent, cfg) -> FinetuneTrainer:
    return FinetuneTrainer(agent, cfg, build_optimizers(cfg, agent))


def main(fabric, cfg: Dict[str, Any], exploration_cfg: Dict[str, Any]) -> Dict[str, Any]:
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    for k in EXPLORATION_ALGO_KEYS:
        if k in exploration_cfg.algo:
            cfg.algo[k] = exploration_cfg.algo[k]
    cfg.env.clip_rewards = exploration_cfg.env.clip_rewards
    if cfg.buffer.get("load_from_exploration", False) and exploration_cfg.buffer.checkpoint:
        cfg.env.num_envs = exploration_cfg.env.num_envs
    exploration_state = None if cfg.checkpoint.resume_from else load_checkpoint(cfg.checkpoint.exploration_ckpt_path)
    return run_dreamer(
        fabric,
        cfg,
        build_agent_fn=build_agent,
        player_cls=make_player(str(cfg.algo.player.actor_type)),
        make_trainer=make_trainer,
        finetuning=True,
        exploration_state=exploration_state,
    )
