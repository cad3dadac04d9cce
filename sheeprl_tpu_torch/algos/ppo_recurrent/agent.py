"""The recurrent PPO agent (port of ``sheeprl_tpu/algos/ppo_recurrent/agent.py``).

The PPO encoders (``algos/ppo/agent.py``) over a dict observation, then an
optional pre-MLP, an LSTM cell and an optional post-MLP (:class:`RNNCore`),
then actor heads and a critic on the cell's output. Children carry the Flax
modules' names for ``interop/flax_to_torch.py``.

:class:`LSTMCell` is Flax's ``nn.OptimizedLSTMCell`` with its parameter set,
which ``torch.nn.LSTMCell`` does not have (torch carries a second bias that
would train): an input kernel ``[in, 4H]`` without bias and a hidden kernel
``[H, 4H]`` with one bias ``[4H]``, the columns in the gate order i, f, g, o;
``i, f, o = sigmoid``, ``g = tanh``, ``c' = f c + i g``, ``h' = o tanh(c')``,
no forget-gate offset.

:meth:`RecurrentPPOAgent.rnn_scan` is the JAX masked scan: a padded step
(mask 0) keeps the carry, and its output is the cell's output all the same.
The carry is ``(c, h)`` inside the cell, as Flax's is; the agent's methods
take and return ``(hx, cx)``, as the JAX ``initial_states`` and
``rnn_scan`` do. The input projections of every step are one product before
the loop, and the pre- and post-MLPs run over the whole sequence at once: the
same values as per step.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.ppo.agent import CNNEncoder, MLPEncoder
from sheeprl_tpu_torch.models.models import _TRUNC_NORMAL_STD, MLP, lecun_init_

Carry = Tuple[torch.Tensor, torch.Tensor]


class LSTMCell(nn.Module):
    """Flax's ``OptimizedLSTMCell`` (module docstring)."""

    def __init__(self, input_dim: int, hidden_size: int) -> None:
        super().__init__()
        self.hidden_size = int(hidden_size)
        self.input_kernel = nn.Parameter(torch.empty(input_dim, 4 * hidden_size))
        self.hidden_kernel = nn.Parameter(torch.empty(hidden_size, 4 * hidden_size))
        self.hidden_bias = nn.Parameter(torch.zeros(4 * hidden_size))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Flax's defaults: LeCun normal input kernels, orthogonal hidden
        kernels (one per gate), zero biases."""
        std = math.sqrt(1.0 / self.input_kernel.shape[0]) / _TRUNC_NORMAL_STD
        nn.init.trunc_normal_(self.input_kernel, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        for gate in self.hidden_kernel.split(self.hidden_size, dim=1):
            nn.init.orthogonal_(gate, generator=generator)
        self.hidden_bias.zero_()

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """The input's share of the four gates, ``x @ W_i``."""
        return x @ self.input_kernel

    def step(self, carry: Carry, projected: torch.Tensor) -> Carry:
        """One step from the input's projection: the new ``(c, h)``."""
        c, h = carry
        gates = (h @ self.hidden_kernel + self.hidden_bias) + projected
        i, f, g, o = gates.split(self.hidden_size, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return new_c, torch.sigmoid(o) * torch.tanh(new_c)

    def forward(self, carry: Carry, x: torch.Tensor) -> Carry:
        return self.step(carry, self.project(x))


def _rnn_mlp(input_dim: int, cfg: Dict[str, Any]) -> Optional[MLP]:
    if not cfg.get("apply", False):
        return None
    return MLP(input_dim, (int(cfg["dense_units"]),), None, cfg["activation"], bool(cfg["layer_norm"]))


class RNNCore(nn.Module):
    """Optional pre-MLP -> LSTM cell -> optional post-MLP."""

    def __init__(self, input_dim: int, hidden_size: int, pre_mlp: Dict[str, Any], post_mlp: Dict[str, Any]) -> None:
        super().__init__()
        self.pre_mlp = _rnn_mlp(input_dim, pre_mlp)
        self.cell = LSTMCell(self.pre_mlp.out_dim if self.pre_mlp is not None else input_dim, hidden_size)
        self.post_mlp = _rnn_mlp(hidden_size, post_mlp)
        self.out_dim = self.post_mlp.out_dim if self.post_mlp is not None else hidden_size

    def init_weights(self, generator: torch.Generator) -> None:
        for m in (self.pre_mlp, self.cell, self.post_mlp):
            if m is not None:
                m.init_weights(generator)


class ActorHeads(nn.Module):
    """An MLP backbone, then one logits head per discrete action dimension or
    one ``concat(mean, log_std)`` head for continuous control."""

    def __init__(self, input_dim: int, actions_dim: Sequence[int], is_continuous: bool, cfg: Dict[str, Any]) -> None:
        super().__init__()
        self.backbone = MLP(input_dim, (cfg["dense_units"],) * cfg["mlp_layers"], None, cfg["dense_act"],
                            cfg["layer_norm"])
        sizes = [int(np.sum(actions_dim)) * 2] if is_continuous else [int(d) for d in actions_dim]
        self.heads = nn.ModuleList(nn.Linear(self.backbone.out_dim, n) for n in sizes)

    def init_weights(self, generator: torch.Generator) -> None:
        self.backbone.init_weights(generator)
        for head in self.heads:
            lecun_init_(head, generator)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.backbone(x)
        return [head(x) for head in self.heads]


class RecurrentPPOAgent(nn.Module):
    """``forward(obs, prev_actions, hx, cx, mask)`` over ``[T, B, ...]``
    sequences returns (actor outputs, values ``[T, B, 1]``, ``(hx, cx)``)."""

    def __init__(
        self,
        actions_dim: Sequence[int],
        is_continuous: bool,
        cnn_keys: Sequence[str],
        mlp_keys: Sequence[str],
        obs_space: Any,
        screen_size: int,
        encoder_cfg: Dict[str, Any],
        rnn_cfg: Dict[str, Any],
        actor_cfg: Dict[str, Any],
        critic_cfg: Dict[str, Any],
    ) -> None:
        super().__init__()
        self.actions_dim = tuple(int(d) for d in actions_dim)
        self.is_continuous = bool(is_continuous)
        self.cnn_encoder = (
            CNNEncoder(cnn_keys, int(sum(np.prod(obs_space[k].shape[:-2]) for k in cnn_keys)),
                       encoder_cfg["cnn_features_dim"], screen_size)
            if len(cnn_keys) > 0
            else None
        )
        self.mlp_encoder = (
            MLPEncoder(
                mlp_keys,
                int(sum(np.prod(obs_space[k].shape) for k in mlp_keys)),
                encoder_cfg["mlp_features_dim"],
                encoder_cfg["dense_units"],
                encoder_cfg["mlp_layers"],
                encoder_cfg["dense_act"],
                encoder_cfg["layer_norm"],
            )
            if len(mlp_keys) > 0
            else None
        )
        if self.cnn_encoder is None and self.mlp_encoder is None:
            raise ValueError("there must be at least one encoder (cnn or mlp)")
        features = sum(e.out_dim for e in (self.cnn_encoder, self.mlp_encoder) if e is not None)
        self.rnn_hidden_size = int(rnn_cfg["lstm"]["hidden_size"])
        self.rnn = RNNCore(features + int(np.sum(self.actions_dim)), self.rnn_hidden_size,
                           dict(rnn_cfg["pre_rnn_mlp"]), dict(rnn_cfg["post_rnn_mlp"]))
        self.actor = ActorHeads(self.rnn.out_dim, self.actions_dim, self.is_continuous, actor_cfg)
        self.critic = MLP(self.rnn.out_dim, (critic_cfg["dense_units"],) * critic_cfg["mlp_layers"], 1,
                          critic_cfg["dense_act"], critic_cfg["layer_norm"])

    def init_weights(self, generator: torch.Generator) -> None:
        """Flax's initialisers, module by module (the values are the
        generator's, not Flax's draws)."""
        for enc in (self.cnn_encoder, self.mlp_encoder):
            if enc is not None:
                (enc.cnn if isinstance(enc, CNNEncoder) else enc.mlp).init_weights(generator)
        self.rnn.init_weights(generator)
        self.actor.init_weights(generator)
        self.critic.init_weights(generator)

    def initial_states(self, num_envs: int, device: Any = "cpu") -> Carry:
        """Zero ``(hx, cx)``, ``[num_envs, H]`` each."""
        zeros = torch.zeros(num_envs, self.rnn_hidden_size, device=device)
        return zeros, zeros.clone()

    def features(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat([enc(obs) for enc in (self.cnn_encoder, self.mlp_encoder) if enc is not None], dim=-1)

    def rnn_scan(
        self, embedded: torch.Tensor, hx: torch.Tensor, cx: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Carry]:
        """The cell over ``embedded [T, B, F + A]`` from ``(hx, cx)``; where
        ``mask [T, B, 1]`` is 0 the carry stays. Returns the outputs ``[T, B,
        out]`` and the last ``(hx, cx)``."""
        rnn = self.rnn
        x = rnn.pre_mlp(embedded) if rnn.pre_mlp is not None else embedded
        projected = rnn.cell.project(x)
        keep = None if mask is None else mask.to(torch.bool)
        carry, outs = (cx, hx), []
        for t in range(projected.shape[0]):
            new = rnn.cell.step(carry, projected[t])
            outs.append(new[1])
            if keep is None:
                carry = new
            else:
                carry = (torch.where(keep[t], new[0], carry[0]), torch.where(keep[t], new[1], carry[1]))
        out = torch.stack(outs, dim=0)
        if rnn.post_mlp is not None:
            out = rnn.post_mlp(out)
        return out, (carry[1], carry[0])

    def forward(
        self,
        obs: Dict[str, torch.Tensor],
        prev_actions: torch.Tensor,
        hx: torch.Tensor,
        cx: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
    ) -> Tuple[List[torch.Tensor], torch.Tensor, Carry]:
        embedded = torch.cat([self.features(obs), prev_actions], dim=-1)
        out, states = self.rnn_scan(embedded, hx, cx, mask)
        return self.actor(out), self.critic(out), states


def build_agent(
    fabric,
    actions_dim: Sequence[int],
    is_continuous: bool,
    cfg,
    obs_space,
    seed: int,
    agent_state: Optional[Dict[str, Any]] = None,
) -> RecurrentPPOAgent:
    """The agent on the fabric's device: Flax's initialisers from ``seed``,
    or the Flax-layout parameters ``agent_state`` of a checkpoint."""
    from sheeprl_tpu_torch.interop.flax_to_torch import load_ppo_recurrent_params

    agent = RecurrentPPOAgent(
        actions_dim=actions_dim,
        is_continuous=is_continuous,
        cnn_keys=tuple(cfg.algo.cnn_keys.encoder),
        mlp_keys=tuple(cfg.algo.mlp_keys.encoder),
        obs_space=obs_space,
        screen_size=cfg.env.screen_size,
        encoder_cfg=dict(cfg.algo.encoder),
        rnn_cfg=dict(cfg.algo.rnn),
        actor_cfg=dict(cfg.algo.actor),
        critic_cfg=dict(cfg.algo.critic),
    )
    agent.init_weights(torch.Generator().manual_seed(int(seed)))
    if agent_state is not None:
        load_ppo_recurrent_params(agent, agent_state)
    return agent.to(fabric.device)
