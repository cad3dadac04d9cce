"""Parameters across: the JAX package's Flax trees <-> the port's modules.

A checkpoint of either package stores the agent's parameters in the Flax
layout, as nested dicts of numpy arrays. This module maps that layout onto the
port's ``nn.Module``s and back:

- Dense ``kernel [in, out]`` / ``bias``  <->  Linear ``weight [out, in]`` / ``bias``
- Conv ``kernel`` HWIO  <->  Conv2d ``weight`` OIHW
- ConvTranspose ``kernel`` HWIO  <->  ConvTranspose2d ``weight (I, O, kH, kW)``,
  spatially flipped (``lax.conv_transpose`` does not flip the kernel,
  ``conv_transpose2d`` does)
- LayerNorm ``scale`` / ``bias``  <->  ``weight`` / ``bias``
- LayerNorm-GRU ``kernel [K, 3H]`` (rows ``concat(x, h)``, columns reset,
  candidate, update), ``bias``, ``ln_scale``, ``ln_bias``: kept as they are.

Composite modules name their children as the Flax modules do (``Dense_0``,
``LayerNorm_1``, ``DenseStack_0``, ``Conv_2``, ...). The Dreamer-V3 agent
(:func:`agent_to_flax`, :func:`load_flax_params`) and the PPO agent, which A2C
shares (:func:`ppo_to_flax`, :func:`load_ppo_params`), are mapped whole;
:func:`dv3_group_to_torch` and :func:`ppo_to_torch` turn a tree shaped like a
parameter group (an optax moment) into the group's tensors.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3 import agent as dv3
from sheeprl_tpu_torch.algos.ppo import agent as ppo
from sheeprl_tpu_torch.models.models import MLP, LayerNormGRUCell, NatureCNN

Tree = Dict[str, Any]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _copy(dst: torch.Tensor, value: np.ndarray, what: str) -> None:
    src = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: checkpoint shape {tuple(src.shape)} != module shape {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src.to(dst.device))


# -- leaves ---------------------------------------------------------------------------
def linear_to_flax(m: nn.Linear) -> Tree:
    out = {"kernel": _np(m.weight).T.copy()}
    if m.bias is not None:
        out["bias"] = _np(m.bias)
    return out


def linear_from_flax(m: nn.Linear, tree: Tree, what: str = "Dense") -> None:
    _copy(m.weight, np.asarray(tree["kernel"]).T, what + ".kernel")
    if m.bias is not None:
        _copy(m.bias, tree["bias"], what + ".bias")


def conv_to_flax(m: nn.Conv2d) -> Tree:
    out = {"kernel": _np(m.weight).transpose(2, 3, 1, 0).copy()}
    if m.bias is not None:
        out["bias"] = _np(m.bias)
    return out


def conv_from_flax(m: nn.Conv2d, tree: Tree, what: str = "Conv") -> None:
    _copy(m.weight, np.asarray(tree["kernel"]).transpose(3, 2, 0, 1), what + ".kernel")
    if m.bias is not None:
        _copy(m.bias, tree["bias"], what + ".bias")


def deconv_to_flax(m: nn.ConvTranspose2d) -> Tree:
    # (I, O, kH, kW) -> HWIO, undoing the spatial flip
    out = {"kernel": _np(m.weight).transpose(2, 3, 0, 1)[::-1, ::-1].copy()}
    if m.bias is not None:
        out["bias"] = _np(m.bias)
    return out


def deconv_from_flax(m: nn.ConvTranspose2d, tree: Tree, what: str = "ConvTranspose") -> None:
    kernel = np.asarray(tree["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)
    _copy(m.weight, kernel, what + ".kernel")
    if m.bias is not None:
        _copy(m.bias, tree["bias"], what + ".bias")


def layer_norm_to_flax(m: nn.LayerNorm) -> Tree:
    return {"scale": _np(m.weight), "bias": _np(m.bias)}


def layer_norm_from_flax(m: nn.LayerNorm, tree: Tree, what: str = "LayerNorm") -> None:
    _copy(m.weight, tree["scale"], what + ".scale")
    _copy(m.bias, tree["bias"], what + ".bias")


def gru_to_flax(m: LayerNormGRUCell) -> Tree:
    out = {"kernel": _np(m.kernel)}
    if m.has_bias:
        out["bias"] = _np(m.bias)
    out["ln_scale"] = _np(m.ln_scale)
    out["ln_bias"] = _np(m.ln_bias)
    return out


def gru_from_flax(m: LayerNormGRUCell, tree: Tree, what: str = "LayerNormGRUCell") -> None:
    _copy(m.kernel, tree["kernel"], what + ".kernel")
    if m.has_bias:
        _copy(m.bias, tree["bias"], what + ".bias")
    _copy(m.ln_scale, tree["ln_scale"], what + ".ln_scale")
    _copy(m.ln_bias, tree["ln_bias"], what + ".ln_bias")


_LEAVES = (
    (nn.Linear, linear_to_flax, linear_from_flax),
    (nn.Conv2d, conv_to_flax, conv_from_flax),
    (nn.ConvTranspose2d, deconv_to_flax, deconv_from_flax),
    (nn.LayerNorm, layer_norm_to_flax, layer_norm_from_flax),
    (LayerNormGRUCell, gru_to_flax, gru_from_flax),
)


# -- composites -----------------------------------------------------------------------
def _children(m: nn.Module) -> Dict[str, nn.Module]:
    """Flax child name -> port module, for every composite module of the agent."""
    if isinstance(m, dv3.DenseStack):
        out = {f"Dense_{i}": lin for i, lin in enumerate(m.linears)}
        out.update({f"LayerNorm_{i}": ln for i, ln in enumerate(m.norms)})
        return out
    if isinstance(m, dv3.MLPHead):
        return {"DenseStack_0": m.stack, "Dense_0": m.head}
    if isinstance(m, dv3.CNNEncoder):
        out = {f"Conv_{i}": conv for i, conv in enumerate(m.convs)}
        out.update({f"LayerNorm_{i}": ln for i, ln in enumerate(m.norms)})
        return out
    if isinstance(m, dv3.MLPEncoder):
        return {"DenseStack_0": m.stack}
    if isinstance(m, dv3.Encoder):
        return {k: v for k, v in (("cnn_encoder", m.cnn_encoder), ("mlp_encoder", m.mlp_encoder)) if v is not None}
    if isinstance(m, dv3.RecurrentModel):
        return {"DenseStack_0": m.stack, "LayerNormGRUCell_0": m.cell}
    if isinstance(m, dv3.Actor):
        out = {"DenseStack_0": m.stack}
        out.update({f"Dense_{i}": head for i, head in enumerate(m.heads)})
        return out
    if isinstance(m, dv3.CNNDecoder):
        out = {"Dense_0": m.linear}
        out.update({f"ConvTranspose_{i}": d for i, d in enumerate(m.deconvs)})
        out.update({f"LayerNorm_{i}": ln for i, ln in enumerate(m.norms)})
        return out
    if isinstance(m, dv3.MLPDecoder):
        out = {"DenseStack_0": m.stack}
        out.update({f"Dense_{i}": head for i, head in enumerate(m.heads)})
        return out
    if isinstance(m, MLP):
        out = {f"Dense_{i}": lin for i, lin in enumerate(m.linears)}
        out.update({f"LayerNorm_{i}": ln for i, ln in enumerate(m.norms)})
        return out
    if isinstance(m, NatureCNN):
        return {"CNN_0": m.convs, "Dense_0": m.linear}
    if isinstance(m, nn.ModuleList) and all(isinstance(c, nn.Conv2d) for c in m):  # NatureCNN's CNN_0
        return {f"Conv_{i}": conv for i, conv in enumerate(m)}
    if isinstance(m, ppo.CNNEncoder):
        return {"NatureCNN_0": m.cnn}
    if isinstance(m, ppo.MLPEncoder):
        return {"MLP_0": m.mlp}
    if isinstance(m, dv3.Decoder):
        return {k: v for k, v in (("cnn_decoder", m.cnn_decoder), ("mlp_decoder", m.mlp_decoder)) if v is not None}
    raise TypeError(f"no Flax mapping for {type(m).__name__}")


def module_to_flax(m: nn.Module) -> Tree:
    for cls, to_flax, _ in _LEAVES:
        if isinstance(m, cls):
            return to_flax(m)
    return {name: module_to_flax(child) for name, child in _children(m).items()}


def module_from_flax(m: nn.Module, tree: Tree, what: str = "") -> None:
    for cls, _, from_flax in _LEAVES:
        if isinstance(m, cls):
            from_flax(m, tree, what or cls.__name__)
            return
    children = _children(m)
    missing = sorted(set(children) - set(tree))
    extra = sorted(set(tree) - set(children))
    if missing or extra:
        raise ValueError(
            f"{what or type(m).__name__}: checkpoint children {sorted(tree)} do not match "
            f"the module's {sorted(children)} (missing {missing}, unexpected {extra})"
        )
    for name, child in children.items():
        module_from_flax(child, tree[name], f"{what}/{name}" if what else name)


# -- the Dreamer-V3 agent ---------------------------------------------------------------
_WORLD_MODEL = (
    "encoder",
    "recurrent_model",
    "representation_model",
    "transition_model",
    "observation_model",
    "reward_model",
    "continue_model",
)


def agent_to_flax(agent: "dv3.DV3Agent") -> Tree:
    """The agent's parameters as the JAX package's params tree (numpy leaves)."""
    wm = {name: module_to_flax(agent.world_model[name]) for name in _WORLD_MODEL}
    wm["initial_recurrent_state"] = _np(agent.initial_recurrent_state)
    return {
        "world_model": wm,
        "actor": module_to_flax(agent.actor),
        "critic": module_to_flax(agent.critic),
        "target_critic": module_to_flax(agent.target_critic),
    }


def load_flax_params(agent: "dv3.DV3Agent", params: Tree) -> None:
    """Copy a JAX-package params tree (numpy or array-like leaves) into ``agent``."""
    wm = params["world_model"]
    for name in _WORLD_MODEL:
        module_from_flax(agent.world_model[name], wm[name], f"world_model/{name}")
    _copy(agent.initial_recurrent_state, wm["initial_recurrent_state"], "initial_recurrent_state")
    module_from_flax(agent.actor, params["actor"], "actor")
    module_from_flax(agent.critic, params["critic"], "critic")
    module_from_flax(agent.target_critic, params["target_critic"], "target_critic")


def dv3_group_to_torch(agent: "dv3.DV3Agent", group: str) -> Callable[[Tree], List[torch.Tensor]]:
    """A tree shaped like the JAX params of one optimizer group
    (``world_model``, ``actor`` or ``critic``) -> tensors in the order of
    ``param_groups(agent)[group]``."""

    def convert(tree: Tree) -> List[torch.Tensor]:
        if group == "world_model":
            scratch = copy.deepcopy(agent.world_model)
            for name in _WORLD_MODEL:
                module_from_flax(scratch[name], tree[name], f"world_model/{name}")
            init = torch.tensor(np.asarray(tree["initial_recurrent_state"], dtype=np.float32))
            return [p.detach() for p in scratch.parameters()] + [init]
        scratch = copy.deepcopy(getattr(agent, group))
        module_from_flax(scratch, tree, group)
        return [p.detach() for p in scratch.parameters()]

    return convert


# -- the PPO agent (A2C's too) ------------------------------------------------------------
def _ppo_parts(agent: "ppo.PPOAgent") -> Dict[str, nn.Module]:
    parts = {"critic": agent.critic, "actor_backbone": agent.actor_backbone}
    parts.update({f"actor_heads_{i}": head for i, head in enumerate(agent.actor_heads)})
    return parts


def _ppo_encoders(agent: "ppo.PPOAgent") -> Dict[str, nn.Module]:
    return {k: v for k, v in (("cnn_encoder", agent.cnn_encoder), ("mlp_encoder", agent.mlp_encoder)) if v is not None}


def ppo_to_flax(agent: "ppo.PPOAgent") -> Tree:
    """The agent's parameters as the JAX package's PPO params tree."""
    out = {"feature_extractor": {k: module_to_flax(v) for k, v in _ppo_encoders(agent).items()}}
    out.update({k: module_to_flax(v) for k, v in _ppo_parts(agent).items()})
    return out


def load_ppo_params(agent: "ppo.PPOAgent", params: Tree) -> None:
    """Copy a JAX-package PPO params tree into ``agent``."""
    encoders, parts = _ppo_encoders(agent), _ppo_parts(agent)
    expected, found = sorted(["feature_extractor", *parts]), sorted(params)
    if expected != found or sorted(params["feature_extractor"]) != sorted(encoders):
        raise ValueError(f"PPO params: checkpoint children {found} do not match the agent's {expected}")
    for name, module in encoders.items():
        module_from_flax(module, params["feature_extractor"][name], f"feature_extractor/{name}")
    for name, module in parts.items():
        module_from_flax(module, params[name], name)


def ppo_to_torch(agent: "ppo.PPOAgent") -> Callable[[Tree], List[torch.Tensor]]:
    """A tree shaped like the JAX PPO params -> tensors in ``agent.parameters()`` order."""

    def convert(tree: Tree) -> List[torch.Tensor]:
        scratch = copy.deepcopy(agent)
        load_ppo_params(scratch, tree)
        return [p.detach() for p in scratch.parameters()]

    return convert
