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
- ``OptimizedLSTMCell``'s one dense per gate (``ii``/``if``/``ig``/``io``
  kernels ``[in, H]`` without bias, ``hi``/``hf``/``hg``/``ho`` kernels
  ``[H, H]`` with a bias)  <->  the port's ``LSTMCell``'s fused
  ``input_kernel [in, 4H]``, ``hidden_kernel [H, 4H]`` and ``hidden_bias
  [4H]``, the gates' columns in the order i, f, g, o.

- a vmapped ensemble's stacked ``Dense`` (``kernel [n, in, out]``, ``bias
  [n, out]``) and ``LayerNorm`` (``scale``/``bias`` ``[n, h]``) leaves  <->
  ``EnsembleMLP``'s stacked parameters, kept as they are.

- Plan2Explore's ``EnsembleHeads`` (``VmapMLPHead_0``: stacked ``[n, ...]``
  kernels, LayerNorm and head leaves), kept as they are.

The Dreamer-V2 agent, which Dreamer-V1 shares (:func:`dv2_to_flax`,
:func:`load_dv2_params`, :func:`dv2_group_to_torch`), maps whole too, and so
do the Plan2Explore agents built on them (:func:`p2e_dv_to_flax`,
:func:`load_p2e_dv_params`, :func:`p2e_dv_group_to_torch`).

Composite modules name their children as the Flax modules do (``Dense_0``,
``LayerNorm_1``, ``DenseStack_0``, ``Conv_2``, ``context_0``/``prob_0`` of
Offline Dreamer's CEM, ...). The Dreamer-V3 agent, Offline Dreamer's with its
``world_model/cem`` (:func:`agent_to_flax`, :func:`load_flax_params`), the
Plan2Explore agent (:func:`p2e_to_flax`, :func:`load_p2e_params`,
:func:`p2e_group_to_torch`), the PPO agent, which A2C
shares (:func:`ppo_to_flax`, :func:`load_ppo_params`), the SAC agent,
which DroQ shares (:func:`sac_to_flax`, :func:`load_sac_params`), and the
SAC-AE agent (:func:`sac_ae_to_flax`, :func:`load_sac_ae_params`,
:func:`sac_ae_group_to_torch`) and the recurrent PPO agent
(:func:`ppo_recurrent_to_flax`, :func:`load_ppo_recurrent_params`) are mapped
whole; :func:`dv3_group_to_torch`, :func:`ppo_to_torch`,
:func:`ppo_recurrent_to_torch` and :func:`sac_group_to_torch` turn a tree shaped like a parameter group (an optax
moment) into the group's tensors.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v2 import agent as dv2
from sheeprl_tpu_torch.algos.dreamer_v3 import agent as dv3
from sheeprl_tpu_torch.algos.offline_dreamer import agent as odv3
from sheeprl_tpu_torch.algos.p2e_dv3 import agent as p2e
from sheeprl_tpu_torch.algos.ppo import agent as ppo
from sheeprl_tpu_torch.algos.ppo_recurrent import agent as rppo
from sheeprl_tpu_torch.algos.sac import agent as sac
from sheeprl_tpu_torch.algos.sac_ae import agent as sac_ae
from sheeprl_tpu_torch.models.models import MLP, EnsembleMLP, LayerNormGRUCell, NatureCNN

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
    if m.layer_norm:
        out["ln_scale"] = _np(m.ln_scale)
        out["ln_bias"] = _np(m.ln_bias)
    return out


def gru_from_flax(m: LayerNormGRUCell, tree: Tree, what: str = "LayerNormGRUCell") -> None:
    leaves = ["kernel", *(["bias"] if m.has_bias else []), *(["ln_scale", "ln_bias"] if m.layer_norm else [])]
    if sorted(tree) != sorted(leaves):
        raise ValueError(f"{what}: checkpoint leaves {sorted(tree)} do not match the cell's {sorted(leaves)}")
    _copy(m.kernel, tree["kernel"], what + ".kernel")
    if m.has_bias:
        _copy(m.bias, tree["bias"], what + ".bias")
    if m.layer_norm:
        _copy(m.ln_scale, tree["ln_scale"], what + ".ln_scale")
        _copy(m.ln_bias, tree["ln_bias"], what + ".ln_bias")


def _ensemble_leaves(m: EnsembleMLP) -> Dict[str, Dict[str, torch.Tensor]]:
    """Flax child name -> {leaf name: stacked parameter} of an ensemble's MLP."""
    out = {f"Dense_{i}": {"kernel": k, "bias": b} for i, (k, b) in enumerate(zip(m.kernels, m.biases))}
    if m.layer_norm:
        out.update({f"LayerNorm_{i}": {"scale": s, "bias": b} for i, (s, b) in enumerate(zip(m.ln_scales, m.ln_biases))})
    return out


# nn.vmap names the wrapped critic module (``flax_name``), whose MLP holds the layers
def critic_ensemble_to_flax(m: "sac.CriticEnsemble") -> Tree:
    layers = {name: {k: _np(p) for k, p in leaves.items()} for name, leaves in _ensemble_leaves(m.mlp).items()}
    return {m.flax_name: {"MLP_0": layers}}


def critic_ensemble_from_flax(m: "sac.CriticEnsemble", tree: Tree, what: str = "critic") -> None:
    leaves = _ensemble_leaves(m.mlp)
    layers = tree[m.flax_name].get("MLP_0", {}) if sorted(tree) == [m.flax_name] else {}
    if sorted(layers) != sorted(leaves):
        raise ValueError(f"{what}: checkpoint children {sorted(tree)} do not match the ensemble's "
                         f"{m.flax_name}/MLP_0/{sorted(leaves)}")
    for name, params in leaves.items():
        for key, param in params.items():
            _copy(param, layers[name][key], f"{what}/{m.flax_name}/MLP_0/{name}.{key}")


# Plan2Explore's ensemble: nn.vmap names the wrapped MLPHead ``VmapMLPHead_0``
def ensemble_heads_to_flax(m: "p2e.EnsembleHeads") -> Tree:
    stack = {f"Dense_{i}": {"kernel": _np(k)} for i, k in enumerate(m.kernels)}
    for i, (scale, bias) in enumerate(zip(m.ln_scales, m.ln_biases)):
        stack[f"LayerNorm_{i}"] = {"scale": _np(scale), "bias": _np(bias)}
    head = {"kernel": _np(m.head_kernel), "bias": _np(m.head_bias)}
    return {"VmapMLPHead_0": {"DenseStack_0": stack, "Dense_0": head}}


def ensemble_heads_from_flax(m: "p2e.EnsembleHeads", tree: Tree, what: str = "ensembles") -> None:
    mine = ensemble_heads_to_flax(m)["VmapMLPHead_0"]
    node = tree.get("VmapMLPHead_0") if sorted(tree) == ["VmapMLPHead_0"] else None
    if node is None or sorted(node) != sorted(mine) or sorted(node["DenseStack_0"]) != sorted(mine["DenseStack_0"]):
        raise ValueError(f"{what}: checkpoint children {sorted(tree)} do not match the ensemble's VmapMLPHead_0 "
                         f"with {sorted(mine['DenseStack_0'])} and a Dense_0 head")
    stack = node["DenseStack_0"]
    for i, kernel in enumerate(m.kernels):
        _copy(kernel, stack[f"Dense_{i}"]["kernel"], f"{what}/DenseStack_0/Dense_{i}.kernel")
    for i, (scale, bias) in enumerate(zip(m.ln_scales, m.ln_biases)):
        _copy(scale, stack[f"LayerNorm_{i}"]["scale"], f"{what}/DenseStack_0/LayerNorm_{i}.scale")
        _copy(bias, stack[f"LayerNorm_{i}"]["bias"], f"{what}/DenseStack_0/LayerNorm_{i}.bias")
    _copy(m.head_kernel, node["Dense_0"]["kernel"], f"{what}/Dense_0.kernel")
    _copy(m.head_bias, node["Dense_0"]["bias"], f"{what}/Dense_0.bias")


_LSTM_GATES = ("i", "f", "g", "o")


def lstm_to_flax(m: "rppo.LSTMCell") -> Tree:
    H = m.hidden_size
    w_i, w_h, b = _np(m.input_kernel), _np(m.hidden_kernel), _np(m.hidden_bias)
    out = {}
    for j, gate in enumerate(_LSTM_GATES):
        cols = slice(j * H, (j + 1) * H)
        out[f"i{gate}"] = {"kernel": w_i[:, cols].copy()}
        out[f"h{gate}"] = {"kernel": w_h[:, cols].copy(), "bias": b[cols].copy()}
    return out


def lstm_from_flax(m: "rppo.LSTMCell", tree: Tree, what: str = "OptimizedLSTMCell") -> None:
    names = sorted(f"{side}{gate}" for side in "ih" for gate in _LSTM_GATES)
    if sorted(tree) != names:
        raise ValueError(f"{what}: checkpoint children {sorted(tree)} do not match the cell's {names}")
    cat = lambda side, leaf: np.concatenate([np.asarray(tree[f"{side}{g}"][leaf]) for g in _LSTM_GATES], axis=-1)
    _copy(m.input_kernel, cat("i", "kernel"), what + ".input_kernel")
    _copy(m.hidden_kernel, cat("h", "kernel"), what + ".hidden_kernel")
    _copy(m.hidden_bias, cat("h", "bias"), what + ".hidden_bias")


_LEAVES = (
    (nn.Linear, linear_to_flax, linear_from_flax),
    (sac.CriticEnsemble, critic_ensemble_to_flax, critic_ensemble_from_flax),
    (p2e.EnsembleHeads, ensemble_heads_to_flax, ensemble_heads_from_flax),
    (nn.Conv2d, conv_to_flax, conv_from_flax),
    (nn.ConvTranspose2d, deconv_to_flax, deconv_from_flax),
    (nn.LayerNorm, layer_norm_to_flax, layer_norm_from_flax),
    (LayerNormGRUCell, gru_to_flax, gru_from_flax),
    (rppo.LSTMCell, lstm_to_flax, lstm_from_flax),
)


# -- composites -----------------------------------------------------------------------
def _dv2_children(m: nn.Module) -> Dict[str, nn.Module]:
    """The Dreamer-V1/V2 blocks' Flax children (None for another module)."""
    if isinstance(m, dv2.DenseStack):
        out = {f"Dense_{i}": lin for i, lin in enumerate(m.linears)}
        out.update({f"LayerNorm_{i}": ln for i, ln in enumerate(m.norms)})
        return out
    if isinstance(m, dv2.MLPHead):
        return {"DenseStack_0": m.stack, "Dense_0": m.head}
    if isinstance(m, dv2.CNNEncoder):
        out = {f"Conv_{i}": conv for i, conv in enumerate(m.convs)}
        out.update({f"LayerNorm_{i}": ln for i, ln in enumerate(m.norms)})
        return out
    if isinstance(m, dv2.MLPEncoder):
        return {"DenseStack_0": m.stack}
    if isinstance(m, dv2.CNNDecoder):
        out = {"Dense_0": m.linear}
        out.update({f"ConvTranspose_{i}": d for i, d in enumerate(m.deconvs)})
        out.update({f"LayerNorm_{i}": ln for i, ln in enumerate(m.norms)})
        return out
    if isinstance(m, (dv2.MLPDecoder, dv2.Actor)):
        out = {"DenseStack_0": m.stack}
        out.update({f"Dense_{i}": head for i, head in enumerate(m.heads)})
        return out
    if isinstance(m, dv2.RecurrentModel):
        return {"DenseStack_0": m.stack, "LayerNormGRUCell_0": m.cell}
    return None


def _children(m: nn.Module) -> Dict[str, nn.Module]:
    """Flax child name -> port module, for every composite module of the agent."""
    out = _dv2_children(m)
    if out is not None:
        return out
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
    if isinstance(m, sac_ae.ConvTrunk):
        return {f"Conv_{i}": conv for i, conv in enumerate(m.convs)}
    if isinstance(m, sac_ae.EncoderFC):
        return {"Dense_0": m.linear, "LayerNorm_0": m.norm}
    if isinstance(m, sac_ae.VectorEncoder):
        return {"MLP_0": m.mlp}
    if isinstance(m, sac_ae.CNNDecoderAE):
        out = {"Dense_0": m.linear}
        out.update({f"ConvTranspose_{i}": d for i, d in enumerate(m.deconvs)})
        return out
    if isinstance(m, sac_ae.MLPDecoderAE):
        out = {"MLP_0": m.mlp}
        out.update({f"Dense_{i}": head for i, head in enumerate(m.heads)})
        return out
    if isinstance(m, rppo.RNNCore):
        mlps = [mlp for mlp in (m.pre_mlp, m.post_mlp) if mlp is not None]
        return {"OptimizedLSTMCell_0": m.cell, **{f"MLP_{i}": mlp for i, mlp in enumerate(mlps)}}
    if isinstance(m, rppo.ActorHeads):
        return {"MLP_0": m.backbone, **{f"Dense_{i}": head for i, head in enumerate(m.heads)}}
    if isinstance(m, sac.SACActor):
        return {"MLP_0": m.model, "Dense_0": m.fc_mean, "Dense_1": m.fc_logstd}
    if isinstance(m, odv3.CEM):
        out = {}
        for c, (context, prob) in enumerate(zip(m.contexts, m.probs)):
            out[f"context_{c}"], out[f"prob_{c}"] = context, prob
        out[f"context_{len(m.probs)}"] = m.residual
        return out
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
def agent_to_flax(agent: "dv3.DV3Agent") -> Tree:
    """The agent's parameters as the JAX package's params tree (numpy leaves);
    a fork's extra world-model modules (Offline Dreamer's ``cem``) ride in
    ``world_model`` under their names."""
    wm = {name: module_to_flax(module) for name, module in agent.world_model.items()}
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
    extra = sorted(set(wm) - set(agent.world_model) - {"initial_recurrent_state"})
    if extra:
        raise ValueError(f"world_model: the checkpoint holds {extra}, which the agent has not")
    for name, module in agent.world_model.items():
        module_from_flax(module, wm[name], f"world_model/{name}")
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
            for name, module in scratch.items():
                module_from_flax(module, tree[name], f"world_model/{name}")
            init = torch.tensor(np.asarray(tree["initial_recurrent_state"], dtype=np.float32))
            return [p.detach() for p in scratch.parameters()] + [init]
        scratch = copy.deepcopy(getattr(agent, group))
        module_from_flax(scratch, tree, group)
        return [p.detach() for p in scratch.parameters()]

    return convert


# -- the Dreamer-V1 and V2 agents ------------------------------------------------------------
def dv2_to_flax(agent: "dv2.DV2Agent") -> Tree:
    """A Dreamer-V2 (or V1) agent's parameters as the JAX package's params
    tree: ``world_model`` (``continue_model`` with ``use_continues``),
    ``actor``, ``critic`` and, for Dreamer-V2, ``target_critic``."""
    out = {
        "world_model": {name: module_to_flax(module) for name, module in agent.world_model.items()},
        "actor": module_to_flax(agent.actor),
        "critic": module_to_flax(agent.critic),
    }
    if agent.target_critic is not None:
        out["target_critic"] = module_to_flax(agent.target_critic)
    return out


def load_dv2_params(agent: "dv2.DV2Agent", params: Tree) -> None:
    """Copy a JAX-package Dreamer-V2 (or V1) params tree into ``agent``."""
    expected = ["world_model", "actor", "critic"] + (["target_critic"] if agent.target_critic is not None else [])
    if sorted(params) != sorted(expected):
        raise ValueError(f"Dreamer params: checkpoint children {sorted(params)} do not match the agent's {sorted(expected)}")
    wm = params["world_model"]
    if sorted(wm) != sorted(agent.world_model):
        raise ValueError(f"world_model: checkpoint children {sorted(wm)} do not match the agent's "
                         f"{sorted(agent.world_model)}")
    for name, module in agent.world_model.items():
        module_from_flax(module, wm[name], f"world_model/{name}")
    for name in expected[1:]:
        module_from_flax(getattr(agent, name), params[name], name)


def dv2_group_to_torch(agent: "dv2.DV2Agent", group: str) -> Callable[[Tree], List[torch.Tensor]]:
    """A tree shaped like the JAX params of one Dreamer-V1/V2 optimizer group
    (``world_model``, ``actor`` or ``critic``) -> the group's tensors, in the
    order of its module's parameters."""
    module = agent.world_model if group == "world_model" else getattr(agent, group)

    def convert(tree: Tree) -> List[torch.Tensor]:
        scratch = copy.deepcopy(module)
        if group == "world_model":
            for name, child in scratch.items():
                module_from_flax(child, tree[name], f"world_model/{name}")
        else:
            module_from_flax(scratch, tree, group)
        return [p.detach() for p in scratch.parameters()]

    return convert


# -- the Plan2Explore agent ---------------------------------------------------------------
_P2E_KEYS = ("world_model", "actor_task", "critic_task", "target_critic_task", "actor_exploration",
             "critics_exploration", "ensembles")


def p2e_to_flax(agent: "dv3.DV3Agent") -> Tree:
    """A Plan2Explore agent's parameters as the JAX package's P2E params tree."""
    dv3_tree = agent_to_flax(agent)
    return {
        "world_model": dv3_tree["world_model"],
        "actor_task": dv3_tree["actor"],
        "critic_task": dv3_tree["critic"],
        "target_critic_task": dv3_tree["target_critic"],
        "actor_exploration": module_to_flax(agent.actor_exploration),
        "critics_exploration": {
            name: {"module": module_to_flax(pair["module"]), "target": module_to_flax(pair["target"])}
            for name, pair in agent.critics_exploration.items()
        },
        "ensembles": module_to_flax(agent.ensembles),
    }


def load_p2e_params(agent: "dv3.DV3Agent", params: Tree) -> None:
    """Copy a JAX-package (or port) P2E params tree into a Plan2Explore agent:
    the ensembles' stacked leaves as they are, one module and one target per
    exploration critic, which must be the config's critics."""
    if sorted(params) != sorted(_P2E_KEYS):
        raise ValueError(f"P2E params: checkpoint children {sorted(params)} do not match {sorted(_P2E_KEYS)}")
    if sorted(params["critics_exploration"]) != sorted(agent.critics_exploration):
        raise ValueError(f"P2E params: the checkpoint's exploration critics {sorted(params['critics_exploration'])} "
                         f"are not the config's {sorted(agent.critics_exploration)}")
    load_flax_params(agent, {"world_model": params["world_model"], "actor": params["actor_task"],
                             "critic": params["critic_task"], "target_critic": params["target_critic_task"]})
    module_from_flax(agent.actor_exploration, params["actor_exploration"], "actor_exploration")
    for name, pair in agent.critics_exploration.items():
        for role in ("module", "target"):
            module_from_flax(pair[role], params["critics_exploration"][name][role], f"critics_exploration/{name}/{role}")
    module_from_flax(agent.ensembles, params["ensembles"], "ensembles")


def p2e_group_modules(agent: "dv3.DV3Agent") -> Dict[str, nn.Module]:
    """The modules of each Plan2Explore optimizer group but the world model's:
    the task heads, the exploration actor, the ensembles and one group per
    exploration critic (``critic_exploration_<name>``)."""
    groups = {"actor_task": agent.actor, "critic_task": agent.critic, "actor_exploration": agent.actor_exploration,
              "ensembles": agent.ensembles}
    groups.update({f"critic_exploration_{name}": pair["module"] for name, pair in agent.critics_exploration.items()})
    return groups


def p2e_group_to_torch(agent: "dv3.DV3Agent", group: str) -> Callable[[Tree], List[torch.Tensor]]:
    """A tree shaped like the JAX params of one P2E optimizer group -> tensors
    in the order of that group's parameters."""
    if group == "world_model":
        return dv3_group_to_torch(agent, group)
    module = p2e_group_modules(agent)[group]

    def convert(tree: Tree) -> List[torch.Tensor]:
        scratch = copy.deepcopy(module)
        module_from_flax(scratch, tree, group)
        return [p.detach() for p in scratch.parameters()]

    return convert


# -- the Plan2Explore agents on Dreamer-V1 and V2 ------------------------------------------
# the P2E-DV1/DV2 params tree's keys and the agent's attributes that hold them
_P2E_DV_MODULES = (("actor_task", "actor"), ("critic_task", "critic"), ("target_critic_task", "target_critic"),
                   ("actor_exploration", "actor_exploration"), ("critic_exploration", "critic_exploration"),
                   ("target_critic_exploration", "target_critic_exploration"), ("ensembles", "ensembles"))


def p2e_dv_modules(agent: "dv2.DV2Agent") -> Dict[str, nn.Module]:
    """A P2E-DV1/DV2 agent's modules by their params tree key, but the world
    model's (P2E-DV1 has no target critics)."""
    return {key: getattr(agent, attr) for key, attr in _P2E_DV_MODULES if getattr(agent, attr, None) is not None}


def p2e_dv_to_flax(agent: "dv2.DV2Agent") -> Tree:
    """A P2E-DV1/DV2 agent's parameters as the JAX package's params tree."""
    out = {"world_model": {name: module_to_flax(module) for name, module in agent.world_model.items()}}
    out.update({key: module_to_flax(module) for key, module in p2e_dv_modules(agent).items()})
    return out


def load_p2e_dv_params(agent: "dv2.DV2Agent", params: Tree) -> None:
    """Copy a P2E-DV1/DV2 params tree (either package's) into ``agent``."""
    modules = p2e_dv_modules(agent)
    expected = sorted(["world_model", *modules])
    if sorted(params) != expected:
        raise ValueError(f"P2E params: checkpoint children {sorted(params)} do not match the agent's {expected}")
    load_dv2_params(agent, {"world_model": params["world_model"], "actor": params["actor_task"],
                            "critic": params["critic_task"],
                            **({"target_critic": params["target_critic_task"]} if agent.target_critic is not None
                               else {})})
    for key, module in modules.items():
        if key not in ("actor_task", "critic_task", "target_critic_task"):
            module_from_flax(module, params[key], key)


def p2e_dv_group_to_torch(agent: "dv2.DV2Agent", group: str) -> Callable[[Tree], List[torch.Tensor]]:
    """A tree shaped like the JAX params of one P2E-DV1/DV2 optimizer group ->
    the group's tensors, in the order of its module's parameters."""
    if group == "world_model":
        return dv2_group_to_torch(agent, group)
    module = p2e_dv_modules(agent)[group]

    def convert(tree: Tree) -> List[torch.Tensor]:
        scratch = copy.deepcopy(module)
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


# -- the recurrent PPO agent -------------------------------------------------------------
def _ppo_recurrent_parts(agent: "rppo.RecurrentPPOAgent") -> Dict[str, nn.Module]:
    return {"rnn": agent.rnn, "actor": agent.actor, "critic": agent.critic}


def ppo_recurrent_to_flax(agent: "rppo.RecurrentPPOAgent") -> Tree:
    """The agent's parameters as the JAX package's recurrent PPO params tree."""
    out = {"feature_extractor": {k: module_to_flax(v) for k, v in _ppo_encoders(agent).items()}}
    out.update({k: module_to_flax(v) for k, v in _ppo_recurrent_parts(agent).items()})
    return out


def load_ppo_recurrent_params(agent: "rppo.RecurrentPPOAgent", params: Tree) -> None:
    """Copy a JAX-package recurrent PPO params tree into ``agent``."""
    encoders, parts = _ppo_encoders(agent), _ppo_recurrent_parts(agent)
    expected, found = sorted(["feature_extractor", *parts]), sorted(params)
    if expected != found or sorted(params["feature_extractor"]) != sorted(encoders):
        raise ValueError(f"recurrent PPO params: checkpoint children {found} do not match the agent's {expected}")
    for name, module in encoders.items():
        module_from_flax(module, params["feature_extractor"][name], f"feature_extractor/{name}")
    for name, module in parts.items():
        module_from_flax(module, params[name], name)


def ppo_recurrent_to_torch(agent: "rppo.RecurrentPPOAgent") -> Callable[[Tree], List[torch.Tensor]]:
    """A tree shaped like the JAX recurrent PPO params -> tensors in
    ``agent.parameters()`` order."""

    def convert(tree: Tree) -> List[torch.Tensor]:
        scratch = copy.deepcopy(agent)
        load_ppo_recurrent_params(scratch, tree)
        return [p.detach() for p in scratch.parameters()]

    return convert


# -- the SAC agent (DroQ's too) -----------------------------------------------------------
_SAC_MODULES = ("actor", "critic", "target_critic")


def sac_to_flax(agent: "sac.SACAgent") -> Tree:
    """The agent's parameters as the JAX package's SAC (or DroQ) params tree:
    ``actor``, ``critic``, ``target_critic`` and ``log_alpha`` [1]."""
    out = {name: module_to_flax(getattr(agent, name)) for name in _SAC_MODULES}
    out["log_alpha"] = _np(agent.log_alpha)
    return out


def load_sac_params(agent: "sac.SACAgent", params: Tree) -> None:
    """Copy a JAX-package SAC or DroQ params tree into ``agent``."""
    expected, found = sorted([*_SAC_MODULES, "log_alpha"]), sorted(params)
    if expected != found:
        raise ValueError(f"SAC params: checkpoint children {found} do not match the agent's {expected}")
    for name in _SAC_MODULES:
        module_from_flax(getattr(agent, name), params[name], name)
    _copy(agent.log_alpha, params["log_alpha"], "log_alpha")


def sac_group_to_torch(agent: "sac.SACAgent", group: str) -> Callable[[Tree], List[torch.Tensor]]:
    """A tree shaped like the JAX params of one optimizer group (``actor``,
    ``critic``, or ``alpha``: the ``log_alpha`` array) -> tensors in the order
    of that group's parameters."""

    def convert(tree: Tree) -> List[torch.Tensor]:
        if group == "alpha":
            return [torch.tensor(np.asarray(tree, dtype=np.float32))]
        scratch = copy.deepcopy(getattr(agent, group))
        module_from_flax(scratch, tree, group)
        return [p.detach() for p in scratch.parameters()]

    return convert


# -- the SAC-AE agent ---------------------------------------------------------------------
# each optimizer group's modules by their params tree key, in the group's order
# (the decoder's group is ``agent.decoder``, the temperature's ``log_alpha``)
SAC_AE_GROUPS = {"critic": ("conv", "mlp_enc", "critic_cnn_fc", "qfs"), "actor": ("actor", "actor_cnn_fc"),
                 "encoder": ("conv", "mlp_enc", "critic_cnn_fc")}


def sac_ae_group_modules(agent: "sac_ae.SACAEAgent", group: str) -> Dict[str, nn.Module]:
    """The modules of one SAC-AE optimizer group (but ``alpha``'s) by their
    params tree key, in the group's order."""
    if group == "decoder":
        return dict(agent.decoder.items())
    return {k: getattr(agent, k) for k in SAC_AE_GROUPS[group] if getattr(agent, k) is not None}


def _sac_ae_parts(agent: "sac_ae.SACAEAgent") -> Dict[str, nn.Module]:
    names = ("conv", "mlp_enc", "critic_cnn_fc", "actor_cnn_fc", "qfs", "actor")
    return {k: getattr(agent, k) for k in names if getattr(agent, k) is not None}


def sac_ae_to_flax(agent: "sac_ae.SACAEAgent") -> Tree:
    """The agent's parameters as the JAX package's SAC-AE params tree: the
    modules by name, ``log_alpha`` [1], ``decoder`` (``cnn``, ``mlp``) and
    ``target`` (``conv``, ``mlp_enc``, ``critic_cnn_fc``, ``qfs``)."""
    out = {k: module_to_flax(m) for k, m in _sac_ae_parts(agent).items()}
    out["log_alpha"] = _np(agent.log_alpha)
    out["decoder"] = {k: module_to_flax(m) for k, m in agent.decoder.items()}
    out["target"] = {k: module_to_flax(m) for k, m in agent.target.items()}
    return out


def load_sac_ae_params(agent: "sac_ae.SACAEAgent", params: Tree) -> None:
    """Copy a SAC-AE params tree (either package's) into ``agent``."""
    parts = _sac_ae_parts(agent)
    expected = sorted([*parts, "log_alpha", "decoder", "target"])
    found = sorted(params)
    if found != expected or sorted(params["decoder"]) != sorted(agent.decoder) \
            or sorted(params["target"]) != sorted(agent.target):
        raise ValueError(f"SAC-AE params: checkpoint children {found} (decoder {sorted(params.get('decoder', {}))}, "
                         f"target {sorted(params.get('target', {}))}) do not match the agent's {expected} "
                         f"(decoder {sorted(agent.decoder)}, target {sorted(agent.target)})")
    for k, module in parts.items():
        module_from_flax(module, params[k], k)
    _copy(agent.log_alpha, params["log_alpha"], "log_alpha")
    for k, module in agent.decoder.items():
        module_from_flax(module, params["decoder"][k], f"decoder/{k}")
    for k, module in agent.target.items():
        module_from_flax(module, params["target"][k], f"target/{k}")


def sac_ae_group_to_torch(agent: "sac_ae.SACAEAgent", group: str) -> Callable[[Tree], List[torch.Tensor]]:
    """A tree shaped like the JAX params of one SAC-AE optimizer group (a
    dict of its modules' trees, or the ``log_alpha`` array) -> tensors in the
    order of that group's parameters."""

    def convert(tree: Tree) -> List[torch.Tensor]:
        if group == "alpha":
            return [torch.tensor(np.asarray(tree, dtype=np.float32))]
        out = []
        for k, module in sac_ae_group_modules(agent, group).items():
            scratch = copy.deepcopy(module)
            module_from_flax(scratch, tree[k], f"{group}/{k}")
            out += [p.detach() for p in scratch.parameters()]
        return out

    return convert
