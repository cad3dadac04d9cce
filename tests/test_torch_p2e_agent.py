"""The port's Plan2Explore (Dreamer-V3) blocks and configs against the JAX package's, on the CPU.

- ``EnsembleHeads`` (stacked members, one batched product a layer) against
  the Flax ``nn.vmap`` of ``MLPHead``, and the intrinsic reward (the members'
  variance, averaged over the features) against the JAX formula, float32;
- the converter both ways (``p2e_to_flax``, ``load_p2e_params``) and the
  optax states of the seven optimizer groups carried into the port's;
- the composed ``exp=p2e_dv3_exploration`` (the XL widths) and
  ``exp=offline_dreamer`` configs against the JAX package's;
- the ensemble at bf16, held three ways (``tests/test_torch_bf16_agent.py``):
  the port's bf16 output closer to JAX's bf16 output than that is to JAX's
  float32 output.

Forward values: 1e-5 (the sums of products and LayerNorms run in another
order on each side).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dv3_train import TRAIN
from test_torch_helpers import jax_p2e, numpy_tree, port_p2e

ATOL = 1e-5
EXTRA = tuple(TRAIN)


def _inputs(agent, rows=(5, 3), seed=0):
    width = agent.latent_state_size + int(np.sum(agent.actions_dim))
    return np.random.default_rng(seed).standard_normal((*rows, width)).astype(np.float32)


def test_ensemble_heads_and_intrinsic_reward_match_flax():
    jagent, ensembles, params, cfg_jax, _ = jax_p2e(EXTRA)
    tagent, _ = port_p2e(EXTRA)
    x = _inputs(jagent)
    ref = jax.jit(lambda p, v: ensembles.apply({"params": p}, v))(params["ensembles"], x)
    out = tagent.ensembles(torch.from_numpy(x))
    assert tuple(out.shape) == ref.shape == (3, 5, 3, jagent.stoch_state_size)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)

    from sheeprl_tpu_torch.algos.p2e_dv3.agent import intrinsic_reward

    mult = 2.5
    ref_reward = jnp.asarray(ref).var(axis=0).mean(axis=-1, keepdims=True) * mult
    np.testing.assert_allclose(intrinsic_reward(out, mult).detach().numpy(), np.asarray(ref_reward), atol=ATOL,
                               rtol=ATOL)


def test_converter_both_ways_and_optax_states(tmp_path):
    """The JAX params load into the port and come back bit for bit; the
    optax states of every group (after one update, so that the moments are
    not zero) load into the port's optimizers through a checkpoint; a tree
    with another set of exploration critics is refused."""
    from sheeprl_tpu.algos.p2e_dv3.p2e_dv3_exploration import build_txs
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
    from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import make_trainer
    from sheeprl_tpu_torch.interop.flax_to_torch import load_p2e_params, p2e_group_to_torch, p2e_to_flax
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    _, _, params, cfg_jax, _ = jax_p2e(EXTRA)
    tagent, cfg = port_p2e(EXTRA)
    mine = p2e_to_flax(tagent)
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)

    rng = np.random.default_rng(1)
    opt_state = {}
    for name, tx in build_txs(cfg_jax).items():
        group = params["critics_exploration"][name.split("_", 2)[2]]["module"] if name.startswith("critic_exp") \
            else params[name]
        grads = jax.tree_util.tree_map(lambda x: rng.standard_normal(x.shape).astype(np.float32), group)
        opt_state[name] = jax.jit(tx.update)(grads, tx.init(group), group)[1]
    jax_save_checkpoint(str(tmp_path / "p2e.ckpt"), {"opt_state": opt_state})
    trainer = make_trainer(tagent, cfg)
    trainer.load_opt_state(load_checkpoint(str(tmp_path / "p2e.ckpt"))["opt_state"])
    for name, opt in trainer.optimizers.items():
        adam = next(n for n in jax.tree_util.tree_leaves(opt_state[name], is_leaf=lambda n: hasattr(n, "mu"))
                    if hasattr(n, "mu"))
        params_of = [p for g in opt.param_groups for p in g["params"]]
        for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            for p, ref in zip(params_of, p2e_group_to_torch(tagent, name)(numpy_tree(tree))):
                np.testing.assert_array_equal(opt.state[p][key].numpy(), ref.numpy(), err_msg=name)
        assert all(float(opt.state[p]["step"]) == 1.0 for p in params_of)

    other = dict(params, critics_exploration={"intrinsic": params["critics_exploration"]["intrinsic"]})
    with pytest.raises(ValueError, match="exploration critics"):
        load_p2e_params(tagent, other)


@pytest.mark.parametrize("exp", ["p2e_dv3_exploration", "offline_dreamer"])
def test_composed_configs_equal_the_jax_packages(exp):
    """``exp=p2e_dv3_exploration`` alone composes Dreamer-V3 XL in both
    packages; ``exp=offline_dreamer`` the S preset on MuJoCo's Walker2d (an
    env the port refuses to make by name)."""
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu_torch.config import compose
    from test_torch_config import _strip

    pinned = [f"exp={exp}", "run_name=composer_test"]
    ours = compose(pinned).as_dict()
    assert _strip(ours) == _strip(jax_compose(pinned).as_dict())
    widths = (1024, 5, 4096) if exp.startswith("p2e") else (512, 2, 512)
    algo = ours["algo"]
    assert (algo["dense_units"], algo["mlp_layers"], algo["world_model"]["recurrent_model"]["recurrent_state_size"]) \
        == widths
    assert ours["metric"]["aggregator"]["metrics"]["Loss/world_model_loss"]["_target_"].startswith("sheeprl_tpu_torch.")


def test_ensemble_heads_at_bf16():
    jbf, ens_bf, params, _, _ = jax_p2e(EXTRA, "bf16-true")
    _, ens_f32, _, _, _ = jax_p2e(EXTRA)
    tagent, _ = port_p2e(EXTRA, "bf16-mixed")
    x = _inputs(jbf, seed=2)
    ref = ens_bf.apply({"params": params["ensembles"]}, x)
    assert ref.dtype == jnp.bfloat16
    ref32 = ens_f32.apply({"params": params["ensembles"]}, x)
    out = tagent.ensembles(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16
    d_port = float(np.mean(np.abs(out.detach().float().numpy() - np.asarray(ref, np.float32))))
    d_ref = float(np.mean(np.abs(np.asarray(ref, np.float32) - np.asarray(ref32))))
    assert d_port < d_ref, (d_port, d_ref)
