"""DroQ of the port against the JAX package's, on the CPU.

The dropout masks are matched by re-deriving Flax's own: ``dropout_masks``
applies a probe module whose scopes carry the names of the JAX DroQ
ensemble's (``VmapDROQCritic_0/MLP_0/Dropout_i`` under the same ``nn.vmap``
with per-member dropout streams) and whose ``Dropout`` layers drop units of
an all-ones input, so each probe layer returns the keep-mask that the
ensemble's layer of the same name draws from the same key. The forward test
shows the masks are the ensemble's: the port fed them computes the JAX
ensemble's stochastic output.

- the port's ``dropout`` against ``flax.linen.Dropout``, its mask read off
  the Flax layer's output;
- the DroQ ensemble (Dropout + LayerNorm), deterministic and with masks,
  member by member;
- one DroQ train phase (G critic updates, each with the EMA, then the actor
  and alpha updates on a separate batch, dropout on throughout) against the
  jitted JAX ``make_train_phase``;
- the converter round trip and the CLI: ``exp=droq`` trains, resumes,
  evaluates and serves.

Tolerances: 1e-6 where both sides compute the same float32 expression; for
a train phase, 1e-5 relative on the mean losses and 1e-5 on every parameter
(the actor's heads scaled as in ``test_torch_helpers.unsaturated``).
"""

from __future__ import annotations

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import (
    SAC_TINY,
    close,
    f32,
    jax_sac,
    losses_close,
    numpy_tree,
    optax_states_close,
    port_sac,
    replay_block,
    trees_close,
    unsaturated,
)

ATOL = 1e-6
PARAM_ATOL = 1e-5


# -- the mask probe: the scope names of sheeprl_tpu.algos.droq.agent.DROQCriticEnsemble --
class MLP(nn.Module):
    rate: float
    sizes: tuple
    rows: int

    @nn.compact
    def __call__(self):
        return [nn.Dropout(self.rate, deterministic=False)(jnp.ones((self.rows, h))) != 0 for h in self.sizes]


class DROQCritic(nn.Module):
    rate: float
    sizes: tuple
    rows: int

    @nn.compact
    def __call__(self):
        return MLP(self.rate, self.sizes, self.rows)()


class DROQCriticEnsemble(nn.Module):
    n: int
    rate: float
    sizes: tuple
    rows: int

    @nn.compact
    def __call__(self):
        ensemble = nn.vmap(
            DROQCritic, in_axes=None, out_axes=0, variable_axes={"params": 0},
            split_rngs={"params": True, "dropout": True}, axis_size=self.n,
        )
        return ensemble(self.rate, self.sizes, self.rows)()


@functools.lru_cache(maxsize=None)
def _probe(n: int, rate: float, sizes: tuple, rows: int):
    probe = DROQCriticEnsemble(n, rate, sizes, rows)
    return jax.jit(lambda key: probe.apply({}, rngs={"dropout": key}))


def dropout_masks(key, critic, rows: int) -> torch.Tensor:
    """The keep-masks [layers, n, rows, hidden] that ``critic`` (the JAX DroQ
    ensemble) draws for a batch of ``rows`` from the dropout key ``key``."""
    masks = _probe(critic.n, float(critic.dropout), (critic.hidden_size,) * 2, rows)(key)
    return torch.from_numpy(np.stack([np.asarray(m) for m in masks]))


# ---------------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------------
def test_dropout_matches_flax_dropout():
    """The port's ``dropout`` fed the keep-mask that ``flax.linen.Dropout``
    drew (read off its output: the input holds no zeros) computes that
    layer's output; without a mask it returns its input, as Flax's
    deterministic layer does."""
    from sheeprl_tpu_torch.models.models import dropout

    rate = 0.3
    x = np.random.default_rng(0).standard_normal((32, 64)).astype(np.float32)
    y = nn.Dropout(rate).apply({}, x, deterministic=False, rngs={"dropout": jax.random.PRNGKey(1)})
    keep = torch.from_numpy(np.asarray(y) != 0)
    assert 0 < keep.float().mean() < 1
    close(dropout(f32(x), keep, rate), y)
    close(dropout(f32(x), None, rate), x, atol=0.0)


def test_droq_ensemble_matches_flax_with_its_masks():
    """Deterministic, and with the masks of a dropout key: the port's
    ensemble computes the Flax ensemble's [B, n] output; member 1's masks
    only move column 1."""
    _, critic, params, _ = jax_sac("droq")
    agent, _ = port_sac("droq")
    rng = np.random.default_rng(1)
    obs, act = rng.standard_normal((8, 3)).astype(np.float32), rng.uniform(-2, 2, (8, 1)).astype(np.float32)
    close(agent.critic(f32(obs), f32(act)), critic.apply({"params": params["critic"]}, obs, act))
    key = jax.random.PRNGKey(4)
    q = critic.apply({"params": params["critic"]}, obs, act, False, rngs={"dropout": key})
    keep = dropout_masks(key, critic, 8)
    assert keep.shape == (2, 2, 8, 16) and 0.9 < keep.float().mean() < 1.0  # rate 0.01
    assert not torch.equal(keep[:, 0], keep[:, 1])  # one stream per member
    close(agent.critic(f32(obs), f32(act), keep), q)
    other = keep.clone()
    other[:, 1] = ~other[:, 1]
    moved = agent.critic(f32(obs), f32(act), other).detach().numpy()
    np.testing.assert_allclose(moved[:, 0], np.asarray(q)[:, 0], rtol=0, atol=ATOL)
    assert np.abs(moved[:, 1] - np.asarray(q)[:, 1]).min() > 0


def test_droq_converter_round_trips():
    from sheeprl_tpu_torch.interop.flax_to_torch import sac_to_flax

    _, _, params, _ = jax_sac("droq")
    agent, _ = port_sac("droq")
    assert "LayerNorm_1" in params["critic"]["VmapDROQCritic_0"]["MLP_0"]
    trees_close(sac_to_flax(agent), params, atol=0.0)
    with pytest.raises(ValueError, match="VmapDROQCritic_0"):
        port_sac("sac", params=params)  # a DroQ tree does not load into SAC's ensemble


# ---------------------------------------------------------------------------------
# the train phase
# ---------------------------------------------------------------------------------
@pytest.mark.parametrize("G", [1, 3])
def test_droq_train_phase_matches_the_jax_one(G):
    """G critic updates and one actor/alpha update from the same parameters,
    blocks, normal draws and dropout masks. The JAX phase splits its key into
    ``k_scan, k_actor``; ``split(k_scan, G)`` gives each critic update's key,
    split in three: the next actions' draw, the target ensemble's dropout key
    and the online ensemble's; ``k_actor`` splits into the actor's draw and
    its Q's dropout key."""
    from sheeprl_tpu.algos.droq.droq import make_train_phase
    from sheeprl_tpu.algos.sac.sac import build_optimizers as jax_optimizers
    from sheeprl_tpu.algos.sac.sac import init_opt_state
    from sheeprl_tpu_torch.algos.droq.droq import DroQTrainer
    from sheeprl_tpu_torch.algos.sac.sac import build_optimizers
    from sheeprl_tpu_torch.interop.flax_to_torch import sac_to_flax

    actor, critic, params, cfg_jax = jax_sac("droq")
    params = unsaturated(params)
    txs = jax_optimizers(cfg_jax)
    train_phase = make_train_phase(cfg_jax, actor, critic, -1.0, txs=txs)
    B = 8
    rng = np.random.default_rng(5)
    critic_data, actor_data = replay_block(rng, (G, B)), replay_block(rng, (B,))
    key = jax.random.PRNGKey(7)
    jparams = jax.tree_util.tree_map(jnp.array, params)
    new_params, opt_state, losses, _ = train_phase(
        jparams, init_opt_state(txs, jparams), {k: jnp.asarray(v) for k, v in critic_data.items()},
        {k: jnp.asarray(v) for k, v in actor_data.items()}, key,
    )
    k_scan, k_actor = jax.random.split(key)
    steps = [jax.random.split(k, 3) for k in jax.random.split(k_scan, G)]
    k_pi, k_q = jax.random.split(k_actor)
    noise = {
        "critic": torch.stack([f32(jax.random.normal(k[0], (B, 1))) for k in steps]),
        "target_keep": torch.stack([dropout_masks(k[1], critic, B) for k in steps]),
        "online_keep": torch.stack([dropout_masks(k[2], critic, B) for k in steps]),
        "actor": f32(jax.random.normal(k_pi, (B, 1))),
        "actor_keep": dropout_masks(k_q, critic, B),
    }
    agent, cfg = port_sac("droq", params=params)
    trainer = DroQTrainer(agent, build_optimizers(cfg, agent), cfg, -1.0)
    drawn = trainer.draw_noise(G, B, torch.Generator().manual_seed(0))
    assert {k: (v.shape, v.dtype) for k, v in drawn.items()} == {k: (v.shape, v.dtype) for k, v in noise.items()}
    ours = trainer.train_phase({k: f32(v) for k, v in critic_data.items()}, {k: f32(v) for k, v in actor_data.items()},
                               noise)
    losses_close(ours, losses)
    trees_close(sac_to_flax(agent), new_params, atol=PARAM_ATOL)
    optax_states_close(trainer, opt_state, atol=ATOL)


# ---------------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------------
def test_droq_cli_trains_resumes_evaluates_and_serves(tmp_path, capsys):
    import json

    from sheeprl_tpu_torch.__main__ import main
    from sheeprl_tpu_torch.cli import run

    tiny = [o.replace("exp=sac", "exp=droq") for o in SAC_TINY] + ["algo.replay_ratio=2"]
    first = run(tiny + ["algo.total_steps=64"])
    ckpt = tmp_path / first["checkpoint"]
    # ratio 2: Ratio's first call takes 2 x 11 critic updates, then 4 a phase
    assert first["gradient_steps"] == 22 + 4 * 24 and first["train_phases"] == 25 and ckpt.is_file()
    assert all(np.isfinite(v) for v in first["metrics"].values()) and first["test_reward"] is not None
    resumed = run(tiny + ["algo.total_steps=96", f"checkpoint.resume_from={ckpt}"])
    assert resumed["log_dir"].endswith("version_1") and resumed["gradient_steps"] > 0
    capsys.readouterr()
    assert main(["evaluation", f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "env.capture_video=False"]) == 0
    assert "Test - Reward:" in capsys.readouterr().out
    log_dir = tmp_path / "serve"
    assert main(["serve", f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "serve.sessions=2", "serve.slots=2",
                 "serve.greedy=False", f"serve.log_dir={log_dir}"]) == 0
    assert json.loads((log_dir / "summary.json").read_text())["sessions_completed"] == 2
