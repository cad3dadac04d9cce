"""Card-only tests of the PyTorch port (marker ``cuda``; they skip without a card).

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only torch: from the repo root,

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py imports jax). The hand-written kernel is
held against its plain PyTorch version on the card with TF32 off; the sums over
K are split across blocks on the card and taken in another order by cuBLAS, so
they agree to 1e-4 (``chip_smoke.py`` measures ~2e-6). Both orders are fixed,
so two calls of the kernel on the same inputs agree bit for bit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.ops import LN_GRU, ln_gru_step, ln_gru_step_plain

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _case(B, K, H, device, seed=0):
    rng = np.random.default_rng(seed)
    arrs = (
        rng.standard_normal((B, K)),
        rng.standard_normal((B, H)),
        rng.standard_normal((K, 3 * H)) / np.sqrt(K),
        0.1 * rng.standard_normal(3 * H),
        1.0 + 0.1 * rng.standard_normal(3 * H),
        0.1 * rng.standard_normal(3 * H),
    )
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrs]


@pytest.mark.parametrize("B,K,H", [(4, 1024, 512), (64, 1024, 512), (3, 40, 24), (4, 2816, 2048), (4, 5120, 4096)])
def test_kernel_matches_plain(cuda, B, K, H):
    args = _case(B, K, H, cuda)
    before = LN_GRU.launches
    out = ln_gru_step(*args)
    assert LN_GRU.launches == before + 1
    torch.testing.assert_close(out, ln_gru_step_plain(*args), rtol=1e-4, atol=1e-4)
    targs = [a.clone().requires_grad_(True) for a in args]
    g = torch.randn(B, H, device=cuda)
    gk = torch.autograd.grad(ln_gru_step(*targs), targs, g)
    gp = torch.autograd.grad(ln_gru_step_plain(*targs), targs, g)
    for a, b in zip(gk, gp):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_two_calls_are_bitwise_equal(cuda):
    """No float atomics: the split-K and LayerNorm sums run in a fixed order."""
    args = _case(4, 1024, 512, cuda, seed=1)
    assert torch.equal(ln_gru_step(*args), ln_gru_step(*args))
    args = _case(64, 2816, 2048, cuda, seed=2)
    assert torch.equal(ln_gru_step(*args), ln_gru_step(*args))


@pytest.mark.parametrize("B", [300, 1024])
def test_ragged_row_tiles(cuda, B):
    args = _case(B, 1024, 512, cuda, seed=B)
    torch.testing.assert_close(ln_gru_step(*args), ln_gru_step_plain(*args), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,K,H", [(3, 40, 25), (5, 161, 33), (1, 1, 1)])
def test_odd_widths_take_the_scalar_path(cuda, B, K, H):
    """3H not a multiple of 4: W's rows are not 16-byte aligned."""
    args = _case(B, K, H, cuda, seed=K)
    torch.testing.assert_close(ln_gru_step(*args), ln_gru_step_plain(*args), rtol=1e-4, atol=1e-4)


def test_operands_off_16_byte_alignment(cuda):
    """Contiguous views whose storage offset breaks 16-byte alignment: inp
    (always copied 4 bytes at a time) and W (which then takes the scalar path)."""
    B, K, H = 4, 1024, 512
    args = _case(B, K, H, cuda, seed=3)
    ref = ln_gru_step_plain(*args)
    inp = torch.empty(B * K + 1, device=cuda)[1:].view(B, K)
    inp.copy_(args[0])
    w = torch.empty(K * 3 * H + 3, device=cuda)[3:].view(K, 3 * H)
    w.copy_(args[2])
    assert inp.is_contiguous() and inp.data_ptr() % 16 and w.data_ptr() % 16
    torch.testing.assert_close(ln_gru_step(inp, *args[1:]), ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ln_gru_step(inp, args[1], w, *args[3:]), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B", [4, 16])
def test_kernel_replays_from_a_cuda_graph(cuda, B):
    """Many calls back to back in one graph, replayed: blocks of one call exit
    while the next call's clusters start, so a cluster that let a block leave
    before its neighbours finished reading its shared memory would fault or
    read garbage here."""
    args = _case(B, 1024, 512, cuda, seed=4)
    expected = ln_gru_step(*args)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ln_gru_step(*args)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [ln_gru_step(*args) for _ in range(16)]
    for _ in range(5):
        graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(out, expected) for out in outs)
    args[0].mul_(0.5)  # the graph reads its inputs anew on each replay
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(outs[-1], ln_gru_step(*args))


def test_kernel_refuses_what_it_does_not_take(cuda):
    args = _case(4, 64, 32, cuda)
    with pytest.raises(NotImplementedError, match="float32 only"):
        ln_gru_step(*[a.to(torch.bfloat16) for a in args])
    w_t = args[2].t().contiguous().t()  # same values, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        ln_gru_step(args[0], args[1], w_t, *args[3:])
    with pytest.raises(ValueError, match="is on"):
        ln_gru_step(args[0], args[1].cpu(), *args[2:])


def test_serve_verb_runs_on_the_card_by_default(cuda, tmp_path):
    """``python -m sheeprl_tpu_torch serve`` with no accelerator override serves
    on the card, through the kernel."""
    import yaml

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.interop.flax_to_torch import agent_to_flax
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.utils.checkpoint import save_checkpoint
    from sheeprl_tpu_torch.utils.env import make_env

    cfg = compose(
        ["exp=dreamer_v3", "env=dummy", "algo=dreamer_v3_XS", "algo.cnn_keys.encoder=[rgb]",
         "algo.mlp_keys.encoder=[state]", "env.capture_video=False"]
    )
    env = make_env(cfg, 0, 0)()
    agent = build_agent(Fabric(accelerator="cpu"), (2,), False, cfg, env.observation_space, 0)
    run = tmp_path / "run"
    save_checkpoint(str(run / "version_0" / "checkpoint" / "ckpt_0_0.ckpt"), {"agent": agent_to_flax(agent)})
    with open(run / "version_0" / "config.yaml", "w") as f:
        yaml.safe_dump(cfg.as_dict(), f)
    proc = subprocess.run(
        [sys.executable, "-m", "sheeprl_tpu_torch", "serve", f"checkpoint_path={run}",
         "serve.sessions=2", "serve.slots=2", f"serve.log_dir={tmp_path / 'log'}"],
        env={**os.environ, "PYTHONPATH": str(REPO)}, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    summary = json.loads((tmp_path / "log" / "summary.json").read_text())
    assert summary["device"] == torch.cuda.get_device_name(0)
    assert summary["sessions_completed"] == 2


# ---------------------------------------------------------------------------------
# the training slice on the card: the scans, the player and a gradient step at
# DV3 S width, each held against the same function on the CPU (the plain
# LN-GRU math) from the same weights and noise, TF32 off. The recurrent state
# goes through several steps of cuDNN/cuBLAS and the kernel against the CPU's
# kernels, sums in other orders: 1e-3.
# ---------------------------------------------------------------------------------
CARD_ATOL = 1e-3


def _s_agents(cuda, extra=()):
    """The DV3 S agent (random weights from a seed) on the CPU and a copy on the card."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.interop.flax_to_torch import agent_to_flax
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.utils.env import make_env

    cfg = compose(["exp=dreamer_v3", "env=dummy", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]",
                   "env.capture_video=False", *extra])
    space = make_env(cfg, 0, 0)().observation_space
    cpu = build_agent(Fabric(accelerator="cpu", float32_matmul_precision="highest"), (2,), False, cfg, space, 3)
    card = build_agent(Fabric(accelerator="gpu", float32_matmul_precision="highest"), (2,), False, cfg, space, 3,
                       agent_to_flax(cpu))
    return cpu, card, cfg


def _on(tensors, device):
    return [t.to(device) for t in tensors]


@pytest.mark.parametrize("decoupled", [False, True], ids=["rssm", "decoupled-rssm"])
def test_scans_on_the_card_match_the_cpu(cuda, decoupled):
    """The posterior scan from the expanded (stride-0) initial state, with a
    reset inside the sequence, then imagination from its states."""
    cpu, card, _ = _s_agents(cuda, [f"algo.world_model.decoupled_rssm={decoupled}"])
    T, B, horizon = 8, 4, 15
    g = torch.Generator().manual_seed(0)
    embedded = torch.randn(T, B, cpu.encoder.out_dim, generator=g)
    actions = torch.nn.functional.one_hot(torch.randint(0, 2, (T, B), generator=g), 2).float()
    is_first = torch.zeros(T, B, 1)
    is_first[0] = 1.0
    is_first[5, 2] = 1.0
    gumbel = -torch.log(-torch.log(torch.rand(T, B, cpu.stoch_state_size, generator=g)))
    before = LN_GRU.launches
    with torch.no_grad():
        ref = cpu.dynamic_scan(embedded, actions, is_first, gumbel)
        out = card.dynamic_scan(*_on((embedded, actions, is_first, gumbel), cuda))
    assert LN_GRU.launches == before + T
    for o, r in zip(out, ref):
        torch.testing.assert_close(o.cpu(), r, rtol=CARD_ATOL, atol=CARD_ATOL)
    hs, zs = ref[0], ref[1]
    N = T * B
    trans = -torch.log(-torch.log(torch.rand(horizon, N, cpu.stoch_state_size, generator=g)))
    act = -torch.log(-torch.log(torch.rand(horizon + 1, N, 2, generator=g)))
    z0, h0 = zs.reshape(N, -1), hs.reshape(N, -1)
    before = LN_GRU.launches
    with torch.no_grad():
        ref = cpu.imagination_scan(z0, h0, horizon, trans, act)
        out = card.imagination_scan(*_on((z0, h0), cuda), horizon, *_on((trans, act), cuda))
    assert LN_GRU.launches == before + horizon
    for o, r in zip(out, ref):
        torch.testing.assert_close(o.cpu(), r, rtol=CARD_ATOL, atol=CARD_ATOL)


def test_player_resets_on_the_card(cuda):
    """Full reset (the expanded initial state made contiguous), masked resets
    as a ``where``, one kernel launch per batched step."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerDV3

    cpu, card, _ = _s_agents(cuda)
    n = 3
    players = {"cpu": PlayerDV3(cpu, n, ["rgb"], ["state"]), "card": PlayerDV3(card, n, ["rgb"], ["state"])}
    for p in players.values():
        p.init_states()
    assert players["card"].recurrent_state.is_contiguous()
    g = torch.Generator().manual_seed(1)
    for step in range(6):
        if step in (2, 4):
            for p in players.values():
                p.init_states([step % n])
        obs = {"rgb": torch.rand(n, 3, 64, 64, generator=g) - 0.5, "state": torch.randn(n, 10, generator=g)}
        noise = {"repr": -torch.log(-torch.log(torch.rand(n, cpu.stoch_state_size, generator=g))),
                 "act": -torch.log(-torch.log(torch.rand(n, 2, generator=g)))}
        before = LN_GRU.launches
        a_card = players["card"].get_actions({k: v.to(cuda) for k, v in obs.items()},
                                            {k: v.to(cuda) for k, v in noise.items()})
        assert LN_GRU.launches == before + 1
        a_cpu = players["cpu"].get_actions(obs, noise)
        assert torch.equal(a_card.cpu().argmax(-1), a_cpu.argmax(-1))
        torch.testing.assert_close(players["card"].recurrent_state.cpu(), players["cpu"].recurrent_state,
                                   rtol=CARD_ATOL, atol=CARD_ATOL)


@pytest.mark.parametrize("B", [16, 1024])
def test_kernel_at_the_training_batches(cuda, B):
    """The posterior scan's batch (16) and imagination's (1024 rows)."""
    args = _case(B, 1024, 512, cuda, seed=B + 1)
    before = LN_GRU.launches
    torch.testing.assert_close(ln_gru_step(*args), ln_gru_step_plain(*args), rtol=1e-4, atol=1e-4)
    targs = [a.clone().requires_grad_(True) for a in args]
    g = torch.randn(B, 512, device=cuda)
    gk = torch.autograd.grad(ln_gru_step(*targs), targs, g)
    gp = torch.autograd.grad(ln_gru_step_plain(*targs), targs, g)
    assert LN_GRU.launches == before + 2  # the backward recomputes through the plain math
    for a, b in zip(gk, gp):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_train_step_launches_the_kernel_in_both_scans(cuda):
    """T posterior steps and ``horizon`` imagined steps per gradient step."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, build_optimizers

    _, card, cfg = _s_agents(cuda, ["algo=dreamer_v3_XS", "algo.horizon=5"])
    trainer = DV3Trainer(card, cfg, build_optimizers(cfg, card))
    T, B = 6, 2
    g = torch.Generator(cuda).manual_seed(2)
    batch = {
        "rgb": torch.randint(0, 256, (T, B, 3, 64, 64), device=cuda, dtype=torch.uint8, generator=g),
        "state": torch.randn(T, B, 10, device=cuda, generator=g),
        "actions": torch.nn.functional.one_hot(torch.randint(0, 2, (T, B), device=cuda, generator=g), 2).float(),
        "rewards": torch.randn(T, B, 1, device=cuda, generator=g),
        "terminated": torch.zeros(T, B, 1, device=cuda),
        "truncated": torch.zeros(T, B, 1, device=cuda),
        "is_first": torch.zeros(T, B, 1, device=cuda),
    }
    before = LN_GRU.launches
    metrics = trainer.train_step(batch, 0, trainer.draw_noise(T, B, g))
    assert LN_GRU.launches == before + T + 5
    assert all(torch.isfinite(v) for v in metrics.values())


def test_rmsprop_steps_on_the_card_match_the_cpu(cuda):
    """Five steps of the port's optax-semantics RMSprop (A2C's settings,
    centered and with momentum too) on the card and on the CPU from the same
    gradients: within 1e-6 (the card's rsqrt may round another way)."""
    from sheeprl_tpu_torch.optim import RMSprop

    for kw in (dict(), dict(centered=True, momentum=0.9)):
        rng = np.random.default_rng(0)
        init = [rng.standard_normal(s).astype(np.float32) for s in ((64, 4), (64,), (2, 64))]
        params = {d: [torch.nn.Parameter(torch.tensor(p, device=d)) for p in init] for d in ("cpu", cuda)}
        opts = {d: RMSprop(ps, lr=1e-3, alpha=0.99, eps=1e-4, **kw) for d, ps in params.items()}
        for _ in range(5):
            grads = [rng.standard_normal(p.shape).astype(np.float32) for p in init]
            for d, ps in params.items():
                for p, g in zip(ps, grads):
                    p.grad = torch.tensor(g, device=d)
                opts[d].step()
        for a, b in zip(params["cpu"], params[cuda]):
            np.testing.assert_allclose(b.detach().cpu().numpy(), a.detach().numpy(), rtol=0, atol=1e-6)


def test_ppo_train_phase_on_the_card_matches_the_cpu(cuda):
    """One PPO train phase at the exp's widths (CartPole, 4 envs x 128 steps,
    minibatches of 64, 10 epochs) from the same weights, rollout and
    permutations, TF32 off: every parameter within 1e-4 after 80 Adam
    updates of ~lr = 1e-3 each, and the losses within 1e-4 relative."""
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainer, build_optimizer
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.utils.env import make_env

    cfg = compose(["exp=ppo", "env.capture_video=False"])
    space = make_env(cfg, 0, 0)().observation_space
    rng = np.random.default_rng(1)
    T, E = 128, 4
    data = {
        "state": rng.standard_normal((T, E, 4)).astype(np.float32),
        "actions": np.eye(2, dtype=np.float32)[rng.integers(0, 2, (T, E))],
        "logprobs": -rng.uniform(0.1, 1.5, (T, E, 1)).astype(np.float32),
        "values": rng.standard_normal((T, E, 1)).astype(np.float32),
        "rewards": np.ones((T, E, 1), np.float32),
        "dones": (rng.uniform(size=(T, E, 1)) < 0.05).astype(np.float32),
    }
    next_values = rng.standard_normal((E, 1)).astype(np.float32)
    out = {}
    for accel in ("cpu", "gpu"):
        fabric = Fabric(accelerator=accel, float32_matmul_precision="highest")
        agent = build_agent(fabric, (2,), False, cfg, space, 0)
        optimizer, schedule = build_optimizer(cfg, agent, 128)
        trainer = PPOTrainer(agent, optimizer, cfg, schedule)
        perms = trainer.draw_permutations(torch.Generator().manual_seed(2))
        batch = {k: torch.tensor(v, device=fabric.device) for k, v in data.items()}
        losses = trainer.train_phase(batch, torch.tensor(next_values, device=fabric.device), perms, 0.2, 0.0)
        out[accel] = (losses.cpu(), [p.detach().cpu() for p in agent.parameters()])
    np.testing.assert_allclose(out["gpu"][0].numpy(), out["cpu"][0].numpy(), rtol=1e-4, atol=1e-6)
    for a, b in zip(out["gpu"][1], out["cpu"][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-4)
