"""Where the SAC-AE card-vs-CPU step's parameters part, on one CUDA card.

Run from the root of a checkout:  python3 sac_ae_parity_breakdown.py [--repeats N]

``chip_smoke.sac_ae_step_parity`` takes one SAC-AE gradient step at the exp's
widths (batch 2) on the card and on the CPU in float32 from the same weights,
block and draws. This script takes that step with every optimizer's gradients
recorded and prints, per parameter tensor and optimizer step, how far the
card's gradients lie from the CPU's (relative error, sign flips, exact zeros,
how many sit below Adam's eps of 1e-8), and per tensor how many weights end
more than 1e-5 apart; with cuDNN's default algorithms, with deterministic
ones, and with cuDNN off. Then it runs ``sac_ae_step_parity`` itself
``--repeats`` times, which also holds both float32 steps against the CPU's
float64 step, to show how much the card's counts move between runs. Without
CUDA it exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def breakdown(cs, sae, variant: str) -> dict:
    """The recorded step on the card and the CPU under ``variant``'s cuDNN
    setting, and where their gradients and weights part."""
    record = []
    step = sae._step

    def recording_step(optimizer, params, grads):
        grads = list(grads)
        record.append([g.detach().float().cpu().clone() for g in grads])
        return step(optimizer, params, grads)

    sae._step = recording_step
    torch.backends.cudnn.deterministic = variant == "deterministic"
    torch.backends.cudnn.enabled = variant != "cudnn_off"
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        trainers, _ = cs._sac_ae_trainers(("gpu", "cpu"))
        block = cs._sac_ae_block(np.random.default_rng(17), 1, cs.SAC_AE_PARITY_B)
        cpu = trainers["cpu"]
        noise = cpu.draw_noise(1, {k: torch.from_numpy(v) for k, v in block.items()},
                               torch.Generator().manual_seed(18))
        grads = {}
        for accel, trainer in trainers.items():
            record.clear()
            data = {k: torch.from_numpy(v).to(trainer.device) for k, v in block.items()}
            trainer.train_phase(data, 0, cs._noise_to(noise, trainer.device, torch.float32))
            grads[accel] = list(record)
    finally:
        sae._step = step
        torch.set_num_threads(threads)
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.enabled = True
    names = {id(p): n for n, p in cpu.agent.named_parameters()}
    # the optimizer steps in the order a step at cum 0 takes them
    steps = ("critic", "actor", "alpha", "encoder", "decoder")
    rows = []
    for name, card, host in zip(steps, grads["gpu"], grads["cpu"]):
        for p, a, b in zip(cpu.groups[name], card, host):
            rows.append({"step": name, "param": names[id(p)], "numel": b.numel(),
                         "rel_err": float((a - b).norm() / b.norm().clamp_min(1e-30)),
                         "sign_flips": int(((a > 0) != (b > 0)).sum()), "zero_cpu": int((b == 0).sum()),
                         "zero_card": int((a == 0).sum()), "below_eps_cpu": int((b.abs() < 1e-8).sum())})
    card_state = {k: v.detach().cpu() for k, v in trainers["gpu"].agent.state_dict().items()}
    apart = {k: int(((card_state[k] - v).abs() > cs.TRAIN_PARAM_ATOL).sum())
             for k, v in cpu.agent.state_dict().items()}
    total = sum(v.numel() for v in card_state.values())
    out = {"variant": variant, "params_beyond_atol": sum(apart.values()), "parameters": total,
           "apart_by_tensor": dict(sorted(apart.items(), key=lambda kv: -kv[1])[:10]),
           "grads_by_sign_flips": sorted(rows, key=lambda r: -r["sign_flips"])[:14]}
    print(f"[breakdown] {json.dumps(out)}", flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=3, help="runs of sac_ae_step_parity")
    parser.add_argument("--out", default=None, help="also write the results to this JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("[breakdown] torch.cuda.is_available() is false: this script needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import sheeprl_tpu_torch.algos.sac_ae.sac_ae as sae

    print(f"[breakdown] card: {cs.card_line()}; torch {torch.__version__}", flush=True)
    out = {"breakdown": [breakdown(cs, sae, v) for v in ("default", "deterministic", "cudnn_off")], "parity": []}
    for _ in range(args.repeats):
        try:
            out["parity"].append(cs.sac_ae_step_parity())
        except AssertionError as err:
            out["parity"].append({"failed": str(err)})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
