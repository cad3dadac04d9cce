"""Hand-written kernels of the port, each beside its plain PyTorch version.

``KERNELS`` lists every kernel the port builds; ``chip_smoke.py`` builds,
checks and times each of them and reads their launch counts."""

from sheeprl_tpu_torch.ops.gru import LN_GRU, ln_gru_step, ln_gru_step_plain

KERNELS = (LN_GRU,)

__all__ = ["KERNELS", "LN_GRU", "ln_gru_step", "ln_gru_step_plain"]
