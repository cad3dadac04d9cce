"""The port's runtime: one device, a precision policy and seeding (the torch
counterpart of ``sheeprl_tpu/parallel/fabric.py`` for a single device).

``accelerator``:

- ``auto`` and ``gpu`` select CUDA device 0 and raise when no card is present —
  the port never carries on on the CPU by itself;
- ``cpu`` selects the host CPU (the tests pass it).

``precision`` is ``32-true``; the bf16 policies are not yet ported and raise.

``float32_matmul_precision`` (the root config key) maps onto PyTorch's TF32
switches, which the fabric sets for the whole process:

=================  ==================================  ==============================
value              torch.backends.cuda.matmul.allow_tf32  torch.backends.cudnn.allow_tf32
=================  ==================================  ==============================
``highest``        False                               False
``high``           True                                True
``medium``         True                                True
``default``        True                                True
=================  ==================================  ==============================

TF32 keeps about three decimal digits of a float32 product. It reaches the
cuBLAS matmuls and cuDNN convolutions of the encoders and heads; the
LayerNorm-GRU kernel computes in full float32 whatever the setting.
"""

from __future__ import annotations

import random
import numpy as np
import torch

_PRECISIONS = ("32-true", "32", "32-mixed")
_MATMUL_PRECISIONS = ("highest", "high", "medium", "default")


def apply_matmul_precision(value: str) -> None:
    """Set both TF32 switches from a ``float32_matmul_precision`` value."""
    value = str(value).lower()
    if value not in _MATMUL_PRECISIONS:
        raise ValueError(
            f"float32_matmul_precision={value!r}; choose one of {', '.join(_MATMUL_PRECISIONS)}"
        )
    tf32 = value != "highest"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


class Fabric:
    def __init__(
        self,
        devices: int = 1,
        num_nodes: int = 1,
        strategy: str = "auto",
        accelerator: str = "auto",
        precision: str = "32-true",
        float32_matmul_precision: str = "high",
        **_: object,
    ) -> None:
        if int(devices) != 1 or int(num_nodes) != 1:
            raise NotImplementedError(
                f"fabric.devices={devices}, fabric.num_nodes={num_nodes}: the port runs on one "
                "device; multi-device runs are not yet ported"
            )
        accelerator = str(accelerator).lower()
        if accelerator == "cpu":
            self.device = torch.device("cpu")
        elif accelerator in ("auto", "gpu", "cuda"):
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"fabric.accelerator={accelerator} needs a CUDA device and none is available; "
                    "pass fabric.accelerator=cpu to run on the CPU"
                )
            self.device = torch.device("cuda", 0)
        else:
            raise ValueError(f"fabric.accelerator={accelerator!r}; choose auto, gpu or cpu")
        self.accelerator = accelerator
        precision = str(precision)
        if precision not in _PRECISIONS:
            raise NotImplementedError(
                f"fabric.precision={precision}: only 32-true is ported (bf16 is not yet ported)"
            )
        self.precision = "32-true"
        self.dtype = torch.float32
        self.float32_matmul_precision = str(float32_matmul_precision)
        apply_matmul_precision(self.float32_matmul_precision)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    @property
    def device_name(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return "cpu"

    def seed_everything(self, seed: int) -> None:
        random.seed(seed)
        np.random.seed(seed)
        torch.manual_seed(seed)
