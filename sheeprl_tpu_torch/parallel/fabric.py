"""The port's runtime: one device, a precision policy and seeding (the torch
counterpart of ``sheeprl_tpu/parallel/fabric.py`` for a single device).

``accelerator``:

- ``auto`` and ``gpu`` select CUDA device 0 and raise when no card is present —
  the port never carries on on the CPU by itself;
- ``cpu`` selects the host CPU (the tests pass it).

``precision`` (kept as given in ``self.precision``):

- ``32-true`` (or ``32``, ``32-mixed``): everything in float32;
- ``bf16-mixed`` and ``bf16-true``: the JAX package's bf16 policy. Its
  ``compute_dtype`` is bf16 under both; parameters and optimizer states stay
  float32 under both (``param_dtype``), because the JAX package's
  ``param_dtype`` has no caller: its modules keep float32 parameters and cast
  them to the compute dtype where they are used. So there is no loss scaling,
  and a checkpoint written at bf16 has the float32 layout of one written at
  ``32-true``. The algorithms that run at bf16 check ``compute_dtype``; the
  others refuse the bf16 policies (``cli.unported_precision``).

Under a bf16 policy on a card the fabric also sets
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False``:
the JAX dot of bf16 operands accumulates the products in float32, while
cuBLAS may, by default, reduce a split-K product's partial sums in bf16.

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

``xla_deterministic_ops`` (the root config key; the JAX package adds
``--xla_gpu_deterministic_ops=true`` to ``XLA_FLAGS`` for it) maps onto
PyTorch's deterministic mode, also for the whole process:
``torch.use_deterministic_algorithms``, ``torch.backends.cudnn.deterministic``
and, when on, ``torch.backends.cudnn.benchmark = False`` and
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (cuBLAS reads it when the process makes
its first cuBLAS call, so a run sets it through its Fabric before that). An
op with no deterministic kernel then raises instead of running.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

_F32_PRECISIONS = ("32-true", "32", "32-mixed")
_BF16_PRECISIONS = ("bf16-mixed", "bf16-true")
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


# set when apply_deterministic_ops put CUBLAS_WORKSPACE_CONFIG into the
# environment, so that turning the mode off takes it out again
_workspace_set_here = False


def apply_deterministic_ops(on: bool) -> None:
    """Set PyTorch's deterministic mode from an ``xla_deterministic_ops`` value.
    Off, it removes the ``CUBLAS_WORKSPACE_CONFIG`` it set when on (a value the
    process was started with stays)."""
    global _workspace_set_here
    on = bool(on)
    if on:
        if "CUBLAS_WORKSPACE_CONFIG" not in os.environ:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
            _workspace_set_here = True
        torch.backends.cudnn.benchmark = False
    elif _workspace_set_here:
        os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        _workspace_set_here = False
    torch.use_deterministic_algorithms(on)
    torch.backends.cudnn.deterministic = on


class Fabric:
    def __init__(
        self,
        devices: int = 1,
        num_nodes: int = 1,
        strategy: str = "auto",
        accelerator: str = "auto",
        precision: str = "32-true",
        float32_matmul_precision: str = "high",
        deterministic_ops: bool = False,
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
        if precision not in _F32_PRECISIONS + _BF16_PRECISIONS:
            raise ValueError(
                f"fabric.precision={precision!r}; choose one of "
                f"{', '.join(_F32_PRECISIONS + _BF16_PRECISIONS)}"
            )
        self.precision = precision
        self.float32_matmul_precision = str(float32_matmul_precision)
        apply_matmul_precision(self.float32_matmul_precision)
        self.deterministic_ops = bool(deterministic_ops)
        apply_deterministic_ops(self.deterministic_ops)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
            if self.compute_dtype == torch.bfloat16:
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    @property
    def compute_dtype(self) -> torch.dtype:
        """bf16 under both bf16 policies, else float32."""
        return torch.bfloat16 if self.precision in _BF16_PRECISIONS else torch.float32

    @property
    def param_dtype(self) -> torch.dtype:
        """float32 under every policy (see the module docstring)."""
        return torch.float32

    @property
    def device_name(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return "cpu"

    def seed_everything(self, seed: int) -> None:
        random.seed(seed)
        np.random.seed(seed)
        torch.manual_seed(seed)
