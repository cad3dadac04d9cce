"""Shared math (port of the parts of ``sheeprl_tpu/utils/utils.py`` the slice uses)."""

from __future__ import annotations

import torch


def symlog(x: torch.Tensor) -> torch.Tensor:
    """Dreamer-V3 eq. 10: sign(x) * log(1 + |x|)."""
    return torch.sign(x) * torch.log1p(torch.abs(x))

