"""Basis expansions: smooth radial Bessel and Fourier angular bases.

Port of ``chgnet_tpu.models.basis`` (math of upstream CHGNet
``chgnet/model/basis.py``):

* ``radial_bessel``: sqrt(2/c) * sin(f_k * r / c) / r with learnable
  frequencies f_k (init k*pi), times the polynomial envelope
  1 + a u^p + b u^(p+1) + c u^(p+2) (u = r/c) that decays 1 -> 0 on [0, c].
* ``fourier``: [1/sqrt(2), sin(k theta), cos(k theta)] / sqrt(pi) with
  learnable frequencies (init 1..order).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def bessel_frequencies(num_radial: int) -> np.ndarray:
    """Canonical initialization: k * pi, k = 1..num_radial."""
    return (np.pi * np.arange(1, num_radial + 1)).astype(np.float32)


def fourier_frequencies(order: int) -> np.ndarray:
    """Canonical initialization: 1..order."""
    return np.arange(1, order + 1, dtype=np.float32)


def polynomial_cutoff(r: torch.Tensor, cutoff: float, cutoff_coeff: float):
    """Smooth polynomial envelope decaying from 1 at r=0 to 0 at r=cutoff.

    ``cutoff_coeff`` = 0 disables the envelope (returns ones).
    """
    if cutoff_coeff == 0:
        return torch.ones_like(r)
    p = float(cutoff_coeff)
    a = -(p + 1) * (p + 2) / 2
    b = p * (p + 2)
    c = -p * (p + 1) / 2
    u = r / cutoff
    env = 1 + a * u**p + b * u ** (p + 1) + c * u ** (p + 2)
    return torch.where(u < 1, env, torch.zeros_like(u))


def radial_bessel(
    dist: torch.Tensor,
    frequencies: torch.Tensor,
    cutoff: float,
    cutoff_coeff: float | None,
) -> torch.Tensor:
    """Expand distances [n] -> [n, num_radial]. Callers guarantee dist > 0
    (padded bonds are one lattice vector long)."""
    dist = dist[:, None]
    norm_const = (2.0 / cutoff) ** 0.5
    out = norm_const * torch.sin(frequencies[None, :] * dist / cutoff) / dist
    if cutoff_coeff is not None:
        out = out * polynomial_cutoff(dist, cutoff, cutoff_coeff)
    return out


def fourier(angle: torch.Tensor, frequencies: torch.Tensor) -> torch.Tensor:
    """Expand angles [n] -> [n, 1 + 2*order]."""
    const = torch.full(
        (angle.shape[0], 1), 1.0 / math.sqrt(2.0), dtype=angle.dtype,
        device=angle.device,
    )
    phases = angle[:, None] * frequencies[None, :]
    out = torch.cat([const, torch.sin(phases), torch.cos(phases)], dim=1)
    return out / np.sqrt(np.pi)
