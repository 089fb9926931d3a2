"""Standalone structure core: lattice, structure, element data, CIF IO
(copied from ``chgnet_tpu.core``, numpy only)."""

from chgnet_tpu_torch.core.lattice import Lattice
from chgnet_tpu_torch.core.structure import Structure

__all__ = ["Lattice", "Structure"]
