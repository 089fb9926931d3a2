"""Simulation layer: calculator, relaxation, molecular dynamics, EOS.

Port of ``chgnet_tpu.simulation`` for one device: upstream CHGNet wraps ASE
(host loops rebuilding the graph every step); here simulation loops run in
chunks of steps on the model's device, over a padded graph batch whose
neighbour topology is built once with a skin radius and reused until atoms
drift, with the exact cutoffs restored on the device by dynamic masks.
"""

from chgnet_tpu_torch.simulation.calculator import CHGNetCalculator
from chgnet_tpu_torch.simulation.eos import EquationOfState
from chgnet_tpu_torch.simulation.md import MolecularDynamics
from chgnet_tpu_torch.simulation.observers import (
    CrystalFeasObserver,
    TrajectoryObserver,
)
from chgnet_tpu_torch.simulation.relax import FIRE, StructOptimizer

__all__ = [
    "FIRE",
    "CHGNetCalculator",
    "CrystalFeasObserver",
    "EquationOfState",
    "MolecularDynamics",
    "StructOptimizer",
    "TrajectoryObserver",
]
