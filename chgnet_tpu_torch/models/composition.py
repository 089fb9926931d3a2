"""Composition reference energies: AtomRef.

``AtomRef`` is a frozen per-element linear reference energy added to the
GNN energy. The three pre-fitted weight vectors are published model
parameters of upstream CHGNet (``chgnet/model/composition_model.py:
218-533``), carried as data; copied from ``chgnet_tpu.models.composition``.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np

from chgnet_tpu_torch.core.elements import MAX_NUM_ELEMENTS
from chgnet_tpu_torch.core.structure import Structure
from chgnet_tpu_torch.graph.crystalgraph import CrystalGraph

# fmt: off
MPTRJ_ATOM_REF = np.array([
    -3.4431, -0.1279, -2.8300, -3.4737, -7.4946, -8.2354, -8.1611, -8.3861,
    -5.7498, -0.0236, -1.7406, -1.6788, -4.2833, -6.2002, -6.1315, -5.8405,
    -3.8795, -0.0703, -1.5668, -3.4451, -7.0549, -9.1465, -9.2594, -9.3514,
    -8.9843, -8.0228, -6.4955, -5.6057, -3.4002, -0.9217, -3.2499, -4.9164,
    -4.7810, -5.0191, -3.3316, 0.5130, -1.4043, -3.2175, -7.4994, -9.3816,
    -10.4386, -9.9539, -7.9555, -8.5440, -7.3245, -5.2771, -1.9014, -0.4034,
    -2.6002, -4.0054, -4.1156, -3.9928, -2.7003, 2.2170, -1.9671, -3.7180,
    -6.8133, -7.3502, -6.0712, -6.1699, -5.1471, -6.1925, -11.5829, -15.8841,
    -5.9994, -6.0798, -5.9513, -6.0400, -5.9773, -2.5091, -6.0767, -10.6666,
    -11.8761, -11.8491, -10.7397, -9.6100, -8.4755, -6.2070, -3.0337, 0.4726,
    -1.6425, -3.1295, -3.3328, -0.1221, -0.3448, -0.4364, -0.1661, -0.3680,
    -4.1869, -8.4233, -10.0467, -12.0953, -12.5228, -14.2530,
], dtype=np.float32)

MPF_ATOM_REF = np.array([
    -3.4654e00, -6.2617e-01, -3.4622e00, -4.7758e00, -8.0362e00, -8.4038e00,
    -7.7681e00, -7.3892e00, -4.9472e00, -5.4833e00, -2.4783e00, -2.0202e00,
    -5.1548e00, -7.9121e00, -6.9135e00, -4.6228e00, -3.0155e00, -2.1285e00,
    -2.3174e00, -4.7595e00, -8.1742e00, -1.1421e01, -8.9229e00, -8.4901e00,
    -8.1664e00, -6.5826e00, -5.2614e00, -4.4841e00, -3.2737e00, -1.3498e00,
    -3.6264e00, -4.6727e00, -4.1316e00, -3.6755e00, -2.8030e00, 6.4728e00,
    -2.2469e00, -4.2510e00, -1.0245e01, -1.1666e01, -1.1802e01, -8.6551e00,
    -9.3641e00, -7.5716e00, -5.6990e00, -4.9716e00, -1.8871e00, -6.7951e-01,
    -2.7488e00, -3.7945e00, -3.3883e00, -2.5588e00, -1.9621e00, 9.9793e00,
    -2.5566e00, -4.8803e00, -8.8604e00, -9.0537e00, -7.9431e00, -8.1259e00,
    -6.3212e00, -8.3025e00, -1.2289e01, -1.7310e01, -7.5512e00, -8.1959e00,
    -8.3493e00, -7.2591e00, -8.4170e00, -3.3873e00, -7.6823e00, -1.2630e01,
    -1.3626e01, -9.5299e00, -1.1840e01, -9.7990e00, -7.5561e00, -5.4690e00,
    -2.6508e00, 4.1746e-01, -2.3255e00, -3.4830e00, -3.1808e00, -1.6934e-02,
    -3.6191e-02, -1.0842e-02, 1.3170e-02, -6.5371e-02, -5.4892e00, -1.0335e01,
    -1.1130e01, -1.4312e01, -1.4700e01, -1.5473e01,
], dtype=np.float32)

MP_R2SCAN_ATOM_REF = np.array([
    -3.4690e00, -3.0982e-01, -3.3199e00, -4.7963e00, -8.0507e00, -9.5759e00,
    -9.8677e00, -9.1242e00, -6.7546e00, -1.9120e00, -4.5438e00, -4.0474e00,
    -7.2176e00, -9.6473e00, -9.6514e00, -9.5449e00, -7.9040e00, -4.8555e00,
    -7.0955e00, -8.4121e00, -1.2896e01, -1.4512e01, -1.5121e01, -1.5248e01,
    -1.4923e01, -1.4040e01, -1.2751e01, -1.1945e01, -1.0464e01, -8.9017e00,
    -1.1722e01, -1.4170e01, -1.5067e01, -1.5418e01, -1.4794e01, -1.1486e01,
    -1.5029e01, -1.6974e01, -2.1922e01, -2.4265e01, -2.5605e01, -2.6075e01,
    -2.5442e01, -2.5286e01, -2.4571e01, -2.3376e01, -2.0786e01, -2.0013e01,
    -2.2626e01, -2.4799e01, -2.5832e01, -2.5982e01, -2.5459e01, -2.2229e01,
    -2.6402e01, -2.8426e01, -3.1738e01, -3.2878e01, -3.0945e01, -3.0967e01,
    -2.9942e01, -3.1421e01, -4.0080e01, -4.5251e01, -3.2790e01, -3.3584e01,
    -3.4371e01, -3.5534e01, -3.6623e01, 5.6469e-14, -3.9644e01, -4.6709e01,
    -4.9586e01, -5.1200e01, -5.1762e01, -5.2404e01, -5.2657e01, -5.2166e01,
    -5.0671e01, -4.8918e01, -5.2844e01, -5.6015e01, -5.8066e01, 1.8537e-14,
    -1.0885e-15, -1.0417e-16, -2.1228e-16, 5.6561e-16, -6.9083e01, -7.4960e01,
    -7.8234e01, -8.1985e01, -8.4724e01, -8.7538e01,
], dtype=np.float32)
# fmt: on

_PRESETS = {
    "MPtrj": (MPTRJ_ATOM_REF, True),
    "MPtrj_e": (MPTRJ_ATOM_REF, True),
    "MPF": (MPF_ATOM_REF, False),
    "MP-r2SCAN": (MP_R2SCAN_ATOM_REF, True),
}


def composition_feature(
    atomic_numbers: np.ndarray, *, is_intensive: bool
) -> np.ndarray:
    """One-hot composition vector [94]; normalized per atom when intensive."""
    fea = np.bincount(
        np.asarray(atomic_numbers, dtype=np.int64) - 1, minlength=MAX_NUM_ELEMENTS
    ).astype(np.float32)
    if is_intensive:
        fea = fea / max(len(atomic_numbers), 1)
    return fea


class AtomRef:
    """Frozen per-element reference-energy linear regression
    (upstream ``composition_model.py:87-542``)."""

    def __init__(
        self, *, is_intensive: bool = True, max_num_elements: int = MAX_NUM_ELEMENTS
    ) -> None:
        self.is_intensive = is_intensive
        self.max_num_elements = max_num_elements
        self.weight: np.ndarray | None = None

    @property
    def fitted(self) -> bool:
        return self.weight is not None

    def initialize_from(self, dataset: str) -> None:
        """Load a pre-fitted preset ('MPtrj', 'MPtrj_e', 'MPF', 'MP-r2SCAN')."""
        if dataset not in _PRESETS:
            raise NotImplementedError(f"{dataset=} not supported yet")
        weight, intensive = _PRESETS[dataset]
        self.weight = weight.copy()
        self.is_intensive = intensive

    def initialize_from_numpy(self, file_name: str) -> None:
        self.weight = np.load(file_name).reshape(-1).astype(np.float32)
        self.is_intensive = False

    def fit(
        self,
        structures_or_graphs: Sequence[Structure | CrystalGraph],
        energies: Sequence[float],
    ) -> None:
        """Least-squares fit of per-element energies (pinv, like reference)."""
        feats = np.stack(
            [
                composition_feature(
                    s.atomic_numbers if isinstance(s, Structure) else s.atomic_number,
                    is_intensive=self.is_intensive,
                )
                for s in structures_or_graphs
            ]
        )
        target = np.asarray(energies, dtype=np.float64)
        weight = np.linalg.pinv(feats.T @ feats) @ feats.T @ target
        self.weight = weight.astype(np.float32)

    def __call__(self, graphs: Sequence[CrystalGraph]) -> np.ndarray:
        """Composition energies [batch_size] (host-side convenience)."""
        if not self.fitted:
            raise ValueError("composition model needs to be fitted first!")
        feats = np.stack(
            [
                composition_feature(g.atomic_number, is_intensive=self.is_intensive)
                for g in graphs
            ]
        )
        return feats @ self.weight

    def get_site_energies(
        self, graphs: Sequence[CrystalGraph]
    ) -> list[np.ndarray]:
        """Per-site elemental reference energies for each graph."""
        if not self.fitted:
            raise ValueError("composition model needs to be fitted first!")
        return [self.weight[g.atomic_number - 1] for g in graphs]
