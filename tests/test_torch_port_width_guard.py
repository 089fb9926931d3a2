"""The port's CUDA kernels take widths up to twice the published ones
(``WIDE128``: every feature and hidden width 128); wider configs are
refused on a CUDA device before anything is launched, and run on the CPU,
whose plain versions take any width.

``CHGNetConfig.kernel_width_faults`` works the kernels' limits out from the
config alone (no card needed): the fused tails and the one-kernel pass D <=
128 (2D <= 256), ``gather_project_sum`` tables dt <= 128 and projected
widths K <= 256, segment sums rows of at most 256 floats (64 when not a
multiple of 4). ``check_supported("cuda")`` raises ``NotImplementedError``
naming them; ``check_supported("cpu")`` does not. The card side, a CUDA
model and a CUDA batch, is in ``tests/test_torch_port_cuda.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

from chgnet_tpu_torch import ROOT
from chgnet_tpu_torch.core.structure import Structure
from chgnet_tpu_torch.models.chgnet import CHGNet, CHGNetConfig

# one case per limited field: its over-wide config and the limit the error
# must name (the hidden dims feed gather_project_sum's projected width K)
WIDE = {
    "atom_fea_dim": (dict(atom_fea_dim=160, atom_conv_hidden_dim=160), "dt <= 128"),
    "bond_fea_dim": (dict(bond_fea_dim=160, bond_conv_hidden_dim=160), "D <= 128"),
    "angle_fea_dim": (dict(angle_fea_dim=160), "D <= 128"),
    "atom_conv_hidden_dim": (dict(atom_conv_hidden_dim=160), "K = 2 x first hidden <= 256"),
    "bond_conv_hidden_dim": (dict(bond_conv_hidden_dim=160), "K = 2 x first hidden <= 256"),
    "angle_layer_hidden_dim": (dict(angle_layer_hidden_dim=160),
                               "K = 2 x first hidden <= 256"),
}
# the published 0.3.0 architecture with every feature width doubled
WIDE128 = dict(atom_fea_dim=128, bond_fea_dim=128, angle_fea_dim=128,
               atom_conv_hidden_dim=128, bond_conv_hidden_dim=128)
TOL = {"e": 2e-5, "f": 5e-5, "s": 2e-4, "m": 2e-5}


@pytest.mark.parametrize("field", list(WIDE))
def test_width_over_the_kernels_is_refused_on_cuda_only(field):
    kwargs, limit = WIDE[field]
    cfg = CHGNetConfig(**kwargs)
    cfg.check_supported("cpu")
    with pytest.raises(NotImplementedError, match=field) as err:
        cfg.check_supported("cuda")
    assert limit in str(err.value)
    assert any(line.startswith(field) or f" {field}=" in line
               for line in cfg.kernel_width_faults())


@pytest.mark.parametrize("kwargs", [{}, dict(directed_bonds=False),
                                    dict(fused_kernels=False)],
                         ids=["default", "undirected", "unfused"])
def test_published_width_passes_on_both_devices(kwargs):
    cfg = CHGNetConfig(**kwargs)
    assert cfg.atom_fea_dim == cfg.bond_fea_dim == cfg.angle_fea_dim == 64
    assert cfg.kernel_width_faults() == []
    cfg.check_supported("cpu")
    cfg.check_supported("cuda")


@pytest.mark.parametrize("kwargs", [{}, dict(directed_bonds=False),
                                    dict(fused_kernels=False)],
                         ids=["default", "undirected", "unfused"])
def test_wide128_passes_on_both_devices(kwargs):
    cfg = CHGNetConfig(**WIDE128, **kwargs)
    assert cfg.kernel_width_faults() == []
    cfg.check_supported("cpu")
    cfg.check_supported("cuda")


def test_wide_model_runs_on_the_cpu():
    """A 160-wide model (hidden widths 160, so the tails' second layers are
    square) serves E+F+S+M on the CPU, the fused tails' plain versions
    agreeing with the plain gated MLP, while its config is refused for
    CUDA."""
    wide = dict(atom_fea_dim=160, bond_fea_dim=160, angle_fea_dim=160,
                atom_conv_hidden_dim=160, bond_conv_hidden_dim=160, n_conv=3,
                graph_converter_algorithm="numpy")
    struct = Structure.from_file(f"{ROOT}/examples/mp-18767-LiMnO2.cif")
    fused = CHGNet(device="cpu", **wide)
    with pytest.raises(NotImplementedError, match="D <= 128"):
        fused.config.check_supported("cuda")
    got = fused.predict_structure(struct, task="efsm")
    want = CHGNet(device="cpu", fused_kernels=False, **wide).predict_structure(
        struct, task="efsm")
    for key, tol in TOL.items():
        assert np.isfinite(np.asarray(got[key])).all()
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]),
                                   atol=tol, err_msg=key)
