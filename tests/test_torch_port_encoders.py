"""The port's encoder functions (``chgnet_tpu_torch/models/encoders.py``)
against ``chgnet_tpu.models.encoders`` on the inputs of
tests/test_encoders.py, in f32: the embedding rows exactly (a lookup of
draw-identical parameters), the bases and unit vectors within 1e-6
absolute (the same formulas; sin, cos and arccos of two libraries)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from chgnet_tpu.models import basis as jbasis
from chgnet_tpu.models import encoders as jenc
from chgnet_tpu.models.chgnet import CHGNet as JCHGNet
from chgnet_tpu_torch.models import encoders as tenc
from chgnet_tpu_torch.models.chgnet import CHGNetConfig, init_params

ATOL = 1e-6
SMALL = dict(atom_fea_dim=16, num_radial=9, num_angular=9, n_conv=2,
             mlp_hidden_dims=(16,))


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_atom_embedding_matches_chgnet_tpu():
    """Z = 1, 8, 94 and the clipped 0 and 95, from draw-identical tables."""
    z = np.array([1, 8, 94, 0, 95])
    jm = JCHGNet(seed=0, **SMALL)
    tparams = init_params(CHGNetConfig(**SMALL), seed=0)
    want = jenc.atom_embedding_apply(jm.params["atom_embedding"], z)
    got = tenc.atom_embedding_apply(
        {"weight": _t(tparams["atom_embedding"]["weight"])}, torch.tensor(z))
    assert got.shape == (5, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("num_radial", [9, 31])
def test_bond_encoder_matches_chgnet_tpu(num_radial):
    freqs = {k: jbasis.bessel_frequencies(num_radial) for k in ("freq_ag", "freq_bg")}
    center = np.zeros((4, 3), np.float32)
    nbr = np.array([[1.0, 0, 0], [0, 2.5, 0], [0, 0, 5.0], [0, 0, 6.5]], np.float32)
    want = jenc.bond_encoder(freqs, center_pos=center, neighbor_pos=nbr)
    got = tenc.bond_encoder({k: _t(v) for k, v in freqs.items()},
                            center_pos=_t(center), neighbor_pos=_t(nbr))
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        _close(g, w)


def test_bond_encoder_zero_length_is_nan_in_both():
    freqs = {k: jbasis.bessel_frequencies(9) for k in ("freq_ag", "freq_bg")}
    zero = np.zeros((1, 3), np.float32)
    _, _, jw = jenc.bond_encoder(freqs, center_pos=zero, neighbor_pos=zero)
    _, _, tw = tenc.bond_encoder({k: _t(v) for k, v in freqs.items()},
                                 center_pos=_t(zero), neighbor_pos=_t(zero))
    assert np.isnan(np.asarray(jw)).all() and torch.isnan(tw).all()


def test_angle_encoder_matches_chgnet_tpu():
    freq = jbasis.fourier_frequencies(4)  # num_angular 9
    unit_i = np.array([[1.0, 0, 0], [1.0, 0, 0], [0.6, 0.8, 0]], np.float32)
    unit_j = np.array([[0, 1.0, 0], [1.0, 0, 0], [-0.6, 0.8, 0]], np.float32)
    want = jenc.angle_encoder({"freq": freq}, unit_vec_i=unit_i, unit_vec_j=unit_j)
    got = tenc.angle_encoder({"freq": _t(freq)}, unit_vec_i=_t(unit_i),
                             unit_vec_j=_t(unit_j))
    assert got.shape == (3, 9)
    assert torch.isfinite(got).all()  # parallel vectors stay finite
    _close(got, want)
