"""ctypes bridge to the native C++ graph builder (``src/fast_graph.cpp``).

The port's copy of ``chgnet_tpu``'s ``graph/fast/fast_graph.py``: one native
call does the periodic neighbor search, the directed -> undirected pairing
and the line graph, with the output contract of the numpy builder
(``graph/neighbors.py`` + ``graph/builder.py``): the same index arrays and
images, distances to 1e-10. The library is built on first use by
``utils/native/build.py``; a library that cannot be built raises.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from chgnet_tpu_torch.graph.builder import GraphArrays
from chgnet_tpu_torch.utils.native import build as native_build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src", "fast_graph.cpp")


class _ChgnetGraph(ctypes.Structure):
    _fields_ = [
        ("n_directed", ctypes.c_int64),
        ("n_undirected", ctypes.c_int64),
        ("n_angles", ctypes.c_int64),
        ("atom_graph", ctypes.POINTER(ctypes.c_int64)),
        ("neighbor_image", ctypes.POINTER(ctypes.c_int64)),
        ("d2u", ctypes.POINTER(ctypes.c_int64)),
        ("u2d", ctypes.POINTER(ctypes.c_int64)),
        ("bond_graph", ctypes.POINTER(ctypes.c_int64)),
        ("distances", ctypes.POINTER(ctypes.c_double)),
        ("error", ctypes.c_int32),
    ]


_F64P = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "chgnet_build_graph": (ctypes.POINTER(_ChgnetGraph), [
        ctypes.c_int64, _F64P, _F64P, ctypes.c_double, ctypes.c_double,
        ctypes.c_double,
    ]),
    "chgnet_free_graph": (None, [ctypes.POINTER(_ChgnetGraph)]),
}


def load() -> ctypes.CDLL:
    """The graph builder's library, compiled first if needed (raises if it
    cannot be built or loaded)."""
    return native_build.load(SOURCE, _SIGNATURES)


def _copy(pointer, count: int, dtype) -> np.ndarray:
    """``count`` values out of C memory, converted to the consumer's dtype
    in the one copy (``CrystalGraph`` keeps int32 ids and float32 images)."""
    if count == 0:
        return np.zeros(0, dtype=dtype)
    return np.ctypeslib.as_array(pointer, shape=(count,)).astype(dtype, copy=True)


def build(
    structure,
    atom_graph_cutoff: float,
    bond_graph_cutoff: float,
    *,
    numerical_tol: float = 1e-8,
) -> GraphArrays:
    """The graph topology of one Structure by the native builder: int32
    ids, float32 images, float64 distances. Raises ``ValueError`` when a
    directed edge has no reverse partner."""
    lib = load()
    frac = np.ascontiguousarray(structure.frac_coords, dtype=np.float64)
    lattice = np.ascontiguousarray(structure.lattice.matrix, dtype=np.float64)
    n_atoms = len(structure)
    ptr = lib.chgnet_build_graph(
        n_atoms,
        frac.ctypes.data_as(_F64P),
        lattice.ctypes.data_as(_F64P),
        float(atom_graph_cutoff),
        float(bond_graph_cutoff),
        float(numerical_tol),
    )
    try:
        graph = ptr.contents
        if graph.error:
            raise ValueError(
                "native graph builder found an unpaired directed edge "
                "(neighbor list not reverse-complete)"
            )
        n_dir, n_und, n_ang = graph.n_directed, graph.n_undirected, graph.n_angles
        arrays = GraphArrays(
            atom_graph=_copy(graph.atom_graph, 2 * n_dir, np.int32).reshape(-1, 2),
            neighbor_image=_copy(graph.neighbor_image, 3 * n_dir, np.float32).reshape(-1, 3),
            directed2undirected=_copy(graph.d2u, n_dir, np.int32),
            undirected2directed=_copy(graph.u2d, n_und, np.int32),
            bond_graph=_copy(graph.bond_graph, 5 * n_ang, np.int32).reshape(-1, 5),
            distances=_copy(graph.distances, n_dir, np.float64),
            n_atoms=n_atoms,
        )
    finally:
        lib.chgnet_free_graph(ptr)
    return arrays
