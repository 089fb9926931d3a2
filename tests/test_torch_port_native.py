"""The port's native host stack on the CPU: its C++ graph builder against
chgnet_tpu's numpy builder, its host ops against numpy, its object graph
API, and the g++ builder of both libraries.

* ``graph/fast``: the 12 random cells of ``tests/test_fuzz.py`` (its
  generator, copied) at 6 / 3 A and the two example CIFs at (5, 3) and
  (6, 3) A: index arrays and images equal to chgnet_tpu's numpy builder,
  distances within 1e-10 A;
* ``stable_argsort_i32`` equal to ``np.argsort(kind="stable")`` on keys the
  radix sorts (over 32k keys, ties, pad keys one past the end, a small key
  range for the counting pass, a large one) and on those it leaves to numpy
  (empty, negative, few, not 1-D, not int32); ``fast_gather`` and
  ``gather_col`` equal to fancy indexing, and out-of-range indices raise;
* ``batch_graphs`` with the host ops equal, array for array and plan for
  plan, to the same batch built with ``CHGNET_TPU_NO_HOSTOPS=1`` (numpy),
  on a batch large enough for the radix sort;
* the ``Graph`` object API against the array builders on LiMnO2;
* ``utils/native/build.py``: threads and processes that build into one
  fresh directory at once all load the library, which is compiled once and
  not again; a source that does not compile raises with g++'s output.

chgnet_tpu is only asked for its numpy builder here, never for its own
native libraries.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from chgnet_tpu import ROOT
from chgnet_tpu.core.lattice import Lattice as JLattice
from chgnet_tpu.core.structure import Structure as JStructure
from chgnet_tpu.graph.builder import build_graph_arrays as j_build_graph_arrays
from chgnet_tpu.graph.neighbors import get_neighbor_list as j_get_neighbor_list
from chgnet_tpu_torch.core.lattice import Lattice as TLattice
from chgnet_tpu_torch.core.structure import Structure as TStructure
from chgnet_tpu_torch.graph import DirectedEdge, Graph, Node, UndirectedEdge
from chgnet_tpu_torch.graph.batching import batch_graphs
from chgnet_tpu_torch.graph.converter import CrystalGraphConverter
from chgnet_tpu_torch.graph.fast import fast_graph
from chgnet_tpu_torch.utils import hostmem
from chgnet_tpu_torch.utils.native import build as native_build
from chgnet_tpu_torch.utils.native import hostops

CIFS = ["mp-18767-LiMnO2.cif", "mp-1175469-Li9Co7O16.cif"]
INDEX_FIELDS = (
    "atom_graph", "neighbor_image", "directed2undirected",
    "undirected2directed", "bond_graph",
)
DIST_ATOL = 1e-10  # A: the two builders sum the same terms in other orders


def _random_cell(rng: np.random.Generator):
    """``tests/test_fuzz.py``'s random cell: skewed lattice, 2-24 atoms,
    mixed species. Returns (lattice matrix, species, frac coords)."""
    n_atoms = int(rng.integers(2, 24))
    diag = rng.uniform(3.5, 8.0, 3)
    shear = rng.uniform(-0.3, 0.3, (3, 3)) * diag[:, None]
    matrix = np.diag(diag) + np.tril(shear, -1)
    species = rng.integers(1, 95, n_atoms).tolist()
    frac = rng.random((n_atoms, 3))
    return matrix, species, frac


def _assert_same_graph(fast, js, rc, rb):
    center, neighbor, image, dist = j_get_neighbor_list(js, r=rc)
    ref = j_build_graph_arrays(len(js), center, neighbor, image, dist, rb)
    for field in INDEX_FIELDS:
        np.testing.assert_array_equal(
            getattr(fast, field), getattr(ref, field), err_msg=field
        )
    np.testing.assert_allclose(fast.distances, ref.distances, rtol=0, atol=DIST_ATOL)
    return fast


@pytest.mark.parametrize("seed", range(12))
def test_fast_builder_equals_numpy_builder_on_random_cells(seed):
    matrix, species, frac = _random_cell(np.random.default_rng(seed))
    js = JStructure(JLattice(matrix), species, frac)
    ts = TStructure(TLattice(matrix), species, frac)
    fast = _assert_same_graph(fast_graph.build(ts, 6.0, 3.0), js, 6.0, 3.0)
    assert fast.n_directed == 2 * fast.n_undirected


@pytest.mark.parametrize("name", CIFS)
@pytest.mark.parametrize("cutoffs", [(5.0, 3.0), (6.0, 3.0)])
def test_fast_builder_equals_numpy_builder_on_cifs(name, cutoffs):
    path = f"{ROOT}/examples/{name}"
    fast = _assert_same_graph(
        fast_graph.build(TStructure.from_file(path), *cutoffs),
        JStructure.from_file(path), *cutoffs,
    )
    assert fast.atom_graph.dtype == np.int32
    assert fast.neighbor_image.dtype == np.float32
    if name.startswith("mp-18767") and cutoffs == (5.0, 3.0):
        assert (fast.n_directed, fast.n_undirected, fast.n_angles) == (384, 192, 744)


def _keys(case: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    n = 100_003  # over the 32k-key threshold: the radix sort runs
    if case == "ties_small_range":  # max key < 2^16: one counting pass
        return rng.integers(0, 50, n).astype(np.int32)
    if case == "ties_large_range":  # two 16-bit passes
        return rng.integers(0, 3_000_000, n).astype(np.int32)
    if case == "pad_one_past_the_end":  # a plan's key: valid ids, then pads
        keys = rng.integers(0, 40_000, n).astype(np.int32)
        keys[rng.random(n) < 0.3] = 40_000
        return keys
    if case == "sorted_with_pad_tail":
        keys = np.sort(rng.integers(0, 70_000, n)).astype(np.int32)
        keys[-5000:] = 70_000
        return keys
    if case == "max_int32":
        return rng.choice(np.array([0, 1, 2**31 - 1], np.int32), n)
    if case == "empty":
        return np.zeros(0, np.int32)
    if case == "negative":
        return rng.integers(-5, 5, n).astype(np.int32)
    if case == "few":
        return rng.integers(0, 9, 1000).astype(np.int32)
    if case == "two_dimensional":
        return rng.integers(0, 9, (400, 100)).astype(np.int32)
    if case == "int64":
        return rng.integers(0, 9, n)
    raise ValueError(case)


@pytest.mark.parametrize(
    "case",
    [
        "ties_small_range", "ties_large_range", "pad_one_past_the_end",
        "sorted_with_pad_tail", "max_int32", "empty", "negative", "few",
        "two_dimensional", "int64",
    ],
)
def test_stable_argsort_equals_numpy(case):
    keys = _keys(case)
    got = hostops.stable_argsort_i32(keys)
    want = np.argsort(keys, kind="stable").astype(np.int32)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "shape,dtype",
    [
        ((200_000,), np.float32), ((200_000,), np.int64), ((200_000, 3), np.float32),
        ((200_000, 5), np.int32), ((70_000, 7), np.float64), ((1000, 2), np.int32),
    ],
)
def test_gathers_equal_fancy_indexing(shape, dtype):
    rng = np.random.default_rng(3)
    src = (rng.random(shape) * 1000).astype(dtype)
    idx = rng.integers(0, shape[0], 150_000).astype(np.int32)
    np.testing.assert_array_equal(hostops.fast_gather(src, idx), src[idx])
    np.testing.assert_array_equal(hostops.gather_col(src, None, idx), src[idx])
    if len(shape) == 2:
        col = shape[1] - 1
        np.testing.assert_array_equal(hostops.gather_col(src, col, idx), src[idx, col])


def test_gathers_raise_on_out_of_range_indices():
    src = np.arange(40, dtype=np.float32).reshape(20, 2)
    for bad in (np.array([0, 20], np.int32), np.array([-1, 3], np.int32)):
        with pytest.raises(IndexError, match="out of bounds"):
            hostops.fast_gather(src, bad)
        with pytest.raises(IndexError, match="out of bounds"):
            hostops.gather_col(src, None, bad)


def test_no_hostops_switch_takes_numpy(monkeypatch):
    monkeypatch.setenv("CHGNET_TPU_NO_HOSTOPS", "1")
    src = np.arange(12, dtype=np.int32)
    idx = np.array([3, 1, 1], np.int32)
    out = np.empty(3, np.int32)
    assert not hostops.gather_col_into(src, None, idx, out)
    np.testing.assert_array_equal(hostops.gather_col(src, None, idx), src[idx])
    keys = np.random.default_rng(0).integers(0, 9, 50_000).astype(np.int32)
    np.testing.assert_array_equal(
        hostops.stable_argsort_i32(keys), np.argsort(keys, kind="stable")
    )


def test_batch_with_host_ops_equals_the_numpy_batch(monkeypatch):
    """A 512-atom and a 216-atom supercell: the per-graph pair sort, the
    angle stream's sort and gathers and the plans' sorts all take the
    native routes (over 32k keys), and give the arrays numpy gives."""
    conv = CrystalGraphConverter(atom_graph_cutoff=6.0, bond_graph_cutoff=3.0)
    base = TStructure.from_file(f"{ROOT}/examples/{CIFS[0]}")
    graphs = [
        conv(base.make_supercell(scale).perturb(0.05, seed=seed))
        for seed, scale in enumerate((4, 3))
    ]
    assert graphs[0].n_directed > 1 << 15
    native = batch_graphs(graphs)
    monkeypatch.setenv("CHGNET_TPU_NO_HOSTOPS", "1")
    plain = batch_graphs(graphs)
    for name, got, want in zip(native._fields, native, plain):
        if name.startswith("plan_"):
            for part, g, w in zip(got._fields, got, want):
                np.testing.assert_array_equal(g, w, err_msg=f"{name}.{part}")
        else:
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_object_graph_matches_the_array_builders():
    """Fed the canonical neighbor list, the object Graph gives the C++
    builder's index maps (the third builder held against the other two)."""
    struct = TStructure.from_file(f"{ROOT}/examples/{CIFS[0]}")
    fast = fast_graph.build(struct, 5.0, 3.0)
    graph = Graph([Node(index=idx) for idx in range(len(struct))])
    for (c, n), img, d in zip(fast.atom_graph, fast.neighbor_image, fast.distances):
        graph.add_edge(int(c), int(n), img, float(d))
    rows, d2u = graph.adjacency_list()
    np.testing.assert_array_equal(np.asarray(rows), fast.atom_graph)
    np.testing.assert_array_equal(np.asarray(d2u), fast.directed2undirected)
    line, u2d = graph.line_graph_adjacency_list(cutoff=3.0)
    np.testing.assert_array_equal(np.asarray(u2d), fast.undirected2directed)
    np.testing.assert_array_equal(np.asarray(line), fast.bond_graph)
    assert len(line) == 744


def test_object_graph_pairs_reverse_edges_and_rejects_unpaired():
    edge = DirectedEdge([0, 1], 0, {"image": np.array([0, 0, 1]), "distance": 1.5})
    rev = DirectedEdge([1, 0], 1, {"image": np.array([0, 0, -1]), "distance": 1.5})
    assert edge == rev
    assert isinstance(edge.make_undirected(0), UndirectedEdge)
    graph = Graph([Node(index=idx) for idx in range(2)])
    graph.add_edge(0, 1, np.zeros(3), 1.0)
    graph.add_edge(1, 0, np.zeros(3), 1.0)
    graph.add_edge(0, 0, np.array([0, 0, 1]), 4.0)
    assert graph.adjacency_list()[1] == [0, 0, 1]
    with pytest.raises(ValueError, match="reverse edge"):
        graph.line_graph_adjacency_list(cutoff=3.0)


def _count_compiles(monkeypatch) -> list:
    compiles = []
    run = subprocess.run

    def counting_run(cmd, *args, **kwargs):
        if "-shared" in cmd:
            compiles.append(cmd)
        return run(cmd, *args, **kwargs)

    monkeypatch.setattr(native_build.subprocess, "run", counting_run)
    return compiles


def test_threads_building_into_a_fresh_directory_share_one_compile(tmp_path, monkeypatch):
    compiles = _count_compiles(monkeypatch)
    build_dir = str(tmp_path / "host")
    n_threads = 8
    barrier = threading.Barrier(n_threads)
    libs, errors = [], []

    def worker():
        try:
            barrier.wait(timeout=60)
            libs.append(native_build.load(hostops.SOURCE, hostops._SIGNATURES, build_dir))
        except Exception as exc:  # reported below with the thread's error
            errors.append(exc)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(libs) == n_threads and all(lib is libs[0] for lib in libs)
    assert len(compiles) == 1
    lib_file = native_build.lib_path(hostops.SOURCE, build_dir)
    mtime = os.path.getmtime(lib_file)
    assert not native_build.build(hostops.SOURCE, build_dir)  # never rebuilt
    assert os.path.getmtime(lib_file) == mtime and len(compiles) == 1
    assert sorted(os.listdir(build_dir)) == sorted(["lock", os.path.basename(lib_file)])


def test_processes_building_into_a_fresh_directory_both_load(tmp_path):
    build_dir = str(tmp_path / "host")
    code = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from chgnet_tpu_torch.utils.native import build, hostops\n"
        f"build.load(hostops.SOURCE, hostops._SIGNATURES, {build_dir!r})\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code]) for _ in range(2)]
    assert [p.wait(timeout=300) for p in procs] == [0, 0]
    lib_file = native_build.lib_path(hostops.SOURCE, build_dir)
    assert sorted(os.listdir(build_dir)) == sorted(["lock", os.path.basename(lib_file)])
    ctypes.CDLL(lib_file).hostops_argsort_i32  # a whole library


def test_a_source_that_does_not_compile_raises_with_the_compiler_output(tmp_path):
    source = tmp_path / "broken.cpp"
    source.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native_build.load(str(source), {}, str(tmp_path / "host"))
    assert os.listdir(tmp_path / "host") == ["lock"]  # no partial library left


def test_populated_buffers_and_slab_recycling():
    arr = hostmem.populated_empty((1 << 20,), np.float32)  # 4 MB: mmap route
    arr[:] = 1.0
    assert arr.shape == (1 << 20,) and arr.dtype == np.float32 and arr.sum() == 1 << 20
    slab = hostmem.get_slab(8 << 20)
    carved = slab.carve((1 << 20,), np.float32)
    carved[:] = 2.0
    assert hostmem.get_slab(8 << 20) is not slab  # still in use
    del carved
    assert hostmem.get_slab(8 << 20) is slab  # free: its pages are reused
