"""Host allocator tuning for large-array graph preprocessing.

The host-side pipeline (graph building, padded batching, multi-chip
re-layout) allocates and frees hundreds of MB of numpy arrays per batch.
glibc serves allocations above ``M_MMAP_THRESHOLD`` (128 kB default) with
fresh ``mmap`` regions and unmaps them on free, so every batch pays the
kernel's page-fault cost for the same memory again and again. On
virtualized hosts the fault path can be 10-30x slower than a warm-page
copy (about 150 MB/s against 4 GB/s on such a host).

``tune_host_allocator()`` raises the mmap and trim thresholds via
``mallopt`` so large buffers are served from the (persistent, warm) heap.
Called once when ``chgnet_tpu_torch`` is imported; opt out with
``CHGNET_TPU_NO_MALLOC_TUNE=1``. A copy of ``chgnet_tpu``'s module of the
same name.
Trade-off: peak RSS is retained between batches instead of returned to the
OS — the standard choice for throughput-oriented numeric services.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import sys
import weakref

import numpy as np

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3

_applied = False

# Below this size the mmap syscall overhead beats the fault savings.
_POPULATE_MIN_BYTES = 1 << 20


def populated_empty(shape, dtype) -> np.ndarray:
    """``np.empty`` over pre-populated pages (anonymous MAP_POPULATE mmap).

    On virtualized kernels the per-page fault path can be very slow
    (first-touch writes at ~0.13 GB/s against ~8 GB/s warm on such a
    host); MAP_POPULATE populates the whole range in one kernel pass
    (~2.5 GB/s) so the array's first writer runs at warm speed.
    Use for large host-prep output buffers that are written exactly once.
    Falls back to ``np.empty`` for small sizes or when mmap fails.
    """
    dtype = np.dtype(dtype)
    n_bytes = int(np.prod(shape)) * dtype.itemsize
    if n_bytes < _POPULATE_MIN_BYTES or not sys.platform.startswith("linux"):
        return np.empty(shape, dtype)
    try:
        buf = mmap.mmap(
            -1,
            n_bytes,
            flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS | mmap.MAP_POPULATE,
        )
    except (OSError, ValueError, OverflowError):
        return np.empty(shape, dtype)
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


class Slab:
    """One large pre-populated anonymous mapping carved into sub-arrays.

    Paying the kernel's page-supply cost ONCE per prep (a single
    MAP_POPULATE mmap) instead of per output array avoids both the slow
    per-page fault path and the sporadic pathological populate calls
    seen with per-array mmaps. ``carve`` falls back to :func:`populated_empty` when the slab
    is exhausted, so sizing is best-effort.

    Slabs are RECYCLED through :func:`get_slab`: when every array carved
    from a previous slab has been garbage-collected (tracked by weakrefs
    on the carve anchors), the same warm pages are reused and the
    populate cost disappears entirely — the steady-state of
    simulation/training loops that re-shard every topology rebuild.
    """

    def __init__(self, nbytes: int) -> None:
        self._buf = None
        self._pos = 0
        self._nbytes = 0
        self._live: list = []
        if nbytes < _POPULATE_MIN_BYTES or not sys.platform.startswith(
            "linux"
        ):
            return
        try:
            self._buf = mmap.mmap(
                -1,
                nbytes,
                flags=mmap.MAP_PRIVATE
                | mmap.MAP_ANONYMOUS
                | mmap.MAP_POPULATE,
            )
        except (OSError, ValueError, OverflowError):
            return
        self._nbytes = nbytes
        self._view = memoryview(self._buf)

    def carve(self, shape, dtype) -> np.ndarray:
        dtype = np.dtype(dtype)
        n_bytes = int(np.prod(shape)) * dtype.itemsize
        start = (self._pos + 63) & ~63
        if self._buf is None or start + n_bytes > self._nbytes:
            return populated_empty(shape, dtype)
        self._pos = start + n_bytes
        flat = np.frombuffer(self._view[start: start + n_bytes], dtype=dtype)
        # numpy anchors every derived view's .base on `flat`, so this
        # weakref dies exactly when the last array over this carve dies
        self._live.append(weakref.ref(flat))
        return flat.reshape(shape)

    def _is_free(self) -> bool:
        """True when every array ever carved from this slab is dead."""
        if self._buf is None:
            return False
        self._live = [r for r in self._live if r() is not None]
        return not self._live


_slab_pool: list[Slab] = []
_MAX_POOLED_SLABS = 2


def get_slab(nbytes: int) -> Slab:
    """A :class:`Slab` of at least ``nbytes``, recycling a warm free one
    (same pages, no populate cost) when available."""
    for i, slab in enumerate(_slab_pool):
        if slab._nbytes >= nbytes and slab._is_free():
            _slab_pool.pop(i)
            slab._pos = 0
            _slab_pool.append(slab)
            return slab
    slab = Slab(nbytes)
    if slab._buf is not None:
        _slab_pool.append(slab)
        del _slab_pool[:-_MAX_POOLED_SLABS]
    return slab


def tune_host_allocator(threshold_bytes: int = 0x7FFFFFFF) -> bool:
    """Serve large allocations from the heap instead of fresh mmaps.

    Returns True if the tuning was applied (glibc only; silently a no-op
    elsewhere or when ``CHGNET_TPU_NO_MALLOC_TUNE=1``).
    """
    global _applied
    if _applied or os.environ.get("CHGNET_TPU_NO_MALLOC_TUNE") == "1":
        return _applied
    if not sys.platform.startswith("linux"):
        return False
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok1 = libc.mallopt(_M_MMAP_THRESHOLD, threshold_bytes)
        ok2 = libc.mallopt(_M_TRIM_THRESHOLD, threshold_bytes)
        _applied = bool(ok1) and bool(ok2)
    except OSError:  # pragma: no cover - non-glibc linux
        return False
    return _applied
