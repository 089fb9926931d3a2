"""ctypes bridge to the threaded host-ops library (``src/hostops.cpp``).

A copy of ``chgnet_tpu``'s ``utils/native/hostops.py`` over the port's own
copy of the source. ``fast_gather(src, idx)`` is ``src[idx]`` for 1-D and
2-D arrays, threaded and software-prefetched: random row gathers over
millions of rows are bound by memory latency, which numpy's one-threaded
fancy indexing does not hide. ``stable_argsort_i32`` is a threaded LSD radix
sort of non-negative int32 keys.

Each function takes numpy where its precondition does not hold (below), and
both routes give the same result. ``CHGNET_TPU_NO_HOSTOPS=1`` sends every
call to numpy. Otherwise the library is built on first use
(``utils/native/build.py``) and a library that cannot be built raises.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from chgnet_tpu_torch.utils import hostmem
from chgnet_tpu_torch.utils.native import build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src", "hostops.cpp")
_N_THREADS = min(8, os.cpu_count() or 1)
_MIN_SORT = 1 << 15  # keys this many or fewer: numpy's sort is as fast
_I32P = ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {
    "hostops_gather_rows": (None, [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
    ]),
    "hostops_argsort_i32": (ctypes.c_int32, [
        _I32P, ctypes.c_int64, _I32P, _I32P, ctypes.c_int32, ctypes.c_int32,
    ]),
    "hostops_gather_strided_i32": (None, [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, _I32P,
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
    ]),
}


def _disabled() -> bool:
    return os.environ.get("CHGNET_TPU_NO_HOSTOPS") == "1"


def _lib() -> ctypes.CDLL:
    return build.load(SOURCE, _SIGNATURES)


def _check_range(what: str, idx: np.ndarray, n_rows: int) -> None:
    """numpy's bounds check (without negative wrapping): the native kernels
    would read outside ``src`` on a bad index."""
    lo, hi = int(idx.min()), int(idx.max())
    if lo < 0 or hi >= n_rows:
        raise IndexError(
            f"{what}: index range [{lo}, {hi}] out of bounds for {n_rows} rows"
        )


def fast_gather(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``src[idx]`` (rows) by the threaded native gather; numpy for arrays
    of more than two dimensions."""
    src = np.ascontiguousarray(src)
    if _disabled() or src.ndim > 2:
        return src[idx]
    idx64 = np.ascontiguousarray(idx, dtype=np.int64)
    if idx64.size:
        _check_range("fast_gather", idx64, src.shape[0])
    out = hostmem.populated_empty((idx64.shape[0],) + src.shape[1:], src.dtype)
    row = src.dtype.itemsize * (src.shape[1] if src.ndim == 2 else 1)
    _lib().hostops_gather_rows(
        src.ctypes.data_as(ctypes.c_char_p),
        idx64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.c_char_p),
        idx64.shape[0],
        row,
        _N_THREADS,
    )
    return out


def gather_col_into(
    src: np.ndarray,
    col: int | None,
    idx: np.ndarray,
    out: np.ndarray,
) -> bool:
    """``out[:] = src[idx]`` (``col=None``, whole rows) or ``src[idx, col]``,
    written straight into a caller's contiguous array. Returns False, and
    writes nothing, where the native gather does not apply (the caller then
    uses numpy): ``CHGNET_TPU_NO_HOSTOPS=1``, ``src`` or ``out`` not
    C-contiguous, ``src`` of more than two dimensions, ``idx`` not
    contiguous int32, or dtypes that differ. Indices out of range raise
    ``IndexError``."""
    if (
        _disabled()
        or not src.flags.c_contiguous
        or not out.flags.c_contiguous
        or idx.dtype != np.int32
        or not idx.flags.c_contiguous
        or src.ndim > 2
        or out.dtype != src.dtype
    ):
        return False
    n = idx.shape[0]
    if n == 0:
        return True
    _check_range("gather_col_into", idx, src.shape[0])
    item = src.dtype.itemsize
    stride = item * (src.shape[1] if src.ndim == 2 else 1)
    if col is None:
        elem, base = stride, src.ctypes.data
    else:
        elem, base = item, src.ctypes.data + col * item
    if out.nbytes != n * elem:
        raise ValueError(
            f"gather_col_into: out has {out.nbytes} bytes, expected {n * elem}"
        )
    _lib().hostops_gather_strided_i32(
        ctypes.c_char_p(base),
        stride,
        elem,
        idx.ctypes.data_as(_I32P),
        ctypes.c_char_p(out.ctypes.data),
        n,
        _N_THREADS,
    )
    return True


def gather_col(src: np.ndarray, col: int | None, idx: np.ndarray) -> np.ndarray:
    """Allocating form of :func:`gather_col_into` (pre-populated pages),
    with numpy where the native gather does not apply."""
    shape = idx.shape + (src.shape[1:] if col is None else ())
    out = hostmem.populated_empty(shape, src.dtype)
    if not gather_col_into(src, col, idx, out):
        out[...] = src[idx] if col is None else src[idx, col]
    return out


def stable_argsort_i32(keys: np.ndarray) -> np.ndarray:
    """``np.argsort(keys, kind="stable")`` as int32, by the threaded radix
    sort for 1-D int32 keys, more than 32k of them, none negative (the
    radix sorts the keys' bits as unsigned); numpy otherwise. Keys below
    2^16 take one counting pass."""
    keys = np.asarray(keys)
    if (
        _disabled()
        or keys.dtype != np.int32
        or keys.ndim != 1
        or keys.size <= _MIN_SORT
    ):
        return np.argsort(keys, kind="stable").astype(np.int32)
    keys = np.ascontiguousarray(keys)
    if int(keys.min()) < 0:
        return np.argsort(keys, kind="stable").astype(np.int32)
    hi = int(keys.max())
    out = hostmem.populated_empty(keys.shape[0], np.int32)
    small = hi < (1 << 16)
    scratch = out if small else hostmem.populated_empty(keys.shape[0], np.int32)
    rc = _lib().hostops_argsort_i32(
        keys.ctypes.data_as(_I32P),
        keys.shape[0],
        out.ctypes.data_as(_I32P),
        scratch.ctypes.data_as(_I32P),
        _N_THREADS,
        hi if small else -1,
    )
    if rc:
        raise RuntimeError(f"hostops_argsort_i32: bad input ({keys.shape[0]} keys)")
    return out
