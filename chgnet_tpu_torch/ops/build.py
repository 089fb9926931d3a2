"""Build, load and launch the port's CUDA kernels.

Each ``chgnet_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into its own
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). Libraries land in
``build/chgnet_tpu_torch/`` under the repository root, named by a digest of
their sources and flags, so a stale library is never loaded. The build runs
at first use; :func:`build` compiles several sources in parallel, one
``nvcc`` each. ``nvcc``'s ``-Xptxas -v`` report (registers, shared memory,
spills) is kept beside each library as ``<lib>.log``.

The kernel wrappers (``ops/segment.py``, ``ops/gproj.py``,
``ops/gated_message.py``, ``ops/multi_gather.py``, ``ops/fused_pass.py``)
share the launch
plumbing below: :func:`on_cuda` picks the kernel or the plain version by the
tensor's device, :func:`check_tensors` raises on what a kernel does not take
and names the storage type of its C entry point (``_f32`` or ``_bf16``),
:func:`ptr` and :func:`stream` give the C entry points their arguments, and
:func:`check` raises on the error code they return. :func:`plain_in_f32`
gives a plain version the kernels' rounding for bf16 inputs.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from chgnet_tpu_torch import ROOT

CSRC = os.path.join(ROOT, "chgnet_tpu_torch", "csrc")
BUILD_DIR = os.path.join(ROOT, "build", "chgnet_tpu_torch")
SOURCES = (
    "segment_sum", "gather_rows", "gather_window", "gproj", "gated_message",
    "multi_gather", "fused_pass",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA toolkit's ``nvcc``."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def lib_path(name: str) -> str:
    """Path of ``name``'s library for the current sources and flags: its
    source and every header of the directory go into the digest, so a
    change to a shared header rebuilds every library that may include it."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC, fname), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names=SOURCES) -> list[str]:
    """Compile the libraries of ``names`` that are missing, one ``nvcc``
    per source, all started together. Returns the names it compiled."""
    todo = [n for n in names if not os.path.exists(lib_path(n))]
    if not todo:
        return []
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in todo:
        out = lib_path(name)
        tmp = f"{out}.{os.getpid()}.tmp"
        log = open(f"{out}.log", "w")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs.append((name, out, tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT
        )))
    failed = []
    for name, out, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)  # atomic: readers never see a partial file
        else:
            failed.append(name)
    if failed:
        msgs = []
        for name in failed:
            with open(f"{lib_path(name)}.log") as fh:
                msgs.append(f"--- {name} ---\n{fh.read()}")
        raise RuntimeError("nvcc failed:\n" + "\n".join(msgs))
    return todo


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, with each C
    function in ``signatures`` given its ``argtypes`` (and ``int`` result:
    every entry point returns its ``cudaError_t``)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(lib_path(name))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def on_cuda(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (use the plain version); any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {x.device}")


# the storage types of the kernels' C entry points, by suffix
STORAGE = {torch.float32: "f32", torch.bfloat16: "bf16"}


def check_tensors(what: str, floats=(), ints=(), aligned=()) -> str:
    """Raise unless every tensor is a contiguous CUDA tensor on one device,
    every float tensor of one storage type that the kernels take (f32 or
    bf16: every row of PERF.md's table has both), and every tensor of
    ``aligned`` starts on a 16-byte boundary (the kernel loads it as
    ``float4`` only). Returns the suffix of the C entry point for that type
    (``STORAGE``)."""
    dev = floats[0].device
    dtype = floats[0].dtype
    if dtype not in STORAGE:
        raise TypeError(f"{what}: float32 or bfloat16 expected, got {dtype}")
    for t in floats:
        if t.dtype != dtype:
            raise TypeError(f"{what}: one float type expected, got {dtype} and {t.dtype}")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: int32 indices expected, got {t.dtype}")
    for t in (*floats, *ints):
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: contiguous tensors expected")
    for t in aligned:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: 16-byte aligned storage expected")
    return STORAGE[dtype]


def plain_in_f32(fn):
    """A plain version that computes in f32 and rounds each output once to
    its inputs' type: for bf16 inputs (``compute_dtype="bfloat16"``) the
    rounding of the bf16 kernels, which widen their rows to f32, compute
    in f32 and round once at the store, as the TPU kernels do
    (``preferred_element_type=float32``). f32 inputs pass through
    untouched. Differentiable: the widening and the rounding are casts."""

    def widen(x):
        if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
            return x.float()
        if isinstance(x, (list, tuple)):
            return type(x)(widen(v) for v in x)
        return x

    def narrow(x, dtype):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        if isinstance(x, (list, tuple)):
            return type(x)(narrow(v, dtype) for v in x)
        return x

    @functools.wraps(fn)
    def run(*args, **kwargs):
        first = next(_float_tensors((*args, *kwargs.values())), None)
        if first is None or first.dtype != torch.bfloat16:
            return fn(*args, **kwargs)
        kw = {k: widen(v) for k, v in kwargs.items()}
        return narrow(fn(*widen(args), **kw), torch.bfloat16)

    return run


def _float_tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _float_tensors(a)


def ptr(t: torch.Tensor) -> int | None:
    """Device address of ``t`` for a C entry point (null when empty)."""
    return t.data_ptr() if t.numel() else None


def stream() -> int:
    """Handle of the current CUDA stream, on which every kernel launches."""
    return torch.cuda.current_stream().cuda_stream
