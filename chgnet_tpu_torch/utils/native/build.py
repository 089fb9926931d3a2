"""Build and load the port's host libraries (C++, plain C interface).

Each host source (``utils/native/src/hostops.cpp``,
``graph/fast/src/fast_graph.cpp``) is compiled by ``g++`` into its own
shared library and loaded with ``ctypes``. Libraries land in
``build/chgnet_tpu_torch/host/`` under the repository root, named
``lib<name>-<digest>.so`` by a digest of the source, the flags and the
instruction set ``-march=native`` selects on the building host, so a stale
library, or one built for another CPU, is never loaded.

A build compiles to a temporary file in the build directory and renames it
onto the final name, under a file lock, so that processes and threads that
build at once neither load a half-written file nor compile twice. A failed
compile or load raises with the compiler's output: the port has no quiet
fallback for a library its path needs.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
import tempfile
import threading

from chgnet_tpu_torch import ROOT

HOST_DIR = os.path.join(ROOT, "build", "chgnet_tpu_torch", "host")
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_libs: dict[tuple[str, str], ctypes.CDLL] = {}  # (source, build dir) -> library


@functools.cache
def _target() -> bytes:
    """The predefined macros of ``g++ -march=native``: the instruction set
    a library built here may use."""
    try:
        proc = subprocess.run(
            ["g++", "-march=native", "-dM", "-E", "-x", "c++", "-"],
            input=b"", capture_output=True, check=True, timeout=60,
        )
    except (OSError, subprocess.CalledProcessError) as exc:
        raise RuntimeError(f"g++ cannot build the port's host libraries: {exc}") from exc
    return proc.stdout


def lib_path(source: str, build_dir: str = HOST_DIR) -> str:
    """Path of the library of ``source`` for the current source, flags and
    host instruction set."""
    digest = hashlib.sha1(" ".join(GXX_FLAGS).encode())
    digest.update(_target())
    with open(source, "rb") as fh:
        digest.update(fh.read())
    name = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(build_dir, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(source: str, build_dir: str = HOST_DIR) -> bool:
    """Compile ``source`` unless its library exists. Returns True when this
    call compiled it."""
    out = lib_path(source, build_dir)
    if os.path.exists(out):
        return False
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(out):  # another process built it meanwhile
            return False
        fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=build_dir)
        os.close(fd)
        try:
            proc = subprocess.run(
                ["g++", *GXX_FLAGS, source, "-o", tmp],
                capture_output=True, text=True, timeout=300,
            )
            if proc.returncode:
                raise RuntimeError(
                    f"g++ failed on {source}:\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, out)  # atomic: readers never see a partial file
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return True


def load(
    source: str,
    signatures: dict[str, tuple[object, list]],
    build_dir: str = HOST_DIR,
) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed, each C
    function of ``signatures`` given its ``(restype, argtypes)``. Safe to
    call from several threads at once."""
    with _lock:
        lib = _libs.get((source, build_dir))
        if lib is None:
            build(source, build_dir)
            path = lib_path(source, build_dir)
            try:
                lib = ctypes.CDLL(path)
            except OSError as exc:
                raise RuntimeError(f"cannot load {path}: {exc}") from exc
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[source, build_dir] = lib
        return lib
