"""The one build route of the port's CUDA kernels.

Every kernel source under csrc/ has a plain C interface.  nvcc compiles it
for sm_90a into a shared library under build/kernels/ at first use, and
ctypes loads it.  The library's name carries the -D sizes it was built for
and a hash of the source and of every local header it includes, so a
changed source or header, or another robot or network, never loads an old
library.  Several builds may run at once (start_build
for each, then finish_build for each).
"""

import ctypes
import hashlib
import itertools
import os
import re
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def source_path(source):
    """Absolute path of csrc/<source>."""
    return os.path.join(CSRC_DIR, source)


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def local_headers(source):
    """The headers under csrc/ that csrc/<source> includes with quotes,
    directly or through one another, in the order of first inclusion."""
    seen, todo = [], [source]
    while todo:
        with open(source_path(todo.pop(0)), "rb") as f:
            for name in _LOCAL_INCLUDE.findall(f.read()):
                name = name.decode()
                if name not in seen and os.path.exists(source_path(name)):
                    seen.append(name)
                    todo.append(name)
    return seen


def source_digest(source):
    """The first 10 hex digits of the sha256 of csrc/<source>'s bytes
    followed by those of each of its local_headers."""
    h = hashlib.sha256()
    for name in [source, *local_headers(source)]:
        with open(source_path(name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:10]


def library_path(source, sizes):
    """Build output of csrc/<source> for these -D sizes."""
    digest = source_digest(source)
    stem = os.path.splitext(source)[0]
    tag = "_".join(f"{k.lower()}{v}" for k, v in sizes.items())
    return os.path.join(BUILD_DIR, f"{stem}_{tag}_{digest}.so")


_BUILDS = itertools.count()


def start_build(source, sizes):
    """Start nvcc on csrc/<source> with -D<size>=<value> for each size;
    returns (path, proc, tmp), proc None if the library is already built.
    Each build writes a temporary file of its own that finish_build renames
    into place (two builds of one library may run at once)."""
    path = library_path(source, sizes)
    if os.path.exists(path):
        return path, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    tmp = f"{path}.{os.getpid()}.{next(_BUILDS)}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, *[f"-D{k}={v}" for k, v in sizes.items()],
           "-o", tmp, source_path(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return path, proc, tmp


def finish_build(path, proc, tmp):
    """Wait for a build from start_build; returns nvcc's output (the
    -Xptxas -v register and spill report).  Raises if nvcc failed."""
    if proc is None:
        return ""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {path}:\n{out}")
    os.replace(tmp, path)
    return out


def build(source, sizes):
    """Build (if needed) and return (path, nvcc's report)."""
    path, proc, tmp = start_build(source, sizes)
    return path, finish_build(path, proc, tmp)


def load(path, functions):
    """Load a built library; `functions` maps each exported name to its
    ctypes argtypes.  Every function returns a cudaError_t as an int."""
    lib = ctypes.CDLL(path)
    for name, argtypes in functions.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
