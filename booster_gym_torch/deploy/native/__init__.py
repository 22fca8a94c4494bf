"""ctypes bindings for the native real-time publisher (publisher.cpp).

Builds the shared library on first use with g++, into the repository's
git-ignored build/deploy/ (not next to the source); falls back gracefully —
NativePublisher.available() is False when no compiler is present, and the
controller keeps using its Python publish loop.
"""

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "publisher.cpp")
_SO = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(_DIR))), "build", "deploy",
                   "libpublisher.so")


class JointOut(ctypes.Structure):
    _fields_ = [("q", ctypes.c_float), ("tau", ctypes.c_float),
                ("kp_mask", ctypes.c_float)]


_PUBLISH_CB = ctypes.CFUNCTYPE(
    None, ctypes.POINTER(JointOut), ctypes.c_int, ctypes.c_void_p)


def _build():
    # written under a name of its own, then renamed: processes that build at
    # once never load a half-written library
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp, "-lpthread"]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _SO)


_lib = None


def load_library(rebuild=False):
    global _lib
    if _lib is not None and not rebuild:
        return _lib
    if rebuild or not os.path.exists(_SO) or (
            os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
        _build()
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        # a stale artifact from another machine/arch/toolchain: rebuild once
        # (the .so is a local build product, never shipped in the repo)
        _build()
        lib = ctypes.CDLL(_SO)
    lib.publisher_create.restype = ctypes.c_void_p
    lib.publisher_create.argtypes = [
        ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.publisher_destroy.argtypes = [ctypes.c_void_p]
    lib.publisher_set_targets.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
    lib.publisher_init_filtered.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.publisher_step.argtypes = [ctypes.c_void_p, ctypes.POINTER(JointOut)]
    lib.publisher_run_loop.restype = ctypes.c_long
    lib.publisher_run_loop.argtypes = [
        ctypes.c_void_p, _PUBLISH_CB, ctypes.c_void_p, ctypes.c_long]
    lib.publisher_stop.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available():
    try:
        load_library()
        return True
    except Exception:
        return False


def _fptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


class NativePublisher:
    """High-rate command pipeline backed by publisher.cpp."""

    def __init__(self, cfg, teleop_upper_body=False):
        self.lib = load_library()
        n = len(cfg["common"]["stiffness"])
        self.num_joints = n
        stiffness = np.asarray(cfg["common"]["stiffness"], np.float32)
        torque_limit = np.asarray(cfg["common"]["torque_limit"], np.float32)
        parallel = np.asarray(cfg["mech"]["parallel_mech_indexes"], np.int32)
        teleop = np.zeros(n, np.int32)
        if teleop_upper_body:
            teleop[:10] = 1
        self._handle = self.lib.publisher_create(
            n, cfg["common"]["dt"], _fptr(stiffness), _fptr(torque_limit),
            _iptr(parallel), len(parallel), _iptr(teleop))
        self._out = (JointOut * n)()
        self._cb_keep = None

    def set_targets(self, targets, measured_q):
        t = np.ascontiguousarray(targets, np.float32)
        m = np.ascontiguousarray(measured_q, np.float32)
        self.lib.publisher_set_targets(self._handle, _fptr(t), _fptr(m))

    def init_filtered(self, q):
        q = np.ascontiguousarray(q, np.float32)
        self.lib.publisher_init_filtered(self._handle, _fptr(q))

    def step(self):
        """One filtering+conversion step; returns (q, tau, kp_mask) arrays."""
        self.lib.publisher_step(self._handle, self._out)
        n = self.num_joints
        q = np.array([self._out[i].q for i in range(n)], np.float32)
        tau = np.array([self._out[i].tau for i in range(n)], np.float32)
        mask = np.array([self._out[i].kp_mask for i in range(n)], np.float32)
        return q, tau, mask

    def run_loop(self, callback, num_steps=-1):
        """Run the paced loop; callback(q, tau, kp_mask) per period.
        Returns the number of deadline overruns."""

        def c_cb(out_ptr, n, _user):
            q = np.array([out_ptr[i].q for i in range(n)], np.float32)
            tau = np.array([out_ptr[i].tau for i in range(n)], np.float32)
            mask = np.array([out_ptr[i].kp_mask for i in range(n)], np.float32)
            callback(q, tau, mask)

        self._cb_keep = _PUBLISH_CB(c_cb)
        return self.lib.publisher_run_loop(self._handle, self._cb_keep, None, num_steps)

    def stop(self):
        self.lib.publisher_stop(self._handle)

    def __del__(self):
        try:
            self.lib.publisher_destroy(self._handle)
        except Exception:
            pass
