"""The host's native batch prep for P-256 signatures (csrc/batchprep.cpp).

The port's counterpart of fabric_tpu/native's `batch_prep`: strict DER,
the low-S policy, the scalar ranges, the r + n probe and w = s^-1 mod n
for a whole batch in one C call, with one modular inversion for the
batch. `bccsp/cuda.host_prep_scalars` is its plain version, lane for
lane.

At first use the source is compiled with the host's C++ compiler (`CXX`,
else g++) into fabric_tpu_torch/_build/ (git-ignored), the library named
by the sha256 of the source, so an edited source rebuilds and an
unchanged one is reused; then it is loaded with ctypes. There is no
fallback: a failed build or load raises RuntimeError with the compiler's
output. The first load under a provider's recorder is booked there as
one "batchprep" build event (common/devicecost.py `build_seam`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import subprocess
import threading

import numpy as np

from fabric_tpu_torch.common import devicecost, torchenv

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "batchprep.cpp")

_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C,WRITEABLE")
# C function -> (argtypes, restype)
FUNCTIONS = {
    # der, der_len, r, rpn, w -> 1 when the lane is accepted
    "ftpu_prep_one": ([ctypes.c_char_p, ctypes.c_int32, _U8, _U8, _U8],
                      ctypes.c_int),
    # ptrs, lens, n, r, rpn, w, ok
    "ftpu_batch_prep_ptrs": ([ctypes.POINTER(ctypes.c_char_p),
                              np.ctypeslib.ndpointer(np.int32, flags="C"),
                              ctypes.c_int32, _U8, _U8, _U8, _U8], None),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(torchenv.BUILD_DIR, f"libbatchprep-{digest}.so")


def build() -> str:
    """Compile the source unless its library is current; returns the
    library path. Raises RuntimeError when the compiler fails."""
    lib = library_path()
    if os.path.exists(lib):
        return lib
    os.makedirs(torchenv.BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.tmp{os.getpid()}"
    cmd = [*shlex.split(os.environ.get("CXX") or "g++"), "-O3", "-shared",
           "-fPIC", "-o", tmp, SOURCE]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except OSError as e:
        raise RuntimeError(f"native batch prep: cannot run {cmd[0]}: {e}")
    if out.returncode != 0:
        raise RuntimeError(f"native batch prep: {' '.join(cmd)} failed "
                           f"(exit {out.returncode}):\n{out.stderr}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The bound library, built on first use."""
    return devicecost.build_seam("batchprep", _load, library_path)


def _load() -> ctypes.CDLL:
    with _lock:
        path = library_path()
        lib = _loaded.get(path)
        if lib is None:
            try:
                lib = ctypes.CDLL(build())
            except OSError as e:
                raise RuntimeError(f"native batch prep: cannot load "
                                   f"{path}: {e}") from e
            for fn, (argtypes, restype) in FUNCTIONS.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _loaded[path] = lib
        return lib


def batch_prep(signatures) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray]:
    """Parse, gate and prepare a batch of DER signatures (bytes; b"" for
    a lane to reject). Returns (ok bool[n], r, rpn, w uint8[n, 32]),
    big-endian scalars, zero rows where ok is False."""
    lib = load()
    sigs = [bytes(s) for s in signatures]
    n = len(sigs)
    lens = np.array([len(s) for s in sigs], dtype=np.int32)
    r = np.zeros((n, 32), dtype=np.uint8)
    rpn = np.zeros((n, 32), dtype=np.uint8)
    w = np.zeros((n, 32), dtype=np.uint8)
    ok = np.zeros(n, dtype=np.uint8)
    # the pointer table points into `sigs`, which outlives the call
    ptrs = (ctypes.c_char_p * max(n, 1))(*sigs)
    lib.ftpu_batch_prep_ptrs(ptrs, lens, n, r, rpn, w, ok)
    return ok.astype(bool), r, rpn, w
