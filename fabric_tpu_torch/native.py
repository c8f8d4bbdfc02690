"""The host's native preparation: P-256 signature batches
(csrc/batchprep.cpp) and whole blocks of envelopes (csrc/blockprep.cpp).

The port's counterpart of fabric_tpu/native:

  * `batch_prep`: strict DER, the low-S policy, the scalar ranges, the
    r + n probe and w = s^-1 mod n for a whole batch in one C call, with
    one modular inversion for the batch. `bccsp/cuda.host_prep_scalars`
    is its plain version, lane for lane.
  * `block_prep`: one pass over a block's envelope bytes (the
    wire-format parse, the SHA-256 digest lanes, identity dedup, DER
    staging through the same batch inversion) into the flat arrays of
    `BlockPrep`, the reference's names, shapes and dtypes. It has no
    plain version: the tests hold it to the JAX package's library, array
    for array.

At first use both sources are compiled together with the host's C++
compiler (`CXX`, else g++; -O3 -shared -fPIC, -lpthread) into one
library in fabric_tpu_torch/_build/ (git-ignored), named by the sha256
of both sources, so an edited source rebuilds and unchanged ones are
reused; then it is loaded with ctypes. There is no fallback: a failed
build or load raises RuntimeError with the compiler's output, and so
does a block the library refuses. The first load under a provider's
recorder is booked there as one "batchprep" build event
(common/devicecost.py `build_seam`).
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

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = (os.path.join(_CSRC, "batchprep.cpp"),
           os.path.join(_CSRC, "blockprep.cpp"))

_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C,WRITEABLE")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C,WRITEABLE")
_I64 = np.ctypeslib.ndpointer(np.int64, flags="C,WRITEABLE")
# C function -> (argtypes, restype)
FUNCTIONS = {
    # der, der_len, r, rpn, w -> 1 when the lane is accepted
    "ftpu_prep_one": ([ctypes.c_char_p, ctypes.c_int32, _U8, _U8, _U8],
                      ctypes.c_int),
    # ptrs, lens, n, r, rpn, w, ok
    "ftpu_batch_prep_ptrs": ([ctypes.POINTER(ctypes.c_char_p),
                              np.ctypeslib.ndpointer(np.int32, flags="C"),
                              ctypes.c_int32, _U8, _U8, _U8, _U8], None),
    # see csrc/blockprep.cpp: -> unique identities, or -1 on bad arguments
    "ftpu_block_prep": ([
        ctypes.POINTER(ctypes.c_char_p),               # envs
        np.ctypeslib.ndpointer(np.int64, flags="C"),   # env_lens
        ctypes.c_int32,                                # n
        ctypes.c_char_p, ctypes.c_int32,               # channel_id
        ctypes.c_int32,                                # max_e
        _I32, _I64, _I32, _I32, _I64, _I32,            # status..csig
        _U8,                                           # payload_digest
        _I64, _I32, _I64, _I32, _I64, _I32,            # txid, config, ccname
        _I64, _I32, _I64, _I32,                        # results, prp
        _I32, _I32, _I64, _I32,                        # rw_mode/nkeys/keys
        _I32,                                          # e_count
        _I64, _I32, _I32, _I64, _I32,                  # e_ident, e_uid, e_sig
        _U8,                                           # e_digest
        _U8, _U8, _U8, _U8,                            # c_r/rpn/w/ok
        _U8, _U8, _U8, _U8,                            # e_r/rpn/w/ok
        _I32, _I64, _I32,                              # uid table
    ], ctypes.c_int32),
}

# ftpu_block_prep's status values (csrc/blockprep.cpp)
BP_OK_ENDORSER = 0
BP_OK_CONFIG = 1
BP_NEEDS_PYTHON = 2
BP_FAIL_BASE = 100          # + TxValidationCode

# rw_mode values (csrc/blockprep.cpp scan_results)
RW_PLAIN = 1                # clean parse, only simple public writes
RW_RICH = 2                 # clean parse, features for the per-tx walk
RW_UNPARSED = 3             # not clean: the per-tx parser decides
MAX_K = 16                  # plain written keys per tx in the flat table

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def library_path() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(torchenv.BUILD_DIR,
                        f"libbatchprep-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources unless their library is current; returns the
    library path. Raises RuntimeError when the compiler fails."""
    lib = library_path()
    if os.path.exists(lib):
        return lib
    os.makedirs(torchenv.BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.tmp{os.getpid()}"
    cmd = [*shlex.split(os.environ.get("CXX") or "g++"), "-O3", "-shared",
           "-fPIC", "-o", tmp, *SOURCES, "-lpthread"]
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


class BlockPrep:
    """Flat per-tx arrays from one native pass over a block.

    Every offset is local to that tx's envelope bytes; identity uids
    index the block's unique identities (`unique_identity`), -1 where
    absent. `status` is BP_OK_ENDORSER, BP_OK_CONFIG, BP_NEEDS_PYTHON
    (the native parser does not decide the tx: the caller's per-tx path
    does) or BP_FAIL_BASE + a TxValidationCode; csrc/blockprep.cpp states
    the clean-parse contract."""

    __slots__ = (
        "envs", "status", "creator_off", "creator_len", "creator_uid",
        "csig_off", "csig_len", "payload_digest", "txid_off",
        "txid_len", "config_off", "config_len", "ccname_off",
        "ccname_len", "results_off", "results_len", "prp_off",
        "prp_len", "rw_mode", "rw_nkeys", "rw_key_off", "rw_key_len",
        "e_count", "e_ident_off", "e_ident_len", "e_uid",
        "e_sig_off", "e_sig_len", "e_digest", "c_r", "c_rpn", "c_w",
        "c_ok", "e_r", "e_rpn", "e_w", "e_ok", "n_unique", "uid_env",
        "uid_off", "uid_len")

    def slice(self, i: int, off_a, len_a) -> bytes:
        o = int(off_a[i])
        return self.envs[i][o:o + int(len_a[i])]

    def unique_identity(self, uid: int) -> bytes:
        env = self.envs[int(self.uid_env[uid])]
        o = int(self.uid_off[uid])
        return env[o:o + int(self.uid_len[uid])]


def block_prep(envs, channel_id: str, max_e: int = 8) -> BlockPrep:
    """One native pass over a block's envelopes (bytes): wire-format
    field extraction, digest lanes, identity dedup and DER signature
    staging. Raises RuntimeError where the library refuses the call
    (max_e outside 1..64)."""
    lib = load()
    envs = [bytes(e) for e in envs]
    n = len(envs)
    bp = BlockPrep()
    bp.envs = envs
    # the pointer table points into `envs`, which the BlockPrep keeps
    arr = (ctypes.c_char_p * max(n, 1))(*envs)
    env_lens = np.array([len(e) for e in envs], dtype=np.int64)
    bp.status = np.zeros(n, dtype=np.int32)
    for name in ("creator", "csig", "txid", "config", "ccname",
                 "results", "prp"):
        setattr(bp, name + "_off", np.zeros(n, dtype=np.int64))
        setattr(bp, name + "_len", np.zeros(n, dtype=np.int32))
    bp.creator_uid = np.full(n, -1, dtype=np.int32)
    bp.payload_digest = np.zeros((n, 32), dtype=np.uint8)
    bp.rw_mode = np.zeros(n, dtype=np.int32)
    bp.rw_nkeys = np.zeros(n, dtype=np.int32)
    bp.rw_key_off = np.zeros((n, MAX_K), dtype=np.int64)
    bp.rw_key_len = np.zeros((n, MAX_K), dtype=np.int32)
    bp.e_count = np.zeros(n, dtype=np.int32)
    bp.e_ident_off = np.zeros((n, max_e), dtype=np.int64)
    bp.e_ident_len = np.zeros((n, max_e), dtype=np.int32)
    bp.e_uid = np.full((n, max_e), -1, dtype=np.int32)
    bp.e_sig_off = np.zeros((n, max_e), dtype=np.int64)
    bp.e_sig_len = np.zeros((n, max_e), dtype=np.int32)
    bp.e_digest = np.zeros((n, max_e, 32), dtype=np.uint8)
    bp.c_r = np.zeros((n, 32), dtype=np.uint8)
    bp.c_rpn = np.zeros((n, 32), dtype=np.uint8)
    bp.c_w = np.zeros((n, 32), dtype=np.uint8)
    bp.c_ok = np.zeros(n, dtype=np.uint8)
    bp.e_r = np.zeros((n, max_e, 32), dtype=np.uint8)
    bp.e_rpn = np.zeros((n, max_e, 32), dtype=np.uint8)
    bp.e_w = np.zeros((n, max_e, 32), dtype=np.uint8)
    bp.e_ok = np.zeros((n, max_e), dtype=np.uint8)
    cap = max(n * (max_e + 1), 1)
    bp.uid_env = np.zeros(cap, dtype=np.int32)
    bp.uid_off = np.zeros(cap, dtype=np.int64)
    bp.uid_len = np.zeros(cap, dtype=np.int32)
    chan = channel_id.encode()
    bp.n_unique = lib.ftpu_block_prep(
        arr, env_lens, n, chan, len(chan), max_e,
        bp.status, bp.creator_off, bp.creator_len, bp.creator_uid,
        bp.csig_off, bp.csig_len, bp.payload_digest,
        bp.txid_off, bp.txid_len, bp.config_off, bp.config_len,
        bp.ccname_off, bp.ccname_len, bp.results_off, bp.results_len,
        bp.prp_off, bp.prp_len,
        bp.rw_mode, bp.rw_nkeys, bp.rw_key_off, bp.rw_key_len,
        bp.e_count,
        bp.e_ident_off, bp.e_ident_len, bp.e_uid,
        bp.e_sig_off, bp.e_sig_len, bp.e_digest,
        bp.c_r, bp.c_rpn, bp.c_w, bp.c_ok,
        bp.e_r, bp.e_rpn, bp.e_w, bp.e_ok,
        bp.uid_env, bp.uid_off, bp.uid_len)
    if bp.n_unique < 0:
        raise RuntimeError(f"native block prep refused the block (n={n}, "
                           f"max_e={max_e})")
    return bp
