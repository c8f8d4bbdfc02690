"""Build and bind the port's hand-written CUDA kernels.

Each source under csrc/ is compiled by `nvcc` for sm_90a into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) and loaded with ctypes. Libraries land in
fabric_tpu_torch/_build/ (git-ignored), named by the sha256 of their
source and of every csrc/ header it includes (transitively), so an
edited source or header rebuilds and an unchanged one is reused.
`nvcc -Xptxas -v` reports registers, stack and spills; each build writes
that report beside the library as <name>.ptxas.log, which
`ptxas_summary` reads per kernel.

Nothing here runs at import: `load` builds on first use, and
`build_all` (a provider's prewarm, chip_smoke.py) builds and loads every
library, one nvcc per source, all at once. Both pass each library through
the port's build seam (the reference's `TPUProvider._jit`): the first
load of a library under a provider's recorder is booked there as one
build event (common/devicecost.py `build_seam`), cold when nvcc wrote
the library, a hit when it was reused.
`check_args` and `launch` are the wrappers' shared argument checks and
ctypes call.
`sass_mix` counts a built library's SASS instructions by opcode
(`cuobjdump -sass`), the instruction mix PERF.md reads.
"""

from __future__ import annotations

import contextvars
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

from fabric_tpu_torch.common import devicecost, torchenv

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

# kernel name -> (source file, {C function: (argtypes, restype)})
_VOIDP, _INT = ctypes.c_void_p, ctypes.c_int
KERNELS = {
    "ptree": ("ptree.cu", {
        # pts, r, rpn, premask, out, B, M, T, stream -> cudaError_t
        "ptree_verify_launch": ([_VOIDP] * 5 + [_INT] * 3 + [_VOIDP], _INT),
        # w1, w2, key_idx, g_tab, q_tab, r, rpn, premask, out, B, K,
        # wbits_g, wbits_q, T, stream -> cudaError_t
        "ptree_windows_launch": ([_VOIDP] * 9 + [_INT] * 5 + [_VOIDP], _INT),
        "ptree_error_string": ([_INT], ctypes.c_char_p),
    }),
    "field_selftest": ("field_selftest.cu", {
        # a13, b13, n_ops, p13, q13, n_add, out_ops, out_add, stream
        "field_selftest_launch": ([_VOIDP] * 2 + [_INT] + [_VOIDP] * 2
                                  + [_INT] + [_VOIDP] * 3, _INT),
        # e, r8, w8, n, out, stream
        "modn_selftest_launch": ([_VOIDP] * 3 + [_INT] + [_VOIDP] * 2, _INT),
        # p13, n, out, stream
        "dbl_selftest_launch": ([_VOIDP, _INT, _VOIDP, _VOIDP], _INT),
        # a, b, n, out, stream: the 2^255 - 19 core
        "f25_selftest_launch": ([_VOIDP] * 2 + [_INT] + [_VOIDP] * 2, _INT),
        # p, q, n, out, stream: ed_add and ed_dbl
        "ed_selftest_launch": ([_VOIDP] * 2 + [_INT] + [_VOIDP] * 2, _INT),
        "field_selftest_error_string": ([_INT], ctypes.c_char_p),
    }),
    "sha_windows": ("sha_windows.cu", {
        # blocks, nblocks, digests, has_digest, r8, w8, w1, w2, words, B,
        # NB, wbits_g, wbits_q, stream -> cudaError_t
        "sha_windows_launch": ([_VOIDP] * 9 + [_INT] * 4 + [_VOIDP], _INT),
        # digests, r8, w8, w1, w2, B, wbits_g, wbits_q, stream
        "digest_windows_launch": ([_VOIDP] * 5 + [_INT] * 3 + [_VOIDP],
                                  _INT),
        # blocks, nblocks, words, B, NB, stream -> cudaError_t
        "sha256_digest_launch": ([_VOIDP] * 3 + [_INT] * 2 + [_VOIDP], _INT),
        "sha_windows_error_string": ([_INT], ctypes.c_char_p),
    }),
    "fused_resident": ("fused_resident.cu", {
        # blocks, nblocks, digests, has_digest, key_idx, r8, rpn8, w8,
        # premask, g_tab, q_tab, out, B, NB, K, T, stream -> cudaError_t
        "fused_resident_launch": ([_VOIDP] * 12 + [_INT] * 4 + [_VOIDP],
                                  _INT),
        "fused_resident_error_string": ([_INT], ctypes.c_char_p),
    }),
    "ladder": ("ladder.cu", {
        # digests, q8, r8, rpn8, w8, premask, out, B, stream
        "ladder_digest_launch": ([_VOIDP] * 7 + [_INT] + [_VOIDP], _INT),
        "ladder_error_string": ([_INT], ctypes.c_char_p),
    }),
    "ed25519_verify": ("ed25519_verify.cu", {
        # s8, k8, anx8, ay8, rx8, ry8, premask, tab, out, B, stream
        "ed25519_verify_launch": ([_VOIDP] * 9 + [_INT] + [_VOIDP], _INT),
        "ed25519_verify_error_string": ([_INT], ctypes.c_char_p),
    }),
    "bn254_pairing": ("bn254_pairing.cu", {
        # pts, consts, out, B, bits_lo, bits_hi, nbits, group, stream
        "bn254_miller_launch": ([_VOIDP] * 3 + [_INT] * 5 + [_VOIDP], _INT),
        # f, consts, prog, nrows, cyc_from, gt, ok, nterms, B, group, stream
        "bn254_final_exp_launch": ([_VOIDP] * 3 + [_INT] * 2 + [_VOIDP] * 2
                                   + [_INT] * 3 + [_VOIDP], _INT),
        # a, b, consts, n, out, stream: the BN254 core
        "bn_fp_selftest_launch": ([_VOIDP] * 3 + [_INT] + [_VOIDP] * 2,
                                  _INT),
        # cases, consts, n, out, stream: the BN254 tower and twist steps
        "bn_tower_selftest_launch": ([_VOIDP] * 2 + [_INT] + [_VOIDP] * 2,
                                     _INT),
        # cases, consts, n, out, stream: the cooperative layer on BN254
        "bn_coop_selftest_launch": ([_VOIDP] * 2 + [_INT] + [_VOIDP] * 2,
                                    _INT),
        "bn254_pairing_error_string": ([_INT], ctypes.c_char_p),
    }),
    "bls12_381_pairing": ("bls12_381_pairing.cu", {
        # pts, mask, consts, out, B, bits_lo, bits_hi, nbits, stream
        "bls_miller_launch": ([_VOIDP] * 4 + [_INT] * 4 + [_VOIDP], _INT),
        # f (in place), consts, nodes, cnt, B, stream
        "bls_reduce_launch": ([_VOIDP] * 4 + [_INT] + [_VOIDP], _INT),
        # f, consts, prog, nrows, cyc_from, gt, ok, B, stream
        "bls_final_exp_launch": ([_VOIDP] * 3 + [_INT] * 2 + [_VOIDP] * 2
                                 + [_INT, _VOIDP], _INT),
        # a, b, consts, n, out, stream: the 381-bit core
        "bls_fp_selftest_launch": ([_VOIDP] * 3 + [_INT] + [_VOIDP] * 2,
                                   _INT),
        # cases, consts, n, out, stream: the BLS12-381 tower
        "bls_tower_selftest_launch": ([_VOIDP] * 2 + [_INT] + [_VOIDP] * 2,
                                      _INT),
        # cases, consts, n, out, stream: the cooperative layer
        "bls_coop_selftest_launch": ([_VOIDP] * 2 + [_INT] + [_VOIDP] * 2,
                                     _INT),
        "bls12_381_pairing_error_string": ([_INT], ctypes.c_char_p),
    }),
    "g2_msm": ("g2_msm.cu", {
        # k words, q, consts, scratch, out, B, nterms, nbits, stream
        "g2_msm_launch": ([_VOIDP] * 5 + [_INT] * 3 + [_VOIDP], _INT),
        # B, nterms -> the bytes of the scratch g2_msm_launch takes
        "g2_msm_scratch_bytes": ([_INT, _INT], ctypes.c_longlong),
        "g2_msm_error_string": ([_INT], ctypes.c_char_p),
    }),
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: dict = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "build on a machine with the CUDA toolkit")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def sources(name: str) -> list[str]:
    """Kernel `name`'s source and every file it includes with
    `#include "..."` (relative to the including file), transitively."""
    out: list[str] = []
    todo = [os.path.join(_CSRC, KERNELS[name][0])]
    while todo:
        path = os.path.normpath(todo.pop())
        if path in out:
            continue
        out.append(path)
        with open(path, "rb") as f:
            incs = _INCLUDE.findall(f.read())
        todo += [os.path.join(os.path.dirname(path), i.decode())
                 for i in incs]
    return out


def library_path(name: str) -> str:
    """Where kernel `name`'s current library is (or will be) built."""
    return _paths(name)[1]


def _paths(name: str) -> tuple[str, str, str]:
    srcs = sources(name)
    src = srcs[0]
    h = hashlib.sha256()
    for path in sorted(srcs):
        with open(path, "rb") as f:
            data = f.read()
        h.update(os.path.relpath(path, _CSRC).encode() + b"\0")
        h.update(hashlib.sha256(data).digest())
    digest = h.hexdigest()[:16]
    lib = os.path.join(torchenv.BUILD_DIR, f"lib{name}-{digest}.so")
    log = os.path.join(torchenv.BUILD_DIR, f"{name}.ptxas.log")
    return src, lib, log


def _start(name: str):
    """Start nvcc for `name` unless its library is current; returns
    (process or None, tmp path, lib path, log path)."""
    src, lib, log = _paths(name)
    if os.path.exists(lib):
        return None, None, lib, log
    os.makedirs(torchenv.BUILD_DIR, exist_ok=True)
    # one name per thread: a load and build_all may build one library
    # side by side
    tmp = f"{lib}.tmp{os.getpid()}.{threading.get_ident()}"
    proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, lib, log


def _finish(name, proc, tmp, lib, log) -> str:
    if proc is None:
        return lib
    out, _ = proc.communicate()
    with open(log, "w") as f:
        f.write(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)
    return lib


def build(name: str) -> str:
    """Compile kernel `name` if needed; returns the library path."""
    return _finish(name, *_start(name))


def build_all() -> dict:
    """Build and load every kernel, one nvcc per source, all at once:
    each library passes the build seam in a thread of its own, under the
    caller's context, so the caller's recorder books it (build_all sets
    one of its own when the caller has none). Returns {name: {"seconds",
    "cold"}} from each library's build event in that recorder; raises
    the first failed build's error once every build has ended."""
    rec = devicecost.current() or devicecost.CompileRecorder()
    errors: dict = {}

    def one(name):
        try:
            load(name, parallel=True)
        except Exception as e:          # raised below, after the joins
            errors[name] = e

    with devicecost.recording(rec):
        # a copy of the context for each thread: threads do not inherit
        # the recorder
        threads = [threading.Thread(target=contextvars.copy_context().run,
                                    args=(one, name)) for name in KERNELS]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise next(iter(errors.values()))
    booked = {e["kind"]: e for e in rec.events
              if e["kind"] in KERNELS and e["error"] is None}
    return {name: {"seconds": booked[name]["seconds"],
                   "cold": booked[name]["cold"]}
            for name in KERNELS if name in booked}


_PTXAS_FN = re.compile(r"(?:Compiling entry function|Function properties "
                       r"for) '?([\w.$]+)'?")
_PTXAS_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_KERNEL_NAME = re.compile(
    r"\d([A-Za-z]\w*?_kernel)(?:ILi(\d+)E(?:Li(\d+)E)?)?")


def ptxas_summary(name: str) -> dict:
    """Per kernel of `name`'s last build, from `-Xptxas -v`: {kernel:
    {"registers", "stack", "spill_stores", "spill_loads"}}, a template's
    int arguments in the key ("sha_windows_kernel<8,8>",
    "bn254_miller_coop_kernel<8>")."""
    log = _paths(name)[2]
    if not os.path.exists(log):
        return {}
    out: dict = {}
    fn = None
    with open(log) as f:
        for ln in f:
            m = _PTXAS_FN.search(ln)
            if m:
                k = _KERNEL_NAME.search(m.group(1))
                args = [a for a in k.groups()[1:] if a] if k else []
                fn = m.group(1) if k is None else k.group(1) + (
                    f"<{','.join(args)}>" if args else "")
                out.setdefault(fn, {})
                continue
            m = _PTXAS_STACK.search(ln)
            if m and fn:
                out[fn].update(zip(("stack", "spill_stores", "spill_loads"),
                                   map(int, m.groups())))
            m = _PTXAS_REGS.search(ln)
            if m and fn:
                out[fn]["registers"] = int(m.group(1))
    return out


# "/*0120*/  @!P0 IMAD.WIDE.U32 R2, ..." -> "IMAD.WIDE.U32"
_SASS_OP = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+"
                      r"(?:@!?U?P\w+\s+)?([A-Z][\w.]*)")


def sass_mix(name: str, top: int = 12) -> dict:
    """The SASS instruction mix of each kernel in `name`'s built library,
    by `cuobjdump -sass` from nvcc's toolkit: {kernel: {"instructions": n,
    "top": {opcode with modifiers: count}}}. Static counts: the tree's
    loop body is one straight-line complete addition, so its mix is the
    per-addition mix."""
    exe = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    out = subprocess.run([exe, "-sass", build(name)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    mix: dict = {}
    fn = None
    for ln in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            mix[fn] = {}
            continue
        m = _SASS_OP.match(ln)
        if fn and m:
            mix[fn][m.group(1)] = mix[fn].get(m.group(1), 0) + 1
    return {f: {"instructions": sum(c.values()),
                "top": dict(sorted(c.items(), key=lambda kv: -kv[1])[:top])}
            for f, c in mix.items()}


def load(name: str, parallel: bool = False) -> ctypes.CDLL:
    """The bound library for kernel `name`, built on first use; its first
    load under a provider's recorder books one build event there.
    parallel=True runs nvcc outside the module's lock (`build_all`, one
    thread a library)."""
    return devicecost.build_seam(name, lambda: _load(name, parallel),
                                 lambda: library_path(name))


def _load(name: str, parallel: bool) -> ctypes.CDLL:
    path = build(name) if parallel else None
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(path or build(name))
            for fn, (argtypes, restype) in KERNELS[name][1].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _loaded[name] = lib
        return lib


def check_args(ref, want, what: str, aligned=()) -> None:
    """(name, tensor, shape, dtypes) rows: shapes, types and devices (ref's
    device); on the card also contiguity, and 16-byte alignment for the
    rows named in `aligned` (the kernels read them as 16-byte vectors). A
    device other than the CPU or the card has no `what` kernel."""
    for name, t, shape, dtypes in want:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, not {ref.device}")
    if ref.device.type == "cuda":
        for name, t, *_ in want:
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if name in aligned and t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
    elif ref.device.type != "cpu":
        raise ValueError(f"no {what} kernel for device {ref.device}")


def launch(dev, name: str, fn: str, *args) -> None:
    """Call library `name`'s `fn` with the tensors' pointers (None: a null
    pointer) and the ints, on `dev`'s current stream; raise if the launch
    was refused."""
    import torch

    lib = load(name)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cargs = [ctypes.c_int(a) if isinstance(a, int)
             else None if a is None else a.data_ptr() for a in args]
    with torch.cuda.device(dev):
        err = getattr(lib, fn)(*cargs, ctypes.c_void_p(stream))
    if err:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{fn} failed: CUDA error {err} ({msg})")
