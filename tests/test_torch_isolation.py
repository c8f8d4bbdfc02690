"""The port imports neither jax nor anything of fabric_tpu.

In a fresh interpreter whose import system refuses `jax`, `fabric_tpu`
and their submodules (an exact-name match, not a prefix:
fabric_tpu_torch shares the prefix), every module of fabric_tpu_torch
and chip_smoke.py must import.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import importlib, importlib.abc, os, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "fabric_tpu")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Block())
root = sys.argv[1]
sys.path.insert(0, root)
import fabric_tpu_torch

names = ["fabric_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(fabric_tpu_torch.__path__,
                                          "fabric_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("ops.verify", "ops.mont", "ops.ed25519", "bccsp.ed25519_host",
             "ops.tower", "ops.bn254", "ops.bn254_ref", "ops.bls12_381_ref",
             "ops.bls12_381", "ops.bls12_381_kernel"):
    assert "fabric_tpu_torch." + name in names, name
importlib.import_module("chip_smoke")
leaked = [m for m in sys.modules
          if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
assert not leaked, leaked
try:
    import fabric_tpu  # noqa: F401
except ImportError:
    pass
else:
    raise AssertionError("the blocker let fabric_tpu through")
print("imported", len(names), "modules")
"""


def test_port_imports_without_jax_or_fabric_tpu():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _CHILD, ROOT], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    n = int(out.stdout.split()[1])
    # __init__, kernels, stage_a_timing, ladder_timing, common.torchenv,
    # ops.{limb,p256,comb,ptree,sha256,fused_verify,verify,mont,ed25519,
    # tower,bn254,bn254_ref,bls12_381_ref,bls12_381,bls12_381_kernel},
    # bccsp.{bccsp,utils,p256_host,ed25519_host,sw,cuda,factory} and the
    # subpackages
    assert n >= 30, out.stdout
