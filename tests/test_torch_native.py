"""fabric_tpu_torch.native: the port's batch prep against its plain
version and the JAX package's native prep.

Every lane of every batch is held three ways, bit for bit: the port's
`native.batch_prep` (csrc/batchprep.cpp), the port's per-lane plain
version `bccsp.cuda.host_prep_scalars`, and fabric_tpu.native.batch_prep
(the JAX package's build of its own native/batchprep.cpp): the ok bit and
the r, rpn and w rows. The single-lane entry `ftpu_prep_one` (one
inversion a lane) is held to the batch entry (one inversion a batch).
"""

import hashlib

import numpy as np
import pytest
import torch

from fabric_tpu import native as jnative

from fabric_tpu_torch import native
from fabric_tpu_torch.bccsp import p256_host, sw, utils
from fabric_tpu_torch.bccsp.cuda import host_prep_scalars
from fabric_tpu_torch.common import torchenv

N = utils.P256_N
P256_P = p256_host.P
HALF = N >> 1
# any P-256 key: the gates read only its curve order
PUB = sw.ECDSAPublicKey(p256_host.GX, p256_host.GY)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lib():
    lib = native.load()
    assert jnative.available(), "the JAX package's native prep did not build"
    return lib


def _assert_parity(lib, sigs):
    ok, r, rpn, w = native.batch_prep(sigs)
    assert ok.shape == (len(sigs),) and ok.dtype == bool
    for a in (r, rpn, w):
        assert a.shape == (len(sigs), 32) and a.dtype == np.uint8
    j_ok, j_r, j_rpn, j_w = jnative.batch_prep(sigs)
    np.testing.assert_array_equal(ok, j_ok)
    for mine, ref in ((r, j_r), (rpn, j_rpn), (w, j_w)):
        np.testing.assert_array_equal(mine, ref)
    one = np.zeros((3, 32), np.uint8)
    for i, sig in enumerate(sigs):
        plain = host_prep_scalars(PUB, sig)
        assert bool(ok[i]) == (plain is not None), (i, sig.hex())
        rows = (r[i], rpn[i], w[i])
        if plain is None:
            assert not any(row.any() for row in rows), i
        else:
            assert tuple(row.tobytes() for row in rows) == plain, i
        one[:] = 0
        got = lib.ftpu_prep_one(sig, len(sig), one[0], one[1], one[2])
        assert bool(got) == bool(ok[i]), i
        if got:
            np.testing.assert_array_equal(one, np.stack(rows))
    return ok


def test_random_valid_signatures(lib):
    rng = np.random.default_rng(2026)
    sigs = []
    for i in range(64):
        d = int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1
        r, s = p256_host.sign(d, hashlib.sha256(b"m%d" % i).digest())
        sigs.append(utils.marshal_signature(r, utils.to_low_s(s)))
        # the high-S twin: every path rejects it
        sigs.append(utils.marshal_signature(r, N - utils.to_low_s(s)))
    ok = _assert_parity(lib, sigs)
    assert ok.tolist() == [True, False] * 64


ADVERSARIAL = [
    b"",
    b"\x30",
    b"\x30\x00",
    b"\x02\x01\x01",                                # no SEQUENCE
    b"\x30\x06\x02\x01\x01\x02\x01\x01",            # valid tiny r, s
    b"\x30\x06\x02\x01\x01\x02\x01\x01" + b"xx",    # trailing bytes: ok
    b"\x30\x07\x02\x01\x01\x02\x01\x01x",           # trailing inside
    b"\x30\x06\x02\x01\x00\x02\x01\x01",            # r == 0
    b"\x30\x06\x02\x01\x01\x02\x01\x00",            # s == 0
    b"\x30\x06\x02\x01\x81\x02\x01\x01",            # r negative
    b"\x30\x08\x02\x03\x00\x00\x01\x02\x01\x01",    # non-minimal r
    b"\x30\x07\x02\x02\x00\x80\x02\x01\x01",        # minimal 0x80
    utils.marshal_signature(1, HALF),               # s = n/2: accepted
    utils.marshal_signature(1, HALF + 1),           # s above it: rejected
    utils.marshal_signature(N - 1, 1),              # r = n - 1: accepted
    utils.marshal_signature(N, 1),                  # r = n: rejected
    utils.marshal_signature(N + 5, 1),              # r > n: rejected
    utils.marshal_signature(1, 1),
    utils.marshal_signature(2**256 + 7, 1),         # r wider than 256 bits
    utils.marshal_signature(P256_P - N - 1, HALF),  # rpn = r + n
    utils.marshal_signature(P256_P - N + 1, HALF),  # rpn = r
    b"\x30\x84\x00\x00\x00\x06\x02\x01\x01\x02\x01\x01",  # long-form length
    b"\x30\x81\x06\x02\x01\x01\x02\x01\x01",        # 0x81 length below 0x80
]


def test_adversarial_corpus(lib):
    ok = _assert_parity(lib, ADVERSARIAL)
    assert ok.sum() == 8


def test_fuzz_mutations(lib):
    """Bit flips of a valid signature and random bytes, seeded."""
    rng = np.random.default_rng(42)
    base = utils.marshal_signature(1234567890123456789,
                                   utils.to_low_s(987654321))
    sigs = [base]
    for _ in range(150):
        mutated = bytearray(base)
        for _ in range(int(rng.integers(1, 4))):
            mutated[int(rng.integers(len(mutated)))] ^= \
                1 << int(rng.integers(8))
        sigs.append(bytes(mutated))
    for _ in range(100):
        sigs.append(rng.bytes(int(rng.integers(0, 80))))
    _assert_parity(lib, sigs)


def test_modinv_edge_scalars(lib):
    sigs = [utils.marshal_signature(1, s)
            for s in (1, 2, 3, HALF - 1, HALF)]
    assert _assert_parity(lib, sigs).all()


@pytest.mark.parametrize("n", [0, 1])
def test_tiny_batches(lib, n):
    sigs = [utils.marshal_signature(3, 5)][:n]
    ok = _assert_parity(lib, sigs)
    assert ok.tolist() == [True] * n


@pytest.mark.parametrize("cxx", ["false", "/nonexistent/c++"])
def test_failed_build_raises(monkeypatch, tmp_path, cxx):
    """A compiler that fails, or is not there, raises RuntimeError from
    the first call: no Python prep takes its place."""
    monkeypatch.setattr(torchenv, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(RuntimeError, match="native batch prep"):
        native.batch_prep([utils.marshal_signature(3, 5)])
    assert not list((tmp_path / "build").glob("*.so"))

