"""fabric_tpu_torch.ops.fused_verify (stage A and the fused tier) against
fabric_tpu.

On the CPU every wrapper runs its plain torch version. Stage A, both
entries (message lanes and digest lanes), is held to hashlib and to the
JAX package's eager limb functions (`words_be_to_limbs`,
`FN.mulmod`/`canonical`, `comb._windows`) at 8 and 16 bits, with digest
lanes of e = 0 and e >= n, w = 1, w = n - 1 and r = 1; the tiered,
digest-lane and resident pipelines to the port's comb-digest verdicts
over hashlib digests and the bitmap known by construction. The JAX
package's Pallas functions themselves, interpreted, are `slow`.
Inputs are seeded numpy arrays; tolerance: exact equality. The CUDA
kernels are held to these plain versions by tests/test_torch_cuda.py
and chip_smoke.py on the card.
"""

import hashlib
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fabric_tpu.ops import comb as jcomb
from fabric_tpu.ops import fused_verify as jfv
from fabric_tpu.ops import limb as jlimb
from fabric_tpu.ops import p256 as jp256

from fabric_tpu_torch import kernels
from fabric_tpu_torch.bccsp import p256_host, utils
from fabric_tpu_torch.ops import comb as tcomb
from fabric_tpu_torch.ops import fused_verify as tfv
from fabric_tpu_torch.ops import limb as tlimb
from fabric_tpu_torch.ops import p256 as tp256
from fabric_tpu_torch.ops import ptree as tptree
from fabric_tpu_torch.ops import sha256 as tsha
from tests.test_torch_comb import _point, _q8_ints

N, P = jp256.N, jp256.P
EDGE_LENS = (0, 1, 55, 56, 63, 64, 119, 120, 503)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _be32(x: int) -> np.ndarray:
    return np.frombuffer(x.to_bytes(32, "big"), np.uint8)


@pytest.fixture(scope="module")
def stage():
    """24 lanes at NB = 8: the edge message lengths, random ones, garbage
    past every count; digest lanes with digest 0 (e = 0), all-ones
    (e >= n) and a random one; w = 1, w = n - 1, r = 1."""
    rng = np.random.default_rng(31)
    B, nb = 24, 8
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, 504, size=B)]
    for j, n in enumerate(EDGE_LENS):
        msgs[j] = rng.bytes(n)
    blocks, counts = tsha.pack_messages(msgs, nb)
    past = np.arange(nb)[None, :] >= counts[:, None]
    blocks[past] = rng.integers(0, 1 << 32, size=(int(past.sum()), 16),
                                dtype=np.uint32)
    has = np.zeros(B, bool)
    has[[9, 10, 11]] = True
    dig = np.zeros((B, 8), np.uint32)
    dig[10] = 0xFFFFFFFF
    dig[11] = rng.integers(0, 1 << 32, size=8, dtype=np.uint32)
    nblocks = np.where(has, 0, counts).astype(np.int32)
    rs = [int.from_bytes(rng.bytes(32), "big") % N for _ in range(B)]
    ws = [int.from_bytes(rng.bytes(32), "big") % N for _ in range(B)]
    ws[12], ws[13], rs[14] = 1, N - 1, 1
    words = np.stack([np.frombuffer(hashlib.sha256(m).digest(), ">u4")
                      for m in msgs]).astype(np.uint32)
    words[has] = dig[has]
    return dict(blocks=blocks, nblocks=nblocks, dig=dig, has=has,
                r=jlimb.ints_to_limbs(rs), w=jlimb.ints_to_limbs(ws),
                r8=np.stack([_be32(x) for x in rs]),
                w8=np.stack([_be32(x) for x in ws]),
                rs=rs, ws=ws, words=words)


def _stage_args(st):
    return (torch.from_numpy(st["blocks"]), torch.from_numpy(st["nblocks"]),
            torch.from_numpy(st["dig"]), torch.from_numpy(st["has"]),
            torch.from_numpy(st["r8"]), torch.from_numpy(st["w8"]))


def test_consts_match_jax():
    """The mod-n constants the plain versions run on, and the SHA
    constants the kernels carry as compile-time words."""
    np.testing.assert_array_equal(tptree.KMod(tp256.FN).pack_consts(),
                                  jfv._fnk().pack_consts())
    np.testing.assert_array_equal(tsha.sha_consts(), jfv._sha_consts())


@pytest.mark.parametrize("wbits", [8, 16])
def test_stage_a_matches_jax_eager_and_ints(stage, wbits):
    before = tfv.sha_windows_launches
    w1, w2, words = tfv.sha_windows(*_stage_args(stage), wbits_g=wbits,
                                    wbits_q=wbits)
    assert tfv.sha_windows_launches == before   # the plain version
    assert w1.shape == w2.shape == (24, 256 // wbits)
    assert words.dtype == torch.int64
    np.testing.assert_array_equal(words.numpy(), stage["words"])
    e = jlimb.words_be_to_limbs(jnp.asarray(stage["words"]))
    w = jnp.asarray(stage["w"])
    u1 = jp256.FN.canonical(jp256.FN.mulmod(e, w))
    u2 = jp256.FN.canonical(jp256.FN.mulmod(jnp.asarray(stage["r"]), w))
    np.testing.assert_array_equal(w1.numpy(),
                                  np.asarray(jcomb._windows(u1, wbits)))
    np.testing.assert_array_equal(w2.numpy(),
                                  np.asarray(jcomb._windows(u2, wbits)))
    mask = (1 << wbits) - 1
    for i in (9, 10, 11, 12, 13, 14):
        ev = int.from_bytes(stage["words"][i].astype(">u4").tobytes(), "big")
        for got, u in ((w1[i], ev * stage["ws"][i] % N),
                       (w2[i], stage["rs"][i] * stage["ws"][i] % N)):
            assert got.tolist() == [(u >> (wbits * k)) & mask
                                    for k in range(256 // wbits)], i
    assert int.from_bytes(stage["words"][10].astype(">u4").tobytes(),
                          "big") >= N


@pytest.mark.parametrize("wbits", [8, 16])
def test_digest_windows_matches_jax_eager_and_ints(stage, wbits):
    """The digest-lanes entry (every lane takes its digest): the stage's
    words as digests, lane 15's digest n itself (e = n, so u1 = 0)."""
    words = stage["words"].copy()
    words[15] = np.frombuffer(N.to_bytes(32, "big"), ">u4")
    before = tfv.sha_windows_launches
    w1, w2 = tfv.digest_windows(torch.from_numpy(words.view(np.int32)),
                                torch.from_numpy(stage["r8"]),
                                torch.from_numpy(stage["w8"]),
                                wbits_g=wbits, wbits_q=wbits)
    assert tfv.sha_windows_launches == before   # the plain version
    assert w1.shape == w2.shape == (24, 256 // wbits)
    e = jlimb.words_be_to_limbs(jnp.asarray(words.astype(np.int64)))
    w = jnp.asarray(stage["w"])
    u1 = jp256.FN.canonical(jp256.FN.mulmod(e, w))
    u2 = jp256.FN.canonical(jp256.FN.mulmod(jnp.asarray(stage["r"]), w))
    np.testing.assert_array_equal(w1.numpy(),
                                  np.asarray(jcomb._windows(u1, wbits)))
    np.testing.assert_array_equal(w2.numpy(),
                                  np.asarray(jcomb._windows(u2, wbits)))
    mask = (1 << wbits) - 1
    for i in (9, 10, 11, 12, 13, 14, 15):
        ev = int.from_bytes(words[i].astype(">u4").tobytes(), "big")
        for got, u in ((w1[i], ev * stage["ws"][i] % N),
                       (w2[i], stage["rs"][i] * stage["ws"][i] % N)):
            assert got.tolist() == [(u >> (wbits * k)) & mask
                                    for k in range(256 // wbits)], i
    assert not w1[15].any()


@pytest.mark.parametrize("wbits", [(16, 8), (8, 16)])
def test_mixed_window_widths_rejected(stage, wbits):
    """No route pairs G16 with Q8 or G8 with Q16, so the wrapper (and the
    kernel, built for 8/8 and 16/16 only) refuses mixed widths."""
    with pytest.raises(ValueError, match="8/8 or 16/16"):
        tfv.sha_windows(*_stage_args(stage), wbits_g=wbits[0],
                        wbits_q=wbits[1])


def test_wrappers_reject_bad_inputs(stage):
    args = list(_stage_args(stage))
    with pytest.raises(ValueError):
        tfv.sha_windows(*args, wbits_g=12)
    for i, bad in ((2, args[2][:, :7]), (3, args[3].to(torch.int32)),
                   (4, args[4].to(torch.int64)), (5, args[5][:3])):
        a = list(args)
        a[i] = bad
        with pytest.raises((ValueError, TypeError)):
            tfv.sha_windows(*a)
    with pytest.raises(ValueError):
        tfv.sha_windows(*(t.to("meta") for t in args))
    dig, r8, w8 = args[2], args[4], args[5]
    for bad in ((dig.to(torch.int64), r8, w8), (dig, r8[:, :20], w8),
                (dig, r8, w8[:3])):
        with pytest.raises((ValueError, TypeError)):
            tfv.digest_windows(*bad)
    with pytest.raises(ValueError, match="8/8 or 16/16"):
        tfv.digest_windows(dig, r8, w8, wbits_g=16, wbits_q=8)


def test_resident_table_bytes_and_budget():
    for K in (1, 2, 4, 8, 16):
        assert tfv.resident_table_bytes(K) == jfv.resident_table_bytes(K)
    # half of the H100's L2: key sets of up to 8 keys qualify
    assert tfv.resident_table_bytes(8) <= tfv.RESIDENT_TABLE_BUDGET
    assert tfv.resident_table_bytes(16) > tfv.RESIDENT_TABLE_BUDGET


def test_library_names_follow_included_headers(tmp_path, monkeypatch):
    """A kernel library is named by its source and every csrc/ header it
    includes, so an edited header rebuilds every library that uses it."""
    src = tmp_path / "csrc"
    shutil.copytree(kernels._CSRC, src)
    monkeypatch.setattr(kernels, "_CSRC", str(src))
    assert {os.path.basename(f) for f in kernels.sources("fused_resident")} \
        == {"fused_resident.cu", "stage_a.cuh", "modn32.cuh", "sha256.cuh",
            "tree_sum.cuh", "p256_field.cuh"}

    def names():
        return {k: kernels._paths(k)[1] for k in kernels.KERNELS}

    first = names()
    assert names() == first
    with open(src / "sha256.cuh", "a") as f:
        f.write("\n// edited\n")
    second = names()
    assert second["ptree"] == first["ptree"]
    assert second["sha_windows"] != first["sha_windows"]
    assert second["fused_resident"] != first["fused_resident"]
    with open(src / "modn32.cuh", "a") as f:
        f.write("\n// edited\n")
    third = names()
    assert third["ptree"] == second["ptree"]
    for k in ("sha_windows", "fused_resident", "field_selftest"):
        assert third[k] != second[k]
    with open(src / "p256_field.cuh", "a") as f:
        f.write("\n// edited\n")
    fourth = names()
    uses = {k for k in kernels.KERNELS if "p256_field.cuh" in {
        os.path.basename(f) for f in kernels.sources(k)}}
    assert uses >= {"ptree", "sha_windows", "fused_resident",
                    "field_selftest", "ladder", "ed25519_verify"}
    assert all((fourth[k] != third[k]) == (k in uses)
               for k in kernels.KERNELS)


# -- the whole tier over signed lanes --

D_KEYS = (0x51A5, 0xC0FFEE, 0x7E57AB1E)


@pytest.fixture(scope="module")
def verify_case():
    """48 lanes over 3 keys (K = 4; slot 3 a copy of slot 0): message
    lanes of assorted lengths and digest lanes; valid, tampered message,
    wrong key, high-S (premask off), r + 1; the int-built q8 table."""
    rng = np.random.default_rng(77)
    keys = [jp256.to_affine_int(_point(d)) for d in D_KEYS]
    q8 = torch.as_tensor(_q8_ints(keys + keys[:1]))
    B = 48
    msgs, want = [], []
    blocks_msgs = []
    r8, rpn8, w8 = (np.zeros((B, 32), np.uint8) for _ in range(3))
    key_idx = np.zeros(B, np.int32)
    premask = np.zeros(B, bool)
    has = np.zeros(B, bool)
    dig = np.zeros((B, 8), np.uint32)
    for i in range(B):
        k = i % 3
        msg = rng.bytes(int(rng.integers(0, 300)))
        digest = hashlib.sha256(msg).digest()
        r, s = p256_host.sign(D_KEYS[k], digest)
        s = utils.to_low_s(s)
        kind = i % 6
        if kind == 1:
            msg = msg + b"!"
        elif kind == 2:
            k = (k + 1) % 3
        elif kind == 3:
            s = N - s
        elif kind == 4:
            r = (r + 1) % N
        msgs.append(msg)
        key_idx[i] = k
        premask[i] = utils.is_low_s(s)
        rpn = r + N if r + N < P else r
        r8[i], rpn8[i], w8[i] = _be32(r), _be32(rpn), _be32(pow(s, -1, N))
        if i % 4 == 3:
            has[i] = True
            dig[i] = np.frombuffer(hashlib.sha256(msg).digest(), ">u4")
        blocks_msgs.append(b"" if has[i] else msg)
        want.append(kind in (0, 5))
    blocks, counts = tsha.pack_messages(blocks_msgs, 8)
    nblocks = np.where(has, 0, counts).astype(np.int32)
    words = np.stack([np.frombuffer(hashlib.sha256(m).digest(), ">u4")
                      for m in msgs]).astype(np.int64)
    t = torch.from_numpy
    return dict(args=(t(blocks), t(nblocks), t(key_idx), q8, t(r8), t(rpn8),
                      t(w8), t(premask), t(dig), t(has)),
                words=t(words), want=np.array(want),
                g8=tcomb.g_tables_on("cpu"))


def _comb_digest(case):
    """The port's comb-digest verdicts over hashlib digests."""
    _, _, key_idx, q8, r8, rpn8, w8, premask, _, _ = case["args"]
    r, rpn, w = (tlimb.be_bytes_to_limbs(x) for x in (r8, rpn8, w8))
    return tcomb.comb_verify_with_tables(case["words"], key_idx, q8, r, rpn,
                                         w, premask, g_flat=case["g8"])


def test_digest_verify_with_tables_matches_comb_digest(verify_case):
    """The commit path's function (digest lanes, byte scalars) on every
    lane's hashlib digest: the comb-digest verdicts and the bitmap."""
    _, _, key_idx, q8, r8, rpn8, w8, premask, _, _ = verify_case["args"]
    digests = verify_case["words"].to(torch.int32)
    before = (tfv.sha_windows_launches, tptree.launches)
    got = tfv.digest_verify_with_tables(digests, key_idx, q8, r8, rpn8, w8,
                                        premask, g_flat=verify_case["g8"])
    assert (tfv.sha_windows_launches, tptree.launches) == before
    assert torch.equal(got, _comb_digest(verify_case))
    np.testing.assert_array_equal(got.numpy(), verify_case["want"])


def test_fused_verify_with_tables_matches_comb_digest(verify_case):
    got = tfv.fused_verify_with_tables(*verify_case["args"],
                                       g_flat=verify_case["g8"])
    want = _comb_digest(verify_case)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), verify_case["want"])
    assert verify_case["want"].any() and not verify_case["want"].all()


def test_fused_verify_resident_matches_comb_digest(verify_case):
    before = tfv.resident_launches
    got = tfv.fused_verify_resident(*verify_case["args"],
                                    g_flat=verify_case["g8"])
    assert tfv.resident_launches == before
    np.testing.assert_array_equal(got.numpy(), verify_case["want"])
    # a key slot outside [0, K) rejects instead of reading past the table
    args = list(verify_case["args"])
    args[2] = args[2].clone()
    args[2][0], args[2][6] = 4, -1
    got = tfv.fused_verify_resident(*args, g_flat=verify_case["g8"])
    want = verify_case["want"].copy()
    want[[0, 6]] = False
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        tfv.fused_verify_resident(*verify_case["args"][:3],
                                  verify_case["args"][3][:100],
                                  *verify_case["args"][4:])


# -- the JAX package's Pallas functions, interpreted (slow on the CPU) --

def _jax_args(case):
    blocks, nblocks, key_idx, q8, r8, rpn8, w8, premask, dig, has = \
        case["args"]
    return (jnp.asarray(blocks.numpy()), jnp.asarray(nblocks.numpy()),
            jnp.asarray(key_idx.numpy()), jnp.asarray(q8.numpy()),
            jnp.asarray(r8.numpy()), jnp.asarray(rpn8.numpy()),
            jnp.asarray(w8.numpy()), jnp.asarray(premask.numpy()),
            jnp.asarray(dig.numpy()), jnp.asarray(has.numpy()))


@pytest.mark.slow
@pytest.mark.parametrize("wbits", [8, 16])
def test_sha_windows_matches_jax_interpret(stage, wbits):
    jargs = [jnp.asarray(np.asarray(t)) for t in _stage_args(stage)[:4]]
    want = jfv.sha_windows(
        *jargs, jnp.asarray(stage["r"]), jnp.asarray(stage["w"]),
        wbits_g=wbits, wbits_q=wbits, interpret=True, block_b=128)
    got = tfv.sha_windows(*_stage_args(stage), wbits_g=wbits, wbits_q=wbits)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.slow
def test_fused_verify_with_tables_matches_jax(verify_case):
    want = jfv.fused_verify_with_tables(*_jax_args(verify_case), tree="xla",
                                        interpret=True, block_b=128)
    got = tfv.fused_verify_with_tables(*verify_case["args"],
                                       g_flat=verify_case["g8"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.slow
def test_fused_verify_resident_matches_jax(verify_case):
    want = jfv.fused_verify_resident(*_jax_args(verify_case),
                                     interpret=True, block_b=128)
    got = tfv.fused_verify_resident(*verify_case["args"],
                                    g_flat=verify_case["g8"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
