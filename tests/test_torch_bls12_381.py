"""The port's BLS12-381 aggregate-verify slice (fabric_tpu_torch/ops/
bls12_381_kernel.py, bccsp/sw.py and bccsp/cuda.py's verify_aggregate)
against the JAX package, on the CPU.

  * the 30-limb M-type tower (f2_mul, f6_mul, f12_mul, f12_frob,
    line_to_f12, the twist steps with their lines) and one Miller step
    against fabric_tpu.ops.bls12_381_kernel's tower, limb for limb. The
    JAX tower runs eagerly with only its four MontMod primitives jitted
    (fixture `jit_primitives`, as tests/test_torch_tower.py does for
    BN254): fully eager, one 30-limb product takes a fraction of a second;
  * the Miller loop at SMALL_LOOP against bls12_381_ref.miller_loop up to
    an Fp2 * w^(3k) monomial (the twist scalings the final
    exponentiation kills), with the mask writing Fp12 one;
  * the final-exp program equal to the JAX array, and a small-u program
    on the plain register machine against the same chain on ints;
  * the product reduce against the int product;
  * `stage_pairs` byte-identical to the JAX function's;
  * the provider's routes with the kernels replaced by a host replay of
    the staged operands: the cutoff and the knob off serve the staged host
    path, a call pads to a power-of-two bucket with masked lanes, the
    router sends BLS lanes to sw;
  * the port's sw `verify_aggregate` against the JAX sw provider's on
    valid, forged, off-subgroup and length-mismatch inputs.

The full final-exp program on the plain version is slow-marked (seconds
of eager 30-limb Fp12 products); tests/test_torch_bls12_381_field_host.py
runs the kernel's lane body on the full program in tier-1. Tolerance:
exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fabric_tpu.bccsp import bccsp as japi
from fabric_tpu.bccsp import sw as jsw
from fabric_tpu.ops import bls12_381_kernel as jdev
from fabric_tpu.ops import bn254 as jbn

from fabric_tpu_torch.bccsp import bccsp as api
from fabric_tpu_torch.bccsp import factory, sw
from fabric_tpu_torch.bccsp.cuda import CUDAProvider
from fabric_tpu_torch.ops import bls12_381 as blsagg
from fabric_tpu_torch.ops import bls12_381_kernel as dev
from fabric_tpu_torch.ops import bls12_381_ref as ref
from fabric_tpu_torch.ops import bn254 as bn
from fabric_tpu_torch.ops import bn254_ref as bnref
from fabric_tpu_torch.ops import tower

B = 2
P = ref.P
G2 = (ref.G2_X, ref.G2_Y)
SMALL_LOOP = 0b1011010


@pytest.fixture(scope="module", autouse=True)
def jit_primitives():
    torch.set_num_threads(1)
    F = jdev.F
    for name in ("mul", "add", "sub", "canonical"):
        setattr(F, name, jax.jit(getattr(type(F), name).__get__(F)))
    yield
    for name in ("mul", "add", "sub", "canonical"):
        delattr(F, name)


RNG = np.random.default_rng(381)


def _fp(n=B):
    return np.stack([dev.F.to_mont(int.from_bytes(RNG.bytes(48), "big") % P)
                     for _ in range(n)])


def _f2():
    return (_fp(), _fp())


def _f6():
    return (_f2(), _f2(), _f2())


def _f12():
    return (_f6(), _f6())


def _pt():
    return (_f2(), _f2(), _f2())


def _aff():
    return (_f2(), _f2())


def J(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def T(t):
    return jax.tree_util.tree_map(torch.as_tensor, t)


def assert_same(jout, tout):
    lj = jax.tree_util.tree_leaves(jout)
    lt = jax.tree_util.tree_leaves(tout)
    assert len(lj) == len(lt)
    for a, b in zip(lj, lt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


CASES = {
    "f2_mul": (_f2, _f2), "f6_mul": (_f6, _f6), "f12_mul": (_f12, _f12),
    "f12_frob": (_f12,), "f12_conj": (_f12,),
    "line_to_f12": (_f2, _f2, _f2),
    "g2_dbl_line": (_pt, _fp, _fp), "g2_add_line": (_pt, _aff, _fp, _fp),
    "gt_is_one": (_f12,),
}


@pytest.mark.parametrize("method", sorted(CASES))
def test_tower_method_matches_jax(method):
    args = [mk() for mk in CASES[method]]
    assert_same(getattr(jdev._T, method)(*map(J, args)),
                getattr(dev._T, method)(*map(T, args)))


def _pairs(n, seed):
    rng = np.random.default_rng(seed)
    out = [(ref.G1, G2)]
    for _ in range(n - 1):
        k1, k2 = (int(rng.integers(2, 1 << 62)) for _ in range(2))
        out.append((ref.g1_mul(k1, ref.G1), ref.g2_mul(k2, G2)))
    return out


def test_stage_pairs_byte_identical_to_jax():
    pairs = _pairs(3, 1)
    for pad in (None, 8):
        got, want = dev.stage_pairs(pairs, pad), jdev.stage_pairs(pairs, pad)
        assert len(got) == len(want) == 7
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()
    assert dev.stage_pairs(pairs)[6].tolist() == [True] * 3 + [False]


def test_one_miller_step_matches_jax():
    """One loop step with its addition (f^2 * tangent line, then f * the
    chord line) from a staged pair, in both towers."""
    xP, yP, qx0, qx1, qy0, qy1, _ = dev.stage_pairs(_pairs(2, 2))
    one = np.broadcast_to(dev.F.to_mont(1), xP.shape).copy()
    args = (xP, yP, ((qx0, qx1), (qy0, qy1)),
            (one, np.zeros_like(one)))

    def step(mod, xP, yP, Q, Z):
        f = mod.f12_sqr(mod.f12_one_like(xP))
        T1, ln = mod.g2_dbl_line((Q[0], Q[1], Z), xP, yP)
        f = mod.f12_mul(f, ln)
        T2, la = mod.g2_add_line(T1, Q, xP, yP)
        return T2, mod.f12_mul(f, la)

    assert_same(step(jdev, *J(args)), step(dev, *T(args)))


def _is_monomial_3k(el) -> bool:
    coeffs = [c for half in el for c in half]
    nz = [i for i, c in enumerate(coeffs) if c != ref.F2_ZERO]
    return len(nz) == 1 and nz[0] in (0, 4)


def test_miller_small_loop_matches_ref_up_to_monomial():
    sk, pk = ref.bls_keygen(b"kern")
    sig = ref.bls_sign(sk, b"smoke")
    pairs = [(sig, ref.g2_neg(G2)), (ref.hash_to_g1(b"smoke"), pk),
             (ref.G1, G2)]
    st = dev.to_device(dev.stage_pairs(pairs), "cpu")
    f = dev.miller_loop_batch(st[0], st[1], ((st[2], st[3]), (st[4], st[5])),
                              loop=SMALL_LOOP, mask=st[6])
    back = dev.f12_from_device(f)
    for i, (p, q) in enumerate(pairs):
        ratio = ref.f12_mul(back[i], ref.f12_inv(ref.miller_loop(
            q, p, loop=SMALL_LOOP)))
        assert _is_monomial_3k(ratio), i
    assert back[3] == ref.F12_ONE                     # the masked lane


def test_product_reduce_matches_ints():
    x = tuple(tuple((_fp(4), _fp(4)) for _ in range(3)) for _ in range(2))
    f = T(x)
    got = dev.f12_from_device(dev.product_reduce(f))
    vals = dev.f12_from_device(f)
    want = ref.f12_mul(ref.f12_mul(vals[0], vals[2]),
                       ref.f12_mul(vals[1], vals[3]))
    assert got == [want]
    with pytest.raises(ValueError):
        dev.product_reduce(tuple(tuple((c[0][:3], c[1][:3]) for c in h)
                                 for h in f))


def test_final_exp_program_matches_jax():
    np.testing.assert_array_equal(dev.final_exp_program(),
                                  jdev._FINAL_EXP_PROGRAM)
    np.testing.assert_array_equal(dev.final_exp_program(0b1101),
                                  jdev.final_exp_program(0b1101))
    assert dev._FINAL_EXP_PROGRAM.dtype == np.int32


def _chain_u(f, u):
    """bls12_381_ref.final_exponentiation_chain with |x| replaced by u."""
    m = ref.f12_mul(ref.f12_conj(f), ref.f12_inv(f))
    m = ref.f12_mul(ref._frob2(m), m)
    t0 = ref.f12_mul(ref.f12_pow(m, u), m)
    y1 = ref.f12_mul(ref.f12_pow(t0, u), t0)
    y2 = ref.f12_mul(ref.f12_conj(ref.f12_pow(y1, u)), ref.f12_frob(y1))
    y3 = ref.f12_mul(ref.f12_mul(ref.f12_pow(ref.f12_pow(y2, u), u),
                                 ref._frob2(y2)), ref.f12_conj(y2))
    return ref.f12_mul(y3, ref.f12_mul(ref.f12_mul(m, m), m))


def test_small_u_program_matches_host_chain():
    """The plain register machine on the program for u = 0b1101, its
    squarings cyclotomic from the easy part on (as the card's entry runs
    them), against the host emulation of the same chain and against the
    JAX package's register machine: run_final_exp's rows (f12_mul,
    f12_conj, f12_frob of fabric_tpu's tower) run eagerly from (f, 1/f),
    since its lax.scan takes minutes to compile on the CPU, 1/f from the
    int reference; at the real u the emulation is the pinned reference
    chain."""
    U = 0b1101
    prog = dev.final_exp_program(U)
    x = tuple(tuple((_fp(1), _fp(1)) for _ in range(3)) for _ in range(2))
    f = dev.f12_from_device(T(x))[0]
    got = dev.final_exp_batch(T(x), program=prog)
    assert dev.f12_from_device(got)[0] == _chain_u(f, U)
    assert _chain_u(f, ref.X_BLS) == ref.final_exponentiation_chain(f)
    jt = jdev._T
    z = jnp.zeros_like(J(x)[0][0][0])
    regs = ([J(x), J(_f12_lanes_of([ref.f12_inv(f)]))]
            + [(((z, z),) * 3, ((z, z),) * 3)] * 6)
    for op, dst, a, b in prog.tolist():
        regs[dst] = (jt.f12_mul(regs[a], regs[b]) if op == 0 else
                     jt.f12_conj(regs[a]) if op == 1 else
                     jt.f12_frob(regs[a]))
    np.testing.assert_array_equal(_canon(dev, got), _canon(dev, regs[0]))


# -- the card's Fp12 formulas in plain torch (ops/tower.py), both curves --

CURVES = {"bls12_381": (jdev, dev, ref), "bn254": (jbn, bn, bnref)}


@pytest.fixture(scope="module")
def jit_bn254():
    F = jbn.F
    for name in ("mul", "add", "sub", "canonical"):
        setattr(F, name, jax.jit(getattr(type(F), name).__get__(F)))
    yield
    for name in ("mul", "add", "sub", "canonical"):
        delattr(F, name)


def _easy_part(r, f):
    """f^((p^6 - 1)(p^2 + 1)) on ints: into the cyclotomic subgroup."""
    m = r.f12_mul(r.f12_conj(f), r.f12_inv(f))
    return r.f12_mul(r.f12_frob(r.f12_frob(m)), m)


def _f12_lanes(curve, n=B, cyclotomic=False, rng=RNG):
    """n seeded Fp12 values of `curve` as nested (n, L) limb arrays (made
    cyclotomic by the easy part on ints when asked)."""
    _, mod, r = CURVES[curve]
    lanes = []
    for _ in range(n):
        el = tuple(tuple(tuple(int.from_bytes(rng.bytes(48), "big") % r.P
                               for _ in range(2)) for _ in range(3))
                   for _ in range(2))
        lanes.append(_easy_part(r, el) if cyclotomic else el)
    flat = [np.stack([mod.F.to_mont(lane[h][j][c]) for lane in lanes])
            for h in range(2) for j in range(3) for c in range(2)]
    return tower.f12_from_flat(flat)


def _f12_lanes_of(vals):
    """Int Fp12 values as nested (n, L) BLS12-381 limb arrays."""
    flat = [np.stack([dev.F.to_mont(v[h][j][c]) for v in vals])
            for h in range(2) for j in range(3) for c in range(2)]
    return tower.f12_from_flat(flat)


def _canon(mod, f):
    """Canonical limbs of an Fp12 value of either tower."""
    return mod.F.canonical(tower.flat_from_f12(
        jax.tree_util.tree_map(lambda a: torch.as_tensor(np.array(a)),
                               f))).numpy()


@pytest.mark.parametrize("curve", sorted(CURVES))
@pytest.mark.parametrize("formula", ["f12_sqr_complex", "f12_mul_line",
                                     "f12_sqr_cyclotomic"])
def test_card_formula_matches_jax_dense_product(curve, formula, jit_bn254):
    """The complex squaring, the sparse line product (M-type on
    BLS12-381, D-type on BN254) and the cyclotomic squaring (on values
    past the easy part) against the JAX tower's dense f12_mul of the same
    operands: equal limbs after `canonical`."""
    jm, tm, _ = CURVES[curve]
    x = _f12_lanes(curve, cyclotomic=formula == "f12_sqr_cyclotomic")
    if formula == "f12_mul_line":
        line = _f12_lanes(curve)[0]                  # A, B, C
        want = jm._T.f12_mul(J(x), jm._T.line_to_f12(*J(line)))
        got = tm._T.f12_mul_line(T(x), *T(line))
    else:
        want = jm._T.f12_mul(J(x), J(x))
        got = getattr(tm._T, formula)(T(x))
    np.testing.assert_array_equal(_canon(tm, got), _canon(tm, want))


def test_cyclotomic_lowering_starts_after_the_easy_part():
    """The lowering's first row follows the easy part's mul(2, 6, 2), no
    squaring comes before it, and a value outside the cyclotomic subgroup
    (what the card's final-exp check feeds before the easy part) does not
    square to its square by Granger-Scott."""
    for u in (ref.X_BLS, 0b1101):
        prog = dev.final_exp_program(u)
        row = dev.cyclotomic_row(prog)
        assert row == 5 and tuple(prog[row - 1]) == dev.EASY_LAST
        assert not any(op == 0 and a == b
                       for op, _, a, b in prog[:row].tolist())
    x = T(_f12_lanes("bls12_381"))
    assert (_canon(dev, dev.f12_sqr_cyclotomic(x))
            != _canon(dev, dev.f12_mul(x, x))).any()


@pytest.mark.slow
def test_full_final_exp_plain_matches_chain():
    x = tuple(tuple((_fp(1), _fp(1)) for _ in range(3)) for _ in range(2))
    f = dev.f12_from_device(T(x))[0]
    got = dev.final_exp_batch(T(x))
    assert dev.f12_from_device(got)[0] == ref.final_exponentiation_chain(f)
    assert not bool(dev.gt_is_one(got)[0])


# -- the provider (the kernels replaced by a host replay) --

_SW = sw.SWProvider()
_KEY = _SW.key_gen(api.BLSKeyGenOpts(ephemeral=True))


def _aggregate(n, forge=None):
    msgs = [b"blk %d" % i for i in range(n)]
    agg = sw.bls_aggregate_signatures([_SW.sign(_KEY, m) for m in msgs])
    if forge is not None:
        msgs = msgs[:forge] + [b"forged"] + msgs[forge + 1:]
    return [_KEY.public_key()] * n, msgs, agg


def _host_replay(xP, yP, qx0, qx1, qy0, qy1, mask, loop=ref.X_BLS):
    """The staged operands back to ints, through the staged host path."""
    F = dev.F
    pairs = []
    for i in np.nonzero(mask.numpy())[0]:
        v = [F.from_limbs(a[i].numpy()) for a in (xP, yP, qx0, qx1, qy0, qy1)]
        pairs.append(((v[0], v[1]), ((v[2], v[3]), (v[4], v[5]))))
    ok = blsagg.check_products(blsagg.miller_products(pairs))
    return torch.tensor([ok])


@pytest.fixture()
def stubbed(monkeypatch):
    masks = []

    def stub(*args, **kw):
        masks.append(args[6].clone())
        dev.miller_launches += 1
        dev.reduce_launches += int(len(args[6]) > 1)
        dev.final_exp_launches += 1
        return _host_replay(*args, **kw)
    monkeypatch.setattr(dev, "pairs_product_is_one", stub)
    return masks


def _provider(**kw):
    kw.setdefault("min_batch", 1)
    kw.setdefault("bls_pairing", True)
    return CUDAProvider(device="cpu", **kw)


def test_provider_device_route_pads_and_masks(stubbed):
    prov = _provider()
    keys, msgs, agg = _aggregate(4)                 # 5 pairs -> bucket 8
    assert prov.verify_aggregate(keys, msgs, agg) is True
    fk, fm, fa = _aggregate(2, forge=1)             # 3 pairs -> bucket 4
    assert prov.verify_aggregate(fk, fm, fa) is False
    assert [m.tolist() for m in stubbed] == [[True] * 5 + [False] * 3,
                                             [True] * 3 + [False]]
    assert prov.stats["pairing_batches"] == 2
    assert prov.stats["pairing_pairs"] == 8
    assert prov.stats["bls_aggregate_checks"] == 2
    assert (prov.stats["bls_miller_launches"], prov.stats[
        "bls_reduce_launches"], prov.stats["bls_final_exp_launches"]) == (
            2, 2, 2)
    # gates: a malformed signature returns before the counter, an
    # off-subgroup one is False without a pairing
    assert prov.verify_aggregate(keys, msgs, b"short") is False
    assert prov.verify_aggregate(keys, msgs, b"\x01" * 96) is False
    assert len(stubbed) == 2 and prov.stats["bls_aggregate_checks"] == 2


def test_provider_cutoff_and_knob_serve_the_host_path(stubbed):
    keys, msgs, agg = _aggregate(2)                 # 3 pairs
    for prov in (_provider(min_batch=16),           # cutoff: 4 pairs
                 _provider(bls_pairing=False),
                 factory.new_bccsp({"Default": "CUDA", "CUDA": {
                     "Device": "cpu", "MinBatch": 1}})):   # CPU: knob off
        assert prov.verify_aggregate(keys, msgs, agg) is True
        assert prov.stats["pairing_batches"] == 0
        assert prov.stats["bls_aggregate_checks"] == 1
    assert not stubbed
    ed = _SW.key_gen(api.Ed25519KeyGenOpts(ephemeral=True))
    with pytest.raises(TypeError):
        _provider().verify_aggregate([ed], [b"m"], agg)


def test_router_sends_bls_lanes_to_sw(stubbed):
    prov = _provider(min_batch=4)
    ed = prov.key_gen(api.Ed25519KeyGenOpts(ephemeral=True))
    items = []
    for i in range(3):
        m = b"lane %d" % i
        items.append(api.VerifyItem(_KEY.public_key(), _SW.sign(_KEY, m),
                                    message=m if i != 1 else b"other"))
        items.append(api.VerifyItem(ed.public_key(), prov.sign(ed, m),
                                    message=m))
    got = prov.verify_batch(items)
    assert got == _SW.verify_batch(items) == [True, True, False, True,
                                              True, True]
    assert prov.stats["bls_sw_lanes"] == 3
    assert not stubbed


def test_sw_verify_aggregate_matches_jax_sw():
    """valid, forged, an off-subgroup signature, a key off the subgroup
    (a point that skipped the import check) and a length mismatch."""
    jp = jsw.SWProvider()
    sk, pk = ref.bls_keygen(b"sw agg")
    msgs = [b"a", b"b"]
    sigs = [ref.bls_sign(sk, m) for m in msgs]
    agg = ref.g1_to_bytes(ref.bls_aggregate(sigs))
    raw = ref.g2_to_bytes(pk)
    tk = _SW.key_import(raw, api.BLSPublicKeyImportOpts(ephemeral=True))
    jk = jp.key_import(raw, japi.BLSPublicKeyImportOpts(ephemeral=True))
    off_g1 = _off_subgroup_g1()
    off_sig = ref.g1_to_bytes(ref.g1_add(ref.bls_aggregate(sigs), off_g1))
    bad_t, bad_j = (object.__new__(c) for c in (sw.BLSPublicKey,
                                                jsw.BLSPublicKey))
    for k in (bad_t, bad_j):
        k.point, k._raw = _off_subgroup_g2(), b""
    cases = [([tk, tk], [jk, jk], msgs, agg, True),
             ([tk, tk], [jk, jk], [b"a", b"forged"], agg, False),
             ([tk, tk], [jk, jk], msgs, off_sig, False),
             ([tk, bad_t], [jk, bad_j], msgs, agg, False),
             ([tk], [jk], msgs, agg, False)]
    for tkeys, jkeys, m, s, want in cases:
        assert jp.verify_aggregate(jkeys, m, s) is want
        assert _SW.verify_aggregate(tkeys, m, s) is want
    assert _SW.verify(tk, ref.g1_to_bytes(sigs[0]), b"a")
    assert not _SW.verify(tk, b"x" * 96, b"a")


def test_aggregate_operands_tell_identity_from_garbage(stubbed):
    """The identity signature decodes (to None) and is refused by the
    gates; bytes that do not decode are refused before them; both
    providers and the JAX sw agree."""
    keys, msgs, _ = _aggregate(2)
    assert sw.bls_aggregate_operands(keys, b"\x00" * 96) == (
        [k.public_key().point for k in keys], None)
    assert sw.bls_aggregate_operands(keys, b"\x01" * 96) is None
    prov, jp = _provider(), jsw.SWProvider()
    jk = jp.key_import(keys[0].bytes(),
                       japi.BLSPublicKeyImportOpts(ephemeral=True))
    for sig in (b"\x00" * 96, b"\x01" * 96, b"short"):
        assert jp.verify_aggregate([jk] * 2, msgs, sig) is False
        assert _SW.verify_aggregate(keys, msgs, sig) is False
        assert prov.verify_aggregate(keys, msgs, sig) is False
    assert prov.stats["bls_aggregate_checks"] == 1     # the identity only
    assert not stubbed


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the entry point's raise without CUDA")
def test_verify_pairs_runs_on_the_card_unless_told():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dev.verify_pairs([(ref.G1, G2)])

def _off_subgroup_g1():
    """A point of E(Fp) outside the order-r subgroup: try-and-increment
    without the cofactor clearing."""
    x = 1
    while True:
        rhs = (x * x * x + ref.B_G1) % P
        y = pow(rhs, (P + 1) // 4, P)
        if y * y % P == rhs and not ref.g1_in_subgroup((x, y)):
            return (x, y)
        x += 1


def _off_subgroup_g2():
    """A point of the twist E'(Fp2) outside the order-r subgroup: the
    smallest x = (k, 1) whose x^3 + 4(1 + u) is a square in Fp2."""
    b = ref.f2_mul((ref.B_G1, 0), ref.XI)
    k = 0
    while True:
        x = (k, 1)
        rhs = ref.f2_add(ref.f2_mul(ref.f2_mul(x, x), x), b)
        y = _f2_sqrt(rhs)
        if y is not None and not ref.g2_in_subgroup((x, y)):
            return (x, y)
        k += 1


def _f2_sqrt(a):
    """A square root in Fp2 = Fp[u]/(u^2 + 1), p = 3 mod 4, or None."""
    a0, a1 = a
    n = (a0 * a0 + a1 * a1) % P
    s = pow(n, (P + 1) // 4, P)
    if s * s % P != n:
        return None
    for t in (s, P - s):
        h = (a0 + t) * pow(2, -1, P) % P
        x0 = pow(h, (P + 1) // 4, P)
        if x0 * x0 % P == h and x0:
            x1 = a1 * pow(2 * x0, -1, P) % P
            if ref.f2_mul((x0, x1), (x0, x1)) == a:
                return (x0, x1)
    return None
