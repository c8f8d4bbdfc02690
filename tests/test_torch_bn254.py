"""The port's BN254 pairing module (fabric_tpu_torch/ops/bn254.py) and the
CUDA provider's pairing methods, on the CPU.

* Staging: stage_g1, stage_g2 and stage_g2_msm return arrays
  byte-identical to fabric_tpu.ops.bn254's on the same integer points.
* miller_loop_batch's plain version at a truncated loop (SMALL_LOOP, as
  tests/test_bn254_device.py) matches bn254_ref.miller_loop up to an Fp2
  factor (the line denominators the final exponentiation kills), and one
  loop step — squaring, tangent line, chord line, the masked select —
  equals fabric_tpu's eager tower calls limb for limb (the JAX MontMod
  primitives jit-compiled, as in tests/test_torch_tower.py).
* g2_msm_scan on 8-bit scalar columns against the host MSM, the words
  unpacked to the same columns, g2_msm on the words (the card's chain,
  g2_msm_chain) at the same points; g2_msm_chain against fabric_tpu's
  g2_msm_scan (its lax.scan run as a Python loop over the same body) and
  the host MSM, point for point, with the k0, Q + Q, T + (-T) and
  all-zero edges.
* final_exp_batch in full against final_exponentiation_chain (`slow`:
  ~9 s of eager torch); the final-exp program's cyclotomic lowering
  (cyclotomic_row = 5) against the JAX package's eager rows on a short
  program.
* CUDAProvider's pairing routes with the kernels stubbed: host cutoffs,
  the 2-term pad lane, nterms != 2, BLS None lanes, stats, errors that
  propagate; g2_msm_batch's live lanes in class order, results in the
  caller's order.
Tolerance: exact (limbs, or integers).
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fabric_tpu.ops import bn254 as jdev
from fabric_tpu.ops import tower as jtower

from fabric_tpu_torch.bccsp.cuda import CUDAProvider
from fabric_tpu_torch.ops import bn254 as dev
from fabric_tpu_torch.ops import bn254_ref as ref
from fabric_tpu_torch.ops import tower
from tests.test_torch_tower import jit_primitives  # noqa: F401  (autouse)

SMALL_LOOP = 0b1011010          # 6 steps, mixed bits
G2 = (ref.G2_X, ref.G2_Y)


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _points(seed, n):
    rng = random.Random(seed)
    ps = [ref.g1_mul_fast(rng.randrange(2, ref.R), ref.G1) for _ in range(n)]
    qs = [ref.g2_mul_fast(rng.randrange(2, ref.R), G2) for _ in range(n)]
    return ps, qs


def _leaves_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_staging_byte_identical_to_jax():
    ps, qs = _points(71, 3)
    _leaves_equal(dev.stage_g1(ps), jdev.stage_g1(ps))
    _leaves_equal(dev.stage_g2(qs), jdev.stage_g2(qs))
    rng = random.Random(72)
    lanes = [[(rng.randrange(ref.R), qs[0]), (0, qs[1]),
              (rng.randrange(ref.R), None)],
             [(ref.R + 5, G2), (1, qs[2]), (ref.R - 1, qs[0])]]
    _leaves_equal(dev.stage_g2_msm(lanes), jdev.stage_g2_msm(lanes))
    small = [[(rng.randrange(1 << 10), G2), (0, None)]]
    _leaves_equal(dev.stage_g2_msm(small, nbits=10),
                  jdev.stage_g2_msm(small, nbits=10))


def _is_fp2(el) -> bool:
    d0, d1 = el
    return (d0[1] == ref.F2_ZERO and d0[2] == ref.F2_ZERO
            and d1 == ref.F6_ZERO)


def test_miller_small_loop_matches_ref_up_to_fp2():
    ps, qs = _points(73, 3)
    st = dev.stage_g1(ps) + dev.stage_g2(qs)
    f = dev.miller_loop_batch(*dev.to_device(st, "cpu"), loop=SMALL_LOOP)
    for i, got in enumerate(dev.f12_from_device(f)):
        want = ref.miller_loop(qs[i], ps[i], loop=SMALL_LOOP)
        ratio = ref.f12_mul(got, ref.f12_inv(want))
        assert _is_fp2(ratio) and ratio != ref.F12_ZERO, f"lane {i}"


def test_one_loop_step_matches_jax():
    """One step of the Miller loop's body (fabric_tpu's scan body, with
    the select masked by a lane-varying bit) limb for limb."""
    ps, qs = _points(74, 3)
    xP, yP = dev.stage_g1(ps)
    (Q, _, _) = dev.stage_g2(qs)
    rng = np.random.default_rng(75)

    def fp():
        return np.stack([dev.F.to_mont(int.from_bytes(rng.bytes(32), "big"))
                         for _ in range(3)])
    f = tuple(tuple((fp(), fp()) for _ in range(3)) for _ in range(2))
    T0 = (Q[0], Q[1], (fp(), fp()))
    mask = np.array([True, False, True])

    def step(t, m, T, f, xP, yP, Q, mask):
        f = t.f12_mul(f, f)
        T, line = t.g2_dbl_line(T, xP, yP)
        f = t.f12_mul(f, line)
        Ta, la = t.g2_add_line(T, Q, xP, yP)
        fa = t.f12_mul(f, la)
        return m.select_pt(mask, Ta, T), m.select_f12(mask, fa, f)

    jt = jax.tree_util.tree_map(jnp.asarray, (T0, f, xP, yP, Q, mask))
    tt = jax.tree_util.tree_map(torch.as_tensor, (T0, f, xP, yP, Q, mask))
    got_j = step(jdev._T, jtower, *jt)
    got_t = step(dev._T, tower, *tt)
    for a, b in zip(jax.tree_util.tree_leaves(got_j),
                    jax.tree_util.tree_leaves(got_t)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_g2_msm_scan_8bit_matches_host():
    rng = random.Random(76)
    T = ref.g2_mul_fast(987654321, G2)
    lanes = [[(rng.randrange(1 << 8), G2), (rng.randrange(1 << 8), T),
              (0 if i == 2 else rng.randrange(1 << 8),
               None if i == 3 else T)] for i in range(5)]
    lanes.append([(0, G2), (0, None), (0, G2)])                # infinity
    lanes.append([(3, G2), (0, None), (3, ref.g2_neg_tw(G2))])  # Q + (-Q)
    lanes.append([(1, G2), (1, G2), (0, None)])                 # Q + Q
    bits, qf = dev.stage_g2_msm(lanes, nbits=8)
    q = [torch.as_tensor(a) for a in qf]
    out = dev.g2_msm_scan(torch.as_tensor(bits), *q)
    assert dev.read_g2_msm(out) == [ref.g2_msm(lane) for lane in lanes]
    kw, _ = dev.stage_g2_msm_words(lanes)
    kw = torch.as_tensor(kw.view(np.int32))
    assert torch.equal(dev.words_to_bits(kw, 8), torch.as_tensor(bits))
    # g2_msm on the CPU runs the card's chain (g2_msm_chain): the same
    # points through other projective representatives
    out2 = dev.g2_msm(kw, *q, nbits=8)
    assert dev.read_g2_msm(out2) == dev.read_g2_msm(out)


class _LaxLoop:
    """fabric_tpu's `lax.scan` as a Python loop over the same body (its
    MontMod primitives stay jitted by jit_primitives): XLA takes minutes
    to compile the whole MSM scan on the CPU."""

    @staticmethod
    def scan(body, carry, xs):
        for x in xs:
            carry, _ = body(carry, x)
        return carry, None


def test_g2_msm_chain_matches_scan_points_and_ints(monkeypatch):
    """The card's chain in plain torch (joint tables, one projective
    addition a bit) against fabric_tpu's g2_msm_scan and the int MSM on
    8-bit scalars, point for point, with the edges k0, q_plus_q,
    t_minus_t and all_zero."""
    monkeypatch.setattr(jdev, "lax", _LaxLoop)
    rng = random.Random(77)
    T = ref.g2_mul_fast(24680, G2)
    lanes = [[(rng.randrange(1 << 8), G2), (rng.randrange(1 << 8), T),
              (rng.randrange(1 << 8), ref.g2_neg_tw(T))] for _ in range(3)]
    lanes += [[(0, T), (1, G2), (0, None)],                      # k0
              [(1, T), (1, T), (0, None)],                       # q_plus_q
              [(123, T), (0, None), (123, ref.g2_neg_tw(T))],    # t_minus_t
              [(0, None), (0, None), (0, None)]]                 # all_zero
    bits, qf = dev.stage_g2_msm(lanes, nbits=8)
    chain = dev.g2_msm_chain(torch.as_tensor(bits),
                             *[torch.as_tensor(a) for a in qf])
    scan = jdev.g2_msm_scan(jnp.asarray(bits), *[jnp.asarray(a) for a in qf])
    want = [ref.g2_msm(lane) for lane in lanes]
    assert dev.read_g2_msm(chain) == dev.read_g2_msm(
        jax.tree_util.tree_map(np.asarray, scan)) == want
    assert want[5] is None and want[6] is None


def test_cyclotomic_lowering_matches_jax_rows():
    """The final-exp program squares cyclotomically from cyclotomic_row =
    5, the row after the easy part's mul(2, 6, 2), no squaring before it;
    the plain register machine lowered from that row (final_exp_plain) on
    a short program with the real easy part equals the JAX package's
    register machine, its rows run eagerly with the dense f12_mul from
    (f, 1/f), canonically (1/f from the int reference)."""
    prog = dev._FINAL_EXP_PROGRAM
    row = dev.cyclotomic_row(prog)
    assert row == 5 and tuple(prog[row - 1]) == dev.EASY_LAST
    assert not any(op == 0 and a == b for op, _, a, b in prog[:row].tolist())
    A = dev._Asm()
    A.conj(2, 0)
    A.mul(2, 2, 1)
    A.frob(6, 2)
    A.frob(6, 6)
    A.mul(2, 6, 2)
    A.pow_static(3, 2, 7, 0b1101)
    A.mul(0, 3, 2)
    short = A.program()
    assert dev.cyclotomic_row(short) == 5
    rng = random.Random(78)
    fs = [tuple(tuple((rng.randrange(ref.P), rng.randrange(ref.P))
                      for _ in range(3)) for _ in range(2)) for _ in range(2)]

    def limbs(vals):
        return np.stack([np.stack([dev.F.to_mont(c) for h in f for fp2 in h
                                   for c in fp2]) for f in vals], axis=1)
    got = dev.final_exp_plain(tower.f12_from_flat(torch.as_tensor(
        limbs(fs))), short)
    jt = jdev._T

    def jf12(vals):
        return jtower.f12_from_flat(jnp.asarray(limbs(vals)))
    z = jnp.zeros_like(jf12(fs)[0][0][0])
    regs = ([jf12(fs), jf12([ref.f12_inv(f) for f in fs])]
            + [(((z, z),) * 3, ((z, z),) * 3)] * 6)
    for op, dst, a, b in short.tolist():
        regs[dst] = (jt.f12_mul(regs[a], regs[b]) if op == 0 else
                     jt.f12_conj(regs[a]) if op == 1 else
                     jt.f12_frob(regs[a]))
    want = torch.as_tensor(np.array(jtower.flat_from_f12(regs[0])))
    assert torch.equal(dev.F.canonical(tower.flat_from_f12(got)),
                       dev.F.canonical(want))


@pytest.mark.slow
def test_final_exp_batch_full_matches_chain():
    """~9 s: the full register-machine program on 2 lanes."""
    rng = random.Random(77)
    fs = [tuple(tuple((rng.randrange(ref.P), rng.randrange(ref.P))
                      for _ in range(3)) for _ in range(2)) for _ in range(2)]
    flat = torch.as_tensor(np.stack([
        np.stack([dev.F.to_mont(c) for h in f for fp2 in h for c in fp2])
        for f in fs], axis=1))
    got = dev.f12_from_device(dev.final_exp_batch(tower.f12_from_flat(flat)))
    assert got == [ref.final_exponentiation_chain(f) for f in fs]


# -- the provider's routes, kernels stubbed --

def _neg_q_rule(xPs, yPs, Qs, Q1s, nQ2s):
    """A stand-in verdict from the staged limbs: a 2-term lane is "one"
    when its terms share P and their Q's y coordinates are negatives."""
    y = [dev.F.canonical(Qs[t][1][0]) for t in range(2)]
    ysum = dev.F.canonical(dev.F.add(Qs[0][1][0], Qs[1][1][0]))
    same_p = (xPs[0] == xPs[1]).all(dim=-1)
    return same_p & ((ysum == 0).all(dim=-1)
                     & ~(y[0] == 0).all(dim=-1))


@pytest.fixture
def stubbed(monkeypatch):
    calls = {"device": [], "sw": []}

    def fake(*staged, loop=ref.ATE_LOOP):
        calls["device"].append(staged)
        dev.miller_launches += 1
        dev.final_exp_launches += 1
        return _neg_q_rule(*staged)

    monkeypatch.setattr(dev, "pairing_product_is_one", fake)
    prov = CUDAProvider(device="cpu", min_batch=16)
    monkeypatch.setattr(prov._sw, "pairing_check_batch", lambda prods: (
        calls["sw"].append(prods), [None] * len(prods))[1])
    return prov, calls


def _products(n, seed, nterms=2):
    """n 2-term lanes [(P, Q), (P, -Q')]: Q' = Q on odd lanes (the rule's
    "one"), another lane's Q on even ones; or 1-term lanes repeated."""
    ps, qs = _points(seed, n)
    out = []
    for i, (p, q) in enumerate(zip(ps, qs)):
        q2 = qs[(i + 1) % n] if i % 2 == 0 else q
        out.append([(p, q), (p, ref.g2_neg_tw(q2))])
    if nterms != 2:
        out = [lane[:1] * nterms for lane in out]
    return out


def test_provider_pairing_routes(stubbed):
    prov, calls = stubbed
    # under the host cutoff max(2, 16 // 4) = 4: sw
    prods = _products(3, 78)
    assert prov.pairing_check_batch(prods) == [None] * 3
    assert calls["sw"] == [prods] and not calls["device"]
    # 5 lanes -> an 8-lane bucket padded with e(P0, Q0) e(P0, -Q0)
    prods = _products(5, 79)
    before = dict(prov.stats)
    got = prov.pairing_check_batch(prods)
    assert got == [i % 2 == 1 for i in range(5)]
    staged = calls["device"][-1]
    assert staged[0][0].shape == (8, 20) and len(staged[0]) == 2
    assert _neg_q_rule(*staged).tolist()[5:] == [True] * 3
    pad = dev.stage_pairing_products(
        [[prods[0][0], (prods[0][0][0], ref.g2_neg_tw(prods[0][0][1]))]])
    for t in range(2):
        assert torch.equal(staged[0][t][7], torch.as_tensor(pad[0][t][0]))
        assert torch.equal(staged[3][t][1][1][6],
                           torch.as_tensor(pad[3][t][1][1][0]))
    d = {k: prov.stats[k] - before[k] for k in (
        "pairing_batches", "pairing_pairs", "miller_launches",
        "final_exp_launches")}
    assert d == {"pairing_batches": 1, "pairing_pairs": 10,
                 "miller_launches": 1, "final_exp_launches": 1}
    # 3-term products: a full bucket runs on the device, a ragged one on sw
    prods = _products(4, 80, nterms=3)
    prov.pairing_check_batch(prods)
    assert len(calls["device"][-1][0]) == 3
    n_sw = len(calls["sw"])
    prov.pairing_check_batch(_products(5, 81, nterms=3))
    assert len(calls["sw"]) == n_sw + 1


def test_provider_chunks_and_errors(stubbed, monkeypatch):
    prov, calls = stubbed
    prov._chunk = 4
    prov.pairing_check_batch(_products(8, 82))
    assert [s[0][0].shape[0] for s in calls["device"]] == [4, 4]

    def boom(*a, **k):
        raise RuntimeError("device fault")
    monkeypatch.setattr(dev, "pairing_product_is_one", boom)
    with pytest.raises(RuntimeError, match="device fault"):
        prov.pairing_check_batch(_products(8, 83))


def test_provider_bls_none_lanes(stubbed):
    prov, calls = stubbed
    sk, pk = ref.bls_keygen(b"torch-provider")
    msgs = [b"m%d" % i for i in range(7)]
    sigs = [ref.g1_mul_fast(sk, ref.hash_to_g1(m)) for m in msgs]
    sigs[2] = sigs[5] = None
    got = prov.bls_verify_batch(pk, msgs, sigs)
    assert got[2] is False and got[5] is False
    staged = calls["device"][-1]
    assert staged[0][0].shape[0] == 8        # 5 live lanes, bucket 8
    want = dev.stage_pairing_products(dev.bls_products(
        pk, [msgs[i] for i in (0, 1, 3, 4, 6)],
        [sigs[i] for i in (0, 1, 3, 4, 6)]))
    assert torch.equal(staged[1][1][:5], torch.as_tensor(want[1][1]))
    # every lane None: nothing runs
    n = len(calls["device"]) + len(calls["sw"])
    assert prov.bls_verify_batch(pk, msgs[:2], [None, None]) == [False] * 2
    assert len(calls["device"]) + len(calls["sw"]) == n


def test_provider_g2_msm_routes(monkeypatch):
    """g2_msm_batch with the kernel stubbed by the host MSM on the staged
    words and limbs: staging, the (0, None) pad lanes and the read-back."""
    seen = []

    def fake(kw, *q_flat, nbits=dev.NBITS_R):
        seen.append(kw.shape)
        dev.msm_launches += 1
        B, T = kw.shape[0], kw.shape[1]
        cols = [[] for _ in range(6)]
        for i in range(B):
            lane = []
            for t in range(T):
                k = sum((int(w) & 0xFFFFFFFF) << (32 * j)
                        for j, w in enumerate(kw[i, t].tolist()))
                c = [dev.F.from_limbs(q_flat[4 * t + j][i].numpy())
                     for j in range(4)]
                lane.append((k, ((c[0], c[1]), (c[2], c[3]))))
            pt = ref.g2_msm(lane)
            vals = (0, 0, 1, 0, 0, 0) if pt is None else (
                *pt[0], *pt[1], 1, 0)
            for col, v in zip(cols, vals):
                col.append(dev.F.to_mont(v))
        t = [torch.as_tensor(np.stack(c)) for c in cols]
        return ((t[0], t[1]), (t[2], t[3]), (t[4], t[5]))

    monkeypatch.setattr(dev, "g2_msm", fake)
    prov = CUDAProvider(device="cpu", min_batch=16)
    rng = random.Random(84)
    T = ref.g2_mul_fast(55555, G2)
    lanes = [[(rng.randrange(ref.R), G2), (rng.randrange(ref.R), T),
              (ref.R - 1, T)] for _ in range(2)]
    lanes.append([(6 * ref.T_BN ** 2, T), (0, None), (0, None)])
    # one lane, under max(2, 16 // 8) = 2: the host MSM, no launch
    assert prov.g2_msm_batch(lanes[:1]) == [ref.g2_msm(lanes[0])]
    assert not seen
    before = dict(prov.stats)
    assert prov.g2_msm_batch(lanes) == [ref.g2_msm(lane) for lane in lanes]
    assert seen == [(3, 3, 8)]                 # the live lanes, no pad
    assert prov.stats["g2_msm_batches"] - before["g2_msm_batches"] == 1
    assert prov.stats["g2_msm_launches"] - before["g2_msm_launches"] == 1


def test_provider_g2_msm_orders_lanes_by_class(monkeypatch):
    """g2_msm_batch launches the n live lanes (no power-of-two pad) in
    class order (nonzero scalars, then the largest scalar's bit length)
    and returns the results in the caller's order, for a shuffled mix of
    Schnorr lanes (three scalars), subgroup lanes (6x^2 alone) and an
    all-zero lane; the kernel stubbed by the int MSM of the staged words."""
    launched = []

    def fake(kw, *q_flat, nbits=dev.NBITS_R):
        dev.msm_launches += 1
        lanes = []
        for i in range(kw.shape[0]):
            lane = []
            for t in range(kw.shape[1]):
                k = sum((int(w) & 0xFFFFFFFF) << (32 * j)
                        for j, w in enumerate(kw[i, t].tolist()))
                c = [dev.F.from_limbs(q_flat[4 * t + j][i].numpy())
                     for j in range(4)]
                lane.append((k, ((c[0], c[1]), (c[2], c[3]))))
            lanes.append(lane)
        launched.extend(lanes)
        cols = [[] for _ in range(6)]
        for lane in lanes:
            pt = ref.g2_msm(lane)
            vals = (0, 0, 1, 0, 0, 0) if pt is None else (
                *pt[0], *pt[1], 1, 0)
            for col, v in zip(cols, vals):
                col.append(dev.F.to_mont(v))
        t = [torch.as_tensor(np.stack(c)) for c in cols]
        return ((t[0], t[1]), (t[2], t[3]), (t[4], t[5]))

    monkeypatch.setattr(dev, "g2_msm", fake)
    prov = CUDAProvider(device="cpu", min_batch=16)
    rng = random.Random(85)
    qs = [ref.g2_mul_fast(rng.randrange(2, 1 << 20), G2) for _ in range(3)]
    lanes = [[(rng.randrange(1 << 200, ref.R), qs[0]),
              (rng.randrange(1 << 100), qs[1]), (ref.R - 1, qs[2])]
             for _ in range(3)]
    lanes += [[(6 * ref.T_BN ** 2, q), (0, None), (0, None)] for q in qs]
    lanes += [[(0, None), (0, None), (0, None)],
              [(rng.randrange(1 << 60), qs[2]), (0, None), (5, qs[0])]]
    rng.shuffle(lanes)
    want = [ref.g2_msm(lane) for lane in lanes]
    assert prov.g2_msm_batch(lanes) == want
    assert len(launched) == len(lanes) == 8
    classes = [(sum(1 for k, _ in ln if k), max(k.bit_length()
                                                for k, _ in ln))
               for ln in launched]
    assert classes == sorted(classes)
    assert [c for c in classes if c[0] == 1] == [(1, 127)] * 3
