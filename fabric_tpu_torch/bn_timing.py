#!/usr/bin/env python3
"""The BN254 pairing entries' times on the card, the G2 MSM's and
pairing_check_batch's.

    python3 fabric_tpu_torch/bn_timing.py [--root DIR] [--reps 5]
        [--call-reps 3] [--products 10240] [--seed 7] [--msm-only]

Times the package under `--root` (default: this checkout) on the idemix
block's shapes, made from `--seed` out of 64 distinct product lanes
e(P, Q) e(P, -Q) (each a valid identity product) tiled to the width:

  * the Miller entry at 32,768 lanes (the idemix block's 16,384-product
    bucket, two terms a product), 8,192 and 2,048 (bls_verify_batch's
    1,024 products), and the final-exp entry at 16,384, 4,096 and 1,024
    two-term lanes, in every layout the package builds (`bn254.LAYOUTS`, threads a lane;
    a package without them: its one layout), each `--reps` calls back to
    back between two CUDA events after one warm-up call: ms a call;
  * the G2 MSM entry at 32,768 lanes, 20,480 of them live (three 254-bit
    scalars a lane), the rest zero (what the provider launched before it
    launched live lanes only); and at the idemix block's shape, 20,480
    live lanes, a presentation's Schnorr lane (s_sk Y~ + s_r G~ - c T~)
    beside its subgroup lane ([6x^2] T~ alone), in that interleaved order
    and in the provider's class order (`bn254.msm_order` of this
    checkout, applied to both roots: the same lanes in the same order);
  * CUDAProvider.pairing_check_batch on `--products` product lanes: after
    one warm-up call, `--call-reps` calls on the host's clock (their
    median) and the card's busy ms a call from the provider's CUDA events
    (device_cost.busy); every verdict must be True.

`--msm-only` times the G2 MSM alone.

Beside them: each library's build seconds and whether nvcc wrote it (cold:
the first run on a checkout), ptxas' registers, stack and spills of the
pairing and MSM kernels, and the sha256 of each entry's canonical outputs
(every layout, and runs on two checkouts, must print the same; the MSM's
over the affine points of its first 256 lanes, which two chains that
reach a point through other projective representatives share). Running
it on two checkouts in turns (for example a parent commit unpacked with
`git archive` into the git-ignored `chip_tree/`: parent, change, change,
parent) compares them on one card. Prints one JSON line; needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import statistics
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
DISTINCT = 64               # distinct product lanes, tiled to each width
# product lanes a width: the idemix block's bucket, a middle width, and
# bls_verify_batch's 1,024
WIDTHS = (16384, 4096, 1024)
MSM_LANES, MSM_LIVE = 32768, 20480
SAMPLE = 256                # MSM lanes whose affine points are hashed


def _events_ms(fn, reps: int) -> float:
    """ms a call of `reps` back-to-back calls between two CUDA events,
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _sha(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def _tile(tree, n: int):
    """Nested tuples/lists of (m, ...) arrays -> the same tiled to n rows."""
    if isinstance(tree, np.ndarray):
        reps = -(-n // tree.shape[0])
        return np.ascontiguousarray(np.concatenate([tree] * reps)[:n])
    return type(tree)(_tile(t, n) for t in tree)


def _msm_entry(bn254, kw, qf, dev, reps: int, sample=None) -> dict:
    """The MSM entry on staged lanes: ms a call and the sha256 of the
    affine points of `sample` lanes (default the first SAMPLE)."""
    import torch
    kt = torch.as_tensor(np.ascontiguousarray(kw).view(np.int32)).to(dev)
    qt = [torch.as_tensor(np.ascontiguousarray(a)).to(dev) for a in qf]

    def msm():
        return bn254.g2_msm(kt, *qt)
    out = msm()
    idx = torch.as_tensor(np.arange(SAMPLE) if sample is None else sample)
    pts = bn254.read_g2_msm(tuple(tuple(c.cpu()[idx] for c in pt)
                                  for pt in out))
    return dict(lanes=len(kw), ms=_events_ms(msm, reps),
                sha256=hashlib.sha256(repr(pts).encode()).hexdigest()[:16])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--call-reps", type=int, default=3)
    ap.add_argument("--products", type=int, default=10240)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--msm-only", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bn_timing: no CUDA device", file=sys.stderr)
        return 2

    # the provider's launch order, from this checkout (a pure function)
    from fabric_tpu_torch.ops.bn254 import msm_order

    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.startswith("fabric_tpu_torch")]:
        del sys.modules[name]
    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.bccsp import factory
    from fabric_tpu_torch.ops import bn254, tower
    from fabric_tpu_torch.ops import bn254_ref as b

    out = {"root": root, "card": torch.cuda.get_device_name(0),
           "reps": args.reps, "build": {}}
    for lib in ("bn254_pairing", "g2_msm"):
        cold = not os.path.exists(kernels.library_path(lib))
        t0 = time.perf_counter()
        kernels.load(lib)
        out["build"][lib] = dict(seconds=time.perf_counter() - t0, cold=cold)
    out["ptxas"] = {k: v for lib in ("bn254_pairing", "g2_msm")
                    for k, v in kernels.ptxas_summary(lib).items()
                    if "_kernel" in k and "selftest" not in k}

    rng = random.Random(args.seed)
    g2 = (b.G2_X, b.G2_Y)
    prods = []
    for _ in range(DISTINCT):
        p = b.g1_mul_fast(rng.randrange(2, b.R), b.G1)
        q = b.g2_mul_fast(rng.randrange(2, b.R), g2)
        prods.append([(p, q), (p, b.g2_neg_tw(q))])
    staged = bn254.stage_pairing_products(prods)
    dev = torch.device("cuda:0")
    layouts = getattr(bn254, "LAYOUTS", (None,))
    prog = bn254._FINAL_EXP_PROGRAM
    entries = {}
    for n in () if args.msm_only else WIDTHS:
        xPs, yPs, Qs, Q1s, nQ2s = bn254.to_device(_tile(staged, n), dev)

        def cat_pt(qs):
            return tuple(tuple(torch.cat([q[i][j] for q in qs])
                               for j in range(2)) for i in range(2))
        mst = (torch.cat(xPs), torch.cat(yPs), cat_pt(Qs), cat_pt(Q1s),
               cat_pt(nQ2s))
        for g in layouts:
            kw = {} if g is None else {"group": g}
            tag = "default" if g is None else str(g)

            def miller(kw=kw):
                return bn254.miller_loop_batch(*mst, **kw)
            f = tower.flat_from_f12(miller()).contiguous()
            entries[f"miller_{2 * n}_{tag}"] = dict(
                ms=_events_ms(miller, args.reps), sha256=_sha(f))

            def final_exp(kw=kw, f=f):
                return bn254._final_exp_kernel(f, 2, n, prog, **kw)
            gt, ok = final_exp()
            entries[f"final_exp_{n}_{tag}"] = dict(
                ms=_events_ms(final_exp, args.reps), sha256=_sha(gt),
                all_true=bool(ok.all().cpu()))
    # the G2 MSM: 64 distinct three-term lanes tiled to the live lanes
    lanes = [[(rng.randrange(b.R), b.g2_mul_fast(rng.randrange(2, b.R), g2))
              for _ in range(3)] for _ in range(DISTINCT)]
    kw_m, qf = bn254.stage_g2_msm_words(lanes)
    kw_m, qf = _tile((kw_m, qf), MSM_LIVE)
    pad = MSM_LANES - MSM_LIVE
    kw_m = np.concatenate([kw_m, np.zeros((pad,) + kw_m.shape[1:],
                                          kw_m.dtype)])
    qf = [np.concatenate([a, a[:pad]]) for a in qf]
    entries["g2_msm_32768"] = _msm_entry(bn254, kw_m, qf, dev, args.reps)
    # the idemix block's MSM lanes: per presentation a Schnorr lane and
    # its subgroup lane, 64 distinct presentations tiled
    y_t = b.g2_mul_fast(rng.randrange(2, b.R), g2)
    lanes = []
    for _ in range(DISTINCT):
        q = b.g2_mul_fast(rng.randrange(2, b.R), g2)
        lanes.append([(rng.randrange(1, b.R), y_t),
                      (rng.randrange(1, b.R), g2),
                      (b.R - rng.randrange(1, b.R), q)])
        lanes.append([(6 * b.T_BN * b.T_BN, q), (0, None), (0, None)])
    kw_m, qf = _tile(bn254.stage_g2_msm_words(lanes), MSM_LIVE)
    entries[f"g2_msm_idemix_{MSM_LIVE}_interleaved"] = _msm_entry(
        bn254, kw_m, qf, dev, args.reps)
    order = msm_order(kw_m)
    entries[f"g2_msm_idemix_{MSM_LIVE}_class_order"] = _msm_entry(
        bn254, kw_m[order], [a[order] for a in qf], dev, args.reps,
        np.argsort(order)[:SAMPLE])
    out["entries"] = entries
    if args.msm_only:
        print(json.dumps(out), flush=True)
        return 0

    prov = factory.new_bccsp({"Default": "CUDA"})
    batch = (prods * (-(-args.products // DISTINCT)))[:args.products]
    if not all(prov.pairing_check_batch(batch)):
        raise SystemExit("bn_timing: an identity product did not verify")
    walls, busy = [], []
    for _ in range(args.call_reps):
        b0 = prov.device_cost.busy.totals().get(0, 0.0)
        t0 = time.perf_counter()
        if not all(prov.pairing_check_batch(batch)):
            raise SystemExit("bn_timing: an identity product did not verify")
        walls.append(time.perf_counter() - t0)
        busy.append(prov.device_cost.busy.totals().get(0, 0.0) - b0)
    out["pairing_check_batch"] = dict(
        products=args.products, wall_s=statistics.median(walls),
        busy_ms=statistics.median(busy) * 1e3)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
