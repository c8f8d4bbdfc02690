// The pairing kernels' cooperative layer: one lane (a Miller value, a
// final exponentiation) over a group of threads (a warp, or a part of
// one), its operands in shared memory, each Fp12 operation's independent
// products spread over the group's threads in rounds.
//
// A round is `g.each(count, job)`: thread t of the group runs jobs t,
// t + n, t + 2n, ... of it, each job a function of its index over the
// shared operands, and `g.sync()` ends the round. A job reads nothing that
// another job of its round writes, so any order of the jobs gives the
// same values: on the card the n threads of a group run them at once,
// rounds separated by __syncwarp() (a warp of 32 / n groups runs every
// round of its groups in step: the same job indices, the same bits and
// program rows, so one path); the host build
// (tests/cuda_host/cuda_runtime.h, where __syncwarp does nothing) runs
// each round as a loop over the job indices on one thread, first to last
// and, with `rev`, last to first, and the tests hold both orders to the
// plain versions (a round that read what a job of its own round writes
// would differ between them).
//
// A warp issues each instruction once for its 32 threads, and runs the
// distinct paths of a round one after another: so the work of a round is
// cut into jobs that all take one path. An Fp2 product is three jobs of
// one Fp product each (`products`: x0 y0, x1 y1, (x0 + x1)(y0 + y1), the
// tower's fp2_part, each job picking its operands with additions), and a
// second round adds them into the product (f2_from_parts): a round of up
// to 32 Fp products costs one product's time, where one thread's Fp2
// product costs three. Additions come in short rounds of one formula a
// job (terms, then coefficients: bls12_381_tower.cuh).
//
// Generic over the curve: the templates take a tower's traits `Tw` (its
// field core's types Fp, Fp2, Fp6, Fp12, its constants type Consts, its
// words a value NW, its formulas' product counts and its Miller loop's
// points: BlsTower, BnTower), and call the tower's functions unqualified,
// found through their argument types' namespace (bls12_381_tower.cuh,
// bn254_tower.cuh: fp2_part, f2_from_parts, f2_add, ..., the formulas'
// operands, terms and coefficients: sqr_operands, mul_operands,
// line_operands, cyc_operand, frob_operands, f6k_term, line_term,
// kara_coef, sqr_coef, cyc_coef, f6k_operands/f6k_coef, and fp_load,
// fp_store, f2_inv_binary, fp_to_plain). The line's placement (BLS12-381's
// M-type, BN254's D-type) lives in its tower's line_operands and
// line_term. Instantiated for BLS12-381 (bls12_381_pairing.cu) and BN254
// (bn254_pairing.cu).
//
// The bodies:
//   sqr, mul, mul_line, cyc, conj, frob: one Fp12 operation (out of line,
//     one body for every kernel that calls it): the products (12, 18, 13,
//     9, -, 6 Fp2 products: 36, 54, 39, 27, -, 18 jobs), a round of terms
//     (6, 9, 9; none for cyc, conj and frob) and one of six
//     coefficients;
//   inv: 1/f by the adjoint/norm method, Fp6 products in rounds, the Fp2
//     norm's inverse on one thread (f2_inv_binary);
//   miller_group: the Miller loop; a doubling step is f^2's products
//     beside the tangent step's first (57 jobs), f^2's terms beside its
//     second products (24) and f^2's coefficients beside their sums, f^2
//     times the sparse line beside its third products (48), the line
//     product's terms beside T', its coefficients; an addition step the
//     chord step's three product rounds (21, 18, 57 jobs: the last
//     beside f times the line), the terms beside T', the coefficients;
//     after the loop one addition step through each further point (BN254's
//     two correction points);
//   final_exp_group: the product of the lane's terms, 1/f, then the
//     register-machine program row by row, every `mul(d, a, a)` from row
//     `cyc_from` on a cyclotomic squaring;
//   reduce_group: the lanes' product tree in one launch, a group a node,
//     the second group to reach a node carrying on to its parent;
//   selftest_group: the layer's self-test, and the serial formulas'.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace coop {

struct Group {
  int t, n;           // this thread's index in the group, the group's size
  bool rev;           // host only: run a round's jobs last to first

  template <class Job>
  __device__ __forceinline__ void each(int count, Job job) const {
    if (rev) {
      for (int j = count - 1; j >= 0; --j) job(j);
    } else {
      for (int j = t; j < count; j += n) job(j);
    }
  }

  __device__ __forceinline__ void sync() const { __syncwarp(); }
};

// The most Fp2 products a round holds (a Miller step's first: f^2's 12
// and the tangent step's 7; the addition step's last: 13 and 6), as Fp
// parts.
constexpr int MAX_PARTS = 3 * 19;

// `count` Fp2 products in two rounds: pick(j, x, y) gives product j's
// operands and out(j) where it goes; n1 jobs x1(i) join the parts' round
// and n2 jobs x2(i) the sums'. m holds the parts.
template <class Tw, class Pick, class Out, class X1, class X2>
__device__ __forceinline__ void products_x(const Group& g, int count,
                                           Pick pick, Out out,
                                           typename Tw::Fp* m, int n1, X1 x1,
                                           int n2, X2 x2) {
  g.each(3 * count + n1, [&](int q) {
    if (q < 3 * count) {
      typename Tw::Fp2 x, y;
      pick(q / 3, x, y);
      m[q] = fp2_part(x, y, q % 3);
    } else {
      x1(q - 3 * count);
    }
  });
  g.sync();
  g.each(count + n2, [&](int j) {
    if (j < count) out(j) = f2_from_parts(m + 3 * j);
    else x2(j - count);
  });
  g.sync();
}

template <class Tw, class Pick, class Out>
__device__ __forceinline__ void products(const Group& g, int count,
                                         Pick pick, Out out,
                                         typename Tw::Fp* m) {
  products_x<Tw>(g, count, pick, out, m, 0, [](int) {}, 0, [](int) {});
}

// A lane's scratch for one Fp12 operation: the parts, the Fp2 products,
// the terms.
template <class Tw>
struct Scratch {
  typename Tw::Fp m[MAX_PARTS];
  typename Tw::Fp2 p[Tw::MUL_PRODS], t[9];
};

// -- one Fp12 operation each; r may alias a (and b) --

template <class Tw>
__device__ __noinline__ void sqr(const Group& g, typename Tw::Fp12& r,
                                 const typename Tw::Fp12& a, Scratch<Tw>& s,
                                 const typename Tw::Consts& k) {
  products<Tw>(
      g, Tw::SQR_PRODS,
      [&](int j, typename Tw::Fp2& x, typename Tw::Fp2& y) {
        sqr_operands(a, j, x, y, k);
      },
      [&](int j) -> typename Tw::Fp2& { return s.p[j]; }, s.m);
  g.each(6, [&](int j) { s.t[j] = f6k_term(s.p, j, k); });
  g.sync();
  g.each(6, [&](int i) { f12_slot(r, i) = sqr_coef(s.t, i, k); });
  g.sync();
}

template <class Tw>
__device__ __noinline__ void mul(const Group& g, typename Tw::Fp12& r,
                                 const typename Tw::Fp12& a,
                                 const typename Tw::Fp12& b, Scratch<Tw>& s,
                                 const typename Tw::Consts& k) {
  products<Tw>(
      g, Tw::MUL_PRODS,
      [&](int j, typename Tw::Fp2& x, typename Tw::Fp2& y) {
        mul_operands(a, b, j, x, y);
      },
      [&](int j) -> typename Tw::Fp2& { return s.p[j]; }, s.m);
  g.each(9, [&](int j) { s.t[j] = f6k_term(s.p, j, k); });
  g.sync();
  g.each(6, [&](int i) { f12_slot(r, i) = kara_coef(s.t, i, k); });
  g.sync();
}

template <class Tw>
__device__ __noinline__ void cyc(const Group& g, typename Tw::Fp12& r,
                                 const typename Tw::Fp12& a, Scratch<Tw>& s,
                                 const typename Tw::Consts& k) {
  products<Tw>(
      g, Tw::CYC_PRODS,
      [&](int j, typename Tw::Fp2& x, typename Tw::Fp2& y) {
        x = y = cyc_operand(a, j);
      },
      [&](int j) -> typename Tw::Fp2& { return s.p[j]; }, s.m);
  g.each(6, [&](int i) { f12_slot(r, i) = cyc_coef(a, s.p, i, k); });
  g.sync();
}

template <class Tw>
__device__ __noinline__ void conj(const Group& g, typename Tw::Fp12& r,
                                  const typename Tw::Fp12& a) {
  g.each(6, [&](int i) {
    f12_slot(r, i) = i < 3 ? f12_slot(a, i) : f2_neg(f12_slot(a, i));
  });
  g.sync();
}

template <class Tw>
__device__ __noinline__ void frob(const Group& g, typename Tw::Fp12& r,
                                  const typename Tw::Fp12& a, Scratch<Tw>& s,
                                  const typename Tw::Consts& k) {
  products<Tw>(
      g, 6,
      [&](int i, typename Tw::Fp2& x, typename Tw::Fp2& y) {
        frob_operands(a, i, x, y, k);
      },
      [&](int i) -> typename Tw::Fp2& { return f12_slot(r, i); }, s.m);
}

// r = f times a sparse line whose coefficients `line` computes (A, B, C)
// from shared values (in each job), with n1 further products (`pick1(j,
// x, y)` their operands, `out1(j)` where they go) beside the line's and
// n2 jobs x2 beside its terms
template <class Tw, class Line, class Pick1, class Out1, class X2>
__device__ __forceinline__ void mul_line(
    const Group& g, typename Tw::Fp12& r, const typename Tw::Fp12& f,
    Line line, int n1, Pick1 pick1, Out1 out1, int n2, X2 x2,
    Scratch<Tw>& s, const typename Tw::Consts& k) {
  using Fp2 = typename Tw::Fp2;
  constexpr int L = Tw::LINE_PRODS;
  products<Tw>(
      g, L + n1,
      [&](int j, Fp2& x, Fp2& y) {
        if (j < L) {
          Fp2 A, B, C;
          line(A, B, C);
          line_operands(f, A, B, C, j, x, y);
        } else {
          pick1(j - L, x, y);
        }
      },
      [&](int j) -> Fp2& { return j < L ? s.p[j] : out1(j - L); }, s.m);
  g.each(9 + n2, [&](int j) {
    if (j < 9) s.t[j] = line_term(s.p, j, k);
    else x2(j - 9);
  });
  g.sync();
  g.each(6, [&](int i) { f12_slot(r, i) = kara_coef(s.t, i, k); });
  g.sync();
}

// Scratch for 1/f: the Fp6 norm N, the adjoint t, the Fp2 norm's inverse
// and 1/N.
template <class Tw>
struct InvScratch {
  typename Tw::Fp2 n[3], t[3], ninv;
  typename Tw::Fp6 ni;
};

template <class Tw>
__device__ __noinline__ void inv_finish(const Group& g, typename Tw::Fp12& r,
                                        const typename Tw::Fp12& a,
                                        Scratch<Tw>& s, InvScratch<Tw>& v,
                                        const typename Tw::Consts& k);

// r = 1/a (r must not alias a)
template <class Tw>
__device__ __noinline__ void inv(const Group& g, typename Tw::Fp12& r,
                                 const typename Tw::Fp12& a, Scratch<Tw>& s,
                                 InvScratch<Tw>& v,
                                 const typename Tw::Consts& k) {
  using Fp2 = typename Tw::Fp2;
  auto* p = s.p;
  auto to_p = [&](int j) -> Fp2& { return p[j]; };
  // a0^2 (products 0-5), a1^2 (6-11)
  products<Tw>(
      g, 12,
      [&](int j, Fp2& x, Fp2& y) {
        f6k_operands(j < 6 ? a.d0 : a.d1, j < 6 ? a.d0 : a.d1, j % 6, x, y);
      },
      to_p, s.m);
  // N = a0^2 - v a1^2
  g.each(3, [&](int i) {
    const Fp2 t1 = f6k_coef(p + 6, i == 0 ? 2 : i - 1, k);
    v.n[i] = f2_sub(f6k_coef(p, i, k), i == 0 ? f2_mul_xi(t1, k) : t1);
  });
  g.sync();
  // c0^2, c1 c2, c2^2, c0 c1, c1^2, c0 c2 of N = (c0, c1, c2)
  products<Tw>(
      g, 6,
      [&](int j, Fp2& x, Fp2& y) {
        x = v.n[j == 1 || j == 4 ? 1 : j == 2 ? 2 : 0];
        y = v.n[j == 0 ? 0 : j == 3 || j == 4 ? 1 : 2];
      },
      to_p, s.m);
  // the adjoint t0 = c0^2 - xi c1 c2, t1 = xi c2^2 - c0 c1,
  // t2 = c1^2 - c0 c2
  g.each(3, [&](int j) {
    v.t[j] = j == 0 ? f2_sub(p[0], f2_mul_xi(p[1], k))
           : j == 1 ? f2_sub(f2_mul_xi(p[2], k), p[3])
                    : f2_sub(p[4], p[5]);
  });
  g.sync();
  // c0 t0, c2 t1, c1 t2
  products<Tw>(
      g, 3,
      [&](int j, Fp2& x, Fp2& y) {
        x = v.n[j == 0 ? 0 : j == 1 ? 2 : 1];
        y = v.t[j];
      },
      to_p, s.m);
  // the Fp2 norm c0 t0 + xi (c2 t1 + c1 t2) and its inverse, one thread
  g.each(1, [&](int) {
    f2_inv_binary(v.ninv, f2_add(p[0], f2_mul_xi(f2_add(p[1], p[2]), k)),
                  k);
  });
  g.sync();
  inv_finish<Tw>(g, r, a, s, v, k);
}

// 1/a from the inverse of its Fp6 norm's adjoint form (inv's last
// rounds)
template <class Tw>
__device__ __noinline__ void inv_finish(const Group& g, typename Tw::Fp12& r,
                                        const typename Tw::Fp12& a,
                                        Scratch<Tw>& s, InvScratch<Tw>& v,
                                        const typename Tw::Consts& k) {
  using Fp2 = typename Tw::Fp2;
  auto* p = s.p;
  // 1/N = t / norm
  products<Tw>(
      g, 3,
      [&](int j, Fp2& x, Fp2& y) {
        x = v.t[j];
        y = v.ninv;
      },
      [&](int j) -> Fp2& { return v.ni.c[j]; }, s.m);
  // a0 / N (products 0-5), a1 / N (6-11); r = (a0 / N, -a1 / N)
  products<Tw>(
      g, 12,
      [&](int j, Fp2& x, Fp2& y) {
        f6k_operands(j < 6 ? a.d0 : a.d1, v.ni, j % 6, x, y);
      },
      [&](int j) -> Fp2& { return p[j]; }, s.m);
  g.each(6, [&](int i) {
    f12_slot(r, i) = i < 3 ? f6k_coef(p, i, k)
                           : f2_neg(f6k_coef(p + 6, i - 3, k));
  });
  g.sync();
}

// -- the Miller loop --

// A lane's Miller state: f, f^2, T = (X : Y : Z), the points q[i] =
// (x, y) (Q first), P = (xP, yP), the twist step's products (d1..d3, its
// three product rounds) and the scratch of the Fp12 operations.
template <class Tw>
struct MillerState {
  typename Tw::Fp12 f, f2;
  typename Tw::Fp2 X, Y, Z, q[Tw::MILLER_POINTS][2];
  typename Tw::Fp xP, yP;
  typename Tw::Fp2 d1[7], d2[6], d3[6];
  Scratch<Tw> s;
};

// The doubling with its tangent line (RCB15 Alg 9, a = 0), regrouped into
// three rounds of independent products (each job picks x, y; squares are
// x x and scalings by an Fp value s are x (s, 0), so that a round's jobs
// share one f2_mul):
//   d1: Z^2, X^2, YZ, Y^2, XY, Y yP, Z xP;
//   d2: (Y yP) Z^2, (Z xP) X^2, X^2 X, Y (YZ), b3' Z^2, YZ 8Y^2;
//   d3: t2 8t0, (t0 - 3t2)(t0 + t2), (t0 - 3t2) XY   (t0 = Y^2,
//       t2 = b3' Z^2);
// line A = 2 Y Z^2 yP, B = -3 X^2 Z xP, C = 3 X^3 - 2 Y^2 Z; T' = (2 d3[2],
// d3[0] + d3[1], d2[5]).
template <class Tw>
__device__ __forceinline__ typename Tw::Fp2 as_f2(const typename Tw::Fp& s,
                                                 const typename Tw::Fp2& z) {
  typename Tw::Fp2 r = z;
  r.c0 = s;
  return r;
}

template <class Tw>
__device__ __forceinline__ void dbl_operands1(const MillerState<Tw>& st,
                                              int j, typename Tw::Fp2& x,
                                              typename Tw::Fp2& y,
                                              const typename Tw::Consts& k) {
  x = j == 0 || j == 6 ? st.Z : j == 1 || j == 4 ? st.X : st.Y;
  y = j == 0 || j == 2 ? st.Z : j == 1 ? st.X : j == 3 || j == 4 ? st.Y
    : as_f2<Tw>(j == 5 ? st.yP : st.xP, f2_zero(k));
}

template <class Tw>
__device__ __forceinline__ void dbl_operands2(const MillerState<Tw>& st,
                                              int j, typename Tw::Fp2& x,
                                              typename Tw::Fp2& y,
                                              const typename Tw::Consts& k) {
  const auto* d = st.d1;
  switch (j) {
    case 0: x = d[5]; y = d[0]; break;
    case 1: x = d[6]; y = d[1]; break;
    case 2: x = d[1]; y = st.X; break;
    case 3: x = st.Y; y = d[2]; break;
    case 4: x = k.b3; y = d[0]; break;
    default: x = d[2]; y = f2_small(d[3], 8); break;
  }
}

template <class Tw>
__device__ __forceinline__ void dbl_operands3(const MillerState<Tw>& st,
                                              int j, typename Tw::Fp2& x,
                                              typename Tw::Fp2& y) {
  const auto& t0 = st.d1[3];
  const auto& t2 = st.d2[4];
  if (j == 0) {
    x = t2;
    y = f2_small(t0, 8);
    return;
  }
  x = f2_sub(t0, f2_small(t2, 3));
  y = j == 1 ? f2_add(t0, t2) : st.d1[4];
}

template <class Tw>
__device__ __noinline__ void dbl_line(const MillerState<Tw>& st,
                                      typename Tw::Fp2& A,
                                      typename Tw::Fp2& B,
                                      typename Tw::Fp2& C) {
  const auto* d = st.d2;
  A = f2_small(d[0], 2);
  B = f2_neg(f2_small(d[1], 3));
  C = f2_sub(f2_small(d[2], 3), f2_small(d[3], 2));
}

// The mixed addition T + Q, Q = (xQ, yQ), with its chord line (RCB15
// Alg 7, a = 0, Z2 = 1), in three rounds:
//   d1: X1 xQ, Y1 yQ, (X1 + Y1)(xQ + yQ), (Y1 + Z1)(yQ + 1),
//       (X1 + Z1)(xQ + 1), xQ Z1, yQ Z1;
//   d2: b3' Z1, b3' Y3, dY xQ, dX yQ, dX yP, -dY xP   (dX = X1 - xQ Z1,
//       dY = Y1 - yQ Z1, Y3 = (X1 + Z1)(xQ + 1) - X1 xQ - Z1);
//   d3: t4 Y3', t3 t1', Y3' t0', t1' Z3, Z3 t4, t0' t3 (the algorithm's
//       last six products);
// line A = dX yP, B = -dY xP, C = dY xQ - dX yQ; T' = (d3[1] - d3[0],
// d3[3] + d3[2], d3[4] + d3[5]).
template <class Tw>
__device__ __forceinline__ void add_operands1(const MillerState<Tw>& st,
                                              const typename Tw::Fp2& xQ,
                                              const typename Tw::Fp2& yQ,
                                              int j, typename Tw::Fp2& x,
                                              typename Tw::Fp2& y,
                                              const typename Tw::Consts& k) {
  const auto one = f2_one(k);
  switch (j) {
    case 0: x = st.X; y = xQ; break;
    case 1: x = st.Y; y = yQ; break;
    case 2: x = f2_add(st.X, st.Y); y = f2_add(xQ, yQ); break;
    case 3: x = f2_add(st.Y, st.Z); y = f2_add(yQ, one); break;
    case 4: x = f2_add(st.X, st.Z); y = f2_add(xQ, one); break;
    case 5: x = xQ; y = st.Z; break;
    default: x = yQ; y = st.Z; break;
  }
}

template <class Tw>
__device__ __forceinline__ void add_operands2(const MillerState<Tw>& st,
                                              const typename Tw::Fp2& xQ,
                                              const typename Tw::Fp2& yQ,
                                              int j, typename Tw::Fp2& x,
                                              typename Tw::Fp2& y,
                                              const typename Tw::Consts& k) {
  const auto* d = st.d1;
  const auto dX = f2_sub(st.X, d[5]), dY = f2_sub(st.Y, d[6]);
  switch (j) {
    case 0: x = k.b3; y = st.Z; break;
    case 1: x = k.b3; y = f2_sub(d[4], f2_add(d[0], st.Z)); break;
    case 2: x = dY; y = xQ; break;
    case 3: x = dX; y = yQ; break;
    case 4: x = dX; y = as_f2<Tw>(st.yP, f2_zero(k)); break;
    default: x = f2_neg(dY); y = as_f2<Tw>(st.xP, f2_zero(k)); break;
  }
}

template <class Tw>
__device__ __forceinline__ void add_operands3(const MillerState<Tw>& st,
                                              int j, typename Tw::Fp2& x,
                                              typename Tw::Fp2& y) {
  const auto* d = st.d1;
  const auto* e = st.d2;
  const auto t3 = f2_sub(d[2], f2_add(d[0], d[1]));
  const auto t4 = f2_sub(d[3], f2_add(d[1], st.Z));
  const auto t0 = f2_small(d[0], 3);
  const auto Z3 = f2_add(d[1], e[0]);
  const auto t1 = f2_sub(d[1], e[0]);
  switch (j) {
    case 0: x = t4; y = e[1]; break;
    case 1: x = t3; y = t1; break;
    case 2: x = e[1]; y = t0; break;
    case 3: x = t1; y = Z3; break;
    case 4: x = Z3; y = t4; break;
    default: x = t0; y = t3; break;
  }
}

template <class Tw>
__device__ __noinline__ void add_line(const MillerState<Tw>& st,
                                      typename Tw::Fp2& A,
                                      typename Tw::Fp2& B,
                                      typename Tw::Fp2& C) {
  A = st.d2[4];
  B = st.d2[5];
  C = f2_sub(st.d2[2], st.d2[3]);
}

// the doubling step: f = f^2 * tangent line, T = 2T
template <class Tw>
__device__ __noinline__ void miller_dbl(const Group& g, MillerState<Tw>& st,
                                        const typename Tw::Consts& k) {
  using Fp2 = typename Tw::Fp2;
  constexpr int S = Tw::SQR_PRODS;
  auto& s = st.s;
  // f^2's products beside d1
  products<Tw>(
      g, S + 7,
      [&](int j, Fp2& x, Fp2& y) {
        if (j < S) sqr_operands(st.f, j, x, y, k);
        else dbl_operands1(st, j - S, x, y, k);
      },
      [&](int j) -> Fp2& { return j < S ? s.p[j] : st.d1[j - S]; }, s.m);
  // d2 with f^2's terms beside its parts and f^2's coefficients beside
  // its sums
  products_x<Tw>(
      g, 6,
      [&](int j, Fp2& x, Fp2& y) { dbl_operands2(st, j, x, y, k); },
      [&](int j) -> Fp2& { return st.d2[j]; }, s.m,
      6, [&](int j) { s.t[j] = f6k_term(s.p, j, k); },
      6, [&](int i) { f12_slot(st.f2, i) = sqr_coef(s.t, i, k); });
  // f = f^2 * line beside d3, then its terms beside T'
  mul_line<Tw>(
      g, st.f, st.f2,
      [&](Fp2& A, Fp2& B, Fp2& C) { dbl_line(st, A, B, C); },
      3, [&](int j, Fp2& x, Fp2& y) { dbl_operands3(st, j, x, y); },
      [&](int j) -> Fp2& { return st.d3[j]; },
      3, [&](int j) {
        if (j == 0) st.X = f2_small(st.d3[2], 2);
        else if (j == 1) st.Y = f2_add(st.d3[0], st.d3[1]);
        else st.Z = st.d2[5];
      },
      s, k);
}

// the addition step: f = f * chord line, T = T + Q, Q = (xQ, yQ)
template <class Tw>
__device__ __noinline__ void miller_add(const Group& g, MillerState<Tw>& st,
                                        const typename Tw::Fp2& xQ,
                                        const typename Tw::Fp2& yQ,
                                        const typename Tw::Consts& k) {
  using Fp2 = typename Tw::Fp2;
  auto& s = st.s;
  products<Tw>(
      g, 7,
      [&](int j, Fp2& x, Fp2& y) { add_operands1(st, xQ, yQ, j, x, y, k); },
      [&](int j) -> Fp2& { return st.d1[j]; }, s.m);
  products<Tw>(
      g, 6,
      [&](int j, Fp2& x, Fp2& y) { add_operands2(st, xQ, yQ, j, x, y, k); },
      [&](int j) -> Fp2& { return st.d2[j]; }, s.m);
  mul_line<Tw>(
      g, st.f, st.f,
      [&](Fp2& A, Fp2& B, Fp2& C) { add_line(st, A, B, C); },
      6, [&](int j, Fp2& x, Fp2& y) { add_operands3(st, j, x, y); },
      [&](int j) -> Fp2& { return st.d3[j]; },
      3, [&](int j) {
        const auto* d = st.d3;
        if (j == 0) st.X = f2_sub(d[1], d[0]);
        else if (j == 1) st.Y = f2_add(d[3], d[2]);
        else st.Z = f2_add(d[4], d[5]);
      },
      s, k);
}

// f = Fp12 one
template <class Tw>
__device__ __forceinline__ void set_one(const Group& g, typename Tw::Fp12& f,
                                        const typename Tw::Consts& k) {
  g.each(6, [&](int i) { f12_slot(f, i) = i ? f2_zero(k) : f2_one(k); });
  g.sync();
}

// The Miller value of lane `lane` (pts (2 + 4 MILLER_POINTS, B, L): xP,
// yP, then each point's x.c0, x.c1, y.c0, y.c1), its bits after the
// leading one msb first in (lo, hi), nbits of them: the loop over Q, then
// one addition step through each further point. A lane whose mask is 0
// (mask may be null: every lane live) stores Fp12 one; a pad lane (lane
// >= B: a group of a block past the batch) runs the rounds on lane B - 1's
// points and stores nothing. out (12, B, L) canonical.
template <class Tw>
__device__ __forceinline__ void miller_group(
    const Group& g, MillerState<Tw>& st, const int* pts, const uint8_t* mask,
    int B, int lane, uint32_t bits_lo, uint32_t bits_hi, int nbits,
    const typename Tw::Consts& k, int* out) {
  const int src = lane < B ? lane : B - 1;
  if (!mask || mask[src]) {
    g.each(2 + 4 * Tw::MILLER_POINTS, [&](int i) {
      const auto v = fp_load(pts, B, i, src, k);
      if (i == 0) {
        st.xP = v;
      } else if (i == 1) {
        st.yP = v;
      } else {
        auto& c = st.q[(i - 2) / 4][(i - 2) / 2 % 2];
        (i % 2 ? c.c1 : c.c0) = v;
      }
    });
    g.sync();
    g.each(3, [&](int j) {
      if (j == 0) st.X = st.q[0][0];
      else if (j == 1) st.Y = st.q[0][1];
      else st.Z = f2_one(k);
    });
    set_one<Tw>(g, st.f, k);
    for (int i = nbits - 1; i >= 0; --i) {
      const uint32_t bit = i >= 32 ? (bits_hi >> (i - 32)) & 1u
                                   : (bits_lo >> i) & 1u;
      miller_dbl<Tw>(g, st, k);
      if (bit) miller_add<Tw>(g, st, st.q[0][0], st.q[0][1], k);
    }
    for (int i = 1; i < Tw::MILLER_POINTS; ++i)
      miller_add<Tw>(g, st, st.q[i][0], st.q[i][1], k);
  } else {
    set_one<Tw>(g, st.f, k);
  }
  if (lane < B) {
    g.each(12, [&](int i) {
      const auto& c = f12_slot(st.f, i / 2);
      fp_store(out, B, i, lane, i & 1 ? c.c1 : c.c0, k);
    });
  }
}

// -- the final exponentiation --

// The register file (8 Fp12 registers), the scratch of the current row
// and of 1/f.
template <class Tw>
struct FinalExpState {
  typename Tw::Fp12 reg[8];
  Scratch<Tw> s;
  InvScratch<Tw> inv;
  int flag[12];
};

// the program's rows on the register file
template <class Tw>
__device__ __noinline__ void run_rows(const Group& g, FinalExpState<Tw>& st,
                                      const int* prog, int nrows,
                                      int cyc_from,
                                      const typename Tw::Consts& k) {
  for (int r = 0; r < nrows; ++r) {
    const int op = __ldg(prog + 4 * r), dst = __ldg(prog + 4 * r + 1),
              a = __ldg(prog + 4 * r + 2), b = __ldg(prog + 4 * r + 3);
    if (op == 0) {
      if (a == b && r >= cyc_from) cyc<Tw>(g, st.reg[dst], st.reg[a], st.s, k);
      else mul<Tw>(g, st.reg[dst], st.reg[a], st.reg[b], st.s, k);
    } else if (op == 1) {
      conj<Tw>(g, st.reg[dst], st.reg[a]);
    } else {
      frob<Tw>(g, st.reg[dst], st.reg[a], st.s, k);
    }
  }
}

// One lane's final exponentiation: f = the product of the lane's nterms
// Miller values (f_in (12, nterms B, L), term t at column t B + lane),
// registers 0 and 1 = f and 1/f, the rest 0, then the program's rows (op,
// dst, a, b: 0 = mul, 1 = conj, 2 = frob), a `mul(d, a, a)` at row
// cyc_from or later as a cyclotomic squaring. gt (12, B, L): register 0,
// canonical; ok[lane] = it is one. A pad lane (lane >= B) runs on lane
// B - 1's values and stores nothing.
template <class Tw>
__device__ __forceinline__ void final_exp_group(
    const Group& g, FinalExpState<Tw>& st, const int* f_in, int B, int lane,
    const int* prog, int nrows, int cyc_from, const typename Tw::Consts& k,
    int* gt, uint8_t* ok, int nterms = 1) {
  const int src = lane < B ? lane : B - 1;
  for (int t = 0; t < nterms; ++t) {
    auto& dst = st.reg[t ? 2 : 0];
    g.each(12, [&](int i) {
      auto& c = f12_slot(dst, i / 2);
      (i & 1 ? c.c1 : c.c0) = fp_load(f_in, nterms * B, i, t * B + src, k);
    });
    g.sync();
    if (t) mul<Tw>(g, st.reg[0], st.reg[0], st.reg[2], st.s, k);
  }
  g.each(6 * 6, [&](int i) {
    f12_slot(st.reg[2 + i / 6], i % 6) = f2_zero(k);
  });
  g.sync();
  inv<Tw>(g, st.reg[1], st.reg[0], st.s, st.inv, k);
  run_rows<Tw>(g, st, prog, nrows, cyc_from, k);
  g.each(12, [&](int i) {
    const auto& c = f12_slot(st.reg[0], i / 2);
    const auto& x = i & 1 ? c.c1 : c.c0;
    if (lane < B) fp_store(gt, B, i, lane, x, k);
    st.flag[i] = i == 0 ? fp_eq_words(fp_canonical(x), fp_canonical(k.one))
                        : fp_is_zero(x);
  });
  g.sync();
  g.each(1, [&](int) {
    bool all = true;
    for (int i = 0; i < 12; ++i) all = all && st.flag[i];
    if (lane < B) ok[lane] = all ? 1 : 0;
  });
}

// -- the product reduce: a lane's product tree in one launch --
//
// fabric_tpu's _product_reduce over f (12, B, L), B a power of two: level
// 0 has B/2 nodes, node j = f[j] * f[j + B/2]; level l + 1 has half as
// many, node j = node j of level l times node j + (its width / 2). Group
// w computes node w of level 0, then climbs: it publishes its node (the
// Fp12 words in `nodes`, node (l, j) at index B - (B >> l) + j: B - 1
// nodes), fences, and bumps the parent's counter in `cnt` (B ints, zero
// before a launch); the group that arrives second at a parent sets the
// counter back to 0 (so the counters are zero again after the launch and
// serve the next one), reads its sibling's node (loads that bypass L1:
// another SM wrote it) and computes the parent; the first stops. So the chain is log2(B) products
// whatever order the groups run in, and the root's group writes the
// product to lane 0 of f, canonical. Each product is lo * hi, as the
// halving product's.
template <class Tw>
struct ReduceState {
  typename Tw::Fp12 v[2];     // this group's node, its sibling's
  Scratch<Tw> s;
  int go;
};

template <class Tw>
__device__ __forceinline__ void reduce_group(const Group& g,
                                             ReduceState<Tw>& st, int* f,
                                             uint32_t* nodes, int* cnt,
                                             int B, int w,
                                             const typename Tw::Consts& k) {
  constexpr int WORDS = 12 * Tw::NW;
  const int half = B / 2;
  g.each(24, [&](int i) {
    auto& c = f12_slot(st.v[i / 12], (i % 12) / 2);
    (i & 1 ? c.c1 : c.c0) = fp_load(f, B, i % 12, w + (i / 12) * half, k);
  });
  g.sync();
  mul<Tw>(g, st.v[0], st.v[0], st.v[1], st.s, k);
  int j = w;
  for (int n = half; n > 1; n /= 2) {       // n: this level's nodes
    const int base = B - 2 * n;             // this level's first node
    g.each(12, [&](int i) {
      const auto& c = f12_slot(st.v[0], i / 2);
      const auto& x = i & 1 ? c.c1 : c.c0;
      uint32_t* dst = nodes + static_cast<size_t>(base + j) * WORDS +
                      i * Tw::NW;
      for (int q = 0; q < Tw::NW; ++q) dst[q] = x.w[q];
      __threadfence();
    });
    g.sync();
    const int up = j & (n / 2 - 1);         // the parent
    g.each(1, [&](int) {
      st.go = atomicAdd(cnt + base + n + up, 1);
      if (st.go) cnt[base + n + up] = 0;   // both arrived: reset for reuse
      __threadfence();
    });
    g.sync();
    if (st.go == 0) return;                 // the sibling carries on
    const int sib = j ^ (n / 2);
    g.each(12, [&](int i) {
      auto& c = f12_slot(st.v[1], i / 2);
      auto& x = i & 1 ? c.c1 : c.c0;
      const uint32_t* src = nodes + static_cast<size_t>(base + sib) * WORDS +
                            i * Tw::NW;
      for (int q = 0; q < Tw::NW; ++q) x.w[q] = __ldcg(src + q);
    });
    g.sync();
    if (j < sib) mul<Tw>(g, st.v[0], st.v[0], st.v[1], st.s, k);
    else mul<Tw>(g, st.v[0], st.v[1], st.v[0], st.s, k);
    j = up;
  }
  g.each(12, [&](int i) {
    const auto& c = f12_slot(st.v[0], i / 2);
    fp_store(f, B, i, 0, i & 1 ? c.c1 : c.c0, k);
  });
}

// -- the layer's self-test (the pairing libraries' coop self-test entries;
// host tests) --
//
// in: 42 plain values as NW words each: x (Fp12, 12), y (Fp12, 12), a
// line's A, B, C (6) and c (Fp12, 12: an element of the cyclotomic
// subgroup). out: 110 canonical plain values, x^2 by f12_sqr and by the
// group, x times the tower's sparse line by f12_mul_line and by the group,
// c^2 by f12_sqr_cyclotomic and by the group, the group's x * y, 1/x and
// x^p, and the inverse of x's first coefficient by fp_inv_binary and by
// fp_inv (0 for 0); then SELFTEST_CYCLES words of clock cycles (0 on the
// host): fp_inv (Fermat) and fp_inv_binary on that coefficient on one
// thread, the group's Fp12 product and cyclotomic squaring (every round
// and barrier), and one thread's f2_mul and f2_add of shared operands
// (each the last of three runs).
constexpr int SELFTEST_IN = 42;
constexpr int SELFTEST_OUT = 9 * 12 + 2;
constexpr int SELFTEST_CYCLES = 6;

template <class Tw>
__device__ __noinline__ void selftest_put(const Group& g,
                                          const typename Tw::Fp12& a,
                                          uint32_t* out, int at) {
  g.each(12, [&](int i) {
    const auto& c = f12_slot(a, i / 2);
    const auto v = fp_to_plain(i & 1 ? c.c1 : c.c0);
    for (int j = 0; j < Tw::NW; ++j) out[Tw::NW * (at + i) + j] = v.w[j];
  });
  g.sync();
}

template <class Tw>
__device__ __forceinline__ void selftest_group(const Group& g,
                                               FinalExpState<Tw>& st,
                                               const uint32_t* in,
                                               const typename Tw::Consts& k,
                                               uint32_t* out) {
  using Fp = typename Tw::Fp;
  using Fp2 = typename Tw::Fp2;
  constexpr int NW = Tw::NW;
  auto &x = st.reg[0], &y = st.reg[1], &c = st.reg[2], &r = st.reg[3];
  Scratch<Tw>& s = st.s;
  Fp2* line = st.inv.n;                      // A, B, C
  g.each(SELFTEST_IN, [&](int i) {
    Fp a;
    for (int j = 0; j < NW; ++j) a.w[j] = in[NW * i + j];
    const Fp m = fp_mul(a, k.r2);
    Fp2& slot = i < 12 ? f12_slot(x, i / 2)
              : i < 24 ? f12_slot(y, (i - 12) / 2)
              : i < 30 ? line[(i - 24) / 2] : f12_slot(c, (i - 30) / 2);
    (i & 1 ? slot.c1 : slot.c0) = m;
  });
  g.sync();
  g.each(1, [&](int) { f12_sqr(r, x, k); });
  g.sync();
  selftest_put<Tw>(g, r, out, 0);
  sqr<Tw>(g, r, x, s, k);
  selftest_put<Tw>(g, r, out, 12);
  g.each(1, [&](int) { f12_mul_line(r, x, line[0], line[1], line[2], k); });
  g.sync();
  selftest_put<Tw>(g, r, out, 24);
  mul_line<Tw>(
      g, r, x,
      [&](Fp2& A, Fp2& B, Fp2& C) {
        A = line[0];
        B = line[1];
        C = line[2];
      },
      0, [&](int, Fp2& a, Fp2& b) { a = b = line[0]; },
      [&](int) -> Fp2& { return s.p[0]; }, 0, [](int) {}, s, k);
  selftest_put<Tw>(g, r, out, 36);
  g.each(1, [&](int) { f12_sqr_cyclotomic(r, c, k); });
  g.sync();
  selftest_put<Tw>(g, r, out, 48);
  cyc<Tw>(g, r, c, s, k);
  selftest_put<Tw>(g, r, out, 60);
  mul<Tw>(g, r, x, y, s, k);
  selftest_put<Tw>(g, r, out, 72);
  inv<Tw>(g, r, x, s, st.inv, k);
  selftest_put<Tw>(g, r, out, 84);
  frob<Tw>(g, r, x, s, k);
  selftest_put<Tw>(g, r, out, 96);
  g.each(1, [&](int) {
    Fp fermat, binary;
    const long long t0 = clock64();
    fp_inv(fermat, x.d0.c[0].c0);
    const long long t1 = clock64();
    fp_inv_binary(binary, x.d0.c[0].c0, k.r2);
    const long long t2 = clock64();
    const Fp v = fp_to_plain(binary), w = fp_to_plain(fermat);
    for (int j = 0; j < NW; ++j) {
      out[NW * 108 + j] = v.w[j];
      out[NW * 109 + j] = w.w[j];
    }
    out[NW * SELFTEST_OUT] = static_cast<uint32_t>(t1 - t0);
    out[NW * SELFTEST_OUT + 1] = static_cast<uint32_t>(t2 - t1);
  });
  g.sync();
  // the group's clock around one Fp12 product and one cyclotomic
  // squaring (their rounds and barriers), then one thread's around an
  // f2_mul and an f2_add of shared operands: each the third of three runs
  // (the first fetches the code)
  long long t3 = 0, t4 = 0, t5 = 0;
  for (int rep = 0; rep < 3; ++rep) {
    t3 = clock64();
    mul<Tw>(g, r, x, y, s, k);
    t4 = clock64();
    cyc<Tw>(g, r, c, s, k);
    t5 = clock64();
  }
  g.each(1, [&](int) {
    long long t6 = 0, t7 = 0, t8 = 0;
    for (int rep = 0; rep < 3; ++rep) {
      t6 = clock64();
      s.p[0] = f2_mul(s.p[1], s.p[2]);
      t7 = clock64();
      s.p[3] = f2_add(s.p[4], s.p[5]);
      t8 = clock64();
    }
    out[NW * SELFTEST_OUT + 2] = static_cast<uint32_t>(t4 - t3);
    out[NW * SELFTEST_OUT + 3] = static_cast<uint32_t>(t5 - t4);
    out[NW * SELFTEST_OUT + 4] = static_cast<uint32_t>(t7 - t6);
    out[NW * SELFTEST_OUT + 5] = static_cast<uint32_t>(t8 - t7);
  });
  g.sync();
}

}  // namespace coop
}  // namespace
