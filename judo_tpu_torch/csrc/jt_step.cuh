// One physics step and the whole T-step rollout of one rollout, computed by
// one warp: sensors (distance sensors over the warp), narrowphase, constraint
// assembly (joint equalities, joint limits, contacts), the accelerated
// projected-gradient dual solve with the carried Collatz-Wielandt probe, and
// implicit-damping integration. Twin of judo_tpu_torch/physics/lane_step.py:
// step_l and fused_rollout.py:rollout_lanes_reference. Every stage that walks
// J or an nefc-long vector spreads its rows (or dofs, contacts, pairs) over
// the lanes through Warp; kinematics, dynamics, sensors and the position
// update run on lane 0.
#pragma once

#include "jt_collision.cuh"
#include "jt_dynamics.cuh"

namespace jt {

constexpr double kMinval = 1e-15, kMinimp = 1e-4, kMaximp = 0.9999;

template <typename T>
HD T impedance(const T* si, T pos) {
  const T dmin = si[0], dmax = si[1], width = tmax(si[2], T(kMinval));
  const T mid = tmin(tmax(si[3], T(kMinimp)), T(kMaximp)), power = tmax(si[4], T(1));
  const T x = tclip(tabs(pos) / width, T(0), T(1));
  T y = x;
  if (power != T(1)) {
    y = x <= mid ? tpow(mid, T(1) - power) * tpow(x, power)
                 : T(1) - tpow(T(1) - mid, T(1) - power) * tpow(T(1) - x, power);
  }
  return tclip(dmin + y * (dmax - dmin), T(kMinimp), T(kMaximp));
}

template <typename T>
HD void sensors(const Ctx<T>& c, Lane<T> qpos, Lane<T> qvel, Lane<T> out) {
  const Lane<T> w = c.w;
  for (int k = 0; k < c.s.nsensordata; ++k) out[k] = T(0);
  for (int i = 0; i < c.s.nsensor; ++i) {
    const int* si = c.mi + c.L.in + NI * i;
    const int st = si[0], ot = si[1], oid = si[2], adr = si[3], reft = si[5], refid = si[6];
    if (st == S_JOINTPOS) {
      out[adr] = qpos[c.jnt_i(oid)[1]];
    } else if (st == S_JOINTVEL) {
      out[adr] = qvel[c.jnt_i(oid)[2]];
    } else if (st == S_FRAMEPOS) {
      int64_t src = -1;
      if (ot == OBJ_SITE) src = c.S.sxpos + 3 * oid;
      if (ot == OBJ_BODY) src = c.S.xipos + 3 * oid;
      if (ot == OBJ_XBODY) src = c.S.xpos + 3 * oid;
      if (src < 0) continue;
      T val[3];
      lload(w, src, 3, val);
      if (refid >= 0 && reft == OBJ_SITE) {
        T rel[3], m[9];
        for (int k = 0; k < 3; ++k) rel[k] = val[k] - w[c.S.sxpos + 3 * refid + k];
        lload(w, c.S.sxmat + 9 * refid, 9, m);
        for (int j = 0; j < 3; ++j) val[j] = m[j] * rel[0] + m[3 + j] * rel[1] + m[6 + j] * rel[2];
      }
      for (int k = 0; k < 3; ++k) out[adr + k] = val[k];
    } else if (st >= S_FRAMEXAXIS && st <= S_FRAMEZAXIS) {
      const int col = st - S_FRAMEXAXIS;
      int64_t src = -1;
      if (ot == OBJ_SITE) src = c.S.sxmat + 9 * oid;
      if (ot == OBJ_BODY || ot == OBJ_XBODY) src = c.S.xmat + 9 * oid;
      if (src < 0) continue;
      for (int k = 0; k < 3; ++k) out[adr + k] = w[src + 3 * k + col];
    } else if (st == S_FRAMEQUAT) {
      T q[4], o[4];
      if (ot == OBJ_SITE) {
        lload(w, c.S.xquat + 4 * c.mi[c.L.is + SI * oid], 4, q);
        qmul(q, c.mf + c.L.fs + SF * oid + 3, o);
      } else if (ot == OBJ_BODY) {
        lload(w, c.S.xquat + 4 * oid, 4, q);
        qmul(q, c.body_f(oid) + 10, o);
      } else if (ot == OBJ_XBODY) {
        lload(w, c.S.xquat + 4 * oid, 4, o);
      } else {
        continue;
      }
      for (int k = 0; k < 4; ++k) out[adr + k] = o[k];
    }
  }
}

// The contact slots of geoms g1 and g2 (sizes s1, s2) of pair kind `kind`.
template <typename T>
HD void geom_pair_contacts(const Ctx<T>& c, int kind, int g1, int g2, const T* s1, const T* s2, T* d, T* pos,
                           T* nrm) {
  T x1[3], m1[9], x2[3], m2[9];
  lload(c.w, c.S.gxpos + 3 * g1, 3, x1);
  lload(c.w, c.S.gxmat + 9 * g1, 9, m1);
  lload(c.w, c.S.gxpos + 3 * g2, 3, x2);
  lload(c.w, c.S.gxmat + 9 * g2, 9, m2);
  pair_contacts(kind, x1, m1, s1, x2, m2, s2, d, pos, nrm);
}

// Distance sensors between two bodies: the least of the cutoff and every slot
// distance of the sensor's geom pairs. Lanes over the pairs, then a warp min.
template <typename T>
HD void distance_sensors(const Ctx<T>& c, Lane<T> out) {
  for (int i = 0; i < c.s.ndist; ++i) {
    const int* xi = c.mi + c.L.ix + XI * i;
    const T v = Warp::min(xi[2], [&](int k) {
      const int* qi = c.mi + c.L.iq + QI * (xi[1] + k);
      const T* qf = c.mf + c.L.fq + QF * (xi[1] + k);
      T d[4], pos[12], nrm[12];
      geom_pair_contacts(c, qi[0], qi[1], qi[2], qf, qf + 3, d, pos, nrm);
      T least = d[0];
      for (int s = 1; s < qi[3]; ++s) least = tmin(least, d[s]);
      return least;
    }, c.mf[c.L.fx + XF * i]);
    Warp::single([&] { out[xi[0]] = v; });
  }
}

// Lanes over pairs; each pair writes its own contact slots.
template <typename T>
HD void narrowphase(const Ctx<T>& c) {
  const Lane<T> w = c.w;
  Warp::for_each(c.s.npair, [&](int p) {
    const int* pi = c.mi + c.L.ip + PI * p;
    const T* pf = c.mf + c.L.fp + PF * p;
    T d[4], pos[12], nrm[12];
    geom_pair_contacts(c, pi[0], pi[1], pi[2], pf, pf + 3, d, pos, nrm);
    for (int s = 0; s < pi[4]; ++s) {
      const int slot = pi[3] + s;
      w[c.S.cdist + slot] = d[s];
      lstore(w, c.S.cpos + 3 * slot, 3, pos + 3 * s);
      lstore(w, c.S.cnorm + 3 * slot, 3, nrm + 3 * s);
    }
  });
}

// A joint-equality row: side * (e1 - poly'(dq2) e2), the violation
// q1 - q1_0 - poly(q2 - q2_0) of a quartic poly (a constant without a second
// joint); always active.
template <typename T>
HD void equality_row(const Ctx<T>& c, Lane<T> qpos, Lane<T> qvel, const int* li, const T* lf, int r) {
  const Lane<T> w = c.w;
  const T side = lf[0], *cf = lf + 11;
  const bool two = li[3] >= 0;
  const T dq2 = two ? qpos[li[3]] - lf[2] : T(0);
  const T poly = two ? cf[0] + dq2 * (cf[1] + dq2 * (cf[2] + dq2 * (cf[3] + dq2 * cf[4]))) : cf[0];
  const T dpoly = two ? cf[1] + dq2 * (T(2) * cf[2] + dq2 * (T(3) * cf[3] + dq2 * T(4) * cf[4])) : T(0);
  const T pos = (qpos[li[1]] - lf[1]) - poly;
  const T imp = impedance(lf + 3, pos);
  const T vel = two ? qvel[li[2]] - dpoly * qvel[li[4]] : qvel[li[2]];
  for (int v = 0; v < c.s.nv; ++v) {
    c.J[r * c.S.jld + v] = v == li[2] ? side : (two && v == li[4] ? side * -dpoly : T(0));
  }
  w[c.S.aref + r] = side * (-lf[9] * vel - lf[8] * imp * pos);
  w[c.S.reg + r] = (T(1) - imp) / tmax(imp, T(kMinimp)) * lf[10];
  w[c.S.act + r] = T(1);
  w[c.S.diag + r] = lf[10];
}

// A joint-limit row: side * e_dof, active within the margin of its range end.
template <typename T>
HD void limit_row(const Ctx<T>& c, Lane<T> qpos, Lane<T> qvel, const int* li, const T* lf, int r) {
  const Lane<T> w = c.w;
  const T side = lf[0], q = qpos[li[1]];
  const T dist = side > T(0) ? q - lf[1] : lf[1] - q;
  const T pos = dist - lf[2];
  const T imp = impedance(lf + 3, pos);
  for (int v = 0; v < c.s.nv; ++v) c.J[r * c.S.jld + v] = v == li[2] ? side : T(0);
  w[c.S.aref + r] = -lf[9] * (side * qvel[li[2]]) - lf[8] * imp * pos;
  w[c.S.reg + r] = (T(1) - imp) / tmax(imp, T(kMinimp)) * lf[10];
  w[c.S.act + r] = dist < lf[2] ? T(1) : T(0);
  w[c.S.diag + r] = lf[10];
}

// Constraint rows (masked by activity), and b = J qacc_smooth - aref. Lanes
// over the rows before the contacts (joint equalities, joint limits), then
// over contact slots (each writes its own 3 or 4 rows, only on the dofs that
// move one of its bodies), then over rows for the masking and b.
template <typename T>
HD void assemble(const Ctx<T>& c, Lane<T> qpos, Lane<T> qvel) {
  const Lane<T> w = c.w;
  const int nv = c.s.nv, nnc = c.s.nnc, nc = c.s.ncon, ld = c.S.jld;
  const T impratio = c.mf[4];
  Warp::for_each(nnc, [&](int r) {
    const int* li = c.mi + c.L.il + LI * r;
    const T* lf = c.mf + c.L.fl + LF * r;
    if (li[0] == ROW_EQUALITY) equality_row(c, qpos, qvel, li, lf, r);
    else limit_row(c, qpos, qvel, li, lf, r);
  });
  Warp::for_each(nc, [&](int ci) {
    const int* sI = c.mi + c.L.ic + CI * ci;
    const T* sF = c.mf + c.L.fc + CF * ci;
    const int* mask1 = c.mi + c.L.imask + nv * sI[0];
    const int* mask2 = c.mi + c.L.imask + nv * sI[1];
    const int r1 = c.body_i(sI[0])[1], r2 = c.body_i(sI[1])[1];
    T p[3], n[3], t1[3], t2[3], arm1[3], arm2[3];
    lload(w, c.S.cpos + 3 * ci, 3, p);
    lload(w, c.S.cnorm + 3 * ci, 3, n);
    for (int k = 0; k < 3; ++k) {
      arm1[k] = p[k] - w[c.S.scom + 3 * r1 + k];
      arm2[k] = p[k] - w[c.S.scom + 3 * r2 + k];
    }
    const bool use_x = tabs(n[0]) < T(0.5);
    T t1r[3] = {use_x ? T(0) : -n[2], use_x ? n[2] : T(0), use_x ? -n[1] : n[0]};
    const T nr = tsqrt(tmax(dot3(t1r, t1r), T(1e-24)));
    const T inv = T(1) / tmax(nr, T(1e-12));
    for (int k = 0; k < 3; ++k) t1[k] = t1r[k] * inv;
    cross3(n, t1, t2);
    const T* dirs[3] = {n, t1, t2};
    const T dist = w[c.S.cdist + ci];
    const T pos = dist - sF[8];
    const T imp = impedance(sF + 3, pos);
    const T active = dist < sF[8] ? T(1) : T(0);
    const T reg_n = (T(1) - imp) / tmax(imp, T(kMinimp)) * sF[9];
    // rows along n, t1, t2; a pyramidal cone turns them into the facets
    // n + mu t1, n - mu t1, n + mu t2, n - mu t2 (contact-major), an elliptic
    // one keeps them grouped as [normals | t1 | t2]
    const bool pyr = c.s.pyramidal;
    const int nrow = pyr ? 4 : 3;
    T w1[3][3], w2[3][3], vel[4] = {T(0), T(0), T(0), T(0)};
    for (int g = 0; g < 3; ++g) {
      cross3(arm1, dirs[g], w1[g]);
      cross3(arm2, dirs[g], w2[g]);
    }
    const T mu = sF[0];
    // the dofs that move one of the bodies, 32 at a time as bits: each lane
    // walks only its slot's dofs; the rows stay zero on the others (rollout_init)
    for (int v0 = 0; v0 < nv; v0 += 32) {
      uint32_t moving = 0;
      for (int v = v0; v < nv && v < v0 + 32; ++v) moving |= uint32_t(mask1[v] | mask2[v]) << (v - v0);
      for (; moving; moving &= moving - 1) {
        const int v = v0 + lowest_bit(moving);
        const int64_t cd = c.S.cdof + 6 * v;
        T jg[3];
        for (int g = 0; g < 3; ++g) {
          const T lin = w[cd + 3] * dirs[g][0] + w[cd + 4] * dirs[g][1] + w[cd + 5] * dirs[g][2];
          const T ang1 = w[cd] * w1[g][0] + w[cd + 1] * w1[g][1] + w[cd + 2] * w1[g][2];
          const T ang2 = w[cd] * w2[g][0] + w[cd + 1] * w2[g][1] + w[cd + 2] * w2[g][2];
          jg[g] = T(mask2[v]) * (lin + ang2) - T(mask1[v]) * (lin + ang1);
        }
        const T jf[4] = {pyr ? jg[0] + mu * jg[1] : jg[0], pyr ? jg[0] - mu * jg[1] : jg[1],
                         pyr ? jg[0] + mu * jg[2] : jg[2], jg[0] - mu * jg[2]};
        for (int f = 0; f < nrow; ++f) {
          const int r = pyr ? nnc + 4 * ci + f : nnc + f * nc + ci;
          c.J[r * ld + v] = jf[f];
          vel[f] = vel[f] + jf[f] * qvel[v];
        }
      }
    }
    for (int f = 0; f < nrow; ++f) {
      const int r = pyr ? nnc + 4 * ci + f : nnc + f * nc + ci;
      const bool normal = pyr || f == 0;
      w[c.S.aref + r] = normal ? -sF[2] * vel[f] - sF[1] * imp * pos : -sF[2] * vel[f];
      w[c.S.reg + r] = normal ? reg_n : reg_n / impratio;
      w[c.S.act + r] = active;
      w[c.S.diag + r] = sF[9];
    }
  });
  Warp::for_each(c.s.nefc, [&](int r) {
    const T a = w[c.S.act + r];
    T bv = T(0);
    for (int v = 0; v < nv; ++v) {
      const T j = c.J[r * ld + v] * a;
      c.J[r * ld + v] = j;
      bv = bv + j * w[c.S.qacc_s + v];
    }
    w[c.S.bvec + r] = bv - w[c.S.aref + r] * a;
    if (!(a > T(0))) { w[c.S.reg + r] = T(1); w[c.S.diag + r] = T(1); }
  });
}

// Projection onto the orthant (equality and limit rows, pyramidal facets) x
// second-order cones (elliptic contacts): lanes over orthant rows, then over
// contacts.
template <typename T>
HD void project(const Ctx<T>& c, int64_t z) {
  T* const w = c.w.p;
  const int nor = c.s.pyramidal ? c.s.nefc : c.s.nnc, nc = c.s.pyramidal ? 0 : c.s.ncon;
  Warp::for_each(nor + nc, [&](int i) {
    if (i < nor) {
      w[z + i] = tmax(w[z + i], T(0));
      return;
    }
    const int ci = i - nor;
    const T mu = w[c.S.muc + ci];
    const T n = w[z + nor + ci], t1 = w[z + nor + nc + ci], t2 = w[z + nor + 2 * nc + ci];
    const T s = tsqrt(t1 * t1 + t2 * t2);
    const bool inside = s <= mu * n, polar = mu * s <= -n;
    const T a = (mu * s + n) / (T(1) + mu * mu);
    const T coef = mu * a / tmax(s, T(kMinval));
    const T n_out = inside ? n : (polar ? T(0) : a);
    const T ts = inside ? T(1) : (polar ? T(0) : coef);
    w[z + nor + ci] = n_out;
    w[z + nor + nc + ci] = t1 * ts;
    w[z + nor + 2 * nc + ci] = t2 * ts;
  });
}

// tv1 = J^T x (|J|^T x when absval): lanes over dofs, each summing its column
// over all rows in a register; neighbouring lanes read neighbouring words.
template <typename T>
HD void jt_vec(const Ctx<T>& c, int64_t x, bool absval) {
  T* const w = c.w.p;
  const T* const J = c.J;
  const int ne = c.s.nefc, ld = c.S.jld;
  Warp::for_each(c.s.nv, [&](int v) {
    T acc = T(0);
    for (int r = 0; r < ne; ++r) {
      const T j = J[r * ld + v];
      acc = acc + (absval ? tabs(j) : j) * w[x + r];
    }
    w[c.S.tv1 + v] = acc;
  });
}

// out = J M^-1 J^T x + reg x  (|J| |M^-1| |J|^T x + reg x when absval); the
// last product runs lanes over rows.
template <typename T>
HD void apply_op(const Ctx<T>& c, int64_t x, int64_t out, bool absval) {
  T* const w = c.w.p;
  const T* const J = c.J;
  const int nv = c.s.nv, ld = c.S.jld;
  jt_vec(c, x, absval);
  island_mv(c, c.S.Minv, c.S.tv1, c.S.tv2, absval);
  Warp::for_each(c.s.nefc, [&](int r) {
    T acc = T(0);
    for (int v = 0; v < nv; ++v) {
      const T j = J[r * ld + v];
      acc = acc + (absval ? tabs(j) : j) * w[c.S.tv2 + v];
    }
    w[out + r] = acc + w[c.S.reg + r] * w[x + r];
  });
}

// 1 / |x| over n entries (a warp sum, the same on every lane).
template <typename T>
HD T norm_inv(const Ctx<T>& c, int64_t x, int n) {
  const T* const w = c.w.p;
  return trsqrt(tmax(Warp::sum(n, [&](int r) { return w[x + r] * w[x + r]; }), T(kMinval)));
}

// APGD on the Jacobi-scaled dual; leaves the scaled solution g in S.f
// (the force is g * inv_s), writes the carried warm start (fw) and probe (cwv).
// Lanes over rows; the norms, the CW maximum and the restart sum are warp
// reductions, so every lane holds the same step, momentum and restart flag.
template <typename T>
HD void dual_solve(const Ctx<T>& c) {
  T* const w = c.w.p;
  const int nv = c.s.nv, ne = c.s.nefc, nnc = c.s.nnc, nc = c.s.ncon, ld = c.S.jld;
  Warp::for_each(ne, [&](int r) {
    const T is = trsqrt(tmax(w[c.S.diag + r] + w[c.S.reg + r], T(kMinval)));
    w[c.S.invs + r] = is;
    for (int v = 0; v < nv; ++v) c.J[r * ld + v] = c.J[r * ld + v] * is;
    w[c.S.reg + r] = w[c.S.reg + r] * is * is;
    w[c.S.bvec + r] = w[c.S.bvec + r] * is;
  });
  Warp::for_each(c.s.pyramidal ? 0 : nc, [&](int ci) {
    const T mu = c.mf[c.L.fc + CF * ci];
    w[c.S.muc + ci] = mu * w[c.S.invs + nnc + ci] / tmax(w[c.S.invs + nnc + nc + ci], T(kMinval));
  });
  // Collatz-Wielandt bound from one |A| apply on the carried probe, or on a
  // cold one after three normalised warm-up applies from ones
  if (c.s.cold) {
    Warp::for_each(ne, [&](int r) { w[c.S.vv + r] = T(1); });
    for (int k = 0; k < 3; ++k) {
      apply_op(c, c.S.vv, c.S.bv, true);
      const T n = norm_inv(c, c.S.bv, ne);
      Warp::for_each(ne, [&](int r) { w[c.S.vv + r] = w[c.S.bv + r] * n; });
    }
  } else {
    const T nin = norm_inv(c, c.S.cwv, ne);
    Warp::for_each(ne, [&](int r) { w[c.S.vv + r] = tmax(w[c.S.cwv + r] * nin, T(1e-7)); });
  }
  apply_op(c, c.S.vv, c.S.bv, true);
  const T L = Warp::max(ne, [&](int r) { return w[c.S.bv + r] / tmax(w[c.S.vv + r], T(1e-12)); }, T(-kBig));
  const T nout = norm_inv(c, c.S.bv, ne);
  Warp::for_each(ne, [&](int r) { w[c.S.cwv + r] = w[c.S.bv + r] * nout; });
  const T step = T(1) / tmax(L, T(kMinval));

  Warp::for_each(ne, [&](int r) { w[c.S.f + r] = w[c.S.fw + r] / tmax(w[c.S.invs + r], T(kMinval)); });
  project(c, c.S.f);
  Warp::for_each(ne, [&](int r) { w[c.S.y + r] = w[c.S.f + r]; });
  T tk = T(1);
  for (int it = 0; it < c.s.iterations; ++it) {
    apply_op(c, c.S.y, c.S.grad, false);
    Warp::for_each(ne, [&](int r) {
      w[c.S.grad + r] = w[c.S.grad + r] + w[c.S.bvec + r];
      w[c.S.fnew + r] = w[c.S.y + r] - step * w[c.S.grad + r];
    });
    project(c, c.S.fnew);
    const T t_new = T(0.5) * (T(1) + tsqrt(T(1) + T(4) * tk * tk));
    const T mom = (tk - T(1)) / t_new;
    const T rs = Warp::sum(ne, [&](int r) { return w[c.S.grad + r] * (w[c.S.fnew + r] - w[c.S.f + r]); });
    const bool restart = rs > T(0);
    Warp::for_each(ne, [&](int r) {
      const T fn = w[c.S.fnew + r];
      w[c.S.y + r] = restart ? fn : fn + mom * (fn - w[c.S.f + r]);
      w[c.S.f + r] = fn;
    });
    tk = restart ? T(1) : t_new;
  }
  Warp::for_each(ne, [&](int r) { w[c.S.fw + r] = w[c.S.f + r] * w[c.S.invs + r]; });
}

template <typename T>
HD void quat_integrate(T* q, const T* om, T h) {
  const T speed = tsqrt(tmax(dot3(om, om), T(1e-24)));
  const T half = T(0.5) * (speed * h);
  const T sn = tsin(half);
  const T dq[4] = {tcos(half), om[0] / speed * sn, om[1] / speed * sn, om[2] / speed * sn};
  T o[4];
  qmul(q, dq, o);
  const T n = tsqrt(tmax(o[0] * o[0] + o[1] * o[1] + o[2] * o[2] + o[3] * o[3], T(kMinval)));
  for (int k = 0; k < 4; ++k) q[k] = o[k] / n;
}

// The position update of every joint (lane 0).
template <typename T>
HD void integrate_pos(const Ctx<T>& c, Lane<T> qpos, Lane<T> qvel, T h) {
  for (int j = 0; j < c.s.njnt; ++j) {
    const int* ji = c.jnt_i(j);
    const int jtype = ji[0], qadr = ji[1], dadr = ji[2];
    if (jtype == SLIDE || jtype == HINGE) {
      qpos[qadr] = qpos[qadr] + h * qvel[dadr];
    } else {
      int qa = qadr, da = dadr;
      if (jtype == FREE) {
        for (int k = 0; k < 3; ++k) qpos[qadr + k] = qpos[qadr + k] + h * qvel[dadr + k];
        qa += 3;
        da += 3;
      }
      T q[4], om[3];
      lload(qpos, qa, 4, q);
      lload(qvel, da, 3, om);
      quat_integrate(q, om, h);
      lstore(qpos, qa, 4, q);
    }
  }
}

// One physics step in place on this rollout's (qpos, qvel, fw, cwv); every
// lane of the warp calls it. Forced inline: left to the compiler it became a
// call once the pair dispatch was inlined into it, and as a call it takes its
// context by reference from the stack, so every read of a size or offset in
// the hot loops becomes a local-memory load (K1 and K2 ran far slower; see
// chip_profile.py inline).
template <typename T>
HD_FORCEINLINE void step(const Ctx<T>& c, Lane<const T> ctrl, Lane<T> sens_out) {
  T* const w = c.w.p;
  const Lane<T> qpos = c.w.at(c.S.qpos), qvel = c.w.at(c.S.qvel);
  const int nv = c.s.nv;
  const T h = c.mf[0];
  Warp::single([&] {
    kinematics(c, qpos);
    com_quantities(c);
    crb_mass_matrix(c);
    velocity_and_bias(c, qvel, c.mf + 1);
    smooth_force(c, qpos, qvel, ctrl);
  });
  island_inverse(c, c.S.M, c.S.Minv);
  island_mv(c, c.S.Minv, c.S.qfrc, c.S.qacc_s, false);
  Warp::single([&] { sensors(c, qpos, qvel, sens_out); });
  distance_sensors(c, sens_out);
  if (c.s.nefc > 0) {
    narrowphase(c);
    assemble(c, qpos, qvel);
    dual_solve(c);
    jt_vec(c, c.S.f, false);
    island_mv(c, c.S.Minv, c.S.tv1, c.S.tv2, false);
    Warp::for_each(nv, [&](int v) { w[c.S.qacc + v] = w[c.S.qacc_s + v] + w[c.S.tv2 + v]; });
  } else {
    Warp::for_each(nv, [&](int v) { w[c.S.qacc + v] = w[c.S.qacc_s + v]; });
  }
  // implicit-in-velocity damping: qvel += (M + h D)^-1 (h M qacc); lane i
  // reads row i of M, then adds to its own diagonal entry
  Warp::for_each(nv, [&](int i) {
    T acc = T(0);
    for (int k = 0; k < nv; ++k) acc = acc + w[c.S.M + i * nv + k] * w[c.S.qacc + k];
    w[c.S.tv1 + i] = h * acc;
    w[c.S.M + i * nv + i] = w[c.S.M + i * nv + i] + h * c.dof_f(i)[2];
  });
  island_inverse(c, c.S.M, c.S.Minv);
  island_mv(c, c.S.Minv, c.S.tv1, c.S.tv2, false);
  Warp::for_each(nv, [&](int v) { qvel[v] = qvel[v] + w[c.S.tv2 + v]; });
  Warp::single([&] { integrate_pos(c, qpos, qvel, h); });
}

// The context of rollout b: model, sizes, its scratch (`work`, stride 1) and
// its J, in the scratch or (JG, the layout s.jglobal) at b's place in the slab
// `jslab`. JG is a template parameter, not read from s: with J's address
// space fixed where the kernel is compiled, the J passes of the shared layout
// stay shared-memory loads (a pointer that may be either takes the generic
// path, which cost the kernels 4-8 % on an H100: chip_profile.py layout).
template <typename T, bool JG>
HD Ctx<T> rollout_ctx(const JtSizes& s, const int* mi, const T* mf, T* work, T* jslab, int b) {
  Ctx<T> c;
  c.s = s;
  c.L = make_layout(s);
  c.S = make_scratch(s);
  c.mi = mi;
  c.mf = mf;
  c.w = Lane<T>{work, 1};
  c.J = JG ? jslab + (int64_t)b * c.S.jsize : work + c.S.J;
  return c;
}

// Load rollout b's start state, warm-start forces (zeros when f0 is null)
// and a probe of ones, and zero J: a contact row's entries on the dofs that
// move neither of its bodies stay zero, since the assembly never writes them.
template <typename T>
HD void rollout_init(const Ctx<T>& c, const T* qpos0, const T* qvel0, const T* f0, int b) {
  T* const w = c.w.p;
  const int64_t B = c.s.B;
  Warp::for_each((int)c.S.jsize, [&](int k) { c.J[k] = T(0); });
  Warp::for_each(c.s.nq, [&](int k) { w[c.S.qpos + k] = qpos0[k * B + b]; });
  Warp::for_each(c.s.nv, [&](int k) { w[c.S.qvel + k] = qvel0[k * B + b]; });
  Warp::for_each(c.s.nefc, [&](int r) {
    w[c.S.fw + r] = f0 ? f0[r * B + b] : T(0);
    w[c.S.cwv + r] = T(1);
  });
}

// Write rollout b's qpos and qvel as step t of the (T, n, B) outputs.
template <typename T>
HD void store_state(const Ctx<T>& c, T* oq, T* ov, int t, int b) {
  const T* const w = c.w.p;
  const int64_t B = c.s.B;
  const int nq = c.s.nq, nv = c.s.nv;
  Warp::for_each(nq + nv, [&](int k) {
    if (k < nq) oq[((int64_t)t * nq + k) * B + b] = w[c.S.qpos + k];
    else ov[((int64_t)t * nv + k - nq) * B + b] = w[c.S.qvel + k - nq];
  });
}

// The whole T-step rollout of rollout b, run by the 32 lanes of one warp on
// the scratch `work` and, in the layout with J in global memory (JG), b's J in
// `jslab` (the body of the CUDA kernels and of the host twin's loop over b).
// Global arrays are batch-last; see fused_rollout.py.
template <typename T, bool JG>
HD void rollout(const JtSizes& s, const int* mi, const T* mf, const T* qpos0, const T* qvel0, const T* ctrl,
                const T* f0, T* oq, T* ov, T* os, T* of0, T* jslab, T* work, int b) {
  const Ctx<T> c = rollout_ctx<T, JG>(s, mi, mf, work, jslab, b);
  const int64_t B = s.B;
  rollout_init(c, qpos0, qvel0, f0, b);
  for (int t = 0; t < s.T; ++t) {
    const Lane<const T> ctrl_t{ctrl + (int64_t)t * s.nu_ * B + b, B};
    const Lane<T> sens_t{os + (int64_t)t * s.ns_ * B + b, B};
    Warp::for_each(s.ns_, [&](int k) { sens_t[k] = T(0); });
    for (int sub = 0; sub < s.substeps; ++sub) step(c, ctrl_t, sens_t);
    store_state(c, oq, ov, t, b);
    if (t == 0) {
      Warp::for_each(s.nefc_, [&](int r) { of0[r * B + b] = r < s.nefc ? work[c.S.fw + r] : T(0); });
    }
  }
}

}  // namespace jt
