// Smooth dynamics of one rollout: kinematics, CoM quantities, the CRB mass
// matrix, RNE bias, passive and actuator forces (scalar code, run on lane 0),
// and the exact inverses and mat-vecs over the static dof islands (lanes over
// rows). Twins of judo_tpu_torch/physics/lane_engine.py.
#pragma once

#include "jt_common.cuh"

namespace jt {

template <typename T>
struct Ctx {
  JtSizes s;
  Layout L;
  Scratch S;
  const int* mi;
  const T* mf;
  Lane<T> w;  // this rollout's scratch
  T* J;       // this rollout's J: in the scratch, or its slab of global memory
  HD const int* body_i(int b) const { return mi + L.ib + BI * b; }
  HD const T* body_f(int b) const { return mf + L.fb + BF * b; }
  HD const int* jnt_i(int j) const { return mi + L.ij + JI * j; }
  HD const T* jnt_f(int j) const { return mf + L.fj + JF * j; }
  HD const int* dof_i(int d) const { return mi + L.id + DI * d; }
  HD const T* dof_f(int d) const { return mf + L.fd + DF * d; }
};

HD int jnt_ndof(int jt) { return jt == FREE ? 6 : (jt == BALL ? 3 : 1); }

// Frames of objects fixed to bodies: world pos and row-major matrix.
template <typename T>
HD void object_frame(const Ctx<T>& c, int body, const T* lpos, const T* lquat, T* pos, T* mat) {
  T bp[3], bq[4], tmp[3], q[4];
  lload(c.w, c.S.xpos + 3 * body, 3, bp);
  lload(c.w, c.S.xquat + 4 * body, 4, bq);
  qrot(bq, lpos, tmp);
  for (int k = 0; k < 3; ++k) pos[k] = bp[k] + tmp[k];
  qmul(bq, lquat, q);
  q2mat(q, mat);
}

template <typename T>
HD void kinematics(const Ctx<T>& c, Lane<T> qpos) {
  const Lane<T> w = c.w;
  const T zero3[3] = {0, 0, 0}, id4[4] = {1, 0, 0, 0};
  lstore(w, c.S.xpos, 3, zero3);
  lstore(w, c.S.xquat, 4, id4);
  for (int b = 1; b < c.s.nbody; ++b) {
    const int* bi = c.body_i(b);
    const T* bf = c.body_f(b);
    T ppos[3], pq[4], pos[3], quat[4], tmp[3];
    lload(w, c.S.xpos + 3 * bi[0], 3, ppos);
    lload(w, c.S.xquat + 4 * bi[0], 4, pq);
    qrot(pq, bf, tmp);
    for (int k = 0; k < 3; ++k) pos[k] = ppos[k] + tmp[k];
    qmul(pq, bf + 3, quat);
    for (int k = 0; k < bi[3]; ++k) {
      const int j = bi[2] + k;
      const int* ji = c.jnt_i(j);
      const T* jf = c.jnt_f(j);
      const int jtype = ji[0], qadr = ji[1];
      T anchor[3], axis[3];
      qrot(quat, jf, tmp);
      for (int i = 0; i < 3; ++i) anchor[i] = tmp[i] + pos[i];
      qrot(quat, jf + 3, axis);
      if (jtype == FREE) {
        for (int i = 0; i < 3; ++i) pos[i] = qpos[qadr + i];
        for (int i = 0; i < 4; ++i) quat[i] = qpos[qadr + 3 + i];
        qnormalize(quat);
        for (int i = 0; i < 3; ++i) anchor[i] = pos[i];
      } else if (jtype == BALL) {
        T ql[4], nq[4];
        for (int i = 0; i < 4; ++i) ql[i] = qpos[qadr + i];
        qnormalize(ql);
        qmul(quat, ql, nq);
        for (int i = 0; i < 4; ++i) quat[i] = nq[i];
        qrot(quat, jf, tmp);
        for (int i = 0; i < 3; ++i) pos[i] = anchor[i] - tmp[i];
      } else if (jtype == SLIDE) {
        const T d = qpos[qadr] - jf[6];
        for (int i = 0; i < 3; ++i) pos[i] = pos[i] + d * axis[i];
      } else {  // HINGE
        const T half = T(0.5) * (qpos[qadr] - jf[6]);
        const T sn = tsin(half);
        const T ql[4] = {tcos(half), jf[3] * sn, jf[4] * sn, jf[5] * sn};
        T nq[4];
        qmul(quat, ql, nq);
        for (int i = 0; i < 4; ++i) quat[i] = nq[i];
        qrot(quat, jf, tmp);
        for (int i = 0; i < 3; ++i) pos[i] = anchor[i] - tmp[i];
      }
      lstore(w, c.S.xanchor + 3 * j, 3, anchor);
      if (jtype == BALL || jtype == HINGE) qrot(quat, jf + 3, axis);
      lstore(w, c.S.xaxis + 3 * j, 3, axis);
    }
    lstore(w, c.S.xpos + 3 * b, 3, pos);
    lstore(w, c.S.xquat + 4 * b, 4, quat);
  }
  for (int b = 0; b < c.s.nbody; ++b) {
    const T* bf = c.body_f(b);
    T q[4], m[9], pos[3];
    lload(w, c.S.xquat + 4 * b, 4, q);
    q2mat(q, m);
    lstore(w, c.S.xmat + 9 * b, 9, m);
    object_frame(c, b, bf + 7, bf + 10, pos, m);
    lstore(w, c.S.xipos + 3 * b, 3, pos);
    lstore(w, c.S.ximat + 9 * b, 9, m);
  }
  for (int g = 0; g < c.s.ngeom; ++g) {
    const T* gf = c.mf + c.L.fg + GF * g;
    T pos[3], m[9];
    object_frame(c, c.mi[c.L.ig + GI * g], gf, gf + 3, pos, m);
    lstore(w, c.S.gxpos + 3 * g, 3, pos);
    lstore(w, c.S.gxmat + 9 * g, 9, m);
  }
  for (int t = 0; t < c.s.nsite; ++t) {
    const T* sf = c.mf + c.L.fs + SF * t;
    T pos[3], m[9];
    object_frame(c, c.mi[c.L.is + SI * t], sf, sf + 3, pos, m);
    lstore(w, c.S.sxpos + 3 * t, 3, pos);
    lstore(w, c.S.sxmat + 9 * t, 9, m);
  }
}

// Subtree CoM, spatial inertias about the root CoM, and the dof axes cdof.
template <typename T>
HD void com_quantities(const Ctx<T>& c) {
  const Lane<T> w = c.w;
  const int nb = c.s.nbody;
  for (int b = 0; b < nb; ++b) {
    const T mass = c.body_f(b)[14];
    for (int k = 0; k < 3; ++k) w[c.S.scom + 3 * b + k] = mass * w[c.S.xipos + 3 * b + k];
  }
  for (int b = nb - 1; b > 0; --b) {
    const int p = c.body_i(b)[0];
    for (int k = 0; k < 3; ++k) w[c.S.scom + 3 * p + k] = w[c.S.scom + 3 * p + k] + w[c.S.scom + 3 * b + k];
  }
  for (int b = 0; b < nb; ++b) {
    const T sm = tmax(c.body_f(b)[18], T(1e-12));
    for (int k = 0; k < 3; ++k) w[c.S.scom + 3 * b + k] = w[c.S.scom + 3 * b + k] / sm;
  }
  for (int b = 0; b < nb; ++b) {
    const T* bf = c.body_f(b);
    const int root = c.body_i(b)[1];
    const T mb = bf[14];
    T R[9], cv[3];
    lload(w, c.S.ximat + 9 * b, 9, R);
    for (int k = 0; k < 3; ++k) cv[k] = w[c.S.xipos + 3 * b + k] - w[c.S.scom + 3 * root + k];
    const T cx[9] = {0, -cv[2], cv[1], cv[2], 0, -cv[0], -cv[1], cv[0], 0};
    const Lane<T> ci = w.at(c.S.cinert + 36 * b);
    for (int r = 0; r < 3; ++r) {
      for (int q = 0; q < 3; ++q) {
        T iw = T(0);
        for (int k = 0; k < 3; ++k) iw = iw + bf[15 + k] * R[3 * r + k] * R[3 * q + k];
        T cc = cx[3 * r] * cx[3 * q] + cx[3 * r + 1] * cx[3 * q + 1] + cx[3 * r + 2] * cx[3 * q + 2];
        ci[6 * r + q] = iw + mb * cc;
        ci[6 * r + 3 + q] = mb * cx[3 * r + q];
        ci[6 * (3 + r) + q] = mb * cx[3 * q + r];
        ci[6 * (3 + r) + 3 + q] = r == q ? mb : T(0);
      }
    }
  }
  for (int j = 0; j < c.s.njnt; ++j) {
    const int* ji = c.jnt_i(j);
    const int jtype = ji[0], d = ji[2], b = ji[3];
    const int root = c.body_i(b)[1];
    T moff[3];
    for (int k = 0; k < 3; ++k) moff[k] = -(w[c.S.xanchor + 3 * j + k] - w[c.S.scom + 3 * root + k]);
    if (jtype == HINGE || jtype == SLIDE) {
      T ax[3], lin[3];
      lload(w, c.S.xaxis + 3 * j, 3, ax);
      const Lane<T> cd = w.at(c.S.cdof + 6 * d);
      if (jtype == HINGE) {
        cross3(ax, moff, lin);
        for (int k = 0; k < 3; ++k) { cd[k] = ax[k]; cd[3 + k] = lin[k]; }
      } else {
        for (int k = 0; k < 3; ++k) { cd[k] = T(0); cd[3 + k] = ax[k]; }
      }
    } else {
      T q[4], rot[9];
      lload(w, c.S.xquat + 4 * b, 4, q);
      q2mat(q, rot);
      int d0 = d;
      if (jtype == FREE) {
        for (int i = 0; i < 3; ++i) {
          const Lane<T> cd = w.at(c.S.cdof + 6 * (d + i));
          for (int k = 0; k < 6; ++k) cd[k] = (k == 3 + i) ? T(1) : T(0);
        }
        d0 = d + 3;
      }
      for (int i = 0; i < 3; ++i) {
        const T col[3] = {rot[i], rot[3 + i], rot[6 + i]};
        T lin[3];
        cross3(col, moff, lin);
        const Lane<T> cd = w.at(c.S.cdof + 6 * (d0 + i));
        for (int k = 0; k < 3; ++k) { cd[k] = col[k]; cd[3 + k] = lin[k]; }
      }
    }
  }
}

template <typename T>
HD void mv6(const Lane<T> m, const T* v, T* o) {
  for (int r = 0; r < 6; ++r) {
    T acc = T(0);
    for (int k = 0; k < 6; ++k) acc = acc + m[6 * r + k] * v[k];
    o[r] = acc;
  }
}

// Dense joint-space mass matrix by composite rigid bodies (mj_crb).
template <typename T>
HD void crb_mass_matrix(const Ctx<T>& c) {
  const Lane<T> w = c.w;
  const int nb = c.s.nbody, nv = c.s.nv;
  for (int k = 0; k < 36 * nb; ++k) w[c.S.crb + k] = w[c.S.cinert + k];
  for (int b = nb - 1; b > 0; --b) {
    const int p = c.body_i(b)[0];
    for (int k = 0; k < 36; ++k) w[c.S.crb + 36 * p + k] = w[c.S.crb + 36 * p + k] + w[c.S.crb + 36 * b + k];
  }
  for (int k = 0; k < nv * nv; ++k) w[c.S.M + k] = T(0);
  for (int i = 0; i < nv; ++i) {
    T cdi[6], f[6];
    lload(w, c.S.cdof + 6 * i, 6, cdi);
    mv6(w.at(c.S.crb + 36 * c.dof_i(i)[0]), cdi, f);
    for (int j = i; j >= 0; j = c.dof_i(j)[1]) {
      T mij = T(0);
      for (int k = 0; k < 6; ++k) mij = mij + f[k] * w[c.S.cdof + 6 * j + k];
      if (i == j) mij = mij + c.dof_f(i)[1];
      w[c.S.M + i * nv + j] = mij;
      w[c.S.M + j * nv + i] = mij;
    }
  }
}

template <typename T>
HD void mcross_motion(const T* v, const T* mv, T* o) {
  T a[3], l1[3], l2[3];
  cross3(v, mv, a);
  cross3(v, mv + 3, l1);
  cross3(v + 3, mv, l2);
  for (int k = 0; k < 3; ++k) { o[k] = a[k]; o[3 + k] = l1[k] + l2[k]; }
}

// Body velocities, cdof_dot, and the bias force C(q, v) into tv1.
template <typename T>
HD void velocity_and_bias(const Ctx<T>& c, Lane<T> qvel, const T* gravity) {
  const Lane<T> w = c.w;
  const int nb = c.s.nbody;
  for (int k = 0; k < 6; ++k) w[c.S.cvel + k] = T(0);
  for (int b = 1; b < nb; ++b) {
    const int* bi = c.body_i(b);
    T v[6], cd[6], o[6];
    lload(w, c.S.cvel + 6 * bi[0], 6, v);
    for (int k = 0; k < bi[3]; ++k) {
      const int* ji = c.jnt_i(bi[2] + k);
      const int jtype = ji[0], d = ji[2];
      if (jtype == FREE) {
        for (int i = 0; i < 3; ++i) {
          lload(w, c.S.cdof + 6 * (d + i), 6, cd);
          for (int r = 0; r < 6; ++r) { v[r] = v[r] + cd[r] * qvel[d + i]; w[c.S.cdofdot + 6 * (d + i) + r] = T(0); }
        }
        for (int i = 3; i < 6; ++i) {
          lload(w, c.S.cdof + 6 * (d + i), 6, cd);
          mcross_motion(v, cd, o);
          lstore(w, c.S.cdofdot + 6 * (d + i), 6, o);
        }
        for (int i = 3; i < 6; ++i) {
          lload(w, c.S.cdof + 6 * (d + i), 6, cd);
          for (int r = 0; r < 6; ++r) v[r] = v[r] + cd[r] * qvel[d + i];
        }
      } else {
        const int n = jnt_ndof(jtype);
        for (int i = 0; i < n; ++i) {
          lload(w, c.S.cdof + 6 * (d + i), 6, cd);
          mcross_motion(v, cd, o);
          lstore(w, c.S.cdofdot + 6 * (d + i), 6, o);
        }
        for (int i = 0; i < n; ++i) {
          lload(w, c.S.cdof + 6 * (d + i), 6, cd);
          for (int r = 0; r < 6; ++r) v[r] = v[r] + cd[r] * qvel[d + i];
        }
      }
    }
    lstore(w, c.S.cvel + 6 * b, 6, v);
  }
  const T base[6] = {0, 0, 0, -gravity[0], -gravity[1], -gravity[2]};
  lstore(w, c.S.cacc, 6, base);
  for (int b = 1; b < nb; ++b) {
    const int* bi = c.body_i(b);
    T a[6];
    lload(w, c.S.cacc + 6 * bi[0], 6, a);
    for (int k = 0; k < bi[3]; ++k) {
      const int* ji = c.jnt_i(bi[2] + k);
      const int d = ji[2];
      for (int i = 0; i < jnt_ndof(ji[0]); ++i)
        for (int r = 0; r < 6; ++r) a[r] = a[r] + w[c.S.cdofdot + 6 * (d + i) + r] * qvel[d + i];
    }
    lstore(w, c.S.cacc + 6 * b, 6, a);
  }
  for (int b = 0; b < nb; ++b) {
    T v[6], a[6], iv[6], ia[6], x1[3], x2[3], x3[3];
    lload(w, c.S.cvel + 6 * b, 6, v);
    lload(w, c.S.cacc + 6 * b, 6, a);
    const Lane<T> ci = w.at(c.S.cinert + 36 * b);
    mv6(ci, v, iv);
    mv6(ci, a, ia);
    cross3(v, iv, x1);
    cross3(v + 3, iv + 3, x2);
    cross3(v, iv + 3, x3);
    for (int k = 0; k < 3; ++k) {
      w[c.S.cfrc + 6 * b + k] = ia[k] + (x1[k] + x2[k]);
      w[c.S.cfrc + 6 * b + 3 + k] = ia[3 + k] + x3[k];
    }
  }
  for (int b = nb - 1; b > 0; --b) {
    const int p = c.body_i(b)[0];
    for (int k = 0; k < 6; ++k) w[c.S.cfrc + 6 * p + k] = w[c.S.cfrc + 6 * p + k] + w[c.S.cfrc + 6 * b + k];
  }
  for (int i = 0; i < c.s.nv; ++i) {
    const int b = c.dof_i(i)[0];
    T acc = T(0);
    for (int k = 0; k < 6; ++k) acc = acc + w[c.S.cdof + 6 * i + k] * w[c.S.cfrc + 6 * b + k];
    w[c.S.tv1 + i] = acc;
  }
}

// qfrc = actuation + passive - bias (bias read from tv1).
template <typename T>
HD void smooth_force(const Ctx<T>& c, Lane<T> qpos, Lane<T> qvel, Lane<const T> ctrl) {
  const Lane<T> w = c.w;
  const int nv = c.s.nv;
  for (int i = 0; i < nv; ++i) w[c.S.tv2 + i] = T(0);
  for (int u = 0; u < c.s.nu; ++u) {
    const int* ai = c.mi + c.L.ia + AI * u;
    const T* af = c.mf + c.L.fa + AF * u;
    T cu = ctrl[u];
    if (ai[2]) cu = tclip(cu, af[5], af[6]);
    const T g = af[0];
    T force = af[1] * cu + af[2] + af[3] * (qpos[ai[0]] * g) + af[4] * (qvel[ai[1]] * g);
    if (ai[3]) force = tclip(force, af[7], af[8]);
    w[c.S.tv2 + ai[1]] = w[c.S.tv2 + ai[1]] + g * force;
  }
  // the per-joint clamp of the actuator force, on every dof of the joint
  for (int j = 0; j < c.s.njnt; ++j) {
    const int* ji = c.jnt_i(j);
    if (!ji[4]) continue;
    const int ndof = ji[0] == FREE ? 6 : (ji[0] == BALL ? 3 : 1);
    for (int d = ji[2]; d < ji[2] + ndof; ++d) w[c.S.tv2 + d] = tclip(w[c.S.tv2 + d], c.jnt_f(j)[9], c.jnt_f(j)[10]);
  }
  for (int i = 0; i < nv; ++i) w[c.S.qfrc + i] = -c.dof_f(i)[0] * qvel[i];
  // joint springs; on a ball joint, and on a free joint's rotation, the
  // spring turns by 2 Im(conj(qpos_spring) * q) (lane_engine.passive_force_l)
  for (int j = 0; j < c.s.njnt; ++j) {
    const T* jf = c.jnt_f(j);
    const int* ji = c.jnt_i(j);
    const T k = jf[7];
    if (k == T(0)) continue;
    int qa = ji[1], da = ji[2];
    if (ji[0] == SLIDE || ji[0] == HINGE) {
      w[c.S.qfrc + da] = w[c.S.qfrc + da] - k * (qpos[qa] - jf[8]);
      continue;
    }
    const T* sp = jf + 11;
    if (ji[0] == FREE) {
      for (int i = 0; i < 3; ++i) w[c.S.qfrc + da + i] = w[c.S.qfrc + da + i] - k * (qpos[qa + i] - sp[i]);
      qa += 3;
      da += 3;
      sp += 3;
    }
    const T qs[4] = {sp[0], -sp[1], -sp[2], -sp[3]};
    const T q[4] = {qpos[qa], qpos[qa + 1], qpos[qa + 2], qpos[qa + 3]};
    T dq[4];
    qmul(qs, q, dq);
    for (int i = 0; i < 3; ++i) w[c.S.qfrc + da + i] = w[c.S.qfrc + da + i] - k * T(2) * dq[1 + i];
  }
  for (int i = 0; i < nv; ++i) w[c.S.qfrc + i] = (w[c.S.tv2 + i] + w[c.S.qfrc + i]) - w[c.S.tv1 + i];
}

// Exact inverse of the island blocks of the matrix at `src` into `dst`
// (Gauss-Jordan without pivoting, then symmetrised), as lane_engine.spd_inverse_l.
// Lanes over the rows of an island: at pivot j each lane eliminates column j
// from its own row, reading only row j, which no lane writes in that step.
template <class G, typename T>
HD void island_inverse(const Ctx<T>& c, int64_t src, int64_t dst) {
  T* const w = c.w.p;
  const int nv = c.s.nv;
  for (int is = 0; is < c.s.nisl; ++is) {
    const int st = c.mi[c.L.ii + II * is], n = c.mi[c.L.ii + II * is + 1];
    T* const a = w + c.S.work;
    T* const x = w + dst + st * nv + st;
    const T* const m = w + src + st * nv + st;
    G::for_each(n * n, [&](int k) {
      const int r = k / n, q = k % n;
      a[k] = m[r * nv + q];
      x[r * nv + q] = r == q ? T(1) : T(0);
    });
    for (int j = 0; j < n; ++j) {
      G::for_each(n, [&](int r) {
        if (r == j) return;
        const T f = a[r * n + j] / a[j * n + j];
        for (int q = 0; q < n; ++q) {
          a[r * n + q] = a[r * n + q] - f * a[j * n + q];
          x[r * nv + q] = x[r * nv + q] - f * x[j * nv + q];
        }
      });
    }
    G::for_each(n, [&](int r) {
      const T d = a[r * n + r];
      for (int q = 0; q < n; ++q) x[r * nv + q] = x[r * nv + q] / d;
    });
    G::for_each(n * n, [&](int k) {
      const int r = k / n, q = k % n;
      if (q < r) return;
      const T s = T(0.5) * (x[r * nv + q] + x[q * nv + r]);
      x[r * nv + q] = s;
      x[q * nv + r] = s;
    });
  }
}

// out = blockdiag(A) v over the islands (|A| when `absval`); lanes over the
// rows of all islands at once (the islands tile the dofs).
template <class G, typename T>
HD void island_mv(const Ctx<T>& c, int64_t A, int64_t v, int64_t out, bool absval) {
  T* const w = c.w.p;
  const int nv = c.s.nv;
  G::for_each(nv, [&](int i) {
    int st = 0, n = nv;
    for (int is = 0; is < c.s.nisl; ++is) {
      const int s0 = c.mi[c.L.ii + II * is], n0 = c.mi[c.L.ii + II * is + 1];
      if (i >= s0 && i < s0 + n0) { st = s0; n = n0; }
    }
    T acc = T(0);
    for (int q = 0; q < n; ++q) {
      const T m = w[A + i * nv + st + q];
      acc = acc + (absval ? tabs(m) : m) * w[v + st + q];
    }
    w[out + i] = acc;
  });
}

}  // namespace jt
