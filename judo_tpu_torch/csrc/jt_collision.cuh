// Narrowphase of one rollout: plane-sphere (1 slot), plane-capsule (2),
// plane-cylinder (2), plane-box (4), sphere-cylinder (1), sphere-box (1),
// capsule-capsule (1), capsule-cylinder (1), capsule-box (2),
// cylinder-cylinder (2), cylinder-box (2) and box-box (4). Scalar twins of
// judo_tpu_torch/physics/lane_collision.py; the one-hot
// selections of the lanes code become index choices with the same tie rules
// (first index wins among equal keys). pair_contacts dispatches on the pair
// kind code and stops on a code it does not know: a trap on the card, an
// exception in the host twin.
#pragma once

#include "jt_common.cuh"

#include <stdexcept>
#include <string>

namespace jt {

constexpr double kBig = 1e10;

// Column i of a row-major 3x3 matrix.
template <typename T> HD void mcol(const T* m, int i, T* o) { o[0] = m[i]; o[1] = m[3 + i]; o[2] = m[6 + i]; }

// Index of the s-th smallest key (stable: ties go to the lower index).
template <typename T> HD int rank_select(const T* keys, int n, int s) {
  for (int i = 0; i < n; ++i) {
    int rank = 0;
    for (int j = 0; j < n; ++j)
      if (keys[j] < keys[i] || (keys[j] == keys[i] && j < i)) ++rank;
    if (rank == s) return i;
  }
  return 0;
}

// First index of the largest |v_i| among three.
template <typename T> HD int first_absmax3(const T* v) {
  const T a0 = tabs(v[0]), a1 = tabs(v[1]), a2 = tabs(v[2]);
  const T mx = tmax(tmax(a0, a1), a2);
  return a0 == mx ? 0 : (a1 == mx ? 1 : 2);
}

// Plane (x1, m1; normal = m1's z column) against a sphere of radius s2[0].
template <typename T>
HD void plane_sphere(const T* x1, const T* m1, const T* x2, const T* s2, T* dist, T* pos, T* nrm) {
  T n[3], rel[3];
  mcol(m1, 2, n);
  for (int k = 0; k < 3; ++k) rel[k] = x2[k] - x1[k];
  dist[0] = dot3(rel, n) - s2[0];
  for (int k = 0; k < 3; ++k) {
    pos[k] = x2[k] - n[k] * (s2[0] + T(0.5) * dist[0]);
    nrm[k] = n[k];
  }
}

// Plane against a capsule (radius s2[0], half length s2[1]): its two segment
// ends, the -axis end first.
template <typename T>
HD void plane_capsule(const T* x1, const T* m1, const T* x2, const T* m2, const T* s2, T* dist, T* pos, T* nrm) {
  T n[3], axis[3];
  mcol(m1, 2, n);
  mcol(m2, 2, axis);
  for (int s = 0; s < 2; ++s) {
    const T sgn = s == 0 ? T(-1) : T(1);
    T cend[3], rel[3];
    for (int k = 0; k < 3; ++k) {
      cend[k] = x2[k] + (sgn * s2[1]) * axis[k];
      rel[k] = cend[k] - x1[k];
    }
    dist[s] = dot3(rel, n) - s2[0];
    for (int k = 0; k < 3; ++k) {
      pos[3 * s + k] = cend[k] - n[k] * (s2[0] + T(0.5) * dist[s]);
      nrm[3 * s + k] = n[k];
    }
  }
}

// Plane against a box: the four deepest of its eight corners (corner k has
// signs (bit2, bit1, bit0) = (x, y, z)), ties to the lowest corner index.
template <typename T>
HD void plane_box(const T* x1, const T* m1, const T* x2, const T* m2, const T* s2, T* dist, T* pos, T* nrm) {
  T n[3], cols[3][3], corner[8][3], cd[8];
  mcol(m1, 2, n);
  for (int i = 0; i < 3; ++i) mcol(m2, i, cols[i]);
  for (int c = 0; c < 8; ++c) {
    const T sg[3] = {T((c >> 2) & 1 ? 1 : -1), T((c >> 1) & 1 ? 1 : -1), T(c & 1 ? 1 : -1)};
    T rel[3];
    for (int k = 0; k < 3; ++k) {
      T off = T(0);
      for (int i = 0; i < 3; ++i) off = off + (sg[i] * s2[i]) * cols[i][k];
      corner[c][k] = x2[k] + off;
      rel[k] = corner[c][k] - x1[k];
    }
    cd[c] = dot3(rel, n);
  }
  for (int s = 0; s < 4; ++s) {
    const int c = rank_select(cd, 8, s);
    dist[s] = cd[c];
    for (int k = 0; k < 3; ++k) {
      pos[3 * s + k] = corner[c][k] - (T(0.5) * cd[c]) * n[k];
      nrm[3 * s + k] = n[k];
    }
  }
}

template <typename T>
HD void capsule_box(const T* x1, const T* m1, const T* s1, const T* x2, const T* m2, const T* s2,
                    T* dist, T* pos, T* nrm) {
  const T r = s1[0], hl = s1[1];
  T axis[3], dx[3];
  mcol(m1, 2, axis);
  for (int k = 0; k < 3; ++k) dx[k] = x2[k] - x1[k];
  const T t = tmax(tmin(dot3(dx, axis), hl), -hl);
  const T tc[3] = {-hl, hl, t};
  T d[3], p[3][3], n[3][3];
  for (int ci = 0; ci < 3; ++ci) {
    T cand[3], rel[3], local[3], clamped[3], delta[3], gaps[3];
    for (int k = 0; k < 3; ++k) {
      cand[k] = ci == 2 ? x1[k] + tc[ci] * axis[k] : (ci == 0 ? x1[k] - hl * axis[k] : x1[k] + hl * axis[k]);
      rel[k] = cand[k] - x2[k];
    }
    for (int j = 0; j < 3; ++j) local[j] = m2[j] * rel[0] + m2[3 + j] * rel[1] + m2[6 + j] * rel[2];
    for (int j = 0; j < 3; ++j) {
      clamped[j] = tmax(tmin(local[j], s2[j]), -s2[j]);
      delta[j] = local[j] - clamped[j];
      gaps[j] = s2[j] - tabs(local[j]);
    }
    const T dn = tsqrt(tmax(dot3(delta, delta), T(1e-24)));
    const bool outside = dn > T(1e-9);
    const T gmin = tmin(tmin(gaps[0], gaps[1]), gaps[2]);
    const int sel = gaps[0] == gmin ? 0 : (gaps[1] == gmin ? 1 : 2);
    T n_in[3] = {0, 0, 0};
    n_in[sel] = tsign(local[sel]);
    const T d_in = -gmin;
    T nl[3], sl[3];
    const T inv = T(1) / tmax(dn, T(1e-12));
    for (int j = 0; j < 3; ++j) {
      nl[j] = outside ? delta[j] * inv : n_in[j];
      sl[j] = outside ? clamped[j] : local[j] - d_in * n_in[j];
    }
    d[ci] = (outside ? dn : d_in) - r;
    for (int k = 0; k < 3; ++k) {
      n[ci][k] = -(m2[3 * k] * nl[0] + m2[3 * k + 1] * nl[1] + m2[3 * k + 2] * nl[2]);
      const T surf = x2[k] + (m2[3 * k] * sl[0] + m2[3 * k + 1] * sl[1] + m2[3 * k + 2] * sl[2]);
      p[ci][k] = surf + T(0.5) * d[ci] * n[ci][k];
    }
  }
  for (int s = 0; s < 2; ++s) {
    const int i = rank_select(d, 3, s);
    dist[s] = d[i];
    for (int k = 0; k < 3; ++k) { pos[3 * s + k] = p[i][k]; nrm[3 * s + k] = n[i][k]; }
  }
}

template <typename T>
HD void box_box(const T* x1, const T* m1, const T* s1, const T* x2, const T* m2, const T* s2,
                T* dist_out, T* pos, T* nrm) {
  T c1[3][3], c2[3][3], dt[3];
  for (int i = 0; i < 3; ++i) { mcol(m1, i, c1[i]); mcol(m2, i, c2[i]); }
  for (int k = 0; k < 3; ++k) dt[k] = x2[k] - x1[k];
  T Rm[3][3], Am[3][3], t1[3], t2[3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) { Rm[i][j] = dot3(c1[i], c2[j]); Am[i][j] = tabs(Rm[i][j]); }
  for (int i = 0; i < 3; ++i) { t1[i] = dot3(dt, c1[i]); t2[i] = dot3(dt, c2[i]); }

  T seps[15], inv_nrm[15];
  bool valid[15];
  for (int i = 0; i < 3; ++i) {
    seps[i] = tabs(t1[i]) - (s1[i] + s2[0] * Am[i][0] + s2[1] * Am[i][1] + s2[2] * Am[i][2]);
    inv_nrm[i] = T(1);
    valid[i] = true;
  }
  for (int j = 0; j < 3; ++j) {
    seps[3 + j] = tabs(t2[j]) - (s2[j] + s1[0] * Am[0][j] + s1[1] * Am[1][j] + s1[2] * Am[2][j]);
    inv_nrm[3 + j] = T(1);
    valid[3 + j] = true;
  }
  for (int i = 0; i < 3; ++i) {
    const int i1 = (i + 1) % 3, i2 = (i + 2) % 3;
    for (int j = 0; j < 3; ++j) {
      const int j1 = (j + 1) % 3, j2 = (j + 2) % 3, k = 6 + 3 * i + j;
      const T ad = tabs(t1[i2] * Rm[i1][j] - t1[i1] * Rm[i2][j]);
      const T p1k = s1[i1] * Am[i2][j] + s1[i2] * Am[i1][j];
      const T p2k = s2[j1] * Am[i][j2] + s2[j2] * Am[i][j1];
      const T len2 = T(1) - Rm[i][j] * Rm[i][j];
      inv_nrm[k] = trsqrt(tmax(len2, T(1e-24)));
      seps[k] = (ad - p1k - p2k) * inv_nrm[k];
      valid[k] = len2 > T(1e-12);
    }
  }
  T dist = T(-kBig), best = T(-kBig);
  int win = 0;
  for (int k = 0; k < 15; ++k) {
    const T sep = valid[k] ? seps[k] : T(-kBig);
    const T score = valid[k] ? seps[k] + (k >= 6 ? T(1e-6) : T(0)) : T(-kBig);
    dist = tmax(dist, sep);
    if (k == 0 || score > best) { best = score; win = k; }
  }
  const bool is_face = win < 6, ref_is_1 = win < 3;
  T axis[3];
  if (win < 3) {
    for (int k = 0; k < 3; ++k) axis[k] = c1[win][k];
  } else if (win < 6) {
    for (int k = 0; k < 3; ++k) axis[k] = c2[win - 3][k];
  } else {
    T cr[3];
    cross3(c1[(win - 6) / 3], c2[(win - 6) % 3], cr);
    for (int k = 0; k < 3; ++k) axis[k] = inv_nrm[win] * cr[k];
  }
  const T sgn = dot3(axis, dt) >= T(0) ? T(1) : T(-1);
  T normal[3];
  for (int k = 0; k < 3; ++k) normal[k] = sgn * axis[k];

  const T* ref_pos = ref_is_1 ? x1 : x2;
  const T* inc_pos = ref_is_1 ? x2 : x1;
  T (*ref_cols)[3] = ref_is_1 ? c1 : c2;
  T (*inc_cols)[3] = ref_is_1 ? c2 : c1;
  const T* ref_size = ref_is_1 ? s1 : s2;
  const T* inc_size = ref_is_1 ? s2 : s1;
  T ref_n[3];
  for (int k = 0; k < 3; ++k) ref_n[k] = ref_is_1 ? normal[k] : -normal[k];

  T ref_align[3], inc_align[3];
  for (int i = 0; i < 3; ++i) { ref_align[i] = dot3(ref_cols[i], ref_n); inc_align[i] = dot3(inc_cols[i], ref_n); }
  const int er = first_absmax3(ref_align), ea = first_absmax3(inc_align);
  const T ref_sign = tsign(ref_align[er] + T(1e-12));
  const T inc_sign = -tsign(inc_align[ea] + T(1e-12));
  const int iu = (ea + 1) % 3, iv = (ea + 2) % 3, ru = (er + 1) % 3, rv = (er + 2) % 3;

  T c_world[3], rel_c[3];
  for (int k = 0; k < 3; ++k) {
    c_world[k] = inc_pos[k] + (inc_sign * inc_size[ea]) * inc_cols[ea][k];
    rel_c[k] = c_world[k] - ref_pos[k];
  }
  const T* u_ax = inc_cols[iu];
  const T* v_ax = inc_cols[iv];
  const T u_half = inc_size[iu], v_half = inc_size[iv];
  const T* frame[3] = {ref_cols[ru], ref_cols[rv], ref_cols[er]};
  const T hu = ref_size[ru], hv = ref_size[rv], h_face = ref_size[er];
  T base[3], du[3], dv[3];
  for (int k = 0; k < 3; ++k) {
    base[k] = dot3(rel_c, frame[k]);
    du[k] = dot3(u_ax, frame[k]) * u_half;
    dv[k] = dot3(v_ax, frame[k]) * v_half;
  }
  const T su[4] = {1, 1, -1, -1}, sv[4] = {1, -1, 1, -1};
  T u[4], v[4], wv[4], uc[4], vc[4];
  for (int s = 0; s < 4; ++s) {
    u[s] = base[0] + su[s] * du[0] + sv[s] * dv[0];
    v[s] = base[1] + su[s] * du[1] + sv[s] * dv[1];
    wv[s] = base[2] + su[s] * du[2] + sv[s] * dv[2];
    uc[s] = tmax(tmin(u[s], hu), -hu);
    vc[s] = tmax(tmin(v[s], hv), -hv);
  }
  T npl[3];
  cross3(v_ax, u_ax, npl);
  const T sc = T(4) * v_half * u_half;
  for (int k = 0; k < 3; ++k) npl[k] = sc * npl[k];
  const T n_u = dot3(npl, frame[0]), n_v = dot3(npl, frame[1]);
  T n_w = dot3(npl, frame[2]);
  n_w = tsign(n_w + T(1e-30)) * tmax(tabs(n_w), T(1e-12));
  const T h_ref = h_face * ref_sign;

  // edge-edge contact
  const int e1 = is_face ? -1 : (win - 6) / 3, e2 = is_face ? -1 : (win - 6) % 3;
  const T* a1 = is_face ? c1[0] : c1[e1];
  const T* a2 = is_face ? c2[0] : c2[e2];
  T ec1[3], ec2[3];
  for (int k = 0; k < 3; ++k) { ec1[k] = x1[k]; ec2[k] = x2[k]; }
  for (int i = 0; i < 3; ++i) {
    T mn[3];
    for (int k = 0; k < 3; ++k) mn[k] = -normal[k];
    if (i != e1) {
      const T si = tsign(dot3(c1[i], normal) + T(1e-12));
      for (int k = 0; k < 3; ++k) ec1[k] = ec1[k] + (si * s1[i]) * c1[i][k];
    }
    if (i != e2) {
      const T si = tsign(dot3(c2[i], mn) + T(1e-12));
      for (int k = 0; k < 3; ++k) ec2[k] = ec2[k] + (si * s2[i]) * c2[i][k];
    }
  }
  T d12[3];
  for (int k = 0; k < 3; ++k) d12[k] = ec2[k] - ec1[k];
  const T a1a2 = dot3(a1, a2);
  const T denom = tmax(T(1) - a1a2 * a1a2, T(1e-9));
  const T te1 = (dot3(d12, a1) - dot3(d12, a2) * a1a2) / denom;
  const T te2 = -(dot3(d12, a2) - dot3(d12, a1) * a1a2) / denom;

  for (int s = 0; s < 4; ++s) {
    const T w_c = wv[0] - (n_u * (uc[s] - u[0]) + n_v * (vc[s] - v[0])) / n_w;
    const T depth = ref_sign * w_c - h_face;
    const T mid_w = T(0.5) * (w_c + h_ref);
    T dd;
    if (is_face) {
      dd = depth < T(0) ? depth : tmax(depth, dist);
      for (int k = 0; k < 3; ++k)
        pos[3 * s + k] = (ref_pos[k] + uc[s] * frame[0][k]) + (vc[s] * frame[1][k] + mid_w * frame[2][k]);
    } else {
      dd = s == 0 ? dist : T(kBig);
      for (int k = 0; k < 3; ++k) pos[3 * s + k] = T(0.5) * ((ec1[k] + te1 * a1[k]) + (ec2[k] + te2 * a2[k]));
    }
    if (dist >= T(0)) dd = s == 0 ? dist : T(kBig);
    dist_out[s] = dd;
    for (int k = 0; k < 3; ++k) nrm[3 * s + k] = normal[k];
  }
}

// v / |v| where |v| > eps, else the fallback.
template <typename T>
HD void safe_unit(const T* v, const T* fallback, T eps, T* o) {
  const T n = tsqrt(tmax(dot3(v, v), T(1e-24)));
  for (int k = 0; k < 3; ++k) o[k] = n > eps ? v[k] / n : fallback[k];
}

// Closest points c1 on segment p1-q1 and c2 on p2-q2.
template <typename T>
HD void segment_segment(const T* p1, const T* q1, const T* p2, const T* q2, T* c1, T* c2) {
  T d1[3], d2[3], r[3];
  for (int k = 0; k < 3; ++k) {
    d1[k] = q1[k] - p1[k];
    d2[k] = q2[k] - p2[k];
    r[k] = p1[k] - p2[k];
  }
  const T a = dot3(d1, d1), e = dot3(d2, d2), f = dot3(d2, r), cr = dot3(d1, r), b = dot3(d1, d2);
  const T denom = a * e - b * b;
  T s = denom > T(1e-12) ? tclip((b * f - cr * e) / tmax(denom, T(1e-12)), T(0), T(1)) : T(0);
  const T t = tclip((b * s + f) / tmax(e, T(1e-12)), T(0), T(1));
  s = tclip((b * t - cr) / tmax(a, T(1e-12)), T(0), T(1));
  for (int k = 0; k < 3; ++k) {
    c1[k] = p1[k] + s * d1[k];
    c2[k] = p2[k] + t * d2[k];
  }
}

// Capsule (radius s[0], half length s[1]) against a capsule: the closest
// points of the two segments.
template <typename T>
HD void capsule_capsule(const T* x1, const T* m1, const T* s1, const T* x2, const T* m2, const T* s2, T* dist,
                        T* pos, T* nrm) {
  T a1[3], a2[3], e1[3], f1[3], e2[3], f2[3], c1[3], c2[3], delta[3];
  mcol(m1, 2, a1);
  mcol(m2, 2, a2);
  for (int k = 0; k < 3; ++k) {
    e1[k] = x1[k] - s1[1] * a1[k];
    f1[k] = x1[k] + s1[1] * a1[k];
    e2[k] = x2[k] - s2[1] * a2[k];
    f2[k] = x2[k] + s2[1] * a2[k];
  }
  segment_segment(e1, f1, e2, f2, c1, c2);
  for (int k = 0; k < 3; ++k) delta[k] = c2[k] - c1[k];
  const T dn = tsqrt(tmax(dot3(delta, delta), T(1e-24)));
  const T ez[3] = {T(0), T(0), T(1)};
  safe_unit(delta, ez, T(1e-9), nrm);
  dist[0] = dn - s1[0] - s2[0];
  for (int k = 0; k < 3; ++k) pos[k] = c1[k] + nrm[k] * (s1[0] + T(0.5) * dist[0]);
}

// Cylinder (radius s[0], half height s[1]) against a cylinder: the radial
// contact of near-parallel axes whose heights overlap, at both ends of the
// overlap; any other pose puts kBig in both slots.
template <typename T>
HD void cylinder_cylinder(const T* x1, const T* m1, const T* s1, const T* x2, const T* m2, const T* s2, T* dist,
                          T* pos, T* nrm) {
  T a1[3], a2[3], c0[3], delta[3], radial[3], n[3];
  mcol(m1, 2, a1);
  mcol(m2, 2, a2);
  mcol(m1, 0, c0);
  for (int k = 0; k < 3; ++k) delta[k] = x2[k] - x1[k];
  const T h = dot3(delta, a1);
  for (int k = 0; k < 3; ++k) radial[k] = delta[k] - a1[k] * h;
  const T rn = tsqrt(tmax(dot3(radial, radial), T(1e-24)));
  safe_unit(radial, c0, T(1e-9), n);
  const bool parallel = tabs(dot3(a1, a2)) > T(0.99);
  const bool overlap = tabs(h) < s1[1] + s2[1];
  const T d_radial = rn - s1[0] - s2[0];
  const T d = parallel && overlap ? d_radial : T(kBig);
  const T hh[2] = {tmin(s1[1], h + s2[1]), tmax(-s1[1], h - s2[1])};
  const T q = s1[0] + T(0.5) * d_radial;
  for (int s = 0; s < 2; ++s) {
    dist[s] = d;
    for (int k = 0; k < 3; ++k) {
      pos[3 * s + k] = (x1[k] + n[k] * q) + a1[k] * hh[s];
      nrm[3 * s + k] = n[k];
    }
  }
}

// A contact distance d of a capsule of radius r (axis `axis`) corrected to the
// rim of the cylinder of the same radius.
template <typename T>
HD T cyl_correction(T d, const T* n, const T* axis, T r) {
  const T na = tclip(tabs(dot3(n, axis)), T(0), T(1));
  return d + r * (T(1) - tsqrt(tmax(T(1) - na * na, T(0))));
}

// Cylinder against a box: capsule-box of the cylinder's axis, each slot's
// distance corrected to the rim.
template <typename T>
HD void cylinder_box(const T* x1, const T* m1, const T* s1, const T* x2, const T* m2, const T* s2, T* dist, T* pos,
                     T* nrm) {
  capsule_box(x1, m1, s1, x2, m2, s2, dist, pos, nrm);
  T axis[3];
  mcol(m1, 2, axis);
  for (int s = 0; s < 2; ++s) dist[s] = cyl_correction(dist[s], nrm + 3 * s, axis, s1[0]);
}

// Sphere (radius s1[0]) against a box: the closest point of the box, or, with
// the centre inside, the face of least gap (ties to the lowest axis).
template <typename T>
HD void sphere_box(const T* x1, const T* s1, const T* x2, const T* m2, const T* s2, T* dist, T* pos, T* nrm) {
  T rel[3], local[3], clamped[3], delta[3], gaps[3];
  for (int k = 0; k < 3; ++k) rel[k] = x1[k] - x2[k];
  bool inside = true;
  for (int j = 0; j < 3; ++j) {
    local[j] = m2[j] * rel[0] + m2[3 + j] * rel[1] + m2[6 + j] * rel[2];
    clamped[j] = tmax(tmin(local[j], s2[j]), -s2[j]);
    delta[j] = local[j] - clamped[j];
    gaps[j] = s2[j] - tabs(local[j]);
    inside = inside && tabs(local[j]) < s2[j];
  }
  const T dn_out = tsqrt(tmax(dot3(delta, delta), T(1e-24)));
  const T gmin = tmin(tmin(gaps[0], gaps[1]), gaps[2]);
  const int sel = gaps[0] == gmin ? 0 : (gaps[1] == gmin ? 1 : 2);
  T n_in[3] = {0, 0, 0};
  n_in[sel] = tsign(local[sel]);
  const T dn_in = -gmin;
  const T inv = T(1) / tmax(dn_out, T(1e-12));
  T nl[3], sl[3];
  for (int j = 0; j < 3; ++j) {
    nl[j] = inside ? n_in[j] : delta[j] * inv;
    sl[j] = inside ? local[j] - dn_in * n_in[j] : clamped[j];
  }
  dist[0] = (inside ? dn_in : dn_out) - s1[0];
  for (int k = 0; k < 3; ++k) {
    nrm[k] = -(m2[3 * k] * nl[0] + m2[3 * k + 1] * nl[1] + m2[3 * k + 2] * nl[2]);
    const T surf = x2[k] + (m2[3 * k] * sl[0] + m2[3 * k + 1] * sl[1] + m2[3 * k + 2] * sl[2]);
    pos[k] = surf + T(0.5) * dist[0] * nrm[k];
  }
}

// Plane against a cylinder (radius s2[0], half height s2[1]): the rim point
// of each end face deepest along the plane's normal, the -axis end first. The
// rim direction is the normal's part across the axis; with the axis along
// the normal (a cylinder lying on a face) that part is rounding noise, and
// below 1e-8 the cylinder's x column takes its place.
template <typename T>
HD void plane_cylinder(const T* x1, const T* m1, const T* x2, const T* m2, const T* s2, T* dist, T* pos, T* nrm) {
  T n[3], axis[3], c0[3], proj[3], rim[3];
  mcol(m1, 2, n);
  mcol(m2, 2, axis);
  mcol(m2, 0, c0);
  const T an = dot3(axis, n);
  for (int k = 0; k < 3; ++k) proj[k] = axis[k] * an - n[k];
  safe_unit(proj, c0, T(1e-8), rim);
  for (int s = 0; s < 2; ++s) {
    const T sgn = s == 0 ? T(-1) : T(1);
    T cend[3], rel[3];
    for (int k = 0; k < 3; ++k) {
      cend[k] = (x2[k] + (sgn * s2[1]) * axis[k]) + s2[0] * rim[k];
      rel[k] = cend[k] - x1[k];
    }
    dist[s] = dot3(rel, n);
    for (int k = 0; k < 3; ++k) {
      pos[3 * s + k] = cend[k] - (T(0.5) * dist[s]) * n[k];
      nrm[3 * s + k] = n[k];
    }
  }
}

// Sphere against a sphere (radii s1[0], s2[0]): along the line of centres,
// +z where the centres coincide.
template <typename T>
HD void sphere_sphere(const T* x1, const T* s1, const T* x2, const T* s2, T* dist, T* pos, T* nrm) {
  T delta[3];
  for (int k = 0; k < 3; ++k) delta[k] = x2[k] - x1[k];
  const T dn = tsqrt(tmax(dot3(delta, delta), T(1e-24)));
  const T ez[3] = {T(0), T(0), T(1)};
  safe_unit(delta, ez, T(1e-9), nrm);
  dist[0] = dn - s1[0] - s2[0];
  for (int k = 0; k < 3; ++k) pos[k] = x1[k] + nrm[k] * (s1[0] + T(0.5) * dist[0]);
}

// Sphere (radius s1[0]) against a capsule (radius s2[0], half length s2[1]):
// the closest point of the capsule's segment.
template <typename T>
HD void sphere_capsule(const T* x1, const T* s1, const T* x2, const T* m2, const T* s2, T* dist, T* pos, T* nrm) {
  T axis[3], a[3], ab[3], pa[3], c[3], delta[3];
  mcol(m2, 2, axis);
  for (int k = 0; k < 3; ++k) {
    a[k] = x2[k] - s2[1] * axis[k];
    ab[k] = (x2[k] + s2[1] * axis[k]) - a[k];
    pa[k] = x1[k] - a[k];
  }
  const T t = tclip(dot3(pa, ab) / tmax(dot3(ab, ab), T(1e-12)), T(0), T(1));
  for (int k = 0; k < 3; ++k) {
    c[k] = a[k] + t * ab[k];
    delta[k] = c[k] - x1[k];
  }
  const T dn = tsqrt(tmax(dot3(delta, delta), T(1e-24)));
  const T ez[3] = {T(0), T(0), T(1)};
  safe_unit(delta, ez, T(1e-9), nrm);
  dist[0] = dn - s1[0] - s2[0];
  for (int k = 0; k < 3; ++k) pos[k] = x1[k] + nrm[k] * (s1[0] + T(0.5) * dist[0]);
}

// Sphere against a cylinder: sphere-capsule of the cylinder's axis, the
// distance corrected to the rim.
template <typename T>
HD void sphere_cylinder(const T* x1, const T* s1, const T* x2, const T* m2, const T* s2, T* dist, T* pos, T* nrm) {
  sphere_capsule(x1, s1, x2, m2, s2, dist, pos, nrm);
  T axis[3];
  mcol(m2, 2, axis);
  dist[0] = cyl_correction(dist[0], nrm, axis, s2[0]);
}

// Capsule against a cylinder: capsule-capsule of the cylinder's axis, the
// distance corrected to the rim.
template <typename T>
HD void capsule_cylinder(const T* x1, const T* m1, const T* s1, const T* x2, const T* m2, const T* s2, T* dist,
                         T* pos, T* nrm) {
  capsule_capsule(x1, m1, s1, x2, m2, s2, dist, pos, nrm);
  T axis[3];
  mcol(m2, 2, axis);
  dist[0] = cyl_correction(dist[0], nrm, axis, s2[0]);
}

// The contact slots of one pair of kind `kind` (at most 4) into dist, pos
// and nrm. An unknown code is never computed as some other pair: it stops
// the kernel. A call, not inlined: the narrowphase and the distance sensors
// share one copy of the fourteen kinds' code.
template <typename T>
HD_NOINLINE void pair_contacts(int kind, const T* x1, const T* m1, const T* s1, const T* x2, const T* m2, const T* s2, T* d,
                      T* pos, T* nrm) {
  switch (kind) {
    case PAIR_BOX_BOX: box_box(x1, m1, s1, x2, m2, s2, d, pos, nrm); return;
    case PAIR_CAPSULE_BOX: capsule_box(x1, m1, s1, x2, m2, s2, d, pos, nrm); return;
    case PAIR_PLANE_SPHERE: plane_sphere(x1, m1, x2, s2, d, pos, nrm); return;
    case PAIR_PLANE_CAPSULE: plane_capsule(x1, m1, x2, m2, s2, d, pos, nrm); return;
    case PAIR_PLANE_BOX: plane_box(x1, m1, x2, m2, s2, d, pos, nrm); return;
    case PAIR_CAPSULE_CAPSULE: capsule_capsule(x1, m1, s1, x2, m2, s2, d, pos, nrm); return;
    case PAIR_CYLINDER_CYLINDER: cylinder_cylinder(x1, m1, s1, x2, m2, s2, d, pos, nrm); return;
    case PAIR_CYLINDER_BOX: cylinder_box(x1, m1, s1, x2, m2, s2, d, pos, nrm); return;
    case PAIR_SPHERE_BOX: sphere_box(x1, s1, x2, m2, s2, d, pos, nrm); return;
    case PAIR_PLANE_CYLINDER: plane_cylinder(x1, m1, x2, m2, s2, d, pos, nrm); return;
    case PAIR_SPHERE_CYLINDER: sphere_cylinder(x1, s1, x2, m2, s2, d, pos, nrm); return;
    case PAIR_CAPSULE_CYLINDER: capsule_cylinder(x1, m1, s1, x2, m2, s2, d, pos, nrm); return;
    case PAIR_SPHERE_SPHERE: sphere_sphere(x1, s1, x2, s2, d, pos, nrm); return;
    case PAIR_SPHERE_CAPSULE: sphere_capsule(x1, s1, x2, m2, s2, d, pos, nrm); return;
    default:
#ifdef __CUDA_ARCH__
      __trap();
#else
      throw std::runtime_error("narrowphase: unknown pair kind code");
#endif
  }
}

#ifndef __CUDACC__
// The host twins' guard: run f(), and turn an exception of the step body into
// error code -1, its message kept for jt_error_string.
inline std::string& host_error() {
  static std::string msg;
  return msg;
}

template <class F>
int host_guard(F f) {
  try {
    f();
    return 0;
  } catch (const std::exception& e) {
    host_error() = e.what();
    return -1;
  }
}
#endif

}  // namespace jt
