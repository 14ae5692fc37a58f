// One Spot policy tick of one rollout, and the whole policy-in-the-loop
// rollout, computed by one warp: the 84-dim observation, the locomotion MLP
// (lanes over output neurons), the mapping to the 19 position targets, and
// `substeps` physics steps. Twin of
// judo_tpu_torch/tasks/spot/policy.py (build_observation_l, the MLP,
// control_from_policy_l) and physics/policy_rollout.py:
// policy_rollout_lanes_reference.
#pragma once

#include "jt_step.cuh"

namespace jt {

enum { ACT_NONE = 0, ACT_ELU = 1 };
constexpr int kPout = 12, kCmd = 25;

HD float texp(float x) { return expf(x); }
HD double texp(double x) { return exp(x); }

// The packed policy (policy_rollout.py:pack_policy).
// ints:    nlayers, dims[nlayers + 1], acts[nlayers], mujoco_to_orbit[19],
//          orbit_to_mujoco_legs[12]
// scalars: default_joint_pos[19], then per layer its weights input-major
//          (element (i, r) of an in x out layer at i * out + r), then its out
//          biases
template <typename T>
struct Policy {
  const int* dims;
  const int* acts;
  const int* m2o;
  const int* o2m;
  const T* djp;
  const T* W;
  int nl, maxw;
};

template <typename T>
HD Policy<T> policy_view(const int* pi, const T* pf) {
  Policy<T> p;
  p.nl = pi[0];
  p.dims = pi + 1;
  p.acts = p.dims + p.nl + 1;
  p.m2o = p.acts + p.nl;
  p.o2m = p.m2o + 19;
  p.djp = pf;
  p.W = pf + 19;
  p.maxw = 0;
  for (int l = 0; l <= p.nl; ++l) p.maxw = p.dims[l] > p.maxw ? p.dims[l] : p.maxw;
  return p;
}

// Scratch of the policy after the physics step's own (make_scratch(s).total):
// the carried policy output, the ctrl of this tick and two activation buffers.
struct PolicyScratch {
  int64_t pout, ctrl, a, b, total;
};

HD PolicyScratch make_policy_scratch(const JtSizes& s, int maxw) {
  PolicyScratch P;
  int64_t o = make_scratch(s).total;
  P.pout = o; o += kPout;
  P.ctrl = o; o += s.nu_;
  P.a = o; o += maxw;
  P.b = o; o += maxw;
  P.total = o;
  return P;
}

template <typename T>
HD T activate(int act, T x) {
  return act == ACT_ELU && !(x > T(0)) ? texp(tmin(x, T(0))) - T(1) : x;
}

// obs -> MLP -> ctrl for one tick; the new policy output lands in P.pout and
// the position targets in P.ctrl. The observation and the ctrl mapping run on
// lane 0. The MLP runs lanes over output neurons: at each input i the 32 lanes
// read 32 consecutive weights of the input-major pack (one coalesced line),
// and the activation, in shared memory, is a broadcast.
template <typename T>
HD void policy_tick(const Ctx<T>& c, const Policy<T>& p, const PolicyScratch& P, Lane<const T> cmd) {
  T* const w = c.w.p;
  const Lane<T> qpos = c.w.at(c.S.qpos), qvel = c.w.at(c.S.qvel);
  // observation: body-frame linear velocity, angular velocity, projected
  // gravity, the 25-dim command, joint positions and velocities in the
  // policy's joint order, the last policy output
  Warp::single([&] {
    const Lane<T> obs = c.w.at(P.a);
    T qinv[4] = {qpos[3], -qpos[4], -qpos[5], -qpos[6]}, v[3], o[3];
    const T down[3] = {T(0), T(0), T(-1)};
    lload(qvel, 0, 3, v);
    qrot(qinv, v, o);
    for (int k = 0; k < 3; ++k) obs[k] = o[k];
    for (int k = 0; k < 3; ++k) obs[3 + k] = qvel[3 + k];
    qrot(qinv, down, o);
    for (int k = 0; k < 3; ++k) obs[6 + k] = o[k];
    for (int k = 0; k < kCmd; ++k) obs[9 + k] = cmd[k];
    for (int j = 0; j < 19; ++j) {
      const int src = p.m2o[j];
      obs[34 + j] = qpos[7 + src] - p.djp[src];
      obs[53 + j] = qvel[6 + src];
    }
    for (int k = 0; k < kPout; ++k) obs[72 + k] = w[P.pout + k];
  });
  // MLP, ping-ponging between the two activation buffers
  int64_t in = P.a, out = P.b;
  const T* W = p.W;
  for (int l = 0; l < p.nl; ++l) {
    const int ni = p.dims[l], no = p.dims[l + 1], act = p.acts[l];
    const T* const bias = W + (int64_t)ni * no;
    Warp::for_each(no, [&](int r) {
      T acc = T(0);
      // unrolled so that eight weight loads from L2 are in flight before
      // their multiply-adds (the sum keeps its order); chip_profile.py unroll
      // measures it
#ifdef __CUDA_ARCH__
#pragma unroll 8
#endif
      for (int i = 0; i < ni; ++i) acc = acc + W[(int64_t)i * no + r] * w[in + i];
      w[out + r] = activate(act, acc + bias[r]);
    });
    W += (int64_t)(ni + 1) * no;
    const int64_t tmp = in;
    in = out;
    out = tmp;
  }
  Warp::for_each(kPout, [&](int k) { w[P.pout + k] = w[in + k]; });
  // position targets: default pose + 0.2 x output (legs, mujoco order), the
  // first leg with a nonzero command overrides its three joints, arm from
  // the command
  Warp::single([&] {
    const Lane<T> ctrl = c.w.at(P.ctrl);
    for (int i = 0; i < 12; ++i) ctrl[i] = T(0.2) * w[P.pout + p.o2m[i]] + p.djp[i];
    for (int leg = 0; leg < 4; ++leg) {
      const T a = cmd[10 + 3 * leg], b = cmd[11 + 3 * leg], d = cmd[12 + 3 * leg];
      if (a * a + b * b + d * d > T(0)) {
        for (int k = 0; k < 3; ++k) ctrl[3 * leg + k] = cmd[10 + 3 * leg + k];
        break;
      }
    }
    for (int k = 0; k < 7; ++k) ctrl[12 + k] = cmd[3 + k];
  });
}

// The whole policy-in-the-loop rollout of rollout b, run by the 32 lanes of
// one warp on the scratch `work` and, in the layout with J in global memory
// (JG), b's J in `jslab` (the body of the CUDA kernel and of the host twin's
// loop). Forces start at zero and the probe at ones; no onset force is read or
// written.
template <typename T, bool JG>
HD void policy_rollout(const JtSizes& s, const int* mi, const T* mf, const int* pi, const T* pf, const T* qpos0,
                       const T* qvel0, const T* pout0, const T* cmds, T* oq, T* ov, T* os, T* op, T* jslab, T* work,
                       int b) {
  const Ctx<T> c = rollout_ctx<T, JG>(s, mi, mf, work, jslab, b);
  const Policy<T> p = policy_view(pi, pf);
  const PolicyScratch P = make_policy_scratch(s, p.maxw);
  const int64_t B = s.B;
  rollout_init(c, qpos0, qvel0, (const T*)nullptr, b);
  Warp::for_each(kPout, [&](int k) { work[P.pout + k] = pout0[k * B + b]; });
  const Lane<const T> ctrl{work + P.ctrl, 1};
  for (int t = 0; t < s.T; ++t) {
    const Lane<const T> cmd_t{cmds + (int64_t)t * kCmd * B + b, B};
    const Lane<T> sens_t{os + (int64_t)t * s.ns_ * B + b, B};
    policy_tick(c, p, P, cmd_t);
    Warp::for_each(s.ns_, [&](int k) { sens_t[k] = T(0); });
    for (int sub = 0; sub < s.substeps; ++sub) step(c, ctrl, sens_t);
    store_state(c, oq, ov, t, b);
    Warp::for_each(kPout, [&](int k) { op[((int64_t)t * kPout + k) * B + b] = work[P.pout + k]; });
  }
}

}  // namespace jt
