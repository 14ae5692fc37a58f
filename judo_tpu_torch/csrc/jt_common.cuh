// Shared definitions of the step body, written for a group of W warps per
// rollout (one warp, W = 1, unless the rollouts leave the card's SMs idle).
//
// Everything here is __host__ __device__: nvcc builds it into the CUDA kernels
// (fused_rollout.cu, fused_policy_rollout.cu) and g++ builds the same code into
// a CPU library (*_host.cpp) that the CPU tests hold against the plain PyTorch
// versions. The model arrives as two flat arrays (ints and scalars) in fixed
// record layouts that judo_tpu_torch/physics/fused_rollout.py packs. One block
// computes one rollout, and that rollout's work arrays (make_scratch) are one
// contiguous buffer: dynamic shared memory on the card, a heap buffer in the
// host twin. The block's W x 32 threads share the work through Group<W>
// (below); on the host the same primitives play the threads in the card's
// order, so the host twin runs the partition and summation order that the
// card runs. No per-thread array is sized by the model (only fixed small
// locals): the wrapper sizes the shared memory from jt_scratch_per_lane, moves
// J to global memory where the whole scratch exceeds the card's per-block
// limit (make_scratch), and raises where even the rest exceeds it.
#pragma once

#include <math.h>
#include <stdint.h>
#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>
#endif

#ifdef __CUDACC__
#define HD __host__ __device__ inline
#define HD_FORCEINLINE __host__ __device__ __forceinline__
#define HD_NOINLINE __host__ __device__ __noinline__
#else
#define HD inline
#define HD_FORCEINLINE inline
#define HD_NOINLINE inline
#endif

extern "C" {
// Sizes of one launch; mirrored by fused_rollout.py:_Sizes.
// pyramidal: 4 facet rows per contact and the orthant projection (else the
// elliptic cone's 3 rows); cold: start each launch's probe with 3 warm-up
// |A| applies instead of reading the carried one. nnc: the rows before the
// contact block (joint-equality rows, then joint-limit rows); ndist, ndpair:
// distance sensors and the geom pairs they read. jglobal: the scratch layout
// that keeps each rollout's J in a slab of global memory (make_scratch).
struct JtSizes {
  int B, T, substeps, iterations, pyramidal, cold;
  int nq, nv, nu, nbody, njnt, ngeom, nsite, nsensor, nsensordata;
  int nnc, npair, ncon, nefc, nisl, ndist, ndpair;
  int nu_, ns_, nefc_, jglobal;
};
}

namespace jt {

enum { FREE = 0, BALL = 1, SLIDE = 2, HINGE = 3 };
// Pair kind codes; fused_rollout.py:PAIR_KINDS mirrors them.
enum {
  PAIR_BOX_BOX = 0, PAIR_CAPSULE_BOX = 1, PAIR_PLANE_SPHERE = 2, PAIR_PLANE_CAPSULE = 3, PAIR_PLANE_BOX = 4,
  PAIR_CAPSULE_CAPSULE = 5, PAIR_CYLINDER_CYLINDER = 6, PAIR_CYLINDER_BOX = 7, PAIR_SPHERE_BOX = 8,
  PAIR_PLANE_CYLINDER = 9, PAIR_SPHERE_CYLINDER = 10, PAIR_CAPSULE_CYLINDER = 11, PAIR_SPHERE_SPHERE = 12,
  PAIR_SPHERE_CAPSULE = 13, NUM_PAIR_KINDS = 14
};
enum { S_JOINTPOS = 9, S_JOINTVEL = 10, S_FRAMEPOS = 26, S_FRAMEQUAT = 27, S_FRAMEXAXIS = 28,
       S_FRAMEZAXIS = 30 };
enum { OBJ_BODY = 1, OBJ_XBODY = 2, OBJ_SITE = 6 };

// Record widths (ints I, scalars F) per entity; fused_rollout.py packs them.
// body  I: parentid rootid jntadr jntnum
//       F: pos3 quat4 ipos3 iquat4 mass inertia3 subtree_mass
// joint I: type qposadr dofadr bodyid actfrclimited
//       F: pos3 axis3 qpos0 stiffness qpos_spring actfrc_lo actfrc_hi spring7
//       (spring7: the joint's qpos_spring entries, zero-padded to 7: a free
//       joint's position and quaternion, a ball joint's quaternion)
// dof   I: bodyid parentid          F: damping armature implicit_damping
// geom  I: bodyid                   F: pos3 quat4
// site  I: bodyid                   F: pos3 quat4
// act   I: qadr dadr ctrllimited forcelimited
//       F: gear gain bias0 bias1 bias2 ctrl_lo ctrl_hi force_lo force_hi
// sensor I: type objtype objid adr dim reftype refid
// row before the contacts (one of nnc), I: kind q1adr d1adr q2adr d2adr
//       F: side a b solimp5 k b invweight coef5
//       kind ROW_LIMIT: a = the range end, b = margin (q2adr, d2adr, coef unused);
//       kind ROW_EQUALITY: a, b = qpos0 of joints 1 and 2, q2adr = -1 where
//       there is no second joint, coef the polynomial's
// pair  I: kind g1 g2 slot0 nslot   F: size1_3 size2_3
// slot  I: body1 body2              F: mu k b solimp5 margin diag
//       (diag: the rows' invweight; max(2 invweight mu^2 (1 + mu^2), 1e-15)
//       for pyramidal facets)
// island I: start size
// distance sensor I: adr dpair0 ndpair   F: cutoff
// distance pair I: kind g1 g2 nslot      F: size1_3 size2_3
// then body_dof_mask (nbody x nv ints); scalars start with the globals
// timestep gravity3 impratio.
constexpr int BI = 4, BF = 19, JI = 5, JF = 18, DI = 2, DF = 3, GI = 1, GF = 7, SI = 1, SF = 7;
constexpr int AI = 4, AF = 9, NI = 7, LI = 5, LF = 16, PI = 5, PF = 6, CI = 2, CF = 10, II = 2;
constexpr int XI = 3, XF = 1, QI = 4, QF = 6;
constexpr int GLOBF = 5;
enum { ROW_LIMIT = 0, ROW_EQUALITY = 1 };

struct Layout {
  int ib, ij, id, ig, is, ia, in, il, ip, ic, ii, ix, iq, imask, nint;
  int fb, fj, fd, fg, fs, fa, fl, fp, fc, fx, fq, nflt;
};

HD Layout make_layout(const JtSizes& s) {
  Layout L;
  int o = 0;
  L.ib = o; o += BI * s.nbody;
  L.ij = o; o += JI * s.njnt;
  L.id = o; o += DI * s.nv;
  L.ig = o; o += GI * s.ngeom;
  L.is = o; o += SI * s.nsite;
  L.ia = o; o += AI * s.nu;
  L.in = o; o += NI * s.nsensor;
  L.il = o; o += LI * s.nnc;
  L.ip = o; o += PI * s.npair;
  L.ic = o; o += CI * s.ncon;
  L.ii = o; o += II * s.nisl;
  L.ix = o; o += XI * s.ndist;
  L.iq = o; o += QI * s.ndpair;
  L.imask = o; o += s.nbody * s.nv;
  L.nint = o;
  o = GLOBF;
  L.fb = o; o += BF * s.nbody;
  L.fj = o; o += JF * s.njnt;
  L.fd = o; o += DF * s.nv;
  L.fg = o; o += GF * s.ngeom;
  L.fs = o; o += SF * s.nsite;
  L.fa = o; o += AF * s.nu;
  L.fl = o; o += LF * s.nnc;
  L.fp = o; o += PF * s.npair;
  L.fc = o; o += CF * s.ncon;
  L.fx = o; o += XF * s.ndist;
  L.fq = o; o += QF * s.ndpair;
  L.nflt = o;
  return L;
}

// Per-rollout scratch sections, in elements. Two layouts: everything in the
// one buffer (shared memory on the card), or, with s.jglobal, everything but J,
// whose jsize elements per rollout then live in a slab of global memory that
// the wrapper allocates (S.J is -1). The wrapper takes the first where it fits
// the card's per-block limit of shared memory, else the second.
struct Scratch {
  int64_t qpos, qvel, fw, cwv;
  int64_t xpos, xquat, xmat, xipos, ximat, xanchor, xaxis, gxpos, gxmat, sxpos, sxmat;
  int64_t scom, cinert, crb, cdof, cvel, cdofdot, cacc, cfrc;
  int64_t M, Minv, work, qfrc, qacc_s, qacc, tv1, tv2;
  int64_t cdist, cpos, cnorm;
  int64_t J, aref, reg, diag, act, invs, bvec, f, y, grad, fnew, vv, bv, muc;
  int64_t total, jsize;
  int jld;  // row stride of J
};

HD Scratch make_scratch(const JtSizes& s) {
  Scratch S;
  int64_t o = 0;
  const int64_t nb = s.nbody, nv = s.nv, ne = s.nefc, nc = s.ncon;
  // J's rows are padded to an odd stride: lanes that walk different rows of J
  // (one row each) then fall in different shared-memory banks, where an even
  // stride such as leap's nv = 22 would put two lanes on every bank.
  S.jld = s.nv | 1;
  S.jsize = ne * S.jld;
  S.qpos = o; o += s.nq;
  S.qvel = o; o += nv;
  S.fw = o; o += ne;
  S.cwv = o; o += ne;
  S.xpos = o; o += 3 * nb;
  S.xquat = o; o += 4 * nb;
  S.xmat = o; o += 9 * nb;
  S.xipos = o; o += 3 * nb;
  S.ximat = o; o += 9 * nb;
  S.xanchor = o; o += 3 * s.njnt;
  S.xaxis = o; o += 3 * s.njnt;
  S.gxpos = o; o += 3 * s.ngeom;
  S.gxmat = o; o += 9 * s.ngeom;
  S.sxpos = o; o += 3 * s.nsite;
  S.sxmat = o; o += 9 * s.nsite;
  S.scom = o; o += 3 * nb;
  S.cinert = o; o += 36 * nb;
  S.crb = o; o += 36 * nb;
  S.cdof = o; o += 6 * nv;
  S.cvel = o; o += 6 * nb;
  S.cdofdot = o; o += 6 * nv;
  S.cacc = o; o += 6 * nb;
  S.cfrc = o; o += 6 * nb;
  S.M = o; o += nv * nv;
  S.Minv = o; o += nv * nv;
  S.work = o; o += nv * nv;
  S.qfrc = o; o += nv;
  S.qacc_s = o; o += nv;
  S.qacc = o; o += nv;
  S.tv1 = o; o += nv;
  S.tv2 = o; o += nv;
  S.cdist = o; o += nc;
  S.cpos = o; o += 3 * nc;
  S.cnorm = o; o += 3 * nc;
  S.J = s.jglobal ? -1 : o;
  if (!s.jglobal) o += S.jsize;
  S.aref = o; o += ne;
  S.reg = o; o += ne;
  S.diag = o; o += ne;
  S.act = o; o += ne;
  S.invs = o; o += ne;
  S.bvec = o; o += ne;
  S.f = o; o += ne;
  S.y = o; o += ne;
  S.grad = o; o += ne;
  S.fnew = o; o += ne;
  S.vv = o; o += ne;
  S.bv = o; o += ne;
  S.muc = o; o += nc;
  S.total = o;
  return S;
}

// A strided view: element k at p[k * s]. The rollout's scratch is a view with
// s = 1; a batch-last global array (element k of rollout b at k * B + b) is
// one with s = B.
template <typename T>
struct Lane {
  T* p;
  int64_t s;
  HD T& operator[](int64_t k) const { return p[k * s]; }
  HD Lane at(int64_t off) const { return Lane{p + off * s, s}; }
};

#ifdef __CUDACC__
// The W partials of a fold over a block of W warps (Group<W>).
template <typename T, int W>
__device__ inline T* fold_partials() {
  __shared__ T partials[W];
  return partials;
}
#endif

// The W warps (W x 32 threads) of the block that computes one rollout; W = 1
// is one warp, as K2 and K3 always run and K1 where its rollouts fill the card.
// Every thread calls each primitive together with the others (never inside
// single() or inside the body of another primitive), and code between
// primitives is the same on every thread and writes no scratch.
//   for_each(n, f): f(i) for i < n, thread l taking i = l, l + 32 W, ...;
//     ends with a barrier (__syncwarp at W = 1, else __syncthreads), so what
//     f wrote is visible to every thread afterwards.
//   sum(n, f), max(n, f, init), min(n, f, init): each thread folds its
//     indices in that order, then an xor-shuffle tree combines the 32
//     partials of each warp; at W > 1 each warp's partial goes to shared
//     memory and every thread combines the W of them in warp order, between
//     two barriers (the second keeps the next fold from overwriting them).
//     Every thread gets the same value.
//   single(f): f() on thread 0 alone, then the barrier.
// Compiled by g++, one thread plays the W x 32 threads in the same partition,
// the same trees and the same order, so the host twin's sums round as the
// card's do.
template <int W>
struct Group {
  static constexpr int kWarps = W;
  static constexpr int kLanes = 32;
  static constexpr int kThreads = W * kLanes;

  template <class F>
  static HD void for_each(int n, F f) {
#ifdef __CUDA_ARCH__
    if constexpr (W == 1) {
      for (int i = threadIdx.x & (kLanes - 1); i < n; i += kLanes) f(i);
      __syncwarp();
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads) f(i);
      __syncthreads();
    }
#else
    for (int l = 0; l < kThreads; ++l)
      for (int i = l; i < n; i += kThreads) f(i);
#endif
  }

  template <class F>
  static HD void single(F f) {
#ifdef __CUDA_ARCH__
    if constexpr (W == 1) {
      if ((threadIdx.x & (kLanes - 1)) == 0) f();
      __syncwarp();
    } else {
      if (threadIdx.x == 0) f();
      __syncthreads();
    }
#else
    f();
#endif
  }

  template <class F>
  static HD auto sum(int n, F f) -> decltype(f(0)) {
    return fold(n, f, decltype(f(0))(0), [](decltype(f(0)) a, decltype(f(0)) b) { return a + b; });
  }

  template <class F, typename T>
  static HD T max(int n, F f, T init) {
    return fold(n, f, init, [](T a, T b) { return a > b ? a : b; });
  }

  template <class F, typename T>
  static HD T min(int n, F f, T init) {
    return fold(n, f, init, [](T a, T b) { return a < b ? a : b; });
  }

 private:
  template <class F, typename T, class Op>
  static HD T fold(int n, F f, T init, Op op) {
#ifdef __CUDA_ARCH__
    T p = init;
    if constexpr (W == 1) {
      for (int i = threadIdx.x & (kLanes - 1); i < n; i += kLanes) p = op(p, f(i));
      for (int o = kLanes / 2; o > 0; o >>= 1) p = op(p, __shfl_xor_sync(0xffffffffu, p, o));
      return p;
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads) p = op(p, f(i));
      for (int o = kLanes / 2; o > 0; o >>= 1) p = op(p, __shfl_xor_sync(0xffffffffu, p, o));
      T* const part = fold_partials<T, W>();
      if ((threadIdx.x & (kLanes - 1)) == 0) part[threadIdx.x / kLanes] = p;
      __syncthreads();
      T r = part[0];
      for (int k = 1; k < W; ++k) r = op(r, part[k]);
      __syncthreads();
      return r;
    }
#else
    T p[kThreads], q[kThreads];
    for (int l = 0; l < kThreads; ++l) {
      p[l] = init;
      for (int i = l; i < n; i += kThreads) p[l] = op(p[l], f(i));
    }
    for (int o = kLanes / 2; o > 0; o >>= 1) {
      for (int l = 0; l < kThreads; ++l) q[l] = op(p[l], p[l ^ o]);
      for (int l = 0; l < kThreads; ++l) p[l] = q[l];
    }
    T r = p[0];
    for (int k = 1; k < W; ++k) r = op(r, p[k * kLanes]);
    return r;
#endif
  }
};

// One warp: the group of K2, K3, and K1 where its rollouts fill the card.
using Warp = Group<1>;

#ifdef __CUDACC__
// The block's dynamic shared memory, which holds the rollout's scratch.
template <typename T>
__device__ inline T* rollout_smem() {
  extern __shared__ __align__(16) unsigned char jt_smem[];
  return reinterpret_cast<T*>(jt_smem);
}

// Let `kernel` take `bytes` of dynamic shared memory per block: above 48 KB a
// launch needs this, once for each kernel and each template instantiation.
// The attribute is set only where a launch needs more than was set before for
// that kernel on the current device, so a launch recorded into a CUDA graph
// after a warm-up launch of the same size makes no attribute call.
template <class K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, int> allowed;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  int& have = allowed[{dev, reinterpret_cast<const void*>(kernel)}];
  if (bytes <= have) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) have = bytes;
  return e;
}
#endif

// Scalar helpers with one overload set for float and double.
HD float tsqrt(float x) { return sqrtf(x); }
HD double tsqrt(double x) { return sqrt(x); }
HD float tsin(float x) { return sinf(x); }
HD double tsin(double x) { return sin(x); }
HD float tcos(float x) { return cosf(x); }
HD double tcos(double x) { return cos(x); }
HD float tabs(float x) { return fabsf(x); }
HD double tabs(double x) { return fabs(x); }
HD float tpow(float x, float y) { return powf(x, y); }
HD double tpow(double x, double y) { return pow(x, y); }
template <typename T> HD T tmax(T a, T b) { return a > b ? a : b; }
template <typename T> HD T tmin(T a, T b) { return a < b ? a : b; }
// The index of x's lowest set bit (x nonzero).
HD int lowest_bit(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __ffs(x) - 1;
#else
  return __builtin_ctz(x);
#endif
}
template <typename T> HD T tclip(T x, T lo, T hi) { return tmin(tmax(x, lo), hi); }
template <typename T> HD T tsign(T x) { return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0)); }
template <typename T> HD T trsqrt(T x) { return T(1) / tsqrt(x); }

template <typename T> HD T dot3(const T* a, const T* b) { return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]; }

template <typename T> HD void cross3(const T* a, const T* b, T* o) {
  T x = a[1] * b[2] - a[2] * b[1], y = a[2] * b[0] - a[0] * b[2], z = a[0] * b[1] - a[1] * b[0];
  o[0] = x; o[1] = y; o[2] = z;
}

template <typename T> HD void qmul(const T* u, const T* v, T* o) {
  T w = u[0] * v[0] - u[1] * v[1] - u[2] * v[2] - u[3] * v[3];
  T x = u[0] * v[1] + u[1] * v[0] + u[2] * v[3] - u[3] * v[2];
  T y = u[0] * v[2] - u[1] * v[3] + u[2] * v[0] + u[3] * v[1];
  T z = u[0] * v[3] + u[1] * v[2] - u[2] * v[1] + u[3] * v[0];
  o[0] = w; o[1] = x; o[2] = y; o[3] = z;
}

// v + 2 (w (u x v) + u x (u x v)), u = q[1:4]
template <typename T> HD void qrot(const T* q, const T* v, T* o) {
  T uv[3], uuv[3];
  cross3(q + 1, v, uv);
  cross3(q + 1, uv, uuv);
  for (int k = 0; k < 3; ++k) o[k] = v[k] + T(2) * (q[0] * uv[k] + uuv[k]);
}

// Row-major 3x3 rotation matrix of a quaternion.
template <typename T> HD void q2mat(const T* q, T* m) {
  T w = q[0], x = q[1], y = q[2], z = q[3];
  m[0] = 1 - 2 * (y * y + z * z); m[1] = 2 * (x * y - w * z); m[2] = 2 * (x * z + w * y);
  m[3] = 2 * (x * y + w * z); m[4] = 1 - 2 * (x * x + z * z); m[5] = 2 * (y * z - w * x);
  m[6] = 2 * (x * z - w * y); m[7] = 2 * (y * z + w * x); m[8] = 1 - 2 * (x * x + y * y);
}

template <typename T> HD void qnormalize(T* q) {
  T s = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  T n = trsqrt(tmax(s, T(1e-15)));
  for (int k = 0; k < 4; ++k) q[k] *= n;
}

template <typename T> HD void lload(Lane<T> a, int64_t off, int n, T* o) {
  for (int k = 0; k < n; ++k) o[k] = a[off + k];
}
template <typename T> HD void lstore(Lane<T> a, int64_t off, int n, const T* v) {
  for (int k = 0; k < n; ++k) a[off + k] = v[k];
}

}  // namespace jt
