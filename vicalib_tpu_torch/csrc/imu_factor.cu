// The IMU factor (SwitchedFullImuCostFunction, ceres-cost-functions.h:
// 379-490) and its Jacobian for Hopper (sm_90a), in float and double.
//
// Replaces no TPU kernel: the JAX package leaves the factor to XLA.
// Written with torch.func (reverse mode inside vmap through the RK4
// preintegration) it is some 4,400 small float64 ops an LM step, the
// largest share of the LM graphs' nodes and of their bytes.  This kernel
// computes per factor what preintegrate.imu_factor_residual computes at
// the solver's tangent increments: the virtual measurement sequence,
// the factorised RK4 chain, the normalised end quaternion, the SE(3) log,
// the whitening by weight_sqrt, the rotation-only rows and the has_meas
// zeros; and optionally the Jacobian against the 33 tangent columns
// [dx1 (9), dx2 (9), gravity (2), biases (6), scales (6), time offset (1)].
// Its plain twin, arithmetic for arithmetic, is imu/factor.py's
// imu_factor_plain.
//
// Derivatives are forward-mode duals (Ceres's jets).  Only 13 directions
// flow along the slots: the biases, the scales and the time offset (dual
// lane w: gyro bias 0-2, accel bias 3-5, gyro scale 6-8, accel scale 9-11,
// time offset 12).  Pose 1 and gravity enter at the chain's closed-form end
// (q_end = q1 P_M, v_end = v1 + R(q1) Sv - g T, t_end = t1 + v1 T +
// R(q1) St - g G) and pose 2 only in the final log, so those 20 columns
// are applied in the epilogue by the chain rule.
//
// Design.  Jacobian: one block of 13 warps per factor; warp w carries the
// value and dual lane w, and its 32 threads take 32 intervals at a time:
// each interval's RK4 locals (three rotations, four exponentials) are
// independent of the others, the rotations' prefix product is a warp scan
// of dual quaternions (left times right, as the twin's doubling), carried
// from one 32-interval chunk to the next, and the sums Sv, St, G are warp
// sums.  Then 33 threads of the block take one tangent column each through
// the epilogue and write it.  Value only: one warp per (candidate,
// factor), the same chain without duals, the epilogue on lane 0.  The
// leading candidate dimension C of the state makes the LM step's damping
// candidates one launch.
//
// Bound on this card: the kernel must read the windows (7 values a slot)
// and write r and J, a few MB at the EuRoC rig's shapes, so bytes bound it
// at a few microseconds; it is bound by float64 issue instead: every dual
// lane recomputes the value, and sin, cos, sqrt and division are dozens of
// float64 instructions each.  What the design does about it: the
// intervals' locals run in parallel, not along the chain, and nothing
// leaves registers but one shuffle-scan per chunk and 13 x 12 chain values
// through shared memory.
//
// Resources (nvcc -Xptxas -v, sm_90a): imu_jac_kernel<double> 128
// registers (the launch bound of 416 threads), a 712-byte stack frame with
// 760 bytes of spill stores, 1,344 bytes of static shared memory;
// imu_value_kernel<double> 166 registers, no spills; the float versions 128
// registers (8 bytes spilled) and 96.
//
// The window's stamps must be non-decreasing (imu.buffer.gather_windows),
// so that a binary search finds the count of stamps at or before a query,
// which preintegrate.virtual_sequence counts directly.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 13;       // dual lanes along the slots
constexpr int kCols = 33;        // tangent columns
constexpr int kChain0 = 20;      // the first chain column
constexpr int kChainVals = 12;   // P_M (4), Sv (3), St (3), T, G
constexpr int kJacThreads = kLanes * 32;
constexpr int kValueWarps = 4;
constexpr double kGravityMag = 9.8007;   // preintegrate.GRAVITY_MAG
constexpr double kEps2 = 1e-8;           // geometry/so3.py _EPS2
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double vsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float vsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double vsin(double x) { return sin(x); }
__device__ __forceinline__ float vsin(float x) { return sinf(x); }
__device__ __forceinline__ double vcos(double x) { return cos(x); }
__device__ __forceinline__ float vcos(float x) { return cosf(x); }
__device__ __forceinline__ double vatan2(double y, double x) {
  return atan2(y, x);
}
__device__ __forceinline__ float vatan2(float y, float x) {
  return atan2f(y, x);
}
__device__ __forceinline__ double vabs(double x) { return fabs(x); }
__device__ __forceinline__ float vabs(float x) { return fabsf(x); }

// ------------------------------------------------------------------ duals
template <typename T>
struct Dual {
  T v, d;
};

template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) {
  return {a.v + b.v, a.d + b.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) {
  return {a.v - b.v, a.d - b.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a) {
  return {-a.v, -a.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, Dual<T> b) {
  const T q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
// with a number, which has no derivative (rounded to T first, as torch
// does a Python number)
template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, double s) {
  return {a.v + T(s), a.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator+(double s, Dual<T> a) {
  return {a.v + T(s), a.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, double s) {
  return {a.v - T(s), a.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(double s, Dual<T> a) {
  return {T(s) - a.v, -a.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, double s) {
  return {a.v * T(s), a.d * T(s)};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(double s, Dual<T> a) {
  return {a.v * T(s), a.d * T(s)};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, double s) {
  return {a.v / T(s), a.d / T(s)};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator/(double s, Dual<T> b) {
  const T q = T(s) / b.v;
  return {q, -q * b.d / b.v};
}

template <typename T>
__device__ __forceinline__ Dual<T> constant(T v) {
  return {v, T(0)};
}
template <typename T>
__device__ __forceinline__ Dual<T> dsqrt(Dual<T> a) {
  const T s = vsqrt(a.v);
  return {s, a.d * (T(0.5) / s)};
}
template <typename T>
__device__ __forceinline__ Dual<T> dsin(Dual<T> a) {
  return {vsin(a.v), a.d * vcos(a.v)};
}
template <typename T>
__device__ __forceinline__ Dual<T> dcos(Dual<T> a) {
  return {vcos(a.v), -a.d * vsin(a.v)};
}
template <typename T>
__device__ __forceinline__ Dual<T> datan2(Dual<T> y, Dual<T> x) {
  const T n = x.v * x.v + y.v * y.v;
  return {vatan2(y.v, x.v), (x.v * y.d - y.v * x.d) / n};
}
// torch.clamp(a, min=lo): the derivative passes where a >= lo
template <typename T>
__device__ __forceinline__ Dual<T> clamp_min(Dual<T> a, double lo) {
  return a.v >= T(lo) ? a : constant(T(lo));
}
// torch.maximum / torch.minimum: a tie splits the derivative evenly
template <typename T>
__device__ __forceinline__ Dual<T> dmax(Dual<T> a, Dual<T> b) {
  if (a.v > b.v) return a;
  if (a.v < b.v) return b;
  return {a.v, T(0.5) * (a.d + b.d)};
}
template <typename T>
__device__ __forceinline__ Dual<T> dmin(Dual<T> a, Dual<T> b) {
  if (a.v < b.v) return a;
  if (a.v > b.v) return b;
  return {a.v, T(0.5) * (a.d + b.d)};
}
// preintegrate._clip: maximum, then minimum
template <typename T>
__device__ __forceinline__ Dual<T> clip(Dual<T> x, T lo, T hi) {
  return dmin(dmax(x, constant(lo)), constant(hi));
}

// ------------------------------------------------------ vectors, rotations
template <typename T>
struct V3 {
  Dual<T> c[3];
};
template <typename T>
struct Q4 {
  Dual<T> c[4];
};

template <typename T>
__device__ __forceinline__ V3<T> cross(const V3<T>& a, const V3<T>& b) {
  return {{a.c[1] * b.c[2] - a.c[2] * b.c[1],
           a.c[2] * b.c[0] - a.c[0] * b.c[2],
           a.c[0] * b.c[1] - a.c[1] * b.c[0]}};
}

template <typename T>
__device__ __forceinline__ Q4<T> qmul(const Q4<T>& a, const Q4<T>& b) {
  const Dual<T> &x1 = a.c[0], &y1 = a.c[1], &z1 = a.c[2], &w1 = a.c[3];
  const Dual<T> &x2 = b.c[0], &y2 = b.c[1], &z2 = b.c[2], &w2 = b.c[3];
  return {{w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
           w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
           w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
           w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2}};
}

// R(q) v = v + 2 (w u x v + u x (u x v)), as geometry/so3.py::rotate
template <typename T>
__device__ __forceinline__ V3<T> rotate(const Q4<T>& q, const V3<T>& v) {
  const V3<T> u = {{q.c[0], q.c[1], q.c[2]}};
  const V3<T> uv = cross(u, v);
  const V3<T> uuv = cross(u, uv);
  V3<T> out;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out.c[i] = v.c[i] + 2.0 * (q.c[3] * uv.c[i] + uuv.c[i]);
  return out;
}

template <typename T>
__device__ __forceinline__ Dual<T> norm2(const V3<T>& a) {
  return a.c[0] * a.c[0] + a.c[1] * a.c[1] + a.c[2] * a.c[2];
}

template <typename T>
__device__ __forceinline__ V3<T> scaled(const V3<T>& a, Dual<T> s) {
  return {{a.c[0] * s, a.c[1] * s, a.c[2] * s}};
}

template <typename T>
__device__ __forceinline__ Q4<T> identity() {
  return {{constant(T(0)), constant(T(0)), constant(T(0)), constant(T(1))}};
}

template <typename T>
__device__ __forceinline__ V3<T> zero3() {
  return {{constant(T(0)), constant(T(0)), constant(T(0))}};
}

// so3.exp with its small-angle branch
template <typename T>
__device__ Q4<T> so3_exp(const V3<T>& w) {
  const Dual<T> th2 = norm2(w);
  Dual<T> k, wq;
  if (th2.v < T(kEps2)) {
    k = 0.5 - th2 / 48.0;
    wq = 1.0 - th2 / 8.0;
  } else {
    const Dual<T> th = dsqrt(clamp_min(th2, kEps2));
    const Dual<T> half = 0.5 * th;
    k = dsin(half) / th;
    wq = dcos(half);
  }
  return {{k * w.c[0], k * w.c[1], k * w.c[2], wq}};
}

// so3.log with its small-angle branch
template <typename T>
__device__ V3<T> so3_log(Q4<T> q) {
  if (q.c[3].v < T(0)) {
#pragma unroll
    for (int i = 0; i < 4; ++i) q.c[i] = -q.c[i];
  }
  const V3<T> u = {{q.c[0], q.c[1], q.c[2]}};
  const Dual<T> w = q.c[3];
  const Dual<T> n2 = norm2(u);
  Dual<T> k;
  if (n2.v < T(kEps2)) {
    const Dual<T> w_safe = vabs(w.v) < T(1e-30) ? constant(T(1)) : w;
    k = 2.0 / w_safe * (1.0 - n2 / (3.0 * clamp_min(w * w, 1e-30)));
  } else {
    const Dual<T> n = dsqrt(clamp_min(n2, kEps2));
    k = 2.0 * datan2(n, w) / n;
  }
  return scaled(u, k);
}

// so3.jl_inv(w) @ t = t - w x t / 2 + c w x (w x t)
template <typename T>
__device__ V3<T> jl_inv_apply(const V3<T>& w, const V3<T>& t) {
  const Dual<T> th2 = norm2(w);
  Dual<T> c;
  if (th2.v < T(kEps2)) {
    c = 1.0 / 12.0 + th2 / 720.0;
  } else {
    const Dual<T> safe2 = clamp_min(th2, kEps2);
    const Dual<T> half = 0.5 * dsqrt(safe2);
    const Dual<T> sh = dsin(half);
    const Dual<T> sh_safe = vabs(sh.v) < T(1e-30) ? constant(T(1)) : sh;
    c = (1.0 - half * dcos(half) / sh_safe) / safe2;
  }
  const V3<T> wt = cross(w, t);
  const V3<T> wwt = cross(w, wt);
  V3<T> out;
#pragma unroll
  for (int i = 0; i < 3; ++i) out.c[i] = t.c[i] - 0.5 * wt.c[i] + c * wwt.c[i];
  return out;
}

// ------------------------------------------------------------------ shuffles
template <bool JAC, typename T>
__device__ __forceinline__ Dual<T> shfl_up(Dual<T> x, int delta) {
  Dual<T> r;
  r.v = __shfl_up_sync(kFull, x.v, delta);
  if constexpr (JAC) r.d = __shfl_up_sync(kFull, x.d, delta);
  else r.d = T(0);
  return r;
}
template <bool JAC, typename T>
__device__ __forceinline__ Dual<T> shfl(Dual<T> x, int src) {
  Dual<T> r;
  r.v = __shfl_sync(kFull, x.v, src);
  if constexpr (JAC) r.d = __shfl_sync(kFull, x.d, src);
  else r.d = T(0);
  return r;
}
template <bool JAC, typename T>
__device__ __forceinline__ Dual<T> warp_sum(Dual<T> x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    x.v += __shfl_xor_sync(kFull, x.v, m);
    if constexpr (JAC) x.d += __shfl_xor_sync(kFull, x.d, m);
  }
  return x;
}
template <bool JAC, typename T>
__device__ __forceinline__ Q4<T> shfl_up(const Q4<T>& q, int delta) {
  Q4<T> r;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.c[i] = shfl_up<JAC>(q.c[i], delta);
  return r;
}
template <bool JAC, typename T>
__device__ __forceinline__ Q4<T> shfl(const Q4<T>& q, int src) {
  Q4<T> r;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.c[i] = shfl<JAC>(q.c[i], src);
  return r;
}

// ------------------------------------------------------------------ factor
template <typename T>
struct Args {
  const T *q_wk, *t_wk, *v_w, *g_dir, *biases, *scales, *toff;
  const T *wt, *wg, *wa, *start, *end;
  const uint8_t* has_meas;
  const int64_t* frame_i;
  const T* wsqrt;
  T* r;
  T* J;
  int C, F, K, M, rotation_only;
};

// one factor's window
template <typename T>
struct Window {
  const T *t, *g, *a;
  int M;
  T start, end;
};

// the chain's parameters, each with its dual lane
template <typename T>
struct Params {
  V3<T> bg, ba, sg, sa;
  Dual<T> toff;
};

template <typename T>
__device__ __forceinline__ Params<T> params(const Args<T>& a, int c,
                                            int lane) {
  Params<T> p;
  const T* b = a.biases + 6 * c;
  const T* s = a.scales + 6 * c;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p.bg.c[i] = {b[i], T(lane == i)};
    p.ba.c[i] = {b[3 + i], T(lane == 3 + i)};
    p.sg.c[i] = {s[i], T(lane == 6 + i)};
    p.sa.c[i] = {s[3 + i], T(lane == 9 + i)};
  }
  p.toff = {a.toff[c], T(lane == 12)};
  return p;
}

// slot m's image-clock time (preintegrate.virtual_sequence)
template <typename T>
__device__ __forceinline__ Dual<T> seq_time(const Window<T>& f, int m,
                                            Dual<T> toff) {
  return clip(toff + f.t[m], f.start, f.end);
}

// slot m of the virtual sequence: time, gyro and accel re-interpolated at
// the clipped time; the index j is an integer and carries no derivative
template <typename T>
__device__ void slot(const Window<T>& f, int m, Dual<T> toff, Dual<T>& st,
                     V3<T>& zg, V3<T>& za) {
  st = seq_time(f, m, toff);
  const Dual<T> rq = st - toff;
  int lo = 0, hi = f.M;  // the count of stamps at or before rq
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (f.t[mid] <= rq.v) lo = mid + 1;
    else hi = mid;
  }
  const int j = min(max(lo - 1, 0), f.M - 2);
  const T t_lo = f.t[j];
  T denom = f.t[j + 1] - t_lo;
  if (vabs(denom) < T(1e-12)) denom = T(1);
  const Dual<T> alpha = clip((rq - t_lo) / denom, T(0), T(1));
  const Dual<T> om = 1.0 - alpha;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    zg.c[c] = om * f.g[3 * j + c] + alpha * f.g[3 * j + 3 + c];
    za.c[c] = om * f.a[3 * j + c] + alpha * f.a[3 * j + 3 + c];
  }
}

template <typename T>
struct Step {
  Q4<T> gamma;
  V3<T> b, e;
  Dual<T> dt;
};

// interval k's RK4 locals (preintegrate._rk4_step_locals); a zero-length
// interval is the identity step
template <typename T>
__device__ Step<T> step_locals(const Window<T>& f, int k, const Params<T>& p) {
  Dual<T> t0, t1;
  V3<T> zg0, za0, zg1, za1;
  slot(f, k, p.toff, t0, zg0, za0);
  slot(f, k + 1, p.toff, t1, zg1, za1);
  const Dual<T> dt = t1 - t0;
  Step<T> s;
  if (vabs(dt.v) < T(1e-12)) {
    s.gamma = identity<T>();
    s.b = zero3<T>();
    s.e = zero3<T>();
    s.dt = constant(T(0));
    return s;
  }
  V3<T> w1, wm, we, a1, am, ae;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    w1.c[c] = zg0.c[c] * p.sg.c[c] + p.bg.c[c];
    wm.c[c] = 0.5 * (zg0.c[c] + zg1.c[c]) * p.sg.c[c] + p.bg.c[c];
    we.c[c] = zg1.c[c] * p.sg.c[c] + p.bg.c[c];
    a1.c[c] = za0.c[c] * p.sa.c[c] + p.ba.c[c];
    am.c[c] = 0.5 * (za0.c[c] + za1.c[c]) * p.sa.c[c] + p.ba.c[c];
    ae.c[c] = za1.c[c] * p.sa.c[c] + p.ba.c[c];
  }
  const Dual<T> h = dt * 0.5;
  const Q4<T> e1 = so3_exp(scaled(w1, h));
  const V3<T> w2 = rotate(e1, wm);
  const Q4<T> e2 = so3_exp(scaled(w2, h));
  const V3<T> w3 = rotate(e2, wm);
  const Q4<T> e3 = so3_exp(scaled(w3, dt));
  const V3<T> w4 = rotate(e3, we);
  V3<T> w_tot;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    w_tot.c[c] = (w1.c[c] + 2.0 * w2.c[c] + 2.0 * w3.c[c] + w4.c[c]) / 6.0;
  s.gamma = so3_exp(scaled(w_tot, dt));
  const V3<T> a2 = rotate(e1, am);
  const V3<T> a3 = rotate(e2, am);
  const V3<T> a4 = rotate(e3, ae);
  const Dual<T> db = dt / 6.0;
  const Dual<T> de = dt * dt / 6.0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.b.c[c] = (a1.c[c] + 2.0 * a2.c[c] + 2.0 * a3.c[c] + a4.c[c]) * db;
    s.e.c[c] = (a1.c[c] + a2.c[c] + a3.c[c]) * de;
  }
  s.dt = dt;
  return s;
}

// The slots' part, run by one warp: out = [P_M (4), Sv (3), St (3), T, G]
// with the derivatives along the warp's dual lane (JAC), in every lane.
template <bool JAC, typename T>
__device__ void chain(const Window<T>& f, const Params<T>& p, int lane,
                      Dual<T> out[kChainVals]) {
  const int n = f.M - 1;
  // T: the sum of the intervals
  Dual<T> len = constant(T(0));
  for (int k = lane; k < n; k += 32) {
    const Dual<T> dt = seq_time(f, k + 1, p.toff) - seq_time(f, k, p.toff);
    if (!(vabs(dt.v) < T(1e-12))) len = len + dt;
  }
  const Dual<T> total = warp_sum<JAC>(len);
  Q4<T> carry = identity<T>();
  Dual<T> csum_carry = constant(T(0));
  V3<T> Sv = zero3<T>(), St = zero3<T>();
  Dual<T> G = constant(T(0));
  for (int base = 0; base < n; base += 32) {
    const int k = base + lane;
    Step<T> s;
    if (k < n) {
      s = step_locals(f, k, p);
    } else {
      s.gamma = identity<T>();
      s.b = zero3<T>();
      s.e = zero3<T>();
      s.dt = constant(T(0));
    }
    // inclusive prefix product of the chunk's rotations, then the carry
    Q4<T> P = s.gamma;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const Q4<T> left = shfl_up<JAC>(P, off);
      if (lane >= off) P = qmul(left, P);
    }
    P = qmul(carry, P);
    Q4<T> P_pre = shfl_up<JAC>(P, 1);
    if (lane == 0) P_pre = carry;
    carry = shfl<JAC>(P, 31);
    // time remaining after the interval: T less the inclusive cumsum
    Dual<T> csum = s.dt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const Dual<T> left = shfl_up<JAC>(csum, off);
      if (lane >= off) csum = left + csum;
    }
    csum = csum_carry + csum;
    csum_carry = shfl<JAC>(csum, 31);
    const Dual<T> tau = total - csum;
    const V3<T> Rb = rotate(P_pre, s.b);
    V3<T> eb;
#pragma unroll
    for (int c = 0; c < 3; ++c) eb.c[c] = s.e.c[c] + tau * s.b.c[c];
    const V3<T> Rt = rotate(P_pre, eb);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      Sv.c[c] = Sv.c[c] + Rb.c[c];
      St.c[c] = St.c[c] + Rt.c[c];
    }
    G = G + (0.5 * s.dt * s.dt + tau * s.dt);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = carry.c[i];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out[4 + c] = warp_sum<JAC>(Sv.c[c]);
    out[7 + c] = warp_sum<JAC>(St.c[c]);
  }
  out[10] = total;
  out[11] = warp_sum<JAC>(G);
}

// A frame's pose and velocity as duals along tangent column col - col0 of
// its block [du (3), dw (3), dv (3)]: a right-multiplicative increment
// moves q by q [dw/2, 0] and t by R(q) du at zero.
template <typename T>
__device__ void pose(const Args<T>& a, int c, int f, int col, Q4<T>& q,
                     V3<T>& t, V3<T>& v) {
  const size_t fr = (size_t)c * a.F + f;
#pragma unroll
  for (int i = 0; i < 4; ++i) q.c[i] = constant(a.q_wk[4 * fr + i]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    t.c[i] = constant(a.t_wk[3 * fr + i]);
    v.c[i] = constant(a.v_w[3 * fr + i]);
  }
  if (col < 0 || col >= 9) return;
  V3<T> unit = zero3<T>();
  unit.c[col % 3] = constant(T(1));
  if (col < 3) {
    const V3<T> rot = rotate(q, unit);
#pragma unroll
    for (int i = 0; i < 3; ++i) t.c[i].d = rot.c[i].v;
  } else if (col < 6) {
    const Q4<T> half = {{0.5 * unit.c[0], 0.5 * unit.c[1], 0.5 * unit.c[2],
                         constant(T(0))}};
    const Q4<T> dq = qmul(q, half);
#pragma unroll
    for (int i = 0; i < 4; ++i) q.c[i].d = dq.c[i].v;
  } else {
    v.c[col - 6].d = T(1);
  }
}

// The epilogue for tangent column col (-1: the value only): every
// direction through the chain's closed-form end, the log and the
// whitening.  ch holds the chain's values with col's derivatives.
template <typename T>
__device__ void epilogue(const Args<T>& a, int c, int k, const Dual<T> ch[],
                         int col, Dual<T> res[9]) {
  const int f1 = (int)a.frame_i[k];
  Q4<T> q1, q2;
  V3<T> t1, v1, t2, v2;
  pose(a, c, f1, col, q1, t1, v1);
  pose(a, c, f1 + 1, col - 9, q2, t2, v2);
  Dual<T> gd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    gd[i] = {a.g_dir[2 * c + i], T(col == 18 + i)};
  const Dual<T> sp = dsin(gd[0]), cp = dcos(gd[0]);
  const Dual<T> sq = dsin(gd[1]), cq = dcos(gd[1]);
  const V3<T> g_w = {{-kGravityMag * (cp * sq), -kGravityMag * -sp,
                      -kGravityMag * (cp * cq)}};
  const Q4<T> PM = {{ch[0], ch[1], ch[2], ch[3]}};
  const V3<T> Sv = {{ch[4], ch[5], ch[6]}};
  const V3<T> St = {{ch[7], ch[8], ch[9]}};
  const Dual<T> len = ch[10], G = ch[11];

  const Q4<T> q_end = qmul(q1, PM);
  const V3<T> RSv = rotate(q1, Sv);
  const V3<T> RSt = rotate(q1, St);
  V3<T> v_end, t_end;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    v_end.c[i] = v1.c[i] + RSv.c[i] - g_w.c[i] * len;
    t_end.c[i] = t1.c[i] + v1.c[i] * len + RSt.c[i] - g_w.c[i] * G;
  }
  const Dual<T> norm = dsqrt(q_end.c[0] * q_end.c[0] + q_end.c[1] * q_end.c[1]
                             + q_end.c[2] * q_end.c[2]
                             + q_end.c[3] * q_end.c[3]);
  Q4<T> qn;
#pragma unroll
  for (int i = 0; i < 4; ++i) qn.c[i] = q_end.c[i] / norm;
  const Q4<T> qi = {{-q2.c[0], -q2.c[1], -q2.c[2], q2.c[3]}};
  const V3<T> rti = rotate(qi, t2);
  const V3<T> ti = {{-rti.c[0], -rti.c[1], -rti.c[2]}};
  const Q4<T> qd = qmul(qn, qi);
  const V3<T> rqt = rotate(qn, ti);
  V3<T> td;
#pragma unroll
  for (int i = 0; i < 3; ++i) td.c[i] = rqt.c[i] + t_end.c[i];
  const V3<T> w = so3_log(qd);
  const V3<T> u = jl_inv_apply(w, td);
  Dual<T> r[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    r[i] = u.c[i];
    r[3 + i] = w.c[i];
    r[6 + i] = v_end.c[i] - v2.c[i];
  }
  if (a.wsqrt != nullptr) {
    const T* W = a.wsqrt + (size_t)k * 81;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      Dual<T> acc = r[0] * W[9 * i];
#pragma unroll
      for (int j = 1; j < 9; ++j) acc = acc + r[j] * W[9 * i + j];
      res[i] = acc;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 9; ++i) res[i] = r[i];
  }
  if (a.rotation_only) {
#pragma unroll
    for (int i = 0; i < 9; ++i)
      if (i < 3 || i >= 6) res[i] = res[i] * 0.0;
  }
}

template <typename T>
__device__ __forceinline__ Window<T> window(const Args<T>& a, int k) {
  const size_t o = (size_t)k * a.M;
  return {a.wt + o, a.wg + 3 * o, a.wa + 3 * o, a.M, a.start[k], a.end[k]};
}

// Residual and Jacobian: one block of 13 warps per (candidate, factor)
template <typename T>
__global__ void __launch_bounds__(kJacThreads, 1) imu_jac_kernel(Args<T> a) {
  __shared__ T chain_d[kLanes][kChainVals];
  __shared__ T chain_v[kChainVals];
  const int item = blockIdx.x;
  const int c = item / a.K, k = item % a.K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* r = a.r + (size_t)item * 9;
  T* J = a.J + (size_t)item * 9 * kCols;
  if (!a.has_meas[k]) {
    for (int i = threadIdx.x; i < 9 * kCols; i += blockDim.x) J[i] = T(0);
    if (threadIdx.x < 9) r[threadIdx.x] = T(0);
    return;
  }
  Dual<T> out[kChainVals];
  chain<true>(window(a, k), params(a, c, warp), lane, out);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kChainVals; ++i) chain_d[warp][i] = out[i].d;
    if (warp == 0) {
#pragma unroll
      for (int i = 0; i < kChainVals; ++i) chain_v[i] = out[i].v;
    }
  }
  __syncthreads();
  const int col = threadIdx.x;
  if (col >= kCols) return;
  Dual<T> ch[kChainVals];
#pragma unroll
  for (int i = 0; i < kChainVals; ++i)
    ch[i] = {chain_v[i], col >= kChain0 ? chain_d[col - kChain0][i] : T(0)};
  Dual<T> res[9];
  epilogue(a, c, k, ch, col, res);
#pragma unroll
  for (int i = 0; i < 9; ++i) J[i * kCols + col] = res[i].d;
  if (col == 0) {
#pragma unroll
    for (int i = 0; i < 9; ++i) r[i] = res[i].v;
  }
}

// Residual only: one warp per (candidate, factor)
template <typename T>
__global__ void __launch_bounds__(kValueWarps * 32)
    imu_value_kernel(Args<T> a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * kValueWarps + warp;
  if (item >= (long long)a.C * a.K) return;
  const int c = (int)(item / a.K), k = (int)(item % a.K);
  T* r = a.r + (size_t)item * 9;
  if (!a.has_meas[k]) {
    if (lane < 9) r[lane] = T(0);
    return;
  }
  Dual<T> out[kChainVals];
  chain<false>(window(a, k), params(a, c, -1), lane, out);
  if (lane == 0) {
    Dual<T> res[9];
    epilogue(a, c, k, out, -1, res);
#pragma unroll
    for (int i = 0; i < 9; ++i) r[i] = res[i].v;
  }
}

template <typename T>
int launch(const Args<T>& a, int jac, cudaStream_t stream) {
  const long long items = (long long)a.C * a.K;
  if (jac) {
    imu_jac_kernel<T><<<(unsigned)items, kJacThreads, 0, stream>>>(a);
  } else {
    const long long blocks = (items + kValueWarps - 1) / kValueWarps;
    imu_value_kernel<T><<<(unsigned)blocks, kValueWarps * 32, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int imu_factor(const T* q_wk, const T* t_wk, const T* v_w, const T* g_dir,
               const T* biases, const T* scales, const T* toff, const T* wt,
               const T* wg, const T* wa, const T* start, const T* end,
               const uint8_t* has_meas, const int64_t* frame_i,
               const T* wsqrt, T* r, T* J, int C, int F, int K, int M,
               int rotation_only, int jac, void* stream) {
  Args<T> a = {q_wk, t_wk, v_w, g_dir, biases, scales, toff, wt, wg, wa,
               start, end, has_meas, frame_i, wsqrt, r, J, C, F, K, M,
               rotation_only};
  return launch(a, jac, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Pointers: the state (q_wk (C,F,4), t_wk (C,F,3), v_w (C,F,3), g_dir
// (C,2), biases (C,6), scales (C,6), time_offset (C,)), the windows
// (times (K,M), gyro and accel (K,M,3)), start, end (K,), has_meas (K,)
// bytes, frame_i (K,) int64, weight_sqrt (K,9,9) or null; out r (C,K,9)
// and, with jac, J (C,K,9,33).  Returns the launch's CUDA error.
extern "C" int vt_imu_factor_f64(
    const double* q_wk, const double* t_wk, const double* v_w,
    const double* g_dir, const double* biases, const double* scales,
    const double* toff, const double* wt, const double* wg, const double* wa,
    const double* start, const double* end, const uint8_t* has_meas,
    const int64_t* frame_i, const double* wsqrt, double* r, double* J, int C,
    int F, int K, int M, int rotation_only, int jac, void* stream) {
  return imu_factor<double>(q_wk, t_wk, v_w, g_dir, biases, scales, toff, wt,
                            wg, wa, start, end, has_meas, frame_i, wsqrt, r,
                            J, C, F, K, M, rotation_only, jac, stream);
}

extern "C" int vt_imu_factor_f32(
    const float* q_wk, const float* t_wk, const float* v_w,
    const float* g_dir, const float* biases, const float* scales,
    const float* toff, const float* wt, const float* wg, const float* wa,
    const float* start, const float* end, const uint8_t* has_meas,
    const int64_t* frame_i, const float* wsqrt, float* r, float* J, int C,
    int F, int K, int M, int rotation_only, int jac, void* stream) {
  return imu_factor<float>(q_wk, t_wk, v_w, g_dir, biases, scales, toff, wt,
                           wg, wa, start, end, has_meas, frame_i, wsqrt, r, J,
                           C, F, K, M, rotation_only, jac, stream);
}

// Loads the four kernels' module now, so that no first launch inside a CUDA
// graph capture has to.
extern "C" int vt_imu_factor_load() {
  cudaFuncAttributes attr;
  cudaError_t err;
  if ((err = cudaFuncGetAttributes(&attr, imu_jac_kernel<double>)) ||
      (err = cudaFuncGetAttributes(&attr, imu_jac_kernel<float>)) ||
      (err = cudaFuncGetAttributes(&attr, imu_value_kernel<double>)) ||
      (err = cudaFuncGetAttributes(&attr, imu_value_kernel<float>)))
    return (int)err;
  return 0;
}
