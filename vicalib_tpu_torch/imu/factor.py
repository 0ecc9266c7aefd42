"""The IMU factor in one launch: the CUDA kernel's wrapper and its plain
PyTorch twin.

Evaluates what ``solver.residuals`` evaluates per IMU factor
(SwitchedFullImuCostFunction, ceres-cost-functions.h:379-490, through
``preintegrate.imu_factor_residual``): the 9-D switched residual of each
factor, whitened by ``weight_sqrt``, rotation rows only in the
rotation-only stage, zeros without measurements, and optionally its
Jacobian against the 33 tangent columns of
``residuals.imu_residuals_and_jacobians``: dx1 (9), dx2 (9), gravity (2),
biases (6), scales (6), time offset (1).  It replaces no TPU kernel: the
JAX package leaves the factor to XLA (reverse mode inside vmap through
the RK4 chain), which written the same way in PyTorch is ~4,400 small
float64 ops an LM step.

The derivatives are forward-mode duals, as Ceres's jets in the reference.
Of the 33 directions only 13 flow along the slots, through the virtual
measurement sequence and the RK4 chain: the gyro and accel biases, the
scales and the time offset (``CHAIN_LANES``).  The chain reduces them to
its closed-form end (preintegrate.integrate_sequence)

    q_end = q1 P_M,   v_end = v1 + R(q1) Sv - g_w T,
    t_end = t1 + v1 T + R(q1) St - g_w G,

with P_M the product of the steps' rotations, Sv = sum_k R(P_k) b_k,
St = sum_k R(P_k) (e_k + tau_k b_k), T the window's length and G its
gravity double integral.  Pose 1 and gravity enter only there and pose 2
only in the final log, so the epilogue carries all 33 directions through
those few lines by the chain rule.

The kernel (``csrc/imu_factor.cu``, built with nvcc for sm_90a on first
use): one block of 13 warps per factor for the Jacobian, warp w carrying
the value and dual lane w, its 32 threads 32 intervals at a time (each
interval's RK4 locals are independent; the rotations' prefix product is a
warp scan of dual quaternions, carried from one 32-interval chunk to the
next), then 33 threads of the block one tangent column each through the
epilogue; value only, one warp per (candidate, factor).  A leading
candidate dimension C of the state evaluates the LM step's damping
candidates in one launch.

``imu_factor`` dispatches on the tensors' device alone: a CPU tensor takes
``imu_factor_plain``, a CUDA tensor launches the kernel, any other raises.
The twin is the same jets in plain PyTorch, vectorised over candidates,
factors and intervals, with the prefix product as a doubling scan.
``tests/test_torch_imu_kernel.py`` holds the twin to reverse mode through
``preintegrate.imu_factor_residual`` and to the JAX package on the CPU;
``chip_smoke.py`` holds the kernel to the twin on the card.  Counters:
``vicalib.imu.factors`` (every candidate factor evaluated, on either
device), ``vicalib.imu.kernel_factors`` (those the kernel evaluated) and
``vicalib.imu.kernel_launches``, counted when the Python runs, eagerly or
at a CUDA graph's capture.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .. import obs
from ..device import nvcc_library
from ..geometry import so3
from .preintegrate import GRAVITY_MAG

# the dual lanes through the slots: gyro bias, accel bias, gyro scale,
# accel scale (3 each), time offset
CHAIN_LANES = 13
# tangent columns: dx1 (9), dx2 (9), gravity (2), then the chain lanes
N_COLS = 33
_CHAIN0 = 20
_EPS2 = so3._EPS2

_lib = None
_lock = threading.Lock()
_FN = {torch.float64: "vt_imu_factor_f64", torch.float32: "vt_imu_factor_f32"}


def build(verbose=False):
    """Compile csrc/imu_factor.cu for sm_90a into build/ (once per source
    version), load it and load its kernels.  Returns the ctypes library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(nvcc_library("imu_factor.cu", verbose=verbose))
        for name in _FN.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        # load every kernel now: a first launch inside a CUDA graph capture
        # must not be the one that loads its module
        lib.vt_imu_factor_load.argtypes = []
        lib.vt_imu_factor_load.restype = ctypes.c_int
        err = lib.vt_imu_factor_load()
        if err != 0:
            raise RuntimeError("imu_factor kernels failed to load: CUDA "
                               "error %d" % err)
        _lib = lib
        return lib


def _check(state, win_times, win_gyro, win_accel, start, end, has_meas,
           frame_i, weight_sqrt):
    """Raise unless the arguments have the kernel's dtypes, shapes,
    devices and contiguity."""
    q_wk, t_wk, v_w, g_dir, biases, scales, time_offset = state
    dtype = q_wk.dtype
    if dtype not in _FN:
        raise TypeError("the IMU factor kernel takes float32 or float64, "
                        "got %s" % dtype)
    if q_wk.dim() != 3:
        raise ValueError("state tensors need a leading candidate dimension: "
                         "q_wk (C, F, 4), got %s" % (tuple(q_wk.shape),))
    C, F = q_wk.shape[:2]
    K, M = win_times.shape if win_times.dim() == 2 else (-1, -1)
    shapes = [(q_wk, (C, F, 4)), (t_wk, (C, F, 3)), (v_w, (C, F, 3)),
              (g_dir, (C, 2)), (biases, (C, 6)), (scales, (C, 6)),
              (time_offset, (C,)), (win_times, (K, M)),
              (win_gyro, (K, M, 3)), (win_accel, (K, M, 3)), (start, (K,)),
              (end, (K,)), (has_meas, (K,)), (frame_i, (K,))]
    if weight_sqrt is not None:
        shapes.append((weight_sqrt, (K, 9, 9)))
    if K < 1 or M < 2 or F < 2 or C < 1:
        raise ValueError("need C >= 1 candidates, F >= 2 frames, K >= 1 "
                         "factors of M >= 2 slots; got C=%d F=%d K=%d M=%d"
                         % (C, F, K, M))
    for x, shape in shapes:
        if tuple(x.shape) != shape:
            raise ValueError("expected shape %s, got %s" % (
                shape, tuple(x.shape)))
        if x.device != q_wk.device:
            raise ValueError("all arguments must be on %s, got %s"
                             % (q_wk.device, x.device))
        if not x.is_contiguous():
            raise ValueError("arguments must be contiguous")
    for x, want in ((has_meas, torch.bool), (frame_i, torch.int64)):
        if x.dtype != want:
            raise TypeError("expected %s, got %s" % (want, x.dtype))
    for x, _ in shapes:
        if x.is_floating_point() and x.dtype != dtype:
            raise TypeError("every float argument must be %s, got %s"
                            % (dtype, x.dtype))
    if C * K > 2 ** 31 - 1 or M > 2 ** 20:
        raise ValueError("at most 2^31-1 candidate factors of 2^20 slots")


def imu_factor(state, win_times, win_gyro, win_accel, start, end, has_meas,
               frame_i, weight_sqrt, rotation_only: bool, jac: bool):
    """The IMU factors of C candidate states, in one launch on the card.

    ``state``: (q_wk (C,F,4), t_wk (C,F,3), v_w (C,F,3), g_dir (C,2),
    biases (C,6), scales (C,6), time_offset (C,)), C candidate states;
    the windows (K, M[, 3]), start, end (K,), has_meas (K,) bool, frame_i
    (K,) int64 (factor k couples frames frame_i[k] and frame_i[k] + 1) and
    weight_sqrt (K, 9, 9) or None are shared by the candidates.  Returns
    (r (C, K, 9), J (C, K, 9, 33) or None).  CPU tensors take
    :func:`imu_factor_plain`, CUDA tensors the kernel; raises for any
    other device or for arguments the kernel does not take."""
    _check(state, win_times, win_gyro, win_accel, start, end, has_meas,
           frame_i, weight_sqrt)
    q_wk = state[0]
    if q_wk.device.type not in ("cpu", "cuda"):
        raise ValueError("no IMU factor kernel for device %s" % q_wk.device)
    C, K = q_wk.shape[0], start.shape[0]
    obs.count("vicalib.imu.factors", C * K)
    if q_wk.device.type == "cpu":
        return imu_factor_plain(state, win_times, win_gyro, win_accel, start,
                                end, has_meas, frame_i, weight_sqrt,
                                rotation_only, jac)
    obs.count("vicalib.imu.kernel_factors", C * K)
    lib = build()
    r = q_wk.new_empty((C, K, 9))
    J = q_wk.new_empty((C, K, 9, N_COLS)) if jac else None
    ptrs = [x.data_ptr() for x in (*state, win_times, win_gyro, win_accel,
                                   start, end, has_meas, frame_i)]
    ptrs += [0 if weight_sqrt is None else weight_sqrt.data_ptr(),
             r.data_ptr(), 0 if J is None else J.data_ptr()]
    with torch.cuda.device(q_wk.device):
        stream = torch.cuda.current_stream(q_wk.device).cuda_stream
        err = getattr(lib, _FN[q_wk.dtype])(
            *ptrs, C, q_wk.shape[1], K, win_times.shape[1],
            int(bool(rotation_only)), int(bool(jac)), stream)
    if err != 0:
        raise RuntimeError("imu_factor kernel failed: CUDA error %d" % err)
    obs.count("vicalib.imu.kernel_launches")
    return r, J


# ----------------------------------------------------------------- plain
class _Jet:
    """A value ``v`` (...) and its derivatives ``d`` (..., L) along L
    directions: the kernel's dual numbers, L at a time."""

    __slots__ = ("v", "d")

    def __init__(self, v, d):
        if v.shape != d.shape[:-1]:
            shape = torch.broadcast_shapes(v.shape, d.shape[:-1])
            v = v.expand(shape)
            d = d.expand(shape + d.shape[-1:])
        self.v = v
        self.d = d

    def at(self, index):
        """The jet at ``index`` of the value's last axis."""
        return _Jet(self.v[..., index], self.d[..., index, :])

    def __add__(self, o):
        if isinstance(o, _Jet):
            return _Jet(self.v + o.v, self.d + o.d)
        return _Jet(self.v + o, self.d)

    __radd__ = __add__

    def __neg__(self):
        return _Jet(-self.v, -self.d)

    def __sub__(self, o):
        if isinstance(o, _Jet):
            return _Jet(self.v - o.v, self.d - o.d)
        return _Jet(self.v - o, self.d)

    def __rsub__(self, o):
        return _Jet(o - self.v, -self.d)

    def __mul__(self, o):
        if isinstance(o, _Jet):
            return _Jet(self.v * o.v, self.d * o.v[..., None]
                        + self.v[..., None] * o.d)
        return _Jet(self.v * o, self.d * _lift(o))

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, _Jet):
            q = self.v / o.v
            return _Jet(q, (self.d - q[..., None] * o.d) / o.v[..., None])
        return _Jet(self.v / o, self.d / _lift(o))

    def __rtruediv__(self, o):
        q = o / self.v
        return _Jet(q, -q[..., None] * self.d / self.v[..., None])


def _lift(o):
    return o[..., None] if isinstance(o, torch.Tensor) else o


def _const(x, n_dirs):
    return _Jet(x, x.new_zeros((1,) * x.dim() + (n_dirs,)))


def _sqrt(a):
    s = torch.sqrt(a.v)
    return _Jet(s, a.d * (0.5 / s)[..., None])


def _sin(a):
    return _Jet(torch.sin(a.v), a.d * torch.cos(a.v)[..., None])


def _cos(a):
    return _Jet(torch.cos(a.v), -a.d * torch.sin(a.v)[..., None])


def _atan2(y, x):
    n = x.v * x.v + y.v * y.v
    return _Jet(torch.atan2(y.v, x.v),
                (x.v[..., None] * y.d - y.v[..., None] * x.d) / n[..., None])


def _where(cond, a, b):
    """torch.where on jets (a, b jets or numbers)."""
    like = a if isinstance(a, _Jet) else b
    av, ad = (a.v, a.d) if isinstance(a, _Jet) else (
        a, torch.zeros_like(like.d))
    bv, bd = (b.v, b.d) if isinstance(b, _Jet) else (
        b, torch.zeros_like(like.d))
    return _Jet(torch.where(cond, av, bv),
                torch.where(cond[..., None], ad, bd))


def _clamp_min(a, lo):
    """torch.clamp(a, min=lo): the derivative passes where a >= lo."""
    keep = a.v >= lo
    return _Jet(torch.clamp(a.v, min=lo),
                torch.where(keep[..., None], a.d, torch.zeros_like(a.d)))


def _extremum(a, b, larger):
    """torch.maximum / torch.minimum of a jet and a jet or tensor: a tie
    splits the derivative evenly between the two."""
    bv, bd = (b.v, b.d) if isinstance(b, _Jet) else (
        b if isinstance(b, torch.Tensor) else torch.full_like(a.v, b),
        torch.zeros_like(a.d))
    a_wins = a.v > bv if larger else a.v < bv
    b_wins = a.v < bv if larger else a.v > bv
    d = torch.where(a_wins[..., None], a.d,
                    torch.where(b_wins[..., None], bd, 0.5 * (a.d + bd)))
    v = torch.maximum(a.v, bv) if larger else torch.minimum(a.v, bv)
    return _Jet(v, d)


def _clip(x, lo, hi):
    """preintegrate._clip on jets: maximum, then minimum."""
    return _extremum(_extremum(x, lo, True), hi, False)


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _qmul(a, b):
    x1, y1, z1, w1 = a
    x2, y2, z2, w2 = b
    return [w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2]


def _rotate(q, v):
    uv = _cross(q[:3], v)
    uuv = _cross(q[:3], uv)
    return [v[i] + 2.0 * (q[3] * uv[i] + uuv[i]) for i in range(3)]


def _norm2(v):
    out = v[0] * v[0]
    for x in v[1:]:
        out = out + x * x
    return out


def _exp(w):
    """so3.exp on jets, with its small-angle branch."""
    th2 = _norm2(w)
    small = th2.v < _EPS2
    th = _sqrt(_clamp_min(th2, _EPS2))
    half = 0.5 * th
    k = _where(small, 0.5 - th2 / 48.0, _sin(half) / th)
    wq = _where(small, 1.0 - th2 / 8.0, _cos(half))
    return [k * w[0], k * w[1], k * w[2], wq]


def _log(q):
    """so3.log on jets, with its small-angle branch."""
    neg = q[3].v < 0
    q = [_where(neg, -x, x) for x in q]
    u, w = q[:3], q[3]
    n2 = _norm2(u)
    n = _sqrt(_clamp_min(n2, _EPS2))
    small = n2.v < _EPS2
    w_safe = _where(torch.abs(w.v) < 1e-30, 1.0, w)
    k = _where(small,
               2.0 / w_safe * (1.0 - n2 / (3.0 * _clamp_min(w * w, 1e-30))),
               2.0 * _atan2(n, w) / n)
    return [k * x for x in u]


def _jl_inv_apply(w, t):
    """so3.jl_inv(w) @ t on jets: t - w x t / 2 + c w x (w x t)."""
    th2 = _norm2(w)
    safe2 = _clamp_min(th2, _EPS2)
    th = _sqrt(safe2)
    half = 0.5 * th
    small = th2.v < _EPS2
    sh = _sin(half)
    sh_safe = _where(torch.abs(sh.v) < 1e-30, 1.0, sh)
    c = _where(small, 1.0 / 12.0 + th2 / 720.0,
               (1.0 - half * _cos(half) / sh_safe) / safe2)
    wt = _cross(w, t)
    wwt = _cross(w, wt)
    return [t[i] - 0.5 * wt[i] + c * wwt[i] for i in range(3)]


def _cat(a, b):
    return _Jet(torch.cat([a.v, b.v], dim=-1), torch.cat([a.d, b.d], dim=-2))


def _chain(win_times, win_gyro, win_accel, start, end, biases, scales,
           time_offset, n_dirs):
    """The slots' part: (P_M (4), Sv (3), St (3), T, G) as jets (C, K)
    along the 13 chain lanes (``n_dirs`` 0: values only)."""
    C = biases.shape[0]
    K, M = win_times.shape
    eye = torch.eye(CHAIN_LANES, dtype=biases.dtype,
                    device=biases.device)[:, :n_dirs]

    def param(x, lane):
        return _Jet(x.reshape(C, 1, 1), eye[lane])

    bg = [param(biases[:, i], i) for i in range(3)]
    ba = [param(biases[:, 3 + i], 3 + i) for i in range(3)]
    sg = [param(scales[:, i], 6 + i) for i in range(3)]
    sa = [param(scales[:, 3 + i], 9 + i) for i in range(3)]
    toff = param(time_offset, 12)

    # the virtual sequence (preintegrate.virtual_sequence), per slot
    seq_t = _clip(toff + win_times, start[:, None], end[:, None])
    rq = seq_t - toff
    wt = win_times.expand(C, K, M).contiguous()
    j = torch.clamp(torch.searchsorted(wt, rq.v.contiguous(), right=True)
                    - 1, 0, M - 2)
    t_lo = torch.gather(wt, 2, j)
    t_hi = torch.gather(wt, 2, j + 1)
    denom = t_hi - t_lo
    denom = torch.where(torch.abs(denom) < 1e-12, torch.ones_like(denom),
                        denom)
    alpha = _clip((rq - t_lo) / denom, 0.0, 1.0)
    one_minus = 1.0 - alpha

    def interp(samples, c):
        s = samples[..., c].expand(C, K, M)
        return (torch.gather(s, 2, j) * one_minus
                + torch.gather(s, 2, j + 1) * alpha)

    zg = [interp(win_gyro, c) for c in range(3)]
    za = [interp(win_accel, c) for c in range(3)]

    # the RK4 step locals (preintegrate._rk4_step_locals), per interval
    lo, hi = slice(None, -1), slice(1, None)
    dt = seq_t.at(hi) - seq_t.at(lo)
    zero = torch.abs(dt.v) < 1e-12
    sdt = _where(zero, 1.0, dt)
    zg0, zg1 = [z.at(lo) for z in zg], [z.at(hi) for z in zg]
    za0, za1 = [z.at(lo) for z in za], [z.at(hi) for z in za]
    w1 = [zg0[c] * sg[c] + bg[c] for c in range(3)]
    wm = [0.5 * (zg0[c] + zg1[c]) * sg[c] + bg[c] for c in range(3)]
    we = [zg1[c] * sg[c] + bg[c] for c in range(3)]
    a1 = [za0[c] * sa[c] + ba[c] for c in range(3)]
    am = [0.5 * (za0[c] + za1[c]) * sa[c] + ba[c] for c in range(3)]
    ae = [za1[c] * sa[c] + ba[c] for c in range(3)]
    h = sdt * 0.5
    e1 = _exp([x * h for x in w1])
    w2 = _rotate(e1, wm)
    e2 = _exp([x * h for x in w2])
    w3 = _rotate(e2, wm)
    e3 = _exp([x * sdt for x in w3])
    w4 = _rotate(e3, we)
    w_tot = [(w1[c] + 2.0 * w2[c] + 2.0 * w3[c] + w4[c]) / 6.0
             for c in range(3)]
    gamma = _exp([x * sdt for x in w_tot])
    a2 = _rotate(e1, am)
    a3 = _rotate(e2, am)
    a4 = _rotate(e3, ae)
    b = [(a1[c] + 2.0 * a2[c] + 2.0 * a3[c] + a4[c]) * (sdt / 6.0)
         for c in range(3)]
    e = [(a1[c] + a2[c] + a3[c]) * (sdt * sdt / 6.0) for c in range(3)]
    gamma = [_where(zero, float(c == 3), g) for c, g in enumerate(gamma)]
    b = [_where(zero, 0.0, x) for x in b]
    e = [_where(zero, 0.0, x) for x in e]
    dt = _where(zero, 0.0, dt)

    # the rotations' inclusive prefix product, by doubling
    P, d, n = gamma, 1, M - 1
    while d < n:
        prod = _qmul([p.at(slice(None, -d)) for p in P],
                     [p.at(slice(d, None)) for p in P])
        P = [_cat(p.at(slice(None, d)), x) for p, x in zip(P, prod)]
        d *= 2
    ident = [_const(torch.full_like(dt.v[..., :1], float(c == 3)), n_dirs)
             for c in range(4)]
    P_pre = [_cat(i, p.at(slice(None, -1))) for i, p in zip(ident, P)]

    T = _Jet(dt.v.sum(-1), dt.d.sum(-2))
    csum = _Jet(dt.v.cumsum(-1), dt.d.cumsum(-2))
    tau = _Jet(T.v[..., None], T.d[..., None, :]) - csum
    Rb = _rotate(P_pre, b)
    Rt = _rotate(P_pre, [e[c] + tau * b[c] for c in range(3)])
    G = 0.5 * dt * dt + tau * dt

    def total(x):
        return _Jet(x.v.sum(-1), x.d.sum(-2))

    return ([p.at(-1) for p in P], [total(x) for x in Rb],
            [total(x) for x in Rt], T, total(G))


def _pose_seeds(q, t, v, col0, n_dirs):
    """A frame's pose and velocity as jets along the 33 columns: a
    right-multiplicative increment [du, dw] moves q by q [dw/2, 0] and t
    by R(q) du at zero; dv moves v."""
    C, K = q.shape[:2]
    shape = (C, K, n_dirs)
    dq = [q.new_zeros(shape) for _ in range(4)]
    dt = [q.new_zeros(shape) for _ in range(3)]
    dv = [q.new_zeros(shape) for _ in range(3)]
    if n_dirs:
        E = torch.eye(3, dtype=q.dtype, device=q.device)
        for a in range(3):
            rot = so3.rotate(q, E[a].expand(q.shape[:-1] + (3,)))
            half = so3.quat_mul(q, torch.cat([0.5 * E[a], E[a, :1] * 0])
                                .expand(q.shape))
            for i in range(3):
                dt[i][..., col0 + a] = rot[..., i]
            for i in range(4):
                dq[i][..., col0 + 3 + a] = half[..., i]
            dv[a][..., col0 + 6 + a].fill_(1.0)
    return ([_Jet(x, d) for x, d in zip(q.unbind(-1), dq)],
            [_Jet(x, d) for x, d in zip(t.unbind(-1), dt)],
            [_Jet(x, d) for x, d in zip(v.unbind(-1), dv)])


def imu_factor_plain(state, win_times, win_gyro, win_accel, start, end,
                     has_meas, frame_i, weight_sqrt, rotation_only: bool,
                     jac: bool):
    """The kernel's arithmetic in plain PyTorch, on any device: the same
    arguments and results as :func:`imu_factor`, which calls it for CPU
    tensors."""
    q_wk, t_wk, v_w, g_dir, biases, scales, time_offset = state
    C = q_wk.shape[0]
    K = start.shape[0]
    n_chain = CHAIN_LANES if jac else 0
    n_cols = N_COLS if jac else 0
    PM, Sv, St, T, G = _chain(win_times, win_gyro, win_accel, start, end,
                              biases, scales, time_offset, n_chain)

    # the epilogue: every direction through the chain's closed-form end
    def widen(x):
        d = x.d.new_zeros(x.d.shape[:-1] + (n_cols,))
        d[..., _CHAIN0:] = x.d
        return _Jet(x.v, d)

    PM, Sv, St = ([widen(x) for x in xs] for xs in (PM, Sv, St))
    T, G = widen(T), widen(G)
    fi = frame_i
    q1, t1, v1 = _pose_seeds(q_wk[:, fi], t_wk[:, fi], v_w[:, fi], 0, n_cols)
    q2, t2, v2 = _pose_seeds(q_wk[:, fi + 1], t_wk[:, fi + 1],
                             v_w[:, fi + 1], 9, n_cols)
    eye = torch.eye(N_COLS, dtype=q_wk.dtype, device=q_wk.device)[:, :n_cols]
    gd = [_Jet(g_dir[:, i, None], eye[18 + i]) for i in range(2)]
    sp, cp = _sin(gd[0]), _cos(gd[0])
    sq, cq = _sin(gd[1]), _cos(gd[1])
    g_w = [-GRAVITY_MAG * (cp * sq), -GRAVITY_MAG * -sp,
           -GRAVITY_MAG * (cp * cq)]

    q_end = _qmul(q1, PM)
    RSv = _rotate(q1, Sv)
    RSt = _rotate(q1, St)
    v_end = [v1[c] + RSv[c] - g_w[c] * T for c in range(3)]
    t_end = [t1[c] + v1[c] * T + RSt[c] - g_w[c] * G for c in range(3)]
    norm = _sqrt(_norm2(q_end))
    qn = [x / norm for x in q_end]
    qi = [-q2[0], -q2[1], -q2[2], q2[3]]
    ti = [-x for x in _rotate(qi, t2)]
    qd = _qmul(qn, qi)
    td = [a + b for a, b in zip(_rotate(qn, ti), t_end)]
    w = _log(qd)
    u = _jl_inv_apply(w, td)
    r = u + w + [v_end[c] - v2[c] for c in range(3)]
    if weight_sqrt is not None:
        W = weight_sqrt
        rw = []
        for i in range(9):
            acc = r[0] * W[:, i, 0]
            for jj in range(1, 9):
                acc = acc + r[jj] * W[:, i, jj]
            rw.append(acc)
        r = rw
    keep = has_meas.expand(C, K)
    rows = []
    for i, x in enumerate(r):
        if rotation_only and not 3 <= i < 6:
            x = x * 0.0
        rows.append(_where(keep, x, 0.0))
    res = torch.stack([x.v for x in rows], dim=-1)
    J = torch.stack([x.d for x in rows], dim=-2) if jac else None
    return res.contiguous(), J
