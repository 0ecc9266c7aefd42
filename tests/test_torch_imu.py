"""Port parity: IMU windows, sources and preintegration (torch vs JAX).

Inputs come from the JAX simulator (a 12-frame mono VI sequence at 100 Hz
with biases and a 4 ms time offset), windowed with 0.35 s of slack, and go
to both packages as the same float64 numpy arrays.  Tolerances:
- host code (window slicing, CSV parsing) is a copy: exactly equal;
- the interpolated sequences, the RK4 locals and end states agree to
  float64 rounding (1e-12 absolute on O(1..10) values): the same arithmetic
  in another operation order (the quaternion prefix product is a doubling
  scan here and a Blelloch tree in JAX; products are associative only in
  exact arithmetic);
- residuals and their Jacobians to 1e-9 relative to their largest entry
  (the Jacobians come from two autodiff systems, reverse mode in both).
The JAX side runs under ``jax.jit``, as the JAX package itself runs it:
op by op (eager), JAX 0.9's reverse mode of the weighted residual has
returned uninitialized values on XLA:CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacrev

from vicalib_tpu.imu import buffer as jbuf
from vicalib_tpu.imu import preintegrate as jpre
from vicalib_tpu.io import sim as jsim
from vicalib_tpu.io import sources as jsources
from vicalib_tpu_torch.imu import buffer as tbuf
from vicalib_tpu_torch.imu import preintegrate as tpre
from vicalib_tpu_torch.io import sources as tsources
from vicalib_tpu_torch.solver.stages import interp


def T(x):
    return torch.as_tensor(np.array(x, dtype=np.float64))


def _rel_close(actual, desired, rtol):
    desired = np.asarray(desired)
    scale = max(float(np.max(np.abs(desired))), 1e-300)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=0,
                               atol=rtol * scale)


@pytest.fixture(scope="module")
def seq():
    cfg = jsim.default_mono_config(
        n_frames=12, model="linear", imu=True, imu_rate=100.0,
        gyro_bias=np.array([0.01, -0.02, 0.015]),
        accel_bias=np.array([0.05, 0.02, -0.04]), time_offset=0.004)
    d = jsim.simulate(cfg)
    win = jbuf.build_windows(d.imu_times, d.frame_times, offset_guess=0.0,
                             slack=0.35)
    wt, wg, wa = jbuf.gather_windows(d.imu_times, d.gyro, d.accel,
                                     win["idx0"], win["n_slots"])
    rng = np.random.default_rng(0)
    q = rng.normal(size=(12, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return dict(d=d, win=win, wt=wt, wg=wg, wa=wa,
                q=q, t=rng.normal(size=(12, 3)), v=rng.normal(size=(12, 3)),
                g_dir=np.array([0.15, -0.1]), bg=np.array([0.01, -0.02, 0.015]),
                ba=np.array([0.05, 0.02, -0.04]),
                sf=1.0 + rng.normal(size=6) * 0.01, off=0.004)


def test_windows_are_a_copy(seq):
    d = seq["d"]
    for slack, guess, max_slots in ((0.35, 0.0, None), (0.1, 0.004, None),
                                    (0.05, -0.3, 200)):
        wj = jbuf.build_windows(d.imu_times, d.frame_times, guess, slack,
                                max_slots)
        wt = tbuf.build_windows(d.imu_times, d.frame_times, guess, slack,
                                max_slots)
        assert wt.keys() == wj.keys()
        for k in wj:
            np.testing.assert_array_equal(wt[k], wj[k])
        for a, b in zip(tbuf.gather_windows(d.imu_times, d.gyro, d.accel,
                                            wt["idx0"], wt["n_slots"]),
                        jbuf.gather_windows(d.imu_times, d.gyro, d.accel,
                                            wj["idx0"], wj["n_slots"])):
            np.testing.assert_array_equal(a, b)
    # the window-width cap raises in both
    for mod in (jbuf, tbuf):
        with pytest.raises(ValueError, match="max_slots"):
            mod.build_windows(d.imu_times, d.frame_times, 0.0, 0.35, 3)
    b = tbuf.ImuBuffer()
    b.add_batch(d.gyro[:5], d.accel[:5], d.imu_times[:5])
    assert len(b) == 5 and b.has_range(d.imu_times[1], d.imu_times[3])
    with pytest.raises(ValueError, match="monotone"):
        b.add(d.gyro[0], d.accel[0], d.imu_times[0])


@pytest.mark.parametrize("layout", ["one_column", "two_column", "leading"])
def test_imu_source_matches_jax(tmp_path, layout):
    rng = np.random.default_rng(1)
    t = 1000.0 + np.arange(20) / 100.0
    acc, gyr = rng.normal(size=(20, 3)), rng.normal(size=(20, 3))
    if layout == "leading":
        np.savetxt(tmp_path / "accel.txt", np.c_[t, acc])
        np.savetxt(tmp_path / "gyro.txt", np.c_[t, gyr])
    else:
        np.savetxt(tmp_path / "accel.txt", acc)
        np.savetxt(tmp_path / "gyro.txt", gyr[:18])       # shorter: cut
        np.savetxt(tmp_path / "timestamp.txt",
                   t if layout == "one_column" else np.c_[t, t - 1000.0])
    for system in (False, True):
        sj = jsources.parse_imu_uri(f"csv://{tmp_path}", system)
        st = tsources.parse_imu_uri(f"csv://{tmp_path}", system)
        for k in ("times", "accel", "gyro", "device_times", "system_times"):
            np.testing.assert_array_equal(getattr(st, k), getattr(sj, k))


def test_interp_matches_numpy():
    """Ends (below, at, above), repeated stamps and interior points."""
    xp = np.array([0.0, 0.1, 0.1, 0.25, 0.4, 0.4, 0.4, 0.7])
    fp = np.array([1.0, -2.0, 3.0, 0.5, 4.0, -1.0, 2.0, 6.0])
    x = np.array([-1.0, 0.0, 0.05, 0.1, 0.2, 0.25, 0.3, 0.4, 0.55, 0.7,
                  0.9, np.nextafter(0.1, 1.0), np.nextafter(0.4, 0.0)])
    got = interp(T(x), T(xp), T(fp)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.interp(x, xp, fp)))
    np.testing.assert_allclose(got, np.interp(x, xp, fp), rtol=0,
                               atol=1e-15)
    # batched: each row its own stamps
    rng = np.random.default_rng(2)
    xps = np.sort(rng.uniform(0, 1, size=(3, 9)), axis=1)
    fps = rng.normal(size=(3, 9))
    xs = rng.uniform(-0.2, 1.2, size=(3, 5))
    got = interp(T(xs), T(xps), T(fps)).numpy()
    for i in range(3):
        np.testing.assert_allclose(got[i], np.interp(xs[i], xps[i], fps[i]),
                                   rtol=0, atol=1e-15)


def _factor(seq, k):
    return (seq["wt"][k], seq["wg"][k], seq["wa"][k],
            seq["win"]["start"][k], seq["win"]["end"][k])


def test_virtual_sequence_matches_jax(seq):
    for k in range(len(seq["win"]["start"])):
        wt, wg, wa, s, e = _factor(seq, k)
        out_j = jax.jit(jpre.virtual_sequence)(wt, wg, wa, s, e,
                                               seq["off"])
        out_t = tpre.virtual_sequence(T(wt), T(wg), T(wa), T(s), T(e),
                                      T(seq["off"]))
        for a, b in zip(out_j, out_t):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-12)


def test_integrate_sequence_matches_jax_and_oracle(seq):
    g_w = np.asarray(jpre.gravity_vector(jnp.asarray(seq["g_dir"])))
    np.testing.assert_allclose(
        tpre.gravity_vector(T(seq["g_dir"])).numpy(), g_w, rtol=0,
        atol=1e-15)
    for k in (0, 5, 10):
        wt, wg, wa, s, e = _factor(seq, k)
        st, sg, sa = tpre.virtual_sequence(T(wt), T(wg), T(wa), T(s), T(e),
                                           T(seq["off"]))
        y0 = np.concatenate([seq["t"][k], seq["q"][k], seq["v"][k]])
        bias = (seq["bg"], seq["ba"], seq["sf"], g_w)
        y_t = tpre.integrate_sequence(T(y0), st, sg, sa, *map(T, bias))
        y_seq = tpre.integrate_sequence_seq(T(y0), st, sg, sa,
                                            *map(T, bias))
        y_j = jax.jit(jpre.integrate_sequence)(
            jnp.asarray(y0), st.numpy(), sg.numpy(), sa.numpy(), *bias)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(y_t.numpy(), y_seq.numpy(), rtol=0,
                                   atol=1e-12)
        # the RK4 locals, batched here and vmapped in JAX
        args = (st[:-1], st[1:], sg[:-1], sg[1:], sa[:-1], sa[1:])
        loc_t = tpre._rk4_step_locals(*args, *map(T, bias[:3]))
        loc_j = jax.jit(jax.vmap(jpre._rk4_step_locals,
                                 in_axes=(0,) * 6 + (None,) * 3))(
            *[a.numpy() for a in args], *bias[:3])
        for a, b in zip(loc_j, loc_t):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-12)


def test_quat_prefix_product_is_the_sequential_chain():
    rng = np.random.default_rng(3)
    for n in (1, 2, 5, 8, 81):
        g = tpre.so3.exp(T(rng.normal(size=(n, 3)) * 0.3))
        P = tpre.quat_prefix_product(g)
        acc = g[0]
        np.testing.assert_allclose(P[0].numpy(), acc.numpy(), atol=0)
        for i in range(1, n):
            acc = tpre.so3.quat_mul(acc, g[i])
            np.testing.assert_allclose(P[i].numpy(), acc.numpy(), rtol=0,
                                       atol=1e-14)


def _res_args(seq, k, backend):
    wt, wg, wa, s, e = _factor(seq, k)
    conv = jnp.asarray if backend == "jax" else T
    pose = lambda i: ((conv(seq["q"][i]), conv(seq["t"][i])),
                      conv(seq["v"][i]))
    (T1, v1), (T2, v2) = pose(k), pose(k + 1)
    return (T1, v1, T2, v2, conv(wt), conv(wg), conv(wa), conv(s), conv(e),
            conv(seq["g_dir"]), conv(seq["bg"]), conv(seq["ba"]),
            conv(seq["sf"]))


def _j_residual(a, off, g_w, has_meas, rotation_only, W):
    a = list(a)
    a[5] = g_w
    return jpre.imu_factor_residual(*a, off, has_meas, weight_sqrt=W,
                                    rotation_only=rotation_only)


# one compile each for every factor and every switch setting
J_RESIDUAL = jax.jit(_j_residual)
J_RESIDUAL_JAC = jax.jit(jax.jacrev(_j_residual, argnums=(1, 2)))


@pytest.mark.parametrize("rotation_only", [False, True])
@pytest.mark.parametrize("has_meas", [True, False])
def test_imu_factor_residual_matches_jax(seq, rotation_only, has_meas):
    rng = np.random.default_rng(4)
    W = rng.normal(size=(9, 9)) * 10.0
    for k in (0, 6):
        def ft(off, g_w):
            a = list(_res_args(seq, k, "torch"))
            a[5] = g_w
            return tpre.imu_factor_residual(
                *a, off, torch.tensor(has_meas), weight_sqrt=T(W),
                rotation_only=rotation_only)

        wg = seq["wg"][k]
        args_j = (_res_args(seq, k, "jax"), seq["off"], jnp.asarray(wg),
                  jnp.asarray(has_meas), jnp.asarray(rotation_only),
                  jnp.asarray(W))
        r_j = J_RESIDUAL(*args_j)
        r_t = ft(T(seq["off"]), T(wg))
        _rel_close(r_t.numpy(), r_j, 1e-9) if has_meas else \
            np.testing.assert_array_equal(r_t.numpy(), 0.0)
        if rotation_only:
            assert not r_t[[0, 1, 2, 6, 7, 8]].any()
        # Jacobians w.r.t. the time offset and the raw gyro window
        Jj = J_RESIDUAL_JAC(*args_j)
        Jt = jacrev(ft, argnums=(0, 1))(T(seq["off"]), T(wg))
        for a, b in zip(Jj, Jt):
            if has_meas:
                _rel_close(b.numpy(), a, 1e-9)
            else:
                np.testing.assert_array_equal(b.numpy(), 0.0)


def test_end_state_matches_jax(seq):
    for k in (1, 9):
        a_j = _res_args(seq, k, "jax")
        a_t = _res_args(seq, k, "torch")
        y_j = jax.jit(jpre.end_state)(a_j[0], a_j[1], *a_j[4:], seq["off"])
        y_t = tpre.end_state(a_t[0], a_t[1], *a_t[4:], T(seq["off"]))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0,
                                   atol=1e-12)


def test_time_offset_derivative_matches_jax_and_central_difference(seq):
    """d/d(time_offset) goes through the slot times and the interpolation
    weights alpha (the slot index is piecewise constant).  The residual is
    piecewise smooth in the offset, with kinks where a shifted slot lands
    on a frame time; at the true 4 ms offset of this sequence the slots
    land exactly there (100 Hz stamps shifted by 4 ms), so the derivative is
    one-sided and the two packages must pick the same side.  Away from the
    kinks a central difference with h = 1e-7 s agrees to its truncation and
    rounding error, ~1e-6 relative."""
    k = 4
    w = np.random.default_rng(5).normal(size=9)

    def sj(off):
        return jnp.dot(jnp.asarray(w), jpre.imu_factor_residual(
            *_res_args(seq, k, "jax"), off, True))

    def st(off):
        return torch.dot(T(w), tpre.imu_factor_residual(
            *_res_args(seq, k, "torch"), off, torch.tensor(True)))

    grad_j = jax.jit(jax.grad(sj))
    for off in (0.004, 0.0043, 0.0, -0.0117, 0.0171):
        g_j = float(grad_j(off))
        g_t = float(torch.func.grad(st)(T(off)))
        np.testing.assert_allclose(g_t, g_j, rtol=1e-9)
        if off != 0.004:
            h = 1e-7
            fd = (float(st(T(off + h))) - float(st(T(off - h)))) / (2 * h)
            np.testing.assert_allclose(g_t, fd, rtol=1e-5)


def test_jacobians_finite_on_zero_length_intervals(seq):
    """A window whose tail is padding (the same stamp repeated, as
    gather_windows clips at the end of the stream) and a factor whose
    frame interval lies partly outside it: most slots collapse to
    zero-length intervals.  Every Jacobian stays finite and equals JAX."""
    wt, wg, wa, s, e = _factor(seq, 3)
    wt = wt.copy()
    wt[-20:] = wt[-21]
    wg, wa = wg.copy(), wa.copy()
    wg[-20:] = wg[-21]
    wa[-20:] = wa[-21]
    e = wt[-1] + 0.05                     # past the last real sample
    a_t = list(_res_args(seq, 3, "torch"))
    a_j = list(_res_args(seq, 3, "jax"))
    a_t[4:9] = [T(wt), T(wg), T(wa), T(s), T(e)]
    a_j[4:9] = [jnp.asarray(x) for x in (wt, wg, wa, s, e)]

    def ft(q1, t1, v1, g_dir, bias, off):
        a = list(a_t)
        a[0], a[1], a[9] = (q1, t1), v1, g_dir
        return tpre.imu_factor_residual(*a[:10], bias[:3], bias[3:],
                                        a[12], off, torch.tensor(True))

    def fj(q1, t1, v1, g_dir, bias, off):
        a = list(a_j)
        a[0], a[1], a[9] = (q1, t1), v1, g_dir
        return jpre.imu_factor_residual(*a[:10], bias[:3], bias[3:],
                                        a[12], off, True)

    x = (seq["q"][3], seq["t"][3], seq["v"][3], seq["g_dir"],
         np.concatenate([seq["bg"], seq["ba"]]), seq["off"])
    Jt = jacrev(ft, argnums=tuple(range(6)))(*map(T, x))
    Jj = jax.jit(jax.jacrev(fj, argnums=tuple(range(6))))(
        *map(jnp.asarray, x))
    scale = max(float(np.max(np.abs(np.asarray(a)))) for a in Jj)
    for a, b in zip(Jj, Jt):
        assert torch.isfinite(b).all()
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-9 * scale)
