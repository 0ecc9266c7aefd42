"""The IMU factor's wrapper and its plain twin, on the CPU.

``imu.factor.imu_factor`` dispatches on the device: a CPU tensor takes
``imu_factor_plain``, which repeats the CUDA kernel's arithmetic
(``csrc/imu_factor.cu``): 13 dual lanes through the slots, then the
closed-form pose-1, gravity and pose-2 columns.  Here the solver's entry
points (``residuals.imu_residuals_and_jacobians`` and its siblings, which
reach the twin through the wrapper on a CPU state) are held to an oracle
defined below, reverse mode (``jacrev``) through
``preintegrate.imu_factor_residual`` vmapped over factors, on the 12-frame
VI fixture of ``test_torch_lm_graph.py`` in float64, within 1e-10 of the
largest entry, and to the JAX package's ``imu_residuals_and_jacobians``
within 1e-9 (the tolerance of ``test_torch_solver_vi.py``), the tie and
``has_meas`` cases included; the wrapper's checks and dispatch, the
counters and the solver's wiring (every call of the wrapper, the trial
costs and the assembly against the oracle) are tested beside it.  On the
card ``chip_smoke.py`` holds the kernel to the twin.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacrev, vmap

from vicalib_tpu.solver import problem as jp
from vicalib_tpu.solver import residuals as jres
from vicalib_tpu_torch import obs
from vicalib_tpu_torch.geometry import se3
from vicalib_tpu_torch.imu import factor, preintegrate
from vicalib_tpu_torch.io import sim as tsim
from vicalib_tpu_torch.solver import residuals as tres
from vicalib_tpu_torch.solver.build import problem_from_sim
from vicalib_tpu_torch.solver.problem import CalibState

# the package exports a function of the module's name
tasm = importlib.import_module("vicalib_tpu_torch.solver.assemble")
F64 = torch.float64
TOL = 1e-10
JAX_TOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def vi():
    cfg = tsim.default_mono_config(
        n_frames=12, model="linear", imu=True, imu_rate=100.0,
        gyro_bias=np.array([0.01, -0.02, 0.015]),
        accel_bias=np.array([0.05, 0.02, -0.04]), time_offset=0.004,
        pixel_noise=0.1)
    data, state = problem_from_sim(tsim.simulate(cfg, device="cpu"),
                                   use_imu=True, window_slack=0.1,
                                   device="cpu")
    gen = torch.Generator().manual_seed(7)
    K = data.imu.start.shape[0]
    W = (30.0 * torch.eye(9, dtype=F64)
         + torch.randn(K, 9, 9, generator=gen, dtype=F64))
    state = state._replace(
        biases=state.biases + 0.01 * torch.randn(6, generator=gen,
                                                 dtype=F64),
        scales=state.scales + 0.01 * torch.randn(6, generator=gen,
                                                 dtype=F64),
        time_offset=torch.tensor(0.0031, dtype=F64))
    return data, state, W


def _grid_case(data, state):
    """Zero time offset, IMU stamps on the frame grid (ties at the clip
    bounds), and one factor without measurements."""
    imu = data.imu
    wt = torch.round((imu.win_times + 0.004) * 1000.0) / 1000.0
    has = imu.has_meas.clone()
    has[3] = False
    imu = dataclasses.replace(imu, win_times=wt, has_meas=has)
    assert bool((wt == imu.start[:, None]).any())
    assert bool((wt == imu.end[:, None]).any())
    return imu, state._replace(time_offset=torch.zeros((), dtype=F64))


def _kernel_state(state, C=1):
    xs = (state.q_wk, state.t_wk, state.v_w, state.g_dir, state.biases,
          state.scales, state.time_offset)
    return tuple(x[None].expand((C,) + x.shape).contiguous() for x in xs)


def _twin(state, imu, W, rotation_only, jac, C=1):
    return factor.imu_factor_plain(
        _kernel_state(state, C), imu.win_times, imu.win_gyro, imu.win_accel,
        imu.start, imu.end, imu.has_meas, imu.frame_i, W, rotation_only, jac)


def _oracle_candidate(q_wk, t_wk, v_w, g_dir, biases, scales, time_offset,
                      win_times, win_gyro, win_accel, start, end, has_meas,
                      frame_i, weight_sqrt, rotation_only, jac):
    """One candidate's (r (K, 9), J (K, 9, 33) or None): jacrev of
    ``preintegrate.imu_factor_residual`` against the 33 tangent increments
    at zero, vmapped over factors."""
    def res(dx1, dx2, dxg, dxb, dxsf, dxt, q1, t1, v1, q2, t2, v2, wt, wg,
            wa, s, e, h, W):
        b = biases + dxb
        r = preintegrate.imu_factor_residual(
            se3.retract((q1, t1), dx1[:6]), v1 + dx1[6:9],
            se3.retract((q2, t2), dx2[:6]), v2 + dx2[6:9], wt, wg, wa, s, e,
            g_dir + dxg, b[:3], b[3:], scales + dxsf, time_offset + dxt[0],
            h, weight_sqrt=W, rotation_only=rotation_only)
        return r, r

    zeros = [q_wk.new_zeros(n) for n in (9, 9, 2, 6, 6, 1)]
    fi = frame_i
    args = (q_wk[fi], t_wk[fi], v_w[fi], q_wk[fi + 1], t_wk[fi + 1],
            v_w[fi + 1], win_times, win_gyro, win_accel, start, end, has_meas,
            weight_sqrt)
    if not jac:
        return vmap(lambda *a: res(*zeros, *a)[0])(*args), None
    J, r = vmap(lambda *a: jacrev(res, argnums=tuple(range(6)),
                                  has_aux=True)(*zeros, *a))(*args)
    return r, torch.cat(J, dim=-1)


def _oracle_factor(state, *args):
    """imu_factor's arguments and results by reverse mode, one candidate
    at a time."""
    outs = [_oracle_candidate(*xs, *args) for xs in zip(*state)]
    r = torch.stack([r for r, _ in outs])
    return r, None if outs[0][1] is None else torch.stack(
        [J for _, J in outs])


def _oracle(state, imu, W, rotation_only, jac, C=1):
    return _oracle_factor(
        _kernel_state(state, C), imu.win_times, imu.win_gyro, imu.win_accel,
        imu.start, imu.end, imu.has_meas, imu.frame_i, W, rotation_only, jac)


def _close(a, b):
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) <= TOL * scale, (
        float((a - b).abs().max()), scale)


@pytest.mark.parametrize("rotation_only", [False, True])
@pytest.mark.parametrize("case", ["offset", "grid"])
def test_twin_equals_autodiff(vi, case, rotation_only):
    """Residuals and all 33 Jacobian columns of the solver's entry points
    on a CPU state (the twin, through the wrapper) against the jacrev
    oracle, float64, within 1e-10 of the largest entry."""
    data, state, W = vi
    imu = data.imu
    if case == "grid":
        imu, state = _grid_case(data, state)
    r, J1, J2, Jsh = tres.imu_residuals_and_jacobians(state, imu, W,
                                                      rotation_only)
    J = torch.cat([J1, J2, Jsh], dim=2)
    ro, Jo = _oracle(state, imu, W, rotation_only, jac=True)
    assert Jo.shape == (1,) + J.shape
    _close(r, ro[0])
    _close(J, Jo[0])
    # every column carries weight, and the masked rows are exact zeros
    assert bool((Jo[0].abs().amax(dim=(0, 1)) > 0).all())
    if rotation_only:
        assert not bool(r[:, [0, 1, 2, 6, 7, 8]].any())
    if case == "grid":
        assert not bool(r[3].any()) and not bool(J[3].any())
    _close(tres.imu_residuals(state, imu, W, rotation_only), ro[0])
    rv, none = _twin(state, imu, W, rotation_only, jac=False)
    assert none is None
    _close(rv[0], ro[0])


@pytest.fixture(scope="module")
def jax_rj():
    return jax.jit(jres.imu_residuals_and_jacobians)


def _to_jax(state, imu):
    js = jp.CalibState(*[jnp.asarray(x.numpy()) for x in state])
    fields = {f.name: getattr(imu, f.name)
              for f in dataclasses.fields(imu)}
    ji = jres.ImuFactors(**{
        k: (jnp.asarray(v.numpy().astype(np.int32)) if k == "frame_i"
            else jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor)
            else v)
        for k, v in fields.items()})
    return js, ji


@pytest.mark.parametrize("rotation_only", [False, True])
@pytest.mark.parametrize("case", ["offset", "grid"])
def test_twin_equals_jax(vi, jax_rj, case, rotation_only):
    """Residuals and all 33 Jacobian columns of the twin against the JAX
    package, float64, within 1e-9 of the largest entry: the tie rule at
    the clip bounds and a factor without measurements held to JAX."""
    data, state, W = vi
    imu = data.imu
    if case == "grid":
        imu, state = _grid_case(data, state)
    js, ji = _to_jax(state, imu)
    out = jax_rj(js, ji, jnp.asarray(W.numpy()), jnp.asarray(rotation_only))
    r = np.asarray(out[0])
    J = np.concatenate([np.asarray(x) for x in out[1:]], axis=2)
    rt, Jt = _twin(state, imu, W, rotation_only, jac=True)
    for a, b in ((rt[0].numpy(), r), (Jt[0].numpy(), J)):
        assert a.shape == b.shape
        scale = float(np.abs(b).max())
        assert float(np.abs(a - b).max()) <= JAX_TOL * scale, (
            float(np.abs(a - b).max()), scale)
    if case == "grid":
        assert not r[3].any() and not J[3].any()


def _candidates(state, C=3):
    """C perturbed copies of the state, stacked as a trial state."""
    gen = torch.Generator().manual_seed(3)
    outs = []
    for c in range(C):
        outs.append(state._replace(
            t_wk=state.t_wk + 1e-3 * c, v_w=state.v_w - 1e-3 * c,
            g_dir=state.g_dir + 1e-3 * c,
            biases=state.biases + 1e-3 * torch.randn(6, generator=gen,
                                                     dtype=F64),
            time_offset=state.time_offset + 1e-4 * c))
    return CalibState(*[torch.stack(xs) for xs in zip(*outs)]), outs


def test_twin_candidates_equal_one_at_a_time(vi):
    """C = 3 candidates in one value-only evaluation against each alone and
    against the oracle."""
    data, state, W = vi
    trial_b, outs = _candidates(state)
    imu = data.imu
    st = (trial_b.q_wk, trial_b.t_wk, trial_b.v_w, trial_b.g_dir,
          trial_b.biases, trial_b.scales, trial_b.time_offset)
    r3, _ = factor.imu_factor_plain(
        st, imu.win_times, imu.win_gyro, imu.win_accel, imu.start, imu.end,
        imu.has_meas, imu.frame_i, W, False, False)
    assert r3.shape == (3, imu.start.shape[0], 9)
    for c, s in enumerate(outs):
        r1, _ = _twin(s, imu, W, False, jac=False)
        _close(r3[c], r1[0])
        _close(r3[c], _oracle(s, imu, W, False, jac=False)[0][0])


def test_cpu_takes_the_twin(vi, monkeypatch):
    """A CPU state takes the twin through the wrapper: no build, no launch,
    no kernel factors, every factor counted."""
    data, state, W = vi

    def no_build(*a, **k):
        raise AssertionError("the kernel was built")

    calls = []
    twin = factor.imu_factor_plain

    def record(state, *args):
        calls.append((state[0].shape[0], args[-1]))
        return twin(state, *args)

    monkeypatch.setattr(factor, "build", no_build)
    monkeypatch.setattr(factor, "imu_factor_plain", record)
    K = data.imu.start.shape[0]
    trial_b, _ = _candidates(state)
    with obs.recording() as rec:
        tres.imu_residuals(state, data.imu, W, False)
        tres.imu_residuals_and_jacobians(state, data.imu, W, True)
        tres.imu_trial_residuals(trial_b, data.imu, W, False)
    assert calls == [(1, False), (1, True), (3, False)]
    assert rec.count("vicalib.imu.factors") == 5 * K
    assert rec.count("vicalib.imu.kernel_factors") == 0
    assert rec.count("vicalib.imu.kernel_launches") == 0


@pytest.fixture
def wrapper_calls(monkeypatch):
    """The solver's calls of the wrapper, as (candidates, with Jacobian)."""
    calls = []
    wrapper = tres.imu_factor

    def record(state, *args):
        calls.append((state[0].shape[0], args[-1]))
        return wrapper(state, *args)

    monkeypatch.setattr(tres, "imu_factor", record)
    return calls


def test_trial_costs_equal_the_candidate_loop(vi, wrapper_calls,
                                              monkeypatch):
    """The LM step's trial costs over 3 candidates (one C = 3 evaluation of
    the IMU terms) against robust_costs one candidate at a time, and
    against the trial costs with the oracle in the wrapper's place."""
    data, state, W = vi
    trial_b, outs = _candidates(state)
    scale = torch.ones((), dtype=F64)
    with obs.recording() as rec:
        got = tasm.trial_costs(trial_b, data, W, scale, False)
        loop = torch.stack([tasm.robust_costs(s, data, W, scale, False)[0]
                            for s in outs])
    assert wrapper_calls == [(3, False)] + [(1, False)] * 3
    K = data.imu.start.shape[0]
    assert rec.count("vicalib.imu.factors") == 6 * K
    assert rec.count("vicalib.imu.kernel_factors") == 0
    torch.testing.assert_close(got, loop, rtol=1e-12, atol=0)
    monkeypatch.setattr(tres, "imu_factor", _oracle_factor)
    want = tasm.trial_costs(trial_b, data, W, scale, False)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=0)


def test_assemble_on_the_kernel_path(vi, wrapper_calls, monkeypatch):
    """The normal equations assembled through the wrapper (one C = 1 call
    with the Jacobian) equal those assembled with the oracle in the
    wrapper's place."""
    from vicalib_tpu_torch.solver import problem as tp

    data, state, W = vi
    flags = tp.StageFlags(calibrate_imu=True, inertial_active=True,
                          bias_active=True, scale_active=True,
                          optimize_time_offset=True)
    fmask = tp.frame_mask(flags, data.n_frames, F64, "cpu")
    smask = tp.shared_mask(data.layout, flags, F64, "cpu")
    scale = torch.ones((), dtype=F64)
    got = tasm.assemble(state, data, W, fmask, smask, scale, False)
    assert wrapper_calls == [(1, True)]
    monkeypatch.setattr(tres, "imu_factor", _oracle_factor)
    want = tasm.assemble(state, data, W, fmask, smask, scale, False)
    for a, b in zip(got, want):
        _close(a, b)


def _args(vi):
    data, state, W = vi
    imu = data.imu
    return [_kernel_state(state), imu.win_times, imu.win_gyro,
            imu.win_accel, imu.start, imu.end, imu.has_meas, imu.frame_i, W,
            False, True]


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "no_candidates",
                                 "shape", "noncontiguous", "has_meas",
                                 "meta"])
def test_wrapper_refuses_what_the_kernel_does_not_take(vi, bad):
    """imu_factor raises for a wrong dtype, shape or contiguity, and for
    tensors on a device that is neither the CPU nor a CUDA card."""
    args = _args(vi)
    st = list(args[0])
    if bad == "dtype":
        st = [x.to(torch.float16) for x in st]
    elif bad == "mixed_dtype":
        args[1] = args[1].float()
    elif bad == "no_candidates":
        st[0] = st[0][0]
    elif bad == "shape":
        args[2] = args[2][:, :-1]
    elif bad == "noncontiguous":
        args[8] = args[8].transpose(1, 2)
    elif bad == "has_meas":
        args[6] = args[6].to(torch.uint8)
    elif bad == "meta":
        st = [x.to("meta") for x in st]
        args[1:9] = [x.to("meta") for x in args[1:9]]
    args[0] = tuple(st)
    err = (TypeError if bad in ("dtype", "mixed_dtype", "has_meas")
           else ValueError)
    with pytest.raises(err):
        factor.imu_factor(*args)


def test_wrapper_takes_the_twin_on_cpu_and_counts_no_launch(vi):
    """On CPU tensors the wrapper returns the twin's results to the last
    bit, with and without the Jacobian, and counts factors but no launch."""
    args = _args(vi)
    K = args[4].shape[0]
    with obs.recording() as rec:
        r, J = factor.imu_factor(*args)
        rv, none = factor.imu_factor(*args[:-1], False)
    rt, Jt = factor.imu_factor_plain(*args)
    assert torch.equal(r, rt) and torch.equal(J, Jt)
    assert none is None and torch.equal(rv, rt)
    assert rec.count("vicalib.imu.factors") == 2 * K
    assert rec.count("vicalib.imu.kernel_factors") == 0
    assert rec.count("vicalib.imu.kernel_launches") == 0
