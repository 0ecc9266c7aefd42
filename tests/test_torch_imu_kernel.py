"""The IMU factor kernel's plain twin and its wiring, on the CPU.

``imu.factor.imu_factor_plain`` repeats the CUDA kernel's arithmetic
(``csrc/imu_factor.cu``): 13 dual lanes through the slots, then the
closed-form pose-1, gravity and pose-2 columns.  Here it is held to the
``torch.func`` path (``residuals.imu_residuals_and_jacobians``, jacrev
inside vmap) on the 12-frame VI fixture of ``test_torch_lm_graph.py`` in
float64, within 1e-10 of the largest entry, and to the JAX package's
``imu_residuals_and_jacobians`` within 1e-9 (the tolerance of
``test_torch_solver_vi.py``), the tie and ``has_meas`` cases included;
the wrapper's checks, the
counters and the kernel path's wiring (the twin standing in for the
launch) are tested beside it.  On the card ``chip_smoke.py`` holds the
kernel to the twin and to the ``torch.func`` path.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vicalib_tpu.solver import problem as jp
from vicalib_tpu.solver import residuals as jres
from vicalib_tpu_torch import obs
from vicalib_tpu_torch.imu import factor
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


def _close(a, b):
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) <= TOL * scale, (
        float((a - b).abs().max()), scale)


@pytest.mark.parametrize("rotation_only", [False, True])
@pytest.mark.parametrize("case", ["offset", "grid"])
def test_twin_equals_autodiff(vi, case, rotation_only):
    """Residuals and all 33 Jacobian columns of the twin against jacrev,
    float64, within 1e-10 of the largest entry."""
    data, state, W = vi
    imu = data.imu
    if case == "grid":
        imu, state = _grid_case(data, state)
    r, J1, J2, Jsh = tres.imu_residuals_and_jacobians(state, imu, W,
                                                      rotation_only)
    J = torch.cat([J1, J2, Jsh], dim=2)
    rt, Jt = _twin(state, imu, W, rotation_only, jac=True)
    assert Jt.shape == (1,) + J.shape
    _close(rt[0], r)
    _close(Jt[0], J)
    # every column carries weight, and the masked rows are exact zeros
    assert bool((J.abs().amax(dim=(0, 1)) > 0).all())
    if rotation_only:
        assert not bool(rt[0][:, [0, 1, 2, 6, 7, 8]].any())
    if case == "grid":
        assert not bool(rt[0, 3].any()) and not bool(Jt[0, 3].any())
    rv, none = _twin(state, imu, W, rotation_only, jac=False)
    assert none is None
    _close(rv[0], r)


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
    against the torch.func path."""
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
        _close(r3[c], tres.imu_residuals(s, imu, W, False))


def test_cpu_takes_the_autodiff_path(vi, monkeypatch):
    """A CPU state never reaches the wrapper: no launch, no kernel factors,
    every factor counted."""
    data, state, W = vi

    def no_launch(*a, **k):
        raise AssertionError("the kernel wrapper was called")

    monkeypatch.setattr(tres, "imu_factor", no_launch)
    K = data.imu.start.shape[0]
    trial_b, _ = _candidates(state)
    with obs.recording() as rec:
        tres.imu_residuals(state, data.imu, W, False)
        tres.imu_residuals_and_jacobians(state, data.imu, W, True)
        tres.imu_trial_residuals(trial_b, data.imu, W, False)
    assert rec.count("vicalib.imu.factors") == 5 * K
    assert rec.count("vicalib.imu.kernel_factors") == 0
    assert rec.count("vicalib.imu.kernel_launches") == 0


@pytest.fixture
def twin_as_kernel(monkeypatch):
    """The kernel path on the CPU: the twin stands in for the launch."""
    calls = []

    def launch(state, *args):
        _, J = out = factor.imu_factor_plain(state, *args)
        calls.append((state[0].shape[0], J is not None))
        return out

    monkeypatch.setattr(tres, "_on_card", lambda state: True)
    monkeypatch.setattr(tres, "imu_factor", launch)
    return calls


def test_trial_costs_equal_the_candidate_loop(vi, twin_as_kernel,
                                              monkeypatch):
    """The LM step's trial costs over 3 candidates (one C = 3 evaluation of
    the IMU terms) against robust_costs one candidate at a time, on the
    kernel path and on the torch.func path."""
    data, state, W = vi
    trial_b, outs = _candidates(state)
    scale = torch.ones((), dtype=F64)
    with obs.recording() as rec:
        got = tasm.trial_costs(trial_b, data, W, scale, False)
        loop = torch.stack([tasm.robust_costs(s, data, W, scale, False)[0]
                            for s in outs])
    assert twin_as_kernel == [(3, False)] + [(1, False)] * 3
    K = data.imu.start.shape[0]
    assert rec.count("vicalib.imu.factors") == 6 * K
    assert rec.count("vicalib.imu.kernel_factors") == 6 * K
    torch.testing.assert_close(got, loop, rtol=1e-12, atol=0)
    monkeypatch.setattr(tres, "_on_card", lambda state: False)
    plain = tasm.trial_costs(trial_b, data, W, scale, False)
    torch.testing.assert_close(got, plain, rtol=1e-10, atol=0)


def test_assemble_on_the_kernel_path(vi, twin_as_kernel, monkeypatch):
    """The normal equations assembled from the kernel path's (C = 1)
    residuals and Jacobian columns equal the torch.func path's."""
    from vicalib_tpu_torch.solver import problem as tp

    data, state, W = vi
    flags = tp.StageFlags(calibrate_imu=True, inertial_active=True,
                          bias_active=True, scale_active=True,
                          optimize_time_offset=True)
    fmask = tp.frame_mask(flags, data.n_frames, F64, "cpu")
    smask = tp.shared_mask(data.layout, flags, F64, "cpu")
    scale = torch.ones((), dtype=F64)
    got = tasm.assemble(state, data, W, fmask, smask, scale, False)
    assert twin_as_kernel == [(1, True)]
    monkeypatch.setattr(tres, "_on_card", lambda state: False)
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
                                 "cpu"])
def test_wrapper_refuses_what_the_kernel_does_not_take(vi, bad):
    """imu_factor raises for a wrong dtype, shape or contiguity, and for a
    tensor that is not on a CUDA device."""
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
    args[0] = tuple(st)
    err = (TypeError if bad in ("dtype", "mixed_dtype", "has_meas")
           else ValueError)
    with pytest.raises(err):
        factor.imu_factor(*args)
