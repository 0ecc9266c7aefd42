"""Port parity: the solver pieces (torch vs JAX) on one small stereo problem.

Both packages get the same problem and state through ``convert`` (numpy
dicts keyed by the JAX field names).  Float64 throughout.  Sums are taken in
other orders (batched matmul vs XLA dot), so assembled blocks agree to a
relative 1e-9 of their largest entry, and solves of the damped, Jacobi-scaled
systems to 1e-8 relative.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vicalib_tpu.io import sim as jsim
from vicalib_tpu.solver import lm as jlm
from vicalib_tpu.solver import problem as jp
from vicalib_tpu.solver import robust as jr
from vicalib_tpu.solver import schur as js
from vicalib_tpu.solver.build import problem_from_sim
from vicalib_tpu_torch import convert
from vicalib_tpu_torch.solver import lm as tlm
from vicalib_tpu_torch.solver import problem as tp
from vicalib_tpu_torch.solver import robust as tr
from vicalib_tpu_torch.solver import schur as ts

# the solver packages export a function named ``assemble``; take the modules
ja = importlib.import_module("vicalib_tpu.solver.assemble")
ta = importlib.import_module("vicalib_tpu_torch.solver.assemble")


def _rel_close(actual, desired, rtol):
    desired = np.asarray(desired)
    scale = max(float(np.max(np.abs(desired))), 1e-300)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=0,
                               atol=rtol * scale)


@pytest.fixture(scope="module")
def problem():
    cfg = jsim.default_stereo_vi_config(n_frames=6, model="linear",
                                        pixel_noise=0.2)
    cfg.cameras[0].T_ck = (np.array([0.0, 0.0, 0.0, 1.0]), np.zeros(3))
    cfg.cameras[1].T_ck = (np.array([0.0, 0.0, 0.0, 1.0]),
                           np.array([0.0, -0.12, 0.0]))
    data_j, state_j = problem_from_sim(jsim.simulate(cfg))
    d = {"model_names": list(data_j.layout.model_names),
         "n_frames": data_j.n_frames,
         "obs": [{"frame_idx": np.asarray(o.frame_idx),
                  "p_w": np.asarray(o.p_w), "p_c": np.asarray(o.p_c),
                  "valid": np.asarray(o.valid),
                  "points_per_frame": o.points_per_frame}
                 for o in data_j.obs]}
    s = {k: np.asarray(v) for k, v in state_j._asdict().items()}
    data_t = convert.problem_from_numpy(d, "cpu")
    state_t = convert.state_from_numpy(s, "cpu")
    flags = jp.StageFlags(calibrate_imu=False)
    masks_j = (jp.frame_mask(flags, data_j.n_frames),
               jp.shared_mask(data_j.layout, flags))
    tflags = tp.StageFlags(calibrate_imu=False)
    masks_t = (tp.frame_mask(tflags, data_t.n_frames, torch.float64, "cpu"),
               tp.shared_mask(data_t.layout, tflags, torch.float64, "cpu"))
    return data_j, state_j, data_t, state_t, masks_j, masks_t


def test_convert_round_trip_and_masks(problem):
    data_j, state_j, data_t, state_t, masks_j, masks_t = problem
    for k, v in convert.state_to_numpy(state_t).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(state_j, k)))
    for o_j, o_t in zip(data_j.obs, data_t.obs):
        for k in ("frame_idx", "p_w", "p_c", "valid"):
            np.testing.assert_array_equal(getattr(o_t, k).numpy(),
                                          np.asarray(getattr(o_j, k)))
        assert o_t.points_per_frame == o_j.points_per_frame
    assert dataclasses.asdict(data_t.layout) == \
        dataclasses.asdict(data_j.layout)
    for mj, mt in zip(masks_j, masks_t):
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def test_robust_losses_match_jax():
    s = np.logspace(-6, 4, 50)
    for jl, tl in ((jr.SoftL1(0.5), tr.SoftL1(0.5)),
                   (jr.Cauchy(100.0), tr.Cauchy(100.0)),
                   (jr.Trivial(), tr.Trivial())):
        np.testing.assert_allclose(tl.rho(torch.as_tensor(s)).numpy(),
                                   np.asarray(jl.rho(jnp.asarray(s))),
                                   rtol=1e-14)
        np.testing.assert_allclose(tl.weight(torch.as_tensor(s)).numpy(),
                                   np.asarray(jl.weight(jnp.asarray(s))),
                                   rtol=1e-14)


def test_retract_and_init_state_match_jax(problem):
    data_j, state_j, data_t, state_t, _, _ = problem
    rng = np.random.default_rng(0)
    dxf = rng.normal(size=(data_j.n_frames, 9)) * 1e-2
    dxs = rng.normal(size=(data_j.layout.size,)) * 1e-2
    out_j = jp.retract(state_j, data_j.layout, jnp.asarray(dxf),
                       jnp.asarray(dxs))
    out_t = tp.retract(state_t, data_t.layout, torch.as_tensor(dxf),
                       torch.as_tensor(dxs))
    for a, b in zip(out_j, out_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-14)
    ij = jp.init_state(5, ["linear", "fov"], [640, 800], [480, 600])
    it = tp.init_state(5, ["linear", "fov"], [640, 800], [480, 600],
                       torch.float64, "cpu")
    for a, b in zip(ij, it):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_assemble_matches_jax(problem):
    data_j, state_j, data_t, state_t, (fm_j, sm_j), (fm_t, sm_t) = problem
    W = jnp.eye(9)[None] * 500.0
    out_j = ja.assemble(state_j, data_j, W, fm_j, sm_j, jnp.asarray(0.0),
                        jnp.asarray(True))
    out_t = ta.assemble(state_t, data_t, None, fm_t, sm_t, 0.0, True)
    for name, a, b in zip(["D", "U", "Hfs", "Hss", "gf", "gs", "cost",
                           "n_res"], out_j, out_t):
        assert tuple(b.shape) == tuple(a.shape), name
        _rel_close(b.numpy(), a, 1e-9)
    cj = ja.robust_costs(state_j, data_j, W, 0.0, True)
    ct = ta.robust_costs(state_t, data_t, None, 0.0, True)
    for a, b in zip(cj, ct):
        _rel_close(b.numpy(), a, 1e-12)


def test_schur_solve_matches_jax(problem):
    data_j, state_j, data_t, state_t, (fm_j, sm_j), (fm_t, sm_t) = problem
    W = jnp.eye(9)[None] * 500.0
    sys_j = ja.assemble(state_j, data_j, W, fm_j, sm_j, jnp.asarray(0.0),
                        jnp.asarray(True))[:6]
    sys_t = ta.assemble(state_t, data_t, None, fm_t, sm_t, 0.0, True)[:6]
    for lam in (1e-4, 3e-2):
        out_j = js.schur_solve(*sys_j, damping=lam)
        out_t = ts.schur_solve(*sys_t, damping=torch.tensor(lam,
                                                            dtype=torch.float64))
        for a, b in zip(out_j, out_t):
            _rel_close(b.numpy(), a, 1e-8)


def _block_tridiag(F, n, R, seed):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(F - 1, n, n)) * 0.3
    M = rng.normal(size=(F, n, n))
    D = M @ np.swapaxes(M, 1, 2) + 4.0 * n * np.eye(n)[None]
    B = rng.normal(size=(F, n, R))
    return D, U, B


@pytest.mark.parametrize("F", [1, 2, 7, 13])
def test_tridiag_solve_matches_sequential_oracle_and_jax(F):
    D, U, B = _block_tridiag(F, 9, 4, F)
    Dt, Ut, Bt = (torch.as_tensor(x) for x in (D, U, B))
    x_cr = ts.tridiag_solve(Dt, Ut, Bt).numpy()
    x_seq = ts.tridiag_solve_seq(Dt, Ut, Bt).numpy()
    np.testing.assert_allclose(x_cr, x_seq, rtol=0, atol=1e-12)
    x_j = np.asarray(js.tridiag_solve(jnp.asarray(D), jnp.asarray(U),
                                      jnp.asarray(B)))
    np.testing.assert_allclose(x_cr, x_j, rtol=0, atol=1e-12)


def test_non_pd_reduced_system_gives_nan_pred_like_jax():
    """JAX's cholesky returns NaN on a non-PD matrix and the LM policy drops
    that candidate through pred > 0; torch's cholesky would raise, so the
    port maps cholesky_ex's info != 0 to NaN."""
    F, S = 4, 6
    D, U, _ = _block_tridiag(F, 9, 1, 0)
    rng = np.random.default_rng(1)
    Hfs = rng.normal(size=(F, 9, S)) * 5.0
    Hss = -10.0 * np.eye(S)                          # indefinite
    gf = rng.normal(size=(F, 9))
    gs = rng.normal(size=(S,))
    args_j = [jnp.asarray(x) for x in (D, U, Hfs, Hss, gf, gs)]
    args_t = [torch.as_tensor(x) for x in (D, U, Hfs, Hss, gf, gs)]
    _, _, pred_j = js.schur_solve(*args_j, damping=0.0)
    _, dxs_t, pred_t = ts.schur_solve(*args_t, damping=0.0)
    assert np.isnan(float(pred_j)) and np.isnan(float(pred_t))
    assert torch.isnan(dxs_t).all()


def test_one_lm_step_matches_jax(problem):
    data_j, state_j, data_t, state_t, (fm_j, sm_j), (fm_t, sm_t) = problem
    W = jnp.eye(9)[None] * 500.0
    lam = 1e-4
    new_j, lam_j, cost_j, trial_j, acc_j, gnorm_j = jlm.lm_step_jit(
        data_j, state_j, jnp.asarray(lam), W, fm_j, sm_j, jnp.asarray(0.0),
        jnp.asarray(True), jlm.LMOptions())
    (new_t, lam_t, _, cost_t, trial_t, acc_t, gnorm_t,
     _) = tlm._lm_step(data_t, state_t, torch.tensor(lam, dtype=torch.float64),
                       torch.tensor(2.0, dtype=torch.float64), None, fm_t,
                       sm_t, torch.tensor(0.0, dtype=torch.float64), True,
                       tlm.LMOptions())
    assert bool(acc_t) == bool(acc_j) and bool(acc_t)
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-12)
    np.testing.assert_allclose(float(trial_t), float(trial_j), rtol=1e-9)
    np.testing.assert_allclose(float(lam_t), float(lam_j), rtol=1e-6)
    np.testing.assert_allclose(float(gnorm_t), float(gnorm_j), rtol=1e-9)
    for a, b in zip(new_j, new_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-9)
