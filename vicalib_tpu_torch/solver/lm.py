"""Levenberg-Marquardt driver over the structured calibration problem.

Replaces the reference's Ceres DOGLEG trust-region solve with an LM loop
whose state stays on the device: assemble the arrow-plus-chain normal
equations, Schur-eliminate frames, solve the damped system for three
damping candidates as one batch, retract, accept/reject with lambda
adaptation.  The loop is a Python loop over device tensors that reads its
stop test back to the host once per iteration; a stage ends with one packed
info vector.  Convergence criteria mirror the reference: function tolerance
1e-6, gradient-norm early stop at 1e-9, max iterations 200.  The IMU
covariance whitening (UpdateImuWeights, vicalibrator.h:690-692) is
recomputed on the device every ``weight_refresh`` iterations; the cadence
is a branch on the host-side iteration count.

The solve runs with full-precision float32 matmuls (TF32 off for matmuls
and cuDNN) — reduced-precision passes break the normal equations.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging

import numpy as np
import torch
from torch.func import vmap

from .assemble import ProblemData, assemble, robust_costs
from .problem import CalibState, retract
from .schur import schur_solve
from .weights import imu_weights

log = logging.getLogger("vicalib_tpu_torch.solver")


@dataclasses.dataclass(frozen=True)
class LMOptions:
    max_iters: int = 200
    function_tolerance: float = 1e-6
    gradient_tolerance: float = 1e-9
    lam0: float = 1e-4
    lam_min: float = 1e-12
    lam_max: float = 1e10
    # Damping candidates tried per iteration, as multiples of the current
    # lambda: the assembled system is shared; each candidate adds only a
    # structured solve and a cost evaluation.
    lam_factors: tuple = (0.2, 1.0, 30.0)
    # IMU covariance-whitening refresh cadence (iterations).  The reference
    # recomputes the weights every Ceres iteration (vicalibrator.h:690-692);
    # they vary slowly with the state, so refreshing every few iterations
    # saves the propagation cost.  Set 1 for per-iteration semantics.
    weight_refresh: int = 4
    # Plateau stop: if the best cost seen does not improve by >= ftol * cost
    # for this many consecutive iterations, declare convergence.  Spans two
    # weight-refresh cycles, so refresh-cycle oscillation counts as stalling.
    stall_iters: int = 8


@dataclasses.dataclass
class LMInfo:
    cost: float
    iterations: int
    gradient_norm: float
    converged: bool
    cam_rmse: np.ndarray     # per-camera sqrt(cost_c / n_obs_c), Ceres-style
    n_residuals: int


@contextlib.contextmanager
def full_precision_matmul():
    """TF32 off for matmuls and cuDNN inside the block, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def candidate_lams(lam, options: LMOptions):
    """The damping candidates tried this iteration, (n_cand,)."""
    return torch.stack([lam * f for f in options.lam_factors])


def _take(x, j):
    """x[j] for a 0-d index tensor, without a host sync."""
    return torch.index_select(x, 0, j.reshape(1))[0]


def select_candidate(state, trial_b, cost, cost_b, pred_b, lams, lam, nu,
                     gf, gs, options: LMOptions):
    """Accept/reject + lambda adaptation over the damping candidates.

    rho = actual / predicted reduction of the chosen candidate; accepted
    steps move lambda to the candidate shrunk by Nielsen's
    max(1/3, 1 - (2 rho - 1)^3), rejected steps grow it by the doubling
    factor nu.  Returns pred_max (the best model-predicted reduction among
    candidates) so the caller can stop when even the model promises less
    than the function tolerance."""
    valid = pred_b > 0
    cand = torch.where(valid, cost_b, torch.full_like(cost_b, float("inf")))
    j = torch.argmin(cand)
    trial_cost = _take(cand, j)
    pred_red = _take(pred_b, j)
    accept = trial_cost < cost
    rho = (cost - trial_cost) / torch.clamp(pred_red, min=1e-20)
    new_state = CalibState(*[torch.where(accept, _take(tb, j), b)
                             for tb, b in zip(trial_b, state)])
    shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    new_lam = torch.where(accept, _take(lams, j) * shrink, lam * nu)
    new_lam = torch.clamp(new_lam, options.lam_min, options.lam_max)
    new_nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
    gnorm = torch.sqrt(torch.sum(gf * gf) + torch.sum(gs * gs))
    pred_max = torch.max(torch.where(valid, pred_b,
                                     torch.zeros_like(pred_b)))
    return (new_state, new_lam, new_nu, cost, trial_cost, accept, gnorm,
            pred_max)


def _lm_step(data, state, lam, nu, weight_sqrt, fmask, smask, inertial_scale,
             rotation_only, options: LMOptions):
    """One multi-candidate damped step with gain-ratio lambda adaptation.

    The normal equations are assembled once; the damping candidates are
    solved, retracted and cost-evaluated as one batch dimension, and the
    best admissible trial is taken via :func:`select_candidate`."""
    D, U, Hfs, Hss, gf, gs, cost, _ = assemble(
        state, data, weight_sqrt, fmask, smask, inertial_scale,
        rotation_only)
    lams = candidate_lams(lam, options)
    dxf_b, dxs_b, pred_b = vmap(
        lambda l: schur_solve(D, U, Hfs, Hss, gf, gs, damping=l))(lams)
    trial_b = vmap(
        lambda df, ds: retract(state, data.layout, df * fmask, ds * smask))(
        dxf_b, dxs_b)
    cost_b = vmap(
        lambda s: robust_costs(CalibState(*s), data, weight_sqrt,
                               inertial_scale, rotation_only)[0])(
        tuple(trial_b))
    return select_candidate(state, CalibState(*trial_b), cost, cost_b,
                            pred_b, lams, lam, nu, gf, gs, options)


def _get_weights(data, state, seed_weight, use_cov_weights, sigmas,
                 carry_weight=None, refresh=True):
    """Whitening weights for this iteration.

    Covariance propagation runs when ``use_cov_weights`` and ``refresh``
    (host bools) both hold; otherwise the carried weights (else the seed)
    are reused."""
    if data.imu is None or sigmas is None:
        return seed_weight
    if use_cov_weights and refresh:
        return imu_weights(state, data.imu, sigmas[0], sigmas[1])
    return seed_weight if carry_weight is None else carry_weight


def fused_solve(data: ProblemData, state: CalibState, fmask, smask,
                inertial_scale, rotation_only, use_cov_weights, seed_weight,
                options: LMOptions, sigmas):
    """Full LM solve on the device.  Returns (state, info_vec): the packed
    [final_cost, cam_sq (C), cam_cnt (C), iterations, converged] vector."""
    with full_precision_matmul():
        dtype = state.t_wk.dtype
        dev = state.t_wk.device
        lam = torch.tensor(options.lam0, dtype=dtype, device=dev)
        nu = torch.tensor(2.0, dtype=dtype, device=dev)
        best = torch.tensor(float("inf"), dtype=dtype, device=dev)
        stall = torch.zeros((), dtype=torch.int64, device=dev)
        it = 0
        done = False
        W = seed_weight
        while not done and it < options.max_iters:
            W = _get_weights(data, state, seed_weight, use_cov_weights,
                             sigmas, carry_weight=W,
                             refresh=it % options.weight_refresh == 0)
            (state, lam_new, nu, cost, trial_cost, accept, gnorm,
             pred_max) = _lm_step(data, state, lam, nu, W, fmask, smask,
                                  inertial_scale, rotation_only, options)
            ftol_gate = options.function_tolerance * cost
            converged = accept & ((cost - trial_cost) < ftol_gate)
            # even the best candidate's model-predicted reduction is below
            # tolerance (and some candidate was admissible): stop
            converged |= (~accept) & (pred_max > 0) & (pred_max < ftol_gate)
            converged |= (gnorm > 0) & (gnorm < options.gradient_tolerance)
            converged |= lam >= options.lam_max
            cost_cur = torch.where(accept, trial_cost, cost)
            improved = (best - cost_cur) >= ftol_gate
            best = torch.minimum(best, cost_cur)
            stall = torch.where(improved, torch.zeros_like(stall), stall + 1)
            converged |= stall >= options.stall_iters
            lam = lam_new
            it += 1
            done = bool(converged)           # the one host read per iteration
        W = _get_weights(data, state, seed_weight, use_cov_weights, sigmas)
        final_cost, cam_sq, cam_cnt = robust_costs(
            state, data, W, inertial_scale, rotation_only)
        info_vec = torch.cat([
            final_cost[None].to(dtype), cam_sq.to(dtype), cam_cnt.to(dtype),
            torch.tensor([it, float(done)], dtype=dtype, device=dev)])
        return state, info_vec


def materialize_info(raw) -> LMInfo:
    """Packed info vector (tensor or numpy) -> LMInfo; one host transfer."""
    vec = raw.detach().cpu().numpy() if isinstance(raw, torch.Tensor) \
        else np.asarray(raw)
    C = (len(vec) - 3) // 2
    final_cost = vec[0]
    cam_sq = vec[1:1 + C]
    cam_cnt = np.maximum(vec[1 + C:1 + 2 * C], 1.0)
    it, done = vec[-2], vec[-1]
    # Ceres-style per-camera "rmse": sqrt((1/2 sum |r|^2) / n_blocks)
    cam_rmse = np.sqrt(0.5 * cam_sq / cam_cnt)
    return LMInfo(cost=float(final_cost), iterations=int(it),
                  gradient_norm=float("nan"), converged=bool(done),
                  cam_rmse=cam_rmse, n_residuals=int(np.sum(cam_cnt)))


def seed_weights(K, dtype, device):
    """(K, 9, 9) copies of the I*500 seed weight (vicalibrator.h:616)."""
    return (torch.eye(9, dtype=dtype, device=device) * 500.0).expand(
        K, 9, 9).contiguous()


class LMSolver:
    """Binds a ProblemData (tensors already on their device) to the LM
    loop."""

    def __init__(self, data: ProblemData, options: LMOptions = LMOptions(),
                 sigmas=None):
        self.data = data
        self.options = options
        self.sigmas = sigmas

    def solve(self, state: CalibState, fmask, smask, use_cov_weights=False,
              inertial_scale=0.0, rotation_only=False, seed_weight=None,
              lazy=False):
        """Run LM to convergence.  With ``lazy`` the raw info vector is
        returned (see :func:`materialize_info`)."""
        dtype = state.t_wk.dtype
        dev = state.t_wk.device
        if seed_weight is None:
            # the I*500 seed weight (vicalibrator.h:616), one per factor
            K = (self.data.imu.start.shape[0] if self.data.imu is not None
                 else 1)
            seed_weight = seed_weights(K, dtype, dev)
        state, raw = fused_solve(
            self.data, state, fmask, smask,
            torch.tensor(inertial_scale, dtype=dtype, device=dev),
            bool(rotation_only), bool(use_cov_weights), seed_weight,
            self.options, self.sigmas)
        if lazy:
            return state, raw
        return state, materialize_info(raw)
