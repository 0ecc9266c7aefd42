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
is a branch on the host-side iteration count.  Each iteration is a
``vicalib.lm.iter`` span around the weight refresh, assembly, step and
stop-test wait spans (obs.py).

The loop's state lives in preallocated tensors (:class:`_LoopState`); the
iteration's two bodies, the step (:func:`_step_body`) and the weight
refresh (:func:`_weights_body`), read them and write their results back
with ``copy_``.  For a CUDA state on a whole ProblemData, ``LMSolver``
keeps those tensors for all of its stages and replays each body as a CUDA
graph (:class:`_Graphs`): a body runs eagerly the first time, is captured
the second and replayed from then on, so a replayed iteration costs the
device's time and one host read.  Everywhere else (the CPU, the sharded
problem, whose step runs collectives) the same bodies run eagerly.

The solve runs with full-precision float32 matmuls (TF32 off for matmuls
and cuDNN) — reduced-precision passes break the normal equations.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading

import numpy as np
import torch
from torch.func import vmap

from .. import obs
from .assemble import ProblemData, assemble, robust_costs, trial_costs
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
    best admissible trial is taken via :func:`select_candidate`.  ``data``
    is a ProblemData, or a dist.sharded.ShardedProblem with
    ``weight_sqrt`` in its sharded layout (its shards' sums)."""
    whole = isinstance(data, ProblemData)
    with obs.span("vicalib.lm.assemble"):
        D, U, Hfs, Hss, gf, gs, cost, _ = (
            assemble(state, data, weight_sqrt, fmask, smask, inertial_scale,
                     rotation_only) if whole else
            data.assemble(state, weight_sqrt, fmask, smask, inertial_scale,
                          rotation_only))
    with obs.span("vicalib.lm.step"):
        lams = candidate_lams(lam, options)
        dxf_b, dxs_b, pred_b = vmap(
            lambda l: schur_solve(D, U, Hfs, Hss, gf, gs, damping=l))(lams)
        trial_b = CalibState(*vmap(
            lambda df, ds: retract(state, data.layout, df * fmask,
                                   ds * smask))(dxf_b, dxs_b))
        if whole:
            cost_b = trial_costs(trial_b, data, weight_sqrt, inertial_scale,
                                 rotation_only)
        else:
            cost_b = data.trial_costs(trial_b, weight_sqrt, inertial_scale,
                                      rotation_only)
        return select_candidate(state, trial_b, cost, cost_b, pred_b, lams,
                                lam, nu, gf, gs, options)


class _LoopState:
    """The LM loop's state in preallocated tensors: the iterate, lambda,
    nu, the best cost, the stall count, the IMU weights ``W``, the stage's
    masks and inertial scale, and the stop flag.  :meth:`start` fills them
    for a stage; the bodies overwrite them in place, so a graph captured
    over a body replays on the same addresses in every stage."""

    def __init__(self, state: CalibState, seed_weight, fmask, smask,
                 inertial_scale):
        like = state.t_wk
        self.state = CalibState(*[torch.empty_like(x) for x in state])
        self.W = torch.empty_like(seed_weight)
        self.fmask = torch.empty_like(fmask)
        self.smask = torch.empty_like(smask)
        self.inertial_scale = torch.empty_like(inertial_scale)
        self.lam = like.new_empty(())
        self.nu = like.new_empty(())
        self.best = like.new_empty(())
        self.stall = torch.empty((), dtype=torch.int64, device=like.device)
        self.converged = torch.empty((), dtype=torch.bool,
                                     device=like.device)

    def fits(self, state: CalibState, seed_weight, fmask, smask) -> bool:
        """Whether a stage's inputs have this state's shapes and dtypes."""
        pairs = list(zip(self.state, state)) + [
            (self.W, seed_weight), (self.fmask, fmask), (self.smask, smask)]
        return all(a.shape == b.shape and a.dtype == b.dtype
                   for a, b in pairs)

    def start(self, state: CalibState, seed_weight, fmask, smask,
              inertial_scale, options: LMOptions):
        """A stage's starting values: its state, seed weights, masks and
        inertial scale; lambda at lam0, nu 2, no best cost, no stall."""
        for buf, x in zip(self.state, state):
            buf.copy_(x)
        self.W.copy_(seed_weight)
        self.fmask.copy_(fmask)
        self.smask.copy_(smask)
        self.inertial_scale.copy_(inertial_scale)
        self.lam.fill_(options.lam0)
        self.nu.fill_(2.0)
        self.best.fill_(float("inf"))
        self.stall.zero_()
        self.converged.fill_(False)


def _step_body(data, loop: _LoopState, rotation_only, options: LMOptions):
    """One LM step on ``loop``'s tensors: the damped step, the stop tests
    and the stall rule, written back in place.  No host read and no host
    data: it is what a CUDA graph captures."""
    whole = isinstance(data, ProblemData)
    lam, best, stall = loop.lam, loop.best, loop.stall
    (state, lam_new, nu, cost, trial_cost, accept, gnorm,
     pred_max) = _lm_step(data, loop.state, lam, loop.nu,
                          loop.W if whole else data.shard_weight(loop.W),
                          loop.fmask, loop.smask, loop.inertial_scale,
                          rotation_only, options)
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
    for buf, x in zip(loop.state, state):
        buf.copy_(x)
    loop.lam.copy_(lam_new)
    loop.nu.copy_(nu)
    loop.best.copy_(best)
    loop.stall.copy_(stall)
    loop.converged.copy_(converged)


def _weights_body(data, loop: _LoopState, sigmas):
    """The IMU covariance whitening at ``loop``'s state, into ``loop.W``
    (computed on the full problem, also when sharded)."""
    with obs.span("vicalib.lm.weights"):
        loop.W.copy_(imu_weights(loop.state, data.imu, sigmas[0],
                                 sigmas[1]))


class _ThreadState(threading.local):
    """What the graph path keeps per thread, as the CUDA libraries keep
    their handles: each device's capture stream (the libraries' workspaces
    are made per stream, so one stream makes them once) and graph memory
    pool, and the (device, key) of the bodies that have run.  A body's
    first run on a device makes the handles and workspaces that a capture
    may not make, so it runs eagerly (an iteration's real work); from then
    on every solver captures the body at its first run.  The caching
    allocator keeps a pool's memory reserved after its graphs are gone and
    gives it to no other pool, so a pool per solver grew the reserved
    memory by every solver's graphs (3.3 GB a calibration of the EuRoC rig,
    until the card ran out); the solvers of a thread capture into one
    pool, which reuses the memory of the graphs that went.  A pool whose
    last graph has gone takes no further capture (in the device's and the
    pinned host memory's allocators alike), so a one-kernel graph captured
    into it with the pool, and kept here, holds it open."""

    def __init__(self):
        self.streams = {}
        self.pools = {}
        self.warm = set()


_THREAD = _ThreadState()


class _Graphs:
    """CUDA graphs of one LMSolver's iteration bodies, keyed by what a body
    branches on on the host (``("step", rotation_only)``, ``"weights"``).
    A key is captured at its first run in the solver (its first run in the
    thread is eager, see :class:`_ThreadState`) and replayed at every later
    one.  Every graph draws on the thread's private memory pool for the
    device and is captured on the thread's side stream, on which the whole
    loop runs (:meth:`side_stream`); the graphs go with the solver.  A
    solver's graphs replay one at a time, each leaving its results in the
    loop state's buffers (outside the pool), so they may share the pool's
    memory with one another and with the graphs of solvers gone before."""

    def __init__(self, device):
        self.device = device
        if device not in _THREAD.streams:
            _THREAD.streams[device] = torch.cuda.Stream(device)
            _THREAD.pools[device] = self._anchored_pool(
                device, _THREAD.streams[device])
        self.stream = _THREAD.streams[device]
        self.pool = _THREAD.pools[device][0]
        self.graphs = {}

    @staticmethod
    def _anchored_pool(device, stream):
        """A new graph pool and the graph (with its one buffer) that keeps
        it open: (pool, graph, buffer)."""
        pool = torch.cuda.graph_pool_handle()
        buf = torch.zeros((), device=device)
        graph = torch.cuda.CUDAGraph()
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool,
                                capture_error_mode="thread_local")
            buf.add_(1)
            graph.capture_end()
        return pool, graph, buf

    @contextlib.contextmanager
    def side_stream(self):
        """The block on the capture stream, ordered after the current
        stream's work and before the current stream's later work."""
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            yield
        current.wait_stream(self.stream)

    def run(self, key, body) -> bool:
        """Run ``body``; True where it ran as a replay (a capture's
        included)."""
        graph = self.graphs.get(key)
        if graph is None:
            warm = _THREAD.warm
            if (self.device, key) not in warm:
                body()
                warm.add((self.device, key))
                return False
            graph = self.graphs[key] = self._capture(body)
            obs.count("vicalib.lm.graph_capture")
        with obs.span("vicalib.lm.replay"):
            graph.replay()
        return True

    def _capture(self, body):
        """A graph of ``body``'s device work on the current (side) stream;
        the capture runs nothing, the graph's replays do."""
        graph = torch.cuda.CUDAGraph()
        # thread_local: other threads of the process (a status server, a
        # frame reader) may still use the device during the capture
        graph.capture_begin(pool=self.pool,
                            capture_error_mode="thread_local")
        try:
            body()
        finally:
            graph.capture_end()
        return graph


def _iterate(data, loop: _LoopState, rotation_only, use_cov_weights,
             options: LMOptions, sigmas, graphs: _Graphs = None):
    """The LM iterations of a stage on ``loop``'s tensors, then the closing
    weight refresh; with ``graphs`` the bodies run through it.  Returns
    (iterations, converged)."""
    whole = isinstance(data, ProblemData)
    refresh = (use_cov_weights and data.imu is not None
               and sigmas is not None)

    def step():
        _step_body(data, loop, rotation_only, options)

    def weights():
        _weights_body(data, loop, sigmas)

    def run(key, body):
        if graphs is None:
            body()
            return False
        return graphs.run(key, body)

    it = 0
    done = False
    while not done and it < options.max_iters:
        with obs.span("vicalib.lm.iter"):
            if refresh and it % options.weight_refresh == 0:
                run("weights", weights)
            if run(("step", rotation_only), step):
                obs.count("vicalib.lm.graph_replay")
            it += 1
            with obs.span("vicalib.lm.wait"):
                # the one host read per iteration
                done = bool(loop.converged)
                if not whole:
                    done = data.agree(done)  # every rank takes rank 0's
    if refresh:
        run("weights", weights)
    return it, done


def _info_vec(data, loop: _LoopState, rotation_only, it, done):
    """The packed [final_cost, cam_sq (C), cam_cnt (C), iterations,
    converged] vector at ``loop``'s state and weights."""
    whole = isinstance(data, ProblemData)
    dtype = loop.state.t_wk.dtype
    final_cost, cam_sq, cam_cnt = (
        robust_costs(loop.state, data, loop.W, loop.inertial_scale,
                     rotation_only)
        if whole else data.robust_costs(loop.state,
                                        data.shard_weight(loop.W),
                                        loop.inertial_scale, rotation_only))
    return torch.cat([
        final_cost[None].to(dtype), cam_sq.to(dtype), cam_cnt.to(dtype),
        torch.tensor([it, float(done)], dtype=dtype,
                     device=loop.state.t_wk.device)])


def fused_solve(data: ProblemData, state: CalibState, fmask, smask,
                inertial_scale, rotation_only, use_cov_weights, seed_weight,
                options: LMOptions, sigmas):
    """Full LM solve on the device, every body run eagerly.  Returns
    (state, info_vec): the packed [final_cost, cam_sq (C), cam_cnt (C),
    iterations, converged] vector.  ``data`` is a ProblemData or a
    dist.sharded.ShardedProblem; the weights are computed on the full
    problem either way."""
    with full_precision_matmul():
        loop = _LoopState(state, seed_weight, fmask, smask, inertial_scale)
        loop.start(state, seed_weight, fmask, smask, inertial_scale,
                   options)
        it, done = _iterate(data, loop, rotation_only, use_cov_weights,
                            options, sigmas)
        return loop.state, _info_vec(data, loop, rotation_only, it, done)


def _graph_path(data, state: CalibState) -> bool:
    """Whether a solve replays its bodies as CUDA graphs: a CUDA state on
    a whole ProblemData (the sharded problem's step runs collectives)."""
    return state.t_wk.device.type == "cuda" and isinstance(data,
                                                           ProblemData)


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
    loop.  With ``mesh`` the observations and IMU factors are split over
    the mesh's shards (dist.sharded.shard_problem_arrays) and every
    iteration sums the shards' systems.  On a CUDA device without a mesh
    the solver keeps one loop state and its CUDA graphs for all its
    stages (:func:`_graph_path`)."""

    def __init__(self, data: ProblemData, options: LMOptions = LMOptions(),
                 sigmas=None, mesh=None):
        if mesh is not None:
            from ..dist.sharded import shard_problem_arrays
            data = shard_problem_arrays(data, mesh)
        self.data = data
        self.options = options
        self.sigmas = sigmas
        self._loop = None        # the graph path's _LoopState and _Graphs
        self._graphs = None

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
        args = (state, fmask, smask,
                torch.tensor(inertial_scale, dtype=dtype, device=dev),
                bool(rotation_only), bool(use_cov_weights), seed_weight)
        if _graph_path(self.data, state):
            state, raw = self._graphed_solve(*args)
        else:
            state, raw = fused_solve(self.data, *args, self.options,
                                     self.sigmas)
        if lazy:
            return state, raw
        return state, materialize_info(raw)

    def _graphed_solve(self, state, fmask, smask, inertial_scale,
                       rotation_only, use_cov_weights, seed_weight):
        """:func:`fused_solve` on the solver's own loop state, with the
        bodies replayed as CUDA graphs; the state comes back as copies."""
        loop = self._loop
        if loop is None or not loop.fits(state, seed_weight, fmask, smask):
            loop = self._loop = _LoopState(state, seed_weight, fmask, smask,
                                           inertial_scale)
            self._graphs = _Graphs(state.t_wk.device)
        with full_precision_matmul():
            with self._graphs.side_stream():
                loop.start(state, seed_weight, fmask, smask, inertial_scale,
                           self.options)
                it, done = _iterate(self.data, loop, rotation_only,
                                    use_cov_weights, self.options,
                                    self.sigmas, self._graphs)
            out = CalibState(*[x.clone() for x in loop.state])
            return out, _info_vec(self.data, loop, rotation_only, it, done)
