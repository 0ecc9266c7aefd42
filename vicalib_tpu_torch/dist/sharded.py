"""Multi-device calibration: sharded normal-equation assembly.

Residual and Jacobian evaluation, the dominant cost and independent per
observation and per IMU factor, is split into contiguous shards.  Each
shard is assembled on its device into a partial arrow-plus-chain system;
the partial systems (a few MB even at 10k frames) are summed on the
state's device in shard order and then over processes
(multihost.all_reduce_sum), and the structured Schur solve over the
damping candidates runs replicated.  The candidates' trial costs are summed
the same way, and the accept/reject decision goes through the same
``lm.select_candidate`` as the single-device solve.

Frame-state arrays are replicated (O(F * 9) floats); only the
per-observation and per-IMU-factor arrays are split.  The IMU whitening
weights and outlier removal work on the full problem.
"""
from __future__ import annotations

import dataclasses

import torch

from ..solver.assemble import (ProblemData, assemble, robust_costs,
                               trial_costs)
from ..solver.lm import LMOptions
from ..solver.problem import CalibState
from ..solver.residuals import CameraObs, ImuFactors
from . import multihost
from .mesh import make_mesh

_IMU_ARRAYS = ("win_times", "win_gyro", "win_accel", "start", "end",
               "has_meas", "frame_i")


def _pad_rows(a, pad, value=0):
    """a with ``pad`` rows of ``value`` appended."""
    if pad == 0:
        return a
    fill = torch.full((pad,) + tuple(a.shape[1:]), value, dtype=a.dtype,
                      device=a.device)
    return torch.cat([a, fill])


def _split(n, n_shards, k):
    """Shard k's slice of n rows and its padding (ceil(n / n_shards) rows
    each, the last shards padded)."""
    per = -(-n // n_shards)
    sl = slice(min(k * per, n), min((k + 1) * per, n))
    return sl, per - (sl.stop - sl.start)


def shard_problem(data: ProblemData, n_shards: int) -> list[ProblemData]:
    """Split observations and IMU factors into n contiguous shards.

    Each shard is a ProblemData over the SAME frame set; shard k holds the
    k-th 1/n of each camera's observations and of the IMU factors.  Rows
    are padded to equal size with invalid entries: padded observations have
    valid 0 and padded factors has_meas False, so both give exact zeros."""
    shards = []
    for k in range(n_shards):
        obs_k = []
        for obs in data.obs:
            sl, pad = _split(len(obs.frame_idx), n_shards, k)
            obs_k.append(CameraObs(
                frame_idx=_pad_rows(obs.frame_idx[sl], pad),
                p_w=_pad_rows(obs.p_w[sl], pad),
                p_c=_pad_rows(obs.p_c[sl], pad),
                valid=_pad_rows(obs.valid[sl], pad)))
        imu_k = None
        if data.imu is not None:
            sl, pad = _split(len(data.imu.start), n_shards, k)
            imu_k = ImuFactors(
                **{f: _pad_rows(getattr(data.imu, f)[sl], pad)
                   for f in _IMU_ARRAYS}, slack=data.imu.slack)
        shards.append(ProblemData(obs=obs_k, imu=imu_k, layout=data.layout,
                                  n_frames=data.n_frames))
    return shards


@dataclasses.dataclass
class ShardedArrays:
    """Leading-axis-stacked shard arrays ((n_shards, ...) per field)."""
    obs_frame_idx: list
    obs_p_w: list
    obs_p_c: list
    obs_valid: list
    imu: dict | None


def stack_shards(shards: list[ProblemData]) -> ShardedArrays:
    C = len(shards[0].obs)
    field = lambda name, c: torch.stack([getattr(s.obs[c], name)
                                         for s in shards])
    imu = None
    if shards[0].imu is not None:
        imu = {f: torch.stack([getattr(s.imu, f) for s in shards])
               for f in _IMU_ARRAYS}
    return ShardedArrays([field("frame_idx", c) for c in range(C)],
                         [field("p_w", c) for c in range(C)],
                         [field("p_c", c) for c in range(C)],
                         [field("valid", c) for c in range(C)], imu)


def _to(x, dev):
    """A tensor or a CalibState on ``dev`` (a Python number as it is)."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, CalibState):
        return CalibState(*[a.to(dev) for a in x])
    return x


def _problem_to(data: ProblemData, dev) -> ProblemData:
    obs = [dataclasses.replace(o, **{f: getattr(o, f).to(dev) for f in (
        "frame_idx", "p_w", "p_c", "valid")}) for o in data.obs]
    imu = None if data.imu is None else dataclasses.replace(
        data.imu, **{f: getattr(data.imu, f).to(dev) for f in _IMU_ARRAYS})
    return dataclasses.replace(data, obs=obs, imu=imu)


class ShardedProblem:
    """A ProblemData split over a mesh: this process's shards, each on its
    device, with the assembly and costs summed over every shard.

    ``imu``, ``layout`` and ``n_frames`` are the full problem's, so the
    solver computes the IMU weights on the full problem; the weights reach
    the shards through :meth:`shard_weight`."""

    def __init__(self, data: ProblemData, mesh):
        self.mesh = mesh
        shards = shard_problem(data, mesh.n_shards)
        self.local = [_problem_to(shards[i], d)
                      for i, d in zip(mesh.shard_ids, mesh.devices)]
        self.imu = data.imu
        self.layout = data.layout
        self.n_frames = data.n_frames

    def shard_weight(self, weight_sqrt):
        """(K, 9, 9) weights -> the sharded (n_shards, K/n, 9, 9) layout,
        padded with identities (pad factors have no measurements)."""
        if weight_sqrt is None or self.imu is None:
            return None
        K = len(self.imu.start)
        n = self.mesh.n_shards
        per = -(-K // n)
        eye = torch.eye(9, dtype=weight_sqrt.dtype,
                        device=weight_sqrt.device)
        w = torch.cat([weight_sqrt, eye.expand(n * per - K, 9, 9)])
        return w.reshape(n, per, 9, 9)

    def _shards(self, weights):
        """(local problem, its device, its weights) per local shard."""
        ws = ([None] * len(self.local) if weights is None
              else multihost.global_shard(self.mesh, weights))
        return zip(self.local, self.mesh.devices, ws)

    def _sum(self, parts, dev):
        """Per-shard tuples of tensors -> their sums on ``dev`` (shard
        order), then summed over processes."""
        sums = [sum(p[i].to(dev) for p in parts)
                for i in range(len(parts[0]))]
        return multihost.all_reduce_sum(self.mesh, sums)

    def assemble(self, state, weights, frame_mask, shared_mask,
                 inertial_scale, rotation_only):
        """solver.assemble over every shard, summed: (D, U, Hfs, Hss, gf,
        gs, cost, n_residuals) on the state's device."""
        dev = state.t_wk.device
        parts = [assemble(_to(state, d), data, w, frame_mask.to(d),
                          shared_mask.to(d), _to(inertial_scale, d),
                          rotation_only)
                 for data, d, w in self._shards(weights)]
        return tuple(self._sum(parts, dev))

    def robust_costs(self, state, weights, inertial_scale, rotation_only):
        """solver.robust_costs over every shard, summed."""
        dev = state.t_wk.device
        parts = [robust_costs(_to(state, d), data, w, _to(inertial_scale, d),
                              rotation_only)
                 for data, d, w in self._shards(weights)]
        return tuple(self._sum(parts, dev))

    def trial_costs(self, trial_b, weights, inertial_scale, rotation_only):
        """Robust cost of each candidate of a batched trial state
        (n_cand,), summed over every shard."""
        dev = trial_b.t_wk.device
        parts = [(trial_costs(_to(trial_b, d), data, w,
                              _to(inertial_scale, d), rotation_only),)
                 for data, d, w in self._shards(weights)]
        return self._sum(parts, dev)[0]

    def agree(self, flag: bool) -> bool:
        """Rank 0's host decision on every rank (see multihost.agree)."""
        return multihost.agree(self.mesh, flag)


def shard_problem_arrays(data: ProblemData, mesh) -> ShardedProblem:
    """Lay out a ProblemData over ``mesh`` for the staged solver: this
    process's shards on their devices (what ``LMSolver(mesh=...)`` runs)."""
    return ShardedProblem(data, mesh)


class ShardedLMStep:
    """One LM step with mesh-sharded assembly and trial costs, decided by
    the same multi-candidate policy as the single-device solver
    (solver.lm.select_candidate through solver.lm._lm_step)."""

    def __init__(self, data: ProblemData, mesh=None, n_shards=None,
                 options: LMOptions = LMOptions()):
        self.options = options
        self.mesh = mesh if mesh is not None else make_mesh(
            n_shards, device=data.obs[0].p_w.device.type)
        self.n_shards = self.mesh.n_shards
        self.problem = shard_problem_arrays(data, self.mesh)

    def make_step(self):
        from ..solver.lm import _lm_step

        def step(state, lam, nu, weight_sqrt, fmask, smask, inertial_scale,
                 rotation_only):
            return _lm_step(self.problem, state, lam, nu, weight_sqrt,
                            fmask, smask, inertial_scale, rotation_only,
                            self.options)

        return step

    def sharded_weight(self, weight_sqrt):
        """(K, 9, 9) weights -> the (n_shards, K/n, 9, 9) layout the step
        takes (pad weights are the identity)."""
        return self.problem.shard_weight(weight_sqrt)
