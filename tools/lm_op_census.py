"""Op census of one LM step of the port, phase by phase.

For one source tree of the repository (the first argument: this checkout,
or an unpacked older commit to compare with), builds a stereo VI problem
from the port's simulator at the ``vi_sim`` and ``euroc`` shapes and counts,
for one eager call of each phase in float64: the aten ops dispatched
(views left out) and, on a CUDA device, the device kernels that
torch.profiler records, their device ms and the median CUDA-event ms of
five calls.  Phases: the LM step body, the IMU residuals and Jacobians,
the IMU residuals of 3 trial candidates, the Schur solves of 3 damping
candidates and the IMU weight refresh.

    python tools/lm_op_census.py <tree>            # on the card
    DEV=cpu SHAPES='{"small": [24, 10.0, 100.0]}' \\
        python tools/lm_op_census.py .             # ops only, on the CPU

SHAPES maps a name to (frames, frame rate Hz, IMU rate Hz).  Prints one
JSON line per shape, then ``CENSUS <json>``.  Imports nothing of JAX.
"""
import importlib
import json
import os
import sys
import time

import numpy as np
import torch
from torch.func import vmap
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

SHAPES = {"vi_sim": [192, 10.0, 100.0], "euroc": [400, 20.0, 200.0]}


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.n += 1
        return func(*args, **(kwargs or {}))


def census(fn, dev):
    """Ops of one call of fn; on CUDA also its device kernels and ms."""
    if dev != "cuda":
        with _Ops() as m:
            fn()
        return {"ops": m.n}
    fn()
    torch.cuda.synchronize()
    with _Ops() as m:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages() if e.device_type == cuda]
    dev_ms = sum(getattr(e, "self_device_time_total", 0.0)
                 for e in events) / 1e3
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return {"ops": m.n, "device_kernels": sum(e.count for e in events),
            "device_ms": round(dev_ms, 4),
            "eager_ms": round(float(np.median(times)), 3)}


def main(tree, dev, shapes):
    sys.path.insert(0, os.path.abspath(tree))
    from vicalib_tpu_torch.io import sim
    from vicalib_tpu_torch.solver import lm, stages
    from vicalib_tpu_torch.solver import problem as tp
    from vicalib_tpu_torch.solver.build import problem_from_sim
    from vicalib_tpu_torch.solver.problem import CalibState
    from vicalib_tpu_torch.solver.schur import schur_solve
    res_mod = importlib.import_module("vicalib_tpu_torch.solver.residuals")
    asm = importlib.import_module("vicalib_tpu_torch.solver.assemble")

    f64 = torch.float64
    out = {"tree": tree, "card": (torch.cuda.get_device_name(0)
                                  if dev == "cuda" else dev)}
    for name, (F, fr, ir) in shapes.items():
        cfg = sim.default_stereo_vi_config(
            n_frames=F, model="linear", distance=0.35, orbit_radius=0.12,
            frame_rate=fr, imu_rate=ir,
            gyro_bias=np.array([0.01, -0.02, 0.015]),
            accel_bias=np.array([0.05, 0.02, -0.04]), time_offset=0.004)
        t0 = time.time()
        data, state = problem_from_sim(sim.simulate(cfg, device=dev),
                                       use_imu=True, device=dev)
        K, M = data.imu.win_times.shape
        flags = tp.StageFlags(calibrate_imu=True, inertial_active=True,
                              rotation_only=False, bias_active=True)
        fmask = tp.frame_mask(flags, data.n_frames, f64, dev)
        smask = tp.shared_mask(data.layout, flags, f64, dev)
        W = lm.seed_weights(K, f64, dev)
        one = torch.ones((), dtype=f64, device=dev)
        opts = lm.LMOptions()
        loop = lm._LoopState(state, W, fmask, smask, one)
        loop.start(state, W, fmask, smask, one, opts)
        sig = (stages.IMU_GYRO_SIGMA, stages.IMU_ACCEL_SIGMA)
        res = {"K": K, "M": M, "F": data.n_frames,
               "build_s": round(time.time() - t0, 2)}
        with lm.full_precision_matmul():
            res["lm_step"] = census(
                lambda: lm._step_body(data, loop, False, opts), dev)
            loop.start(state, W, fmask, smask, one, opts)
            res["imu_jacobians"] = census(
                lambda: res_mod.imu_residuals_and_jacobians(
                    state, data.imu, W, False), dev)
            trial = CalibState(*[torch.stack([x, x, x]) for x in state])
            if hasattr(res_mod, "imu_trial_residuals"):
                trial_fn = lambda: res_mod.imu_trial_residuals(
                    trial, data.imu, W, False)
            else:   # trees before the IMU factor kernel
                trial_fn = lambda: vmap(lambda s: res_mod.imu_residuals(
                    CalibState(*s), data.imu, W, False))(tuple(trial))
            res["imu_trial_3"] = census(trial_fn, dev)
            D, U, Hfs, Hss, gf, gs, _, _ = asm.assemble(
                state, data, W, fmask, smask, one, False)
            lams = lm.candidate_lams(torch.tensor(1e-4, dtype=f64,
                                                  device=dev), opts)
            res["schur_3"] = census(lambda: vmap(lambda lam: schur_solve(
                D, U, Hfs, Hss, gf, gs, damping=lam))(lams), dev)
            res["imu_weights"] = census(
                lambda: lm._weights_body(data, loop, sig), dev)
        out[name] = res
        print(name, json.dumps(res), flush=True)
    print("CENSUS " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], os.environ.get("DEV", "cuda"),
         json.loads(os.environ["SHAPES"]) if "SHAPES" in os.environ
         else SHAPES)
