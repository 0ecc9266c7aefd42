"""One run of one cell: set-up (the seed's files and one warm call), the
measured window, then the check against the reference and the result."""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

from . import driver, inputs, purity, reference, roofline, spec, trace


class ForbiddenImport(RuntimeError):
    pass


def power_limit():
    """nvidia-smi's name and power limit of the card, or None."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = res.stdout.strip().splitlines()
    return lines[0] if res.returncode == 0 and lines else None


def _import_program():
    import vicalib_tpu_torch
    where = os.path.dirname(os.path.abspath(vicalib_tpu_torch.__file__))
    if os.path.dirname(where) != spec.ROOT:
        raise ImportError("vicalib_tpu_torch was imported from %s, not from "
                          "this checkout (%s)" % (where, spec.ROOT))


@contextlib.contextmanager
def _traced(prof, shapes):
    """The traced run's profiler, with the harness's spans, around the
    window's first call."""
    with trace.spans(shapes), prof:
        yield


def _worst(per_call):
    out = {}
    for nums in per_call:
        for k, v in nums.items():
            out[k] = max(out.get(k, v), v)
    return out


def run_cell(cell, seed, seconds, trace_on, device, t0=None, n_frames=None,
             dtype=None, warm=True, stderr=sys.stderr):
    """Run ``cell`` (spec.Cell); returns the result's dict and the record
    the per-layer readers read.  ``t0`` is the perf_counter reading at
    which set-up began (the process start).  ``n_frames``, ``dtype`` and
    ``warm=False`` (no warm-up call) are for the tests and the control."""
    t0 = time.perf_counter() if t0 is None else t0
    seed = int(seed) % (1 << 63)
    dev = torch.device(device)
    _import_program()
    conf, traffic = cell.config, cell.traffic
    dtype = dtype or conf["solver"]["dtype"]
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    smi = power_limit() if dev.type == "cuda" else None
    work = tempfile.mkdtemp(prefix="vicalib-bench-")
    try:
        t_start = time.perf_counter()
        truth, paths = inputs.write_rig(conf, seed, work, dev, n_frames)
        if dev.type == "cuda":
            # the peak is the program's, not the renderer's
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        t_inputs = time.perf_counter()
        client = driver.Client(conf, traffic, paths, work, str(dev), dtype)
        try:
            if warm:
                client.call("warm")
            setup_s = time.perf_counter() - t0
            print("setup %.3f s: start and imports %.3f s, inputs %.3f s, "
                  "warm call %.3f s" % (
                      setup_s, t_start - t0, t_inputs - t_start,
                      time.perf_counter() - t_inputs), file=stderr)
            shapes = []
            prof = None
            if trace_on:
                prof = trace.profiler(dev)
                calls, window_s = client.window(seconds,
                                                _traced(prof, shapes))
            else:
                calls, window_s = client.window(seconds)
        finally:
            client.close()
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        bad = purity.forbidden_modules()
        if bad:
            raise ForbiddenImport("the run loaded %s" % ", ".join(bad))
        t_red = time.perf_counter()
        traced = trace.reduce(prof) if prof is not None else None
        if traced is not None:
            print("trace: %d device events in the window, reduced in %.1f s; "
                  "event kinds %s" % (traced["device_events"],
                                      time.perf_counter() - t_red,
                                      traced["event_kinds"]), file=stderr)
        del prof
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # the check: the plain reference on the same files, then every
        # call's outputs against its outputs
        t_ref = time.perf_counter()
        ref_err = ""
        try:
            ref_out, n_chunks = reference.plain_reference(
                conf, traffic, paths, truth, dev,
                log=lambda m: print(m, file=stderr))
        except Exception as e:    # a reference that fails judges nothing
            ref_out, n_chunks = None, None
            ref_err = "%s: %s" % (type(e).__name__, e)
            print("the reference failed: %s" % ref_err, file=stderr)
        print("reference %.1f s" % (time.perf_counter() - t_ref),
              file=stderr)
        per_call = []
        for c in calls:
            nums = reference.compare(reference.read_outputs(c.out), ref_out,
                                     truth.rig)
            if traffic.get("chunk"):
                nums.update(reference.compare_published(c.published,
                                                        n_chunks))
            per_call.append(nums)
        failed = sum(1 for c in calls if c.rc != 0)
        ok, checks = reference.judge(_worst(per_call), cell.limits)
        correct = bool(ok and failed == 0 and not ref_err)
        truth_nums = reference.compare(
            ref_out, reference.truth_outputs(truth), truth.rig)

        rec = {"config": conf, "traffic": traffic, "window_s": window_s,
               "calls": [dict(dataclasses.asdict(c), stages=reference.read_log(
                   os.path.join(c.out, "vicalibrator.log"))["stages"]
                   if os.path.exists(os.path.join(c.out, "vicalibrator.log"))
                   else []) for c in calls],
               "trace": traced,
               "kernel_bytes": sum(roofline.threshold_and_label_bytes(
                   s, conf["rig"]["cameras"]) for s in shapes)
               if trace_on else None,
               "peaks": roofline.PEAKS.get(kind)}
        metrics = {}
        if trace_on:
            for m in cell.per_layer:
                v = spec.reader(m["name"])(rec)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            for m in cell.end_to_end:
                v = (setup_s if m["name"] == "setup_s"
                     else driver.end_to_end(traffic, calls, window_s))
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        devinfo = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": int(peak)}
        if smi:
            devinfo["nvidia_smi"] = smi
        result = {"correct": correct, "attempted": len(calls),
                  "failed": failed, "metrics": metrics, "device": devinfo}
        if traced is not None:
            devinfo["busy_s"] = traced["busy_s"]
            devinfo["window_s"] = traced["window_s"]
            result["breakdown"] = {"device_ops": traced["device_ops"],
                                   "idle_gaps": traced["idle_gaps"]}
        for c in calls:
            if c.rc != 0:
                print("call %s failed: rc %d %s" % (c.out, c.rc, c.error),
                      file=stderr)
        # the reference against the simulator's truth: information only
        result["truth"] = truth_nums
        result["checks"] = checks
        return result, rec
    finally:
        shutil.rmtree(work, ignore_errors=True)
