"""The traced run: spans that the harness puts around the program's layers
from its own files, one torch.profiler trace over the window, and its
reduction to device busy time, the kernel's device time inside its spans,
and the breakdown (device operations and idle gaps by what the host was
doing)."""
from __future__ import annotations

import contextlib
import functools

import numpy as np

KERNEL_SPAN = "bench.threshold_and_label"
CALL_SPAN = "bench.call"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_ACTIVITIES = ("cuda_runtime", "cuda_driver")


def _span(name, fn, record=None):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapped(*a, **k):
        if record is not None:
            record(a, k)
        with record_function(name):
            return fn(*a, **k)
    return wrapped


@contextlib.contextmanager
def spans(kernel_shapes):
    """Spans around the calls into the program's layers, for as long as the
    context is open: each entry point call, frame reads, detection, the
    problem build, the staged solve, output and report writing, and the
    threshold_and_label wrapper (whose padded batch shapes are appended to
    ``kernel_shapes``).  ``detect/conics.py`` imports the wrapper by name,
    so the name is replaced there."""
    import importlib

    targets = [
        ("vicalib_tpu_torch.cli", "main", CALL_SPAN, None),
        ("vicalib_tpu_torch.io.sources", "CameraSource.read_batch",
         "bench.read", None),
        ("vicalib_tpu_torch.engine", "_detect_all", "bench.detect", None),
        ("vicalib_tpu_torch.solver.build", "build_problem", "bench.build",
         None),
        ("vicalib_tpu_torch.solver", "run_staged", "bench.solve", None),
        ("vicalib_tpu_torch.io.outputs", "write_cameras_xml", "bench.write",
         None),
        ("vicalib_tpu_torch.io.outputs", "write_poses_txt", "bench.write",
         None),
        ("vicalib_tpu_torch.report", "write_html_report", "bench.report",
         None),
        ("vicalib_tpu_torch.detect.conics", "threshold_and_label",
         KERNEL_SPAN,
         lambda a, k: kernel_shapes.append(tuple(a[0].shape))),
    ]
    saved = []
    try:
        for mod_name, path, name, rec in targets:
            owner = importlib.import_module(mod_name)
            *outer, attr = path.split(".")
            for part in outer:
                owner = getattr(owner, part)
            fn = getattr(owner, attr)
            saved.append((owner, attr, fn))
            setattr(owner, attr, _span(name, fn, rec))
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def profiler(device):
    """A profiler of the host and, on a CUDA device, of the device."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _union(starts, ends):
    """Merged [start, end) intervals, sorted."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    out_s, out_e = [], []
    cur_s, cur_e = None, None
    for a, b in zip(s.tolist(), e.tolist()):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                out_s.append(cur_s)
                out_e.append(cur_e)
            cur_s, cur_e = a, b
        elif b > cur_e:
            cur_e = b
    if cur_e is not None:
        out_s.append(cur_s)
        out_e.append(cur_e)
    return np.array(out_s, np.int64), np.array(out_e, np.int64)


def _kinds(events):
    """A function of an event to its (activity type, start ns, end ns).
    Builds whose events carry no activity type tell the kinds apart by
    device and name: device annotations carry the harness's span names,
    and CUDA runtime and driver calls are named ``cuda*`` or ``cu*``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ev0 = events[0]
    if hasattr(ev0, "start_ns"):
        def span(ev):
            s = ev.start_ns()
            return s, s + ev.duration_ns()
    else:
        def span(ev):
            s = int(ev.start_us() * 1000)
            return s, s + int(ev.duration_us() * 1000)
    if callable(getattr(ev0, "activity_type", None)):
        return lambda ev: (ev.activity_type(),) + span(ev)

    def kind(ev):
        name = ev.name()
        if ev.device_type() == cuda:
            act = ("gpu_user_annotation" if name.startswith("bench.")
                   else "kernel")
        else:
            act = "cuda_runtime" if name.startswith("cu") else "cpu_op"
        return (act,) + span(ev)
    return kind


def reduce(prof, top=10):
    """The trace's numbers, in seconds.

    - ``window_s``: from the first span of an entry point call to the end of
      the last; ``busy_s``: the union of device kernel, copy and set
      intervals inside it;
    - ``kernel_device_s``: the device time of every kernel launched while a
      KERNEL_SPAN was open (launch and kernel matched by CUPTI's
      correlation id), ``kernel_launches`` their count;
    - ``device_ops``: the device operations that took most time, by name;
    - ``idle_gaps``: the longest gaps between device work, each named by
      the harness's layer span and the innermost host operation open at
      its middle.
    """
    events = prof.profiler.kineto_results.events()
    if not events:
        return None
    kind = _kinds(events)
    kinds = {}
    dev_s, dev_e, dev_name, dev_corr, dev_link = [], [], [], [], []
    host_s, host_e, host_name = [], [], []
    launch = {}
    calls, kspans, layers = [], [], []
    for ev in events:
        act, s, e = kind(ev)
        kinds[act] = kinds.get(act, 0) + 1
        if act in DEVICE_ACTIVITIES:
            dev_s.append(s)
            dev_e.append(e)
            dev_name.append(ev.name())
            dev_corr.append(ev.correlation_id())
            dev_link.append(ev.linked_correlation_id())
        elif act in LAUNCH_ACTIVITIES:
            launch[ev.correlation_id()] = s
        elif act in ("cpu_op", "user_annotation"):
            name = ev.name()
            if name == CALL_SPAN:
                calls.append((s, e))
            elif name == KERNEL_SPAN:
                kspans.append((s, e))
            elif name.startswith("bench."):
                layers.append((s, e, name))
            host_s.append(s)
            host_e.append(e)
            host_name.append(name)
    if not calls or not dev_s:
        return None
    w0 = min(s for s, _ in calls)
    w1 = max(e for _, e in calls)
    dev_s = np.array(dev_s, np.int64)
    dev_e = np.array(dev_e, np.int64)
    inside = (dev_e > w0) & (dev_s < w1)
    us, ue = _union(np.clip(dev_s[inside], w0, w1),
                    np.clip(dev_e[inside], w0, w1))
    busy_ns = int((ue - us).sum())

    # kernels launched inside a kernel span: CUPTI gives a kernel and its
    # launch one correlation id (older builds link it the other way)
    k_ns, k_n = 0, 0
    if kspans:
        ks = np.array(sorted(kspans), np.int64)
        for ids in (dev_corr, dev_link):
            n, t_ns = 0, 0
            for i, c in enumerate(ids):
                t = launch.get(c)
                if t is None:
                    continue
                j = np.searchsorted(ks[:, 0], t, side="right") - 1
                if j >= 0 and t <= ks[j, 1]:
                    t_ns += int(dev_e[i] - dev_s[i])
                    n += 1
            if n > k_n:
                k_ns, k_n = t_ns, n

    by_name = {}
    for n, a, b, w in zip(dev_name, dev_s.tolist(), dev_e.tolist(),
                          inside.tolist()):
        if w:
            by_name[n] = by_name.get(n, 0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    gs = np.concatenate([[w0], ue])
    ge = np.concatenate([us, [w1]])
    glen = ge - gs
    hs = np.array(host_s, np.int64)
    he = np.array(host_e, np.int64)
    gaps = []
    for j in np.argsort(-glen)[:top]:
        if glen[j] <= 0:
            break
        mid = (gs[j] + ge[j]) // 2
        layer = max((ly for ly in layers if ly[0] <= mid <= ly[1]),
                    key=lambda ly: ly[0], default=(0, 0, CALL_SPAN))
        cover = [i for i in np.nonzero((hs <= mid) & (he >= mid))[0]
                 if not host_name[i].startswith("bench.")]
        inner = (host_name[max(cover, key=lambda i: hs[i])] if cover
                 else "(host, no op)")
        gaps.append([("%s / %s" % (layer[2], inner))[:160],
                     float(glen[j]) / 1e9])
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9,
            "kernel_device_s": k_ns / 1e9, "kernel_launches": k_n,
            "device_events": int(inside.sum()),
            "device_ops": [[n[:160], v / 1e9] for n, v in ops],
            "idle_gaps": gaps, "event_kinds": kinds}
