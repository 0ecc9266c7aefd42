"""The program's own spans (vicalib_tpu_torch/obs.py), read from the rows
that end each call's result log (``-output_log_file``):

  span vicalib.lm.iter: n=20 s=4.612345

A call whose log has no such rows, as from a program without the spans,
reads as no spans, and a reader that needs one finds nothing (None)."""
from __future__ import annotations

import os
import re

from .readers import untraced

_ROW = re.compile(r"^span (\S+): n=(\d+) s=(\S+)$", re.M)


def spans(call):
    """``{name: (n, seconds)}`` of the call's result log."""
    try:
        with open(os.path.join(call["out"], "vicalibrator.log")) as f:
            text = f.read()
    except OSError:
        return {}
    return {name: (int(n), float(s)) for name, n, s in _ROW.findall(text)}


def per_call_spans(rec, fn):
    """Mean of ``fn(spans)`` over the window's completed untraced calls
    whose logs hold every span ``fn`` reads (a missing one: KeyError)."""
    vals = []
    for c in untraced(rec):
        try:
            vals.append(fn(spans(c)))
        except KeyError:
            continue
    return sum(vals) / len(vals) if vals else None


def per_call_span(rec, name):
    """Seconds in span ``name`` per calibration."""
    return per_call_spans(rec, lambda sp: sp[name][1])


def per_span(rec, name):
    """Seconds per occurrence of span ``name`` (per chunk, per iteration)."""
    return per_call_spans(rec, lambda sp: sp[name][1] / sp[name][0])
