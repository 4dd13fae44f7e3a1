"""Offline summaries of ``torch.profiler`` traces (no TensorBoard needed).

Counterpart of ``mf_data_locality_tpu.utils.trace_summary``, the slot of
the reference's LIKWID hardware-counter reports (``benchmark.h:
186-215``): after :func:`.profiling.trace` has written a Chrome trace,
these helpers read it and sum the device events' durations per name, so a
kernel/copy breakdown is scriptable::

    with profiling.trace(log_dir):
        with profiling.marker("cg_solver"):
            solve()
    trace_summary.top_ops(log_dir, 5)  # [(kernel name, us), ...]

Device events are the card's tracks of the trace: complete events
(``ph == "X"``) of category ``kernel``, ``gpu_memcpy`` or
``gpu_memset``; not CPU operators (``cpu_op``), annotations
(``user_annotation``, ``gpu_user_annotation``) or runtime calls.
"""

from __future__ import annotations

import glob
import gzip
import json
import os

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _trace_events(log_dir: str) -> list[dict]:
    """The events of the newest trace file under ``log_dir``, searched
    recursively (``*.trace.json`` or ``*.trace.json.gz``); [] if none."""
    paths = [p for pattern in ("*.trace.json", "*.trace.json.gz")
             for p in glob.glob(os.path.join(log_dir, "**", pattern),
                                recursive=True)]
    if not paths:
        return []
    path = max(paths, key=os.path.getmtime)
    with (gzip.open(path, "rt") if path.endswith(".gz") else
          open(path)) as f:
        return json.load(f).get("traceEvents", [])


def _device_events(log_dir: str):
    """Yield (name, dur_us) for the device events of the newest trace
    under ``log_dir`` (nothing if no trace was written)."""
    for e in _trace_events(log_dir):
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            yield e.get("name", "?"), float(e.get("dur", 0.0))


def op_durations(log_dir: str) -> dict[str, float]:
    """Total device time (us) per op name over the captured window."""
    out: dict[str, float] = {}
    for name, dur in _device_events(log_dir):
        out[name] = out.get(name, 0.0) + dur
    return out


def top_ops(log_dir: str, n: int = 25) -> list[tuple[str, float]]:
    """The n device ops with the largest total duration (us)."""
    return sorted(op_durations(log_dir).items(), key=lambda kv: -kv[1])[:n]


def total_matching(log_dir: str, prefix: str) -> float:
    """Total device time (us) of the ops whose name starts with
    ``prefix`` (e.g. ``"Memcpy"`` for the copies)."""
    return sum(d for nm, d in op_durations(log_dir).items()
               if nm.startswith(prefix))
