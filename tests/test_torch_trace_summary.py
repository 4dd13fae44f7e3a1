"""PyTorch port: ``utils/trace_summary.py`` and ``utils/profiling.trace`` /
``marker`` against the JAX package's ``utils.trace_summary``.

The JAX test's synthetic events are written twice: in xprof's form (a
``/device:TPU:0`` process track, ``plugins/profile/run1/*.trace.json.gz``)
for the JAX summary, and in torch.profiler's Chrome form (device events
by category) for the port's; ``op_durations``, ``top_ops`` and
``total_matching`` must be equal.  A real CPU trace holds the
``cg_solver`` annotation and no device event.
"""

import gzip
import json
import os

import pytest
import torch

from mf_data_locality_tpu.utils import trace_summary as jts
from mf_data_locality_tpu_torch.utils import profiling
from mf_data_locality_tpu_torch.utils import trace_summary as ts

# (name, duration us, category in torch's form; None: on a host track)
EVENTS = (("copy.1", 10.0, "kernel"), ("copy.1", 5.0, "kernel"),
          ("fusion.7", 40.0, "kernel"), ("Memcpy DtoH", 3.0, "gpu_memcpy"),
          ("Memset", 1.5, "gpu_memset"), ("copy.9", 99.0, None))
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime",
                   "gpu_user_annotation")


def _write_xprof(root) -> str:
    events = [{"ph": "M", "pid": 1, "name": "process_name",
               "args": {"name": "/device:TPU:0"}},
              {"ph": "M", "pid": 2, "name": "process_name",
               "args": {"name": "Host threads"}}]
    events += [{"ph": "X", "pid": 1 if cat else 2, "name": name, "dur": dur,
                "ts": 10 * k} for k, (name, dur, cat) in enumerate(EVENTS)]
    d = os.path.join(root, "plugins", "profile", "run1")
    os.makedirs(d)
    with gzip.open(os.path.join(d, "host.trace.json.gz"), "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(root)


def _write_torch(root, compressed: bool, names=EVENTS) -> str:
    events = [{"ph": "X", "cat": cat or HOST_CATEGORIES[k % 4], "name": name,
               "pid": 0, "tid": 7, "dur": dur, "ts": 10 * k}
              for k, (name, dur, cat) in enumerate(names)]
    # the host tracks' other records, none of them a device event
    events += [{"ph": "X", "cat": c, "name": "copy.1", "pid": 1, "tid": 1,
                "dur": 1000.0, "ts": 0} for c in HOST_CATEGORIES]
    events += [{"ph": "i", "cat": "kernel", "name": "copy.1", "ts": 0},
               {"ph": "M", "name": "process_name", "pid": 0,
                "args": {"name": "python"}}]
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "host.pt.trace.json")
    if compressed:
        with gzip.open(path + ".gz", "wt") as f:
            json.dump({"traceEvents": events}, f)
    else:
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)
    return str(root)


@pytest.mark.parametrize("compressed", [False, True],
                         ids=["json", "json.gz"])
def test_summaries_match_jax(tmp_path, compressed):
    """The same events give the JAX summary's numbers, from a plain and
    from a gzipped trace."""
    jd = _write_xprof(tmp_path / "xprof")
    d = _write_torch(tmp_path / "torch", compressed)
    assert ts.op_durations(d) == jts.op_durations(jd) == {
        "copy.1": 15.0, "fusion.7": 40.0, "Memcpy DtoH": 3.0, "Memset": 1.5}
    for n in (1, 2, 25):
        assert ts.top_ops(d, n) == jts.top_ops(jd, n)
    assert ts.top_ops(d, 1) == [("fusion.7", 40.0)]
    for prefix in ("copy.", "Mem", "fusion", "none"):
        assert ts.total_matching(d, prefix) == jts.total_matching(jd, prefix)
    assert ts.total_matching(d, "copy.") == 15.0


def test_empty_dir(tmp_path):
    assert ts.op_durations(str(tmp_path)) == {} == jts.op_durations(
        str(tmp_path))
    assert ts.top_ops(str(tmp_path)) == []
    assert ts.total_matching(str(tmp_path), "copy.") == 0.0


def test_newest_trace_is_read(tmp_path):
    """Two traces under the directory (one in a subdirectory): the newest
    by modification time is summed, as the JAX summary does."""
    old = _write_torch(tmp_path / "a" / "b", False)
    new = _write_torch(tmp_path, True, names=(("late", 2.0, "kernel"),))
    os.utime(os.path.join(old, "host.pt.trace.json"), (1, 1))
    assert ts.op_durations(str(tmp_path)) == {"late": 2.0}
    assert ts.op_durations(new) == {"late": 2.0}


def test_cpu_trace_capture(tmp_path):
    """``profiling.trace`` with ``marker`` on the CPU writes one
    ``*.pt.trace.json`` holding the annotations and the CPU operators; it
    has no device track, so the summaries are empty."""
    with profiling.trace(str(tmp_path)):
        with profiling.marker("cg_solver"):
            with profiling.marker("matvec"):
                y = torch.sum(torch.ones(8) * 2)
    assert float(y) == 16.0
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    events = ts._trace_events(str(tmp_path))
    notes = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert notes == {"cg_solver", "matvec"}
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert ts.op_durations(str(tmp_path)) == {}
    assert ts.total_matching(str(tmp_path), "") == 0.0


def test_profiler_errors_surface(tmp_path):
    """No guard swallows an error inside the traced block (the JAX
    helpers' try/except has no counterpart here)."""
    with pytest.raises(ZeroDivisionError):
        with profiling.trace(str(tmp_path)):
            with profiling.marker("cg_solver"):
                1 / 0
