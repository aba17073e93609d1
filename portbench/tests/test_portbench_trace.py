"""The traced run's reading of device work: kernels, copies and sets are
work; the profiler's own records and the host's ranges mirrored on the
device are not, on a torch that names each activity and on one that does
not.  The card test profiles real work on the card."""

import json
import subprocess
import sys

import pytest

from portbench import harness, trace


class _Dev:
    def __init__(self, name):
        self.name = name


class _Event:
    """A profiler event as an older torch gives it (no ``activity_type``)."""

    def __init__(self, name, device, start, end, corr=0, annotation=False):
        self._name, self._dev, self._s, self._e = name, _Dev(device), start, end
        self._corr, self._ann = corr, annotation

    def name(self):
        return self._name

    def device_type(self):
        return self._dev

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._ann


class _Named(_Event):
    """The same event as a newer torch gives it."""

    def __init__(self, kind, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._kind = kind

    def activity_type(self):
        return self._kind


def _events(named):
    rows = [
        # kind, name, device, start, end, correlation, annotation
        ("user_annotation", trace.WINDOW, "CPU", 0, 1000, 1, True),
        ("cuda_runtime", "cudaGraphLaunch", "CPU", 10, 20, 7, False),
        ("cuda_runtime", "cudaMemcpyAsync", "CPU", 500, 510, 8, False),
        ("kernel", "gemvx_kernel", "CUDA", 100, 300, 7, False),
        ("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", "CUDA", 600, 650, 8, False),
        ("gpu_memset", "Memset (Device)", "CUDA", 700, 710, 7, False),
        ("gpu_user_annotation", trace.WINDOW, "CUDA", 100, 900, 1, True),
        ("gpu_user_annotation", "zfista.span", "CUDA", 100, 900, 2, True),
        ("overhead", "Activity Buffer Request", "CUDA", 800, 990, 0, False),
        ("overhead", "Buffer Flush", "CUDA", 0, 90, 0, False),
    ]
    if named:
        return [_Named(r[0], *r[1:]) for r in rows]
    return [_Event(*r[1:]) for r in rows]


@pytest.mark.parametrize("named", [True, False], ids=["activity_type", "no_activity_type"])
def test_only_kernels_copies_and_sets_are_device_work(named):
    t = trace.Trace(_events(named))
    assert sorted(t.dev_name) == ["Memcpy DtoH (Device -> Pinned)", "Memset (Device)", "gemvx_kernel"]
    assert t.window_s == pytest.approx(1e-6)
    assert t.busy_s == pytest.approx((200 + 50 + 10) * 1e-9)
    ops = dict(t.device_ops())
    assert "Activity Buffer Request" not in ops and "zfista.span" not in ops


@pytest.mark.card
def test_device_work_on_the_card(card):
    """On the card's torch: a graph's kernels, eager kernels and copies
    are read as work, and no range or profiler record is."""
    code = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
from portbench import trace
a = torch.randn(2000, 2000, device="cuda"); v = torch.randn(2000, device="cuda")
s = torch.cuda.Stream(); s.wait_stream(torch.cuda.current_stream())
with torch.cuda.stream(s):
    w = a @ v
torch.cuda.current_stream().wait_stream(s)
g = torch.cuda.CUDAGraph()
with torch.cuda.graph(g):
    w = a @ v
    w2 = w * 2 + 1
torch.cuda.synchronize()
prof = trace.start()
with torch.profiler.record_function(trace.WINDOW):
    with torch.profiler.record_function("zfista.span"):
        for _ in range(20):
            g.replay()
            h = w2.cpu()
            w.zero_()
    torch.cuda.synchronize()
t = trace.read(trace.stop(prof))
names = set(t.dev_name)
print(json.dumps({"names": sorted(names), "busy": t.busy_s, "window": t.window_s}))
"""
    proc = subprocess.run([sys.executable, "-c", code, str(harness.ROOT)], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    names = out["names"]
    assert any("gemv" in n or "gemm" in n for n in names), names
    assert any(n.startswith("Memcpy") for n in names)
    assert any("elementwise" in n for n in names), names
    assert not set(names) & (trace.PROFILER_OVERHEAD | {trace.WINDOW, "zfista.span"}), names
    assert 0 < out["busy"] < out["window"]
