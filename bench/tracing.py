"""The traced windows: ``torch.profiler`` over whole SFPL epochs, read into
the quantities that the per-layer metrics take.

Two passes, one after the other, over the same number of epochs:

* the device pass (``Busy``): the CUDA activity alone, without operator
  rows or shapes, so that the host is slowed little and the device's busy
  time and idle share read as they are in the untraced window;
* the full pass (``Trace``): operator rows with their shapes as well, for
  what needs to know which host call launched a kernel.

The profile's Chrome trace is written to a temporary file under
``$TMPDIR``, read back and deleted. From it:

* the window, the host span ``bench.window`` around the traced epochs and
  the synchronise that ends them;
* every device operation (kernel, copy, fill) inside it, its busy time as
  the union of their intervals, and its idle gaps;
* the host call that launched each kernel (by correlation id) and the
  operator rows open around that call on its thread: a kernel under
  ``aten::convolution`` or ``aten::convolution_backward`` belongs to that
  convolution, whose shapes the profile records;
* the launch calls of the runtime and the driver API.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

import torch

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel",
                   "cudaLaunchCooperativeKernel", "cuLaunchCooperativeKernel")
CONV_OPS = ("aten::convolution", "aten::convolution_backward")
ELEM_BYTES = {"c10::BFloat16": 2, "c10::Half": 2, "float": 4}


def profile(fn, full=True):
    """Run ``fn()`` and a synchronise under the profiler; returns the
    trace's events. ``full``: operator rows and their shapes too, else
    the CUDA activity alone."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] if full else []
    with torch_profile(activities=acts + [ProfilerActivity.CUDA],
                       record_shapes=full) as prof:
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    return doc["traceEvents"] if isinstance(doc, dict) else doc


def _parse(value):
    return json.loads(value.replace("True", "true").replace("False",
                                                            "false"))


def _union(intervals):
    """Merged, sorted ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _stacks(ops, points):
    """For each point (``ts``), the operator rows open there, outermost
    first: ``ops`` sorted by start (longer first on ties), each
    ``(start, end, index)``; ``points`` sorted."""
    out, stack, i = [], [], 0
    for t in points:
        while i < len(ops) and ops[i][0] <= t:
            while stack and stack[-1][1] < ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append([s[2] for s in stack if s[1] >= t])
    return out


def _device_ops(events, inside=lambda e: True):
    return [e for e in events if e.get("cat") in DEVICE_CATS
            and e.get("ph") == "X" and inside(e)]


def _api_calls(events, inside=lambda e: True):
    return [e for e in events if e.get("cat") in ("cuda_runtime",
                                                  "cuda_driver")
            and e.get("ph") == "X" and inside(e)]


def _busy_s(ops):
    return sum(e - s for s, e in _union(
        (float(o["ts"]), float(o["ts"]) + float(o["dur"])) for o in ops)) \
        * 1e-6


class Busy:
    """The device pass: its window runs from the first runtime or driver
    call to the end of the last call or device operation (the closing
    synchronise), and ``busy_s`` is the union of its device operations.
    ``samples``: the client samples of the epochs it held."""

    def __init__(self, events, *, samples):
        self.samples = samples
        ops, calls = _device_ops(events), _api_calls(events)
        if not ops or not calls:
            raise RuntimeError("the device pass holds no device operation")
        ends = [float(e["ts"]) + float(e["dur"]) for e in ops + calls]
        self.window_s = (max(ends) - min(float(e["ts"]) for e in calls)) \
            * 1e-6
        self.busy_s = _busy_s(ops)

    def idle_pct(self):
        """The share of the window that no device operation covers."""
        if self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)


class Trace:
    """What one traced window holds, for the metric readers; ``busy`` is
    the same run's device pass."""

    def __init__(self, events, *, cell, steps, samples, busy=None):
        self.cell = cell
        self.steps = steps
        self.samples = samples
        self.busy = busy
        self.tf32 = bool(torch.backends.cudnn.allow_tf32)
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("ph") == "X"]
        if not win:
            raise RuntimeError(f"the profile holds no {WINDOW} span")
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        self.window_s = (w1 - w0) * 1e-6
        inside = lambda e: w0 <= float(e["ts"]) <= w1
        dev = _device_ops(events, inside)
        self.device_ops = dev
        self.kernels = [e for e in dev if e["cat"] == "kernel"]
        spans = _union((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in dev)
        self.busy_s = _busy_s(dev)
        self.gaps = [(a[1], b[0]) for a, b in zip(
            [[w0, w0]] + spans, spans + [[w1, w1]]) if b[0] > a[1]]
        calls = _api_calls(events, inside)
        self.launch_calls = [e for e in calls
                             if e["name"].startswith(LAUNCH_PREFIXES)]
        self.ops = [e for e in events if e.get("cat") in ("cpu_op",
                                                          "user_annotation")
                    and e.get("ph") == "X" and inside(e)]
        self._attribute(calls)
        self.main_tid = win[0]["tid"]

    def _ops_by_tid(self):
        by = defaultdict(list)
        for i, e in enumerate(self.ops):
            s = float(e["ts"])
            by[e["tid"]].append((s, s + float(e.get("dur", 0)), i))
        for v in by.values():
            v.sort(key=lambda r: (r[0], -r[1]))
        return by

    def _attribute(self, calls):
        """Each kernel's launching call, and the convolution row (if any)
        open around that call."""
        by_corr = {}
        for e in calls:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                by_corr[c] = e
        ops_tid = self._ops_by_tid()
        want = defaultdict(list)        # tid -> [(ts, kernel index)]
        for k, e in enumerate(self.kernels):
            call = by_corr.get(e.get("args", {}).get("correlation"))
            if call is not None:
                want[call["tid"]].append((float(call["ts"]), k))
        self.kernel_conv = [None] * len(self.kernels)
        self.kernel_host = [None] * len(self.kernels)
        for tid, pts in want.items():
            pts.sort()
            stacks = _stacks(ops_tid.get(tid, []), [t for t, _ in pts])
            for (_, k), st in zip(pts, stacks):
                names = [self.ops[i]["name"] for i in st]
                self.kernel_host[k] = names[-1] if names else None
                conv = [i for i in st if self.ops[i]["name"] in CONV_OPS]
                if conv:
                    self.kernel_conv[k] = conv[0]

    def summary(self):
        """Counts of the window, for the run's log."""
        by_cat = defaultdict(int)
        for e in self.launch_calls:
            by_cat[e["cat"]] += 1
        return {"window_s": self.window_s, "busy_s": self.busy_s,
                "kernels": len(self.kernels),
                "device_ops": len(self.device_ops),
                "launch_calls": dict(by_cat),
                "conv_rows": len(self.conv_calls()), "steps": self.steps,
                "device_pass": (None if self.busy is None else
                                {"window_s": self.busy.window_s,
                                 "busy_s": self.busy.busy_s})}

    # ----------------------------------------------------------------------
    # quantities the readers take

    def launches_per_step(self):
        """Kernels of the window (one launch call each) over its steps."""
        if not self.kernels or not self.steps:
            return None
        return len(self.kernels) / self.steps

    def family_time(self, symbols):
        """``{family: (kernels, device seconds)}`` for kernels whose name
        holds the family's symbol."""
        out = {}
        for fam, sym in symbols.items():
            ks = [e for e in self.kernels if sym in e["name"]]
            out[fam] = (len(ks), sum(float(e["dur"]) for e in ks) * 1e-6)
        return out

    def conv_calls(self):
        """Every convolution row that launched kernels in the window:
        ``(name, input dims, concrete inputs, input types, device s)``."""
        dev = defaultdict(float)
        for k, c in enumerate(self.kernel_conv):
            if c is not None:
                dev[c] += float(self.kernels[k]["dur"]) * 1e-6
        out = []
        for i, secs in sorted(dev.items()):
            a = self.ops[i].get("args", {})
            out.append((self.ops[i]["name"], a.get("Input Dims"),
                        a.get("Concrete Inputs"), a.get("Input type"),
                        secs))
        return out

    def breakdown(self, top=10):
        """The device operations that took most time, and the idle gaps
        summed by the innermost host row open on the main thread at each
        gap's middle."""
        by_name = defaultdict(float)
        for e in self.device_ops:
            by_name[e["name"][:120]] += float(e["dur"]) * 1e-6
        ops = self._ops_by_tid().get(self.main_tid, [])
        mids = sorted(((s + e) / 2, e - s) for s, e in self.gaps)
        idle = defaultdict(float)
        for (_, length), st in zip(mids, _stacks(ops, [m for m, _ in
                                                       mids])):
            name = self.ops[st[-1]]["name"] if st else "(no host row)"
            if name == WINDOW and len(st) == 1:
                name = "(python, outside operator rows)"
            idle[name[:120]] += length * 1e-6
        rank = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                    key=lambda kv: -kv[1])
                          [:top]]
        return {"device_ops": rank(by_name), "idle_gaps": rank(idle)}


def conv_least_seconds(call, peak_for):
    """Least time of one recorded convolution row from its shapes:
    forward (``aten::convolution``), or the data-grad and weight-grad that
    ``aten::convolution_backward``'s output mask asks for."""
    from bench import yardstick as Y
    name, dims, concrete, types, _ = call
    elem = ELEM_BYTES.get(types[0])
    if elem is None:
        return None
    peak = peak_for(types[0])
    if name == "aten::convolution":
        x, w = dims[0], dims[1]
        stride, pad, dil = (_parse(concrete[i]) for i in (3, 4, 5))
        ho = Y.conv_out(x[2], w[2], stride[0], pad[0], pad[0], dil[0])
        wo = Y.conv_out(x[3], w[3], stride[1], pad[1], pad[1], dil[1])
        y = [x[0], w[0], ho, wo]
        flops, nbytes = Y.conv_call_cost(x, w, y, elem)
    else:
        dy, x, w = dims[0], dims[1], dims[2]
        mask = _parse(concrete[10])
        flops, nbytes = Y.conv_call_cost(x, w, dy, elem, fwd=False,
                                         dgrad=bool(mask[0]),
                                         wgrad=bool(mask[1]))
    return Y.least_seconds(flops, nbytes, peak)


def cuda_peak_for(tf32):
    """Compute peak for a recorded input type."""
    from bench import yardstick as Y

    def peak(t):
        if t == "float":
            return Y.PEAK_FLOPS["tf32" if tf32 else "float32"]
        return Y.PEAK_FLOPS["bfloat16"]
    return peak
