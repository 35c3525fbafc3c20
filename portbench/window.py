"""The measured window: its clock, its pauses, and its trace.

A driver opens the window once every shape it uses is warm, runs its
traffic while :meth:`Window.running` says so, and closes it at a step
boundary.  Closing synchronises the device, so the window's wall time
covers all the work enqueued in it.  The only time taken out of the
window is a :meth:`Window.pause`: the device synchronised, the harness
copies what the correctness check needs to the host, and the clock
resumes; nothing of the program runs in a pause.

With ``trace`` the window runs under ``torch.profiler`` (CPU and CUDA
activities).  The profiler starts before the window opens, so its start-up
is not in the window; the window and its pauses are marked with
``record_function`` ranges, and the trace is cut to them.
"""
from __future__ import annotations

import contextlib
import time

import torch

WINDOW_SPAN = "portbench.window"
PAUSE_SPAN = "portbench.pause"
SPAN_PREFIX = "portbench."


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    def __init__(self, seconds: float, device, trace: bool = False):
        self.seconds = float(seconds)
        self.device = torch.device(device)
        self.trace = trace
        self.paused_s = 0.0
        self.t_open = self.t_close = None
        self.setup_peak_bytes = 0
        self.peak_bytes = 0
        self._prof = None
        self._span = None

    # -- clock -----------------------------------------------------------------
    def open(self):
        """Start the clock (and the trace's window range)."""
        synchronize(self.device)
        if self.device.type == "cuda":
            self.setup_peak_bytes = torch.cuda.max_memory_allocated(
                self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            synchronize(self.device)
        self._span = torch.profiler.record_function(WINDOW_SPAN)
        self._span.__enter__()
        self.t_open = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t_open - self.paused_s

    def running(self) -> bool:
        """True until ``seconds`` of window time have passed (call it at a
        point where the device has caught up, such as a host check)."""
        return self.elapsed() < self.seconds

    @contextlib.contextmanager
    def pause(self):
        """Take the enclosed host work out of the window."""
        synchronize(self.device)
        t0 = time.perf_counter()
        with torch.profiler.record_function(PAUSE_SPAN):
            yield
            synchronize(self.device)
        self.paused_s += time.perf_counter() - t0

    @staticmethod
    def span(name: str):
        """A harness range in the trace around a call into the program."""
        return torch.profiler.record_function(SPAN_PREFIX + name)

    def close(self) -> float:
        """Stop the clock at the device's last step; returns the window's
        wall time less its pauses."""
        synchronize(self.device)
        self.t_close = time.perf_counter()
        self._span.__exit__(None, None, None)
        if self.device.type == "cuda":
            self.peak_bytes = torch.cuda.max_memory_allocated(self.device)
        return self.window_s

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open - self.paused_s

    # -- trace -----------------------------------------------------------------
    def record(self) -> dict | None:
        """The trace cut to the window: device operations and host ranges
        as ``(name, start_ns, end_ns)``, the window and its pauses."""
        if self._prof is None:
            return None
        self._prof.__exit__(None, None, None)
        from torch.autograd import DeviceType

        device_ops, host_ops = [], []
        window, thread, pauses = None, None, []
        for ev in self._prof.profiler.kineto_results.events():
            t0 = ev.start_ns()
            t1 = t0 + ev.duration_ns()
            name = ev.name()
            if ev.device_type() == DeviceType.CUDA:
                # a harness range's device-side copy is no operation
                if not name.startswith(SPAN_PREFIX):
                    device_ops.append((name, t0, t1))
            elif name == WINDOW_SPAN:
                window, thread = (t0, t1), ev.start_thread_id()
            elif name == PAUSE_SPAN:
                pauses.append((t0, t1))
            else:
                host_ops.append((name, t0, t1, ev.start_thread_id()))
        self._prof = None
        if window is None:
            return None
        # what the harness's thread did: the program runs on it
        host_ops = [op[:3] for op in host_ops if op[3] == thread]
        return {"window_ns": window, "pauses_ns": sorted(pauses),
                "device_ops": device_ops, "host_ops": host_ops}
