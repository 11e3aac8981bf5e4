"""Prometheus-style metrics (text exposition format, no external deps); a
copy of moshi_tpu/serve/metrics.py.

Behavioral reference: `rust/moshi-server/src/metrics.rs:11-113` — per-module
counters/gauges/histograms (`asr_model_step_duration` with 20-80 ms buckets,
open channels, steps per connection) exposed at `/metrics`
(`main.rs:482-500`).
"""

import threading
import time


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, v: float = 1.0):
        with self._lock:
            self.value += v

    def expose(self) -> str:
        return (f"# HELP {self.name} {self.help}\n# TYPE {self.name} counter\n"
                f"{self.name} {self.value}\n")


class Gauge:
    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float):
        with self._lock:
            self.value = v

    def inc(self, v: float = 1.0):
        with self._lock:
            self.value += v

    def dec(self, v: float = 1.0):
        with self._lock:
            self.value -= v

    def expose(self) -> str:
        return (f"# HELP {self.name} {self.help}\n# TYPE {self.name} gauge\n"
                f"{self.name} {self.value}\n")


class Histogram:
    """Cumulative-bucket histogram; default buckets follow the reference's
    20-80 ms step-duration envelope (metrics.rs:21-25)."""

    DEFAULT_BUCKETS = (0.002, 0.005, 0.010, 0.020, 0.030, 0.040, 0.050, 0.060,
                       0.070, 0.080, 0.120, 0.250, 0.500, 1.0)

    def __init__(self, name: str, help_: str = "", buckets=None):
        self.name, self.help = name, help_
        self.buckets = tuple(buckets) if buckets else self.DEFAULT_BUCKETS
        self.counts = [0] * (len(self.buckets) + 1)
        self.total = 0.0
        self.n = 0
        self._lock = threading.Lock()

    def observe(self, v: float):
        with self._lock:
            self.total += v
            self.n += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    def time(self):
        return _Timer(self)

    def expose(self) -> str:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        cum = 0
        for b, c in zip(self.buckets, self.counts):
            cum += c
            out.append(f'{self.name}_bucket{{le="{b}"}} {cum}')
        out.append(f'{self.name}_bucket{{le="+Inf"}} {self.n}')
        out.append(f"{self.name}_sum {self.total}")
        out.append(f"{self.name}_count {self.n}")
        return "\n".join(out) + "\n"


class _Timer:
    def __init__(self, hist: Histogram):
        self.hist = hist

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.perf_counter() - self.t0)


class Registry:
    def __init__(self):
        self.metrics: list = []

    def counter(self, name, help_=""):
        m = Counter(name, help_)
        self.metrics.append(m)
        return m

    def gauge(self, name, help_=""):
        # idempotent by name: build_app may run more than once per process
        for m in self.metrics:
            if isinstance(m, Gauge) and m.name == name:
                return m
        m = Gauge(name, help_)
        self.metrics.append(m)
        return m

    def histogram(self, name, help_="", buckets=None):
        m = Histogram(name, help_, buckets)
        self.metrics.append(m)
        return m

    def expose(self) -> str:
        return "".join(m.expose() for m in self.metrics)


REGISTRY = Registry()
# Standard serving metrics (names mirror the reference where applicable).
MODEL_STEP_DURATION = REGISTRY.histogram(
    "model_step_duration", "wall-clock duration of one LM frame step (s)")
OPEN_CHANNELS = REGISTRY.gauge("open_channels", "active websocket sessions")
TOTAL_STEPS = REGISTRY.counter("model_steps_total", "total LM frame steps")
CONNECT_COUNT = REGISTRY.counter("connections_total", "accepted connections")
