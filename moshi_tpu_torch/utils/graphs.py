"""CUDA-graph capture of a streaming step: the port's counterpart of the JAX
package's jitted frame programs over donated state (moshi_tpu
serve/server.py `_encode`, `_step`, `_decode`; serve/batched_moshi.py
`frame`), each dispatched once per frame.

A `GraphedStep` wraps a function of tensors whose streaming state is
updated in place.  Graphed, it runs eagerly once on a side stream
(`warm_up`: the kernels' libraries load, the libraries' handles and
workspaces are made), is captured at its first call after that, and every
call replays the graph: the first call's tensors are the graph's static
inputs, its outputs the static outputs, overwritten by each replay.  The
caller copies new inputs into those tensors before a call and reads the
outputs before the next.  A session's `torch.Generator` is registered with
the graph, so each replay draws new numbers and `manual_seed` between
replays takes effect.

Nothing falls back: a capture or replay that fails raises, and so does a
graphed call before `warm_up` or with other tensors than the captured
ones.  The hand-written kernels launch on `torch.cuda.current_stream`,
which capture sets; their Python launch counters tick when the capture
records a launch, not on a replay.

A server replays its engine's graphs on a worker thread, so that the
read-back does not block its event loop: `run_on_device` runs a function
there with the engine's device current and on its default stream, the
stream the event loop's thread uses for the slot ops between frames.  A
capture checks only its own thread for calls a capture forbids, so one
engine may capture while another's thread replays.

A step holds a bound method of its engine weakly: the engine holds its
steps, so a strong reference back would make a cycle, and a dropped engine
(its state, its graphs' memory) would stay on the card until Python's cycle
collector ran.
"""

import contextlib
import inspect
import weakref

import torch


@contextlib.contextmanager
def side_stream(stream: torch.cuda.Stream):
    """Run the body on `stream`, after the current stream's work so far and
    before its later work."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        yield
    current.wait_stream(stream)


def capture(fn, *args, stream: torch.cuda.Stream, generators=()):
    """Capture fn(*args) on `stream` into a new CUDA graph, with each of
    `generators` registered.  Records, runs nothing.  Returns (graph,
    fn's outputs: the graph's static outputs)."""
    graph = torch.cuda.CUDAGraph()
    for generator in generators:
        graph.register_generator_state(generator)
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
        outputs = fn(*args)
    return graph, outputs


def run_on_device(device, fn, *args):
    """fn(*args) with `device` current and its default stream the current
    stream (on any thread; a CPU device changes nothing)."""
    device = torch.device(device)
    if device.type != "cuda":
        return fn(*args)
    with torch.cuda.device(device), torch.cuda.stream(torch.cuda.default_stream(device)):
        return fn(*args)


class GraphedStep:
    """fn(*args) per call: eagerly, or (graphed) as replays of one capture.

    `replays` counts the replays, the one after the capture included."""

    def __init__(self, fn, *, graphed: bool, device=None, generators=()):
        self._fn = weakref.WeakMethod(fn) if inspect.ismethod(fn) else (lambda: fn)
        self.graphed, self.generators = graphed, tuple(generators)
        self.stream = torch.cuda.Stream(device) if graphed else None
        self.graph = self.inputs = self.outputs = None
        self.warm = False
        self.replays = 0

    @property
    def fn(self):
        fn = self._fn()
        if fn is None:
            raise RuntimeError("the engine of this step is gone")
        return fn

    def warm_up(self, *args):
        """One eager call, on the capture's side stream when graphed."""
        if not self.graphed:
            return self.fn(*args)
        with side_stream(self.stream):
            out = self.fn(*args)
        self.warm = True
        return out

    def warm_or_call(self, *args):
        """The warm-up at the first call of a graphed step (the next call
        captures), else the call."""
        if self.graphed and not self.warm:
            return self.warm_up(*args)
        return self(*args)

    def recapture(self):
        """Drop the captured graph: the next call captures again (over the
        tensors it is given then).  The step stays warm."""
        self.graph = self.inputs = self.outputs = None

    def __call__(self, *args):
        if not self.graphed:
            return self.fn(*args)
        if self.graph is None:
            if not self.warm:
                raise RuntimeError("a graphed step needs an eager warm_up call before its "
                                   "capture")
            self.graph, self.outputs = capture(self.fn, *args, stream=self.stream,
                                               generators=self.generators)
            self.inputs = args
        elif len(args) != len(self.inputs) or any(a is not b for a, b in zip(args, self.inputs)):
            raise ValueError("a graphed step is called with the tensors it was captured with")
        self.graph.replay()
        self.replays += 1
        return self.outputs
