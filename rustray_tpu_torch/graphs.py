"""What the sample program needs to run inside a CUDA graph: its gates on
all-dead work as conditional graph nodes, and the launch counters that a
replay keeps true.

Four places of the sample program skip all-dead work, as the JAX package's
``lax.cond``s do on the device: a dead wavefront level, a traversal with
no live ray, an octet slice with no live ray and an octet fallback walk
with no ray over its slots (render/wavefront.render_sample, ops/traverse.
trace_closest, ops/octet_trace.trace_tris_octets and _trace_slice).  Each
is a :func:`cond`.  Eagerly it asks the device (a host sync) and runs one
branch.  While a stream captures a CUDA graph it cannot ask: it writes the
dead branch's outputs, then captures the live branch into the body of an
IF node (``csrc/graph_cond.cu``), whose predicate the device computes at
every replay, so a replay launches what the eager program launches.
Gates nest (a level holds traversals, a traversal slices, a slice its
fallback); a body stream is itself capturing, so the inner gates become
nodes inside the outer node's body, one body stream per depth.

The launch counters of ops/block_trace and ops/octet_trace (and the
block walks' census of calls and blocks) are Python integers that a
wrapper bumps where it launches its kernel.  A replay runs
no Python.  So a capture records, for each gate, what its own body added to
the counters (:func:`snapshot` around it, less the gates nested in it),
and what the graph adds whatever the gates decide; the graph counts on the
device how often each gate's body ran (``runs``).  A replayed graph owes
``replays x unconditional + sum(site delta x runs[site])``, settled at the
next :func:`fetch`, the one host copy of a group of replays.  Counts of
what the device computes (the octet fallback's rays, the census's list
entries, the shading census) are device tensors that the program adds to
in place (:func:`count_on_device`), so a replay adds to them itself.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

# while the sample program runs eagerly as a capture runs it (the warm-up
# before a capture; the CPU tests): one census per level of nesting
_UNCONDITIONAL = []
# the record of the capture in progress (:func:`recording`)
_RECORD = []
# per (device, depth): the stream that captures the bodies of that depth
_BODY_STREAMS = {}
# graphs replayed since the last fetch: (runs tensor, settle(host runs))
_PENDING = []
# launches of set_if (csrc/graph_cond.cu): one per IF node that a replay
# reaches (a node inside a body that does not run is not reached)
launches = {"set_if": 0}


class Census:
    """What an unconditional run passed: its gates and their deepest
    nesting (the size of a capture's ``runs`` and its body streams)."""

    def __init__(self):
        self.gates = 0
        self.depth = 0
        self.max_depth = 0


def capturing() -> bool:
    """Whether the sample program must run without host syncs: a stream is
    capturing a CUDA graph, or :func:`unconditional` is in force."""
    if _UNCONDITIONAL:
        return True
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def unconditional():
    """Run the sample program eagerly as a capture records it: every gate
    runs its live branch (the warm-up before a capture loads every kernel
    the graph's bodies will launch).  Yields a :class:`Census`."""
    census = Census()
    _UNCONDITIONAL.append(census)
    try:
        yield census
    finally:
        _UNCONDITIONAL.pop()


def _capturing_node(mask) -> bool:
    """Whether a gate on ``mask`` becomes an IF node: its stream is
    capturing a CUDA graph."""
    return mask.is_cuda and torch.cuda.is_current_stream_capturing()


def cond(mask, live_fn, dead_fn, site: str):
    """``live_fn()`` if any element of ``mask`` is set, else ``dead_fn()``
    (the outputs of the skipped work: the JAX ``false_fn``'s values).

    Eagerly a host sync decides.  In a CUDA graph capture (under
    :func:`recording`) an IF node decides at every replay: the outputs are
    ``dead_fn()``'s tensors, which the node's body overwrites with
    ``live_fn()``'s.  Under :func:`unconditional` ``live_fn()`` runs (on
    all-dead work it gives the dead outputs).  ``site`` names the gate
    (``graph_stats``)."""
    if not capturing():
        return live_fn() if bool(mask.any()) else dead_fn()
    if _capturing_node(mask):
        if not _RECORD:
            raise RuntimeError(
                f"graphs.cond ({site}): a CUDA graph captures the sample "
                "program outside graphs.recording(); capture it through "
                "render/wavefront.make_chunk_renderer")
        return _RECORD[-1].gate(mask, live_fn, dead_fn, site)
    census = _UNCONDITIONAL[-1] if _UNCONDITIONAL else Census()
    census.gates += 1
    census.depth += 1
    census.max_depth = max(census.max_depth, census.depth)
    try:
        return live_fn()
    finally:
        census.depth -= 1


def _pairs(out, res):
    """The tensors of two output trees (tuples, lists, dicts) side by
    side; raises if the trees differ in structure."""
    if isinstance(out, torch.Tensor):
        yield out, res
    elif isinstance(out, dict):
        if set(out) != set(res):
            raise ValueError(f"gate outputs differ in keys: {sorted(out)} "
                             f"vs {sorted(res)}")
        for k in out:
            yield from _pairs(out[k], res[k])
    else:
        if len(out) != len(res):
            raise ValueError("gate outputs differ in length")
        for o, r in zip(out, res):
            yield from _pairs(o, r)


class _Frame:
    """One open body of a capture: its gate's path, how many gates it has
    opened so far, and what their bodies added to the counters."""

    def __init__(self, path, width):
        self.path = path
        self.children = 0
        self.delta = [0] * width


class Record:
    """The IF nodes of one capture: ``runs`` (int64, one slot per node,
    on the capture's device) counts how often each body ran; ``sites``
    holds each node's gate name and ``deltas`` what its own body adds to
    the counters (:func:`snapshot` order, its nested nodes' bodies not
    included); ``delta`` is what the bodies of the top-level nodes add in
    all.  A node is known by its path (its ordinal among the gates of the
    enclosing body, outermost first), so a program run again under the
    record finds the same slots (a CPU stand-in for a replay)."""

    def __init__(self, runs):
        self.runs = runs
        self.slots = {}
        self.sites = []
        self.deltas = []
        self._stack = [_Frame((), len(snapshot()))]

    @property
    def delta(self):
        return self._stack[0].delta

    def gate(self, mask, live_fn, dead_fn, site):
        frame = self._stack[-1]
        path = frame.path + (frame.children,)
        frame.children += 1
        new = path not in self.slots
        if new:
            if len(self.sites) >= self.runs.numel():
                raise RuntimeError(
                    f"graphs: the capture opened more gates than its "
                    f"warm-up passed ({self.runs.numel()})")
            self.slots[path] = len(self.sites)
            self.sites.append(site)
            self.deltas.append(None)
        slot = self.slots[path]
        out = dead_fn()
        ptrs = [o.data_ptr() for o, _ in _pairs(out, out)]
        if len(set(ptrs)) != len(ptrs):
            raise ValueError(f"graphs.cond ({site}): the dead outputs share "
                             "storage; the body writes each one")
        pred = mask.any()

        def body():
            res = live_fn()
            for o, r in _pairs(out, res):
                if o.shape != r.shape or o.dtype != r.dtype:
                    raise ValueError(
                        f"graphs.cond ({site}): a live output "
                        f"{tuple(r.shape)} {r.dtype} against the dead "
                        f"{tuple(o.shape)} {o.dtype}")
                o.copy_(r)

        launches["set_if"] += 1
        child = _Frame(path, len(frame.delta))
        self._stack.append(child)
        before = snapshot()
        try:
            _if_node(pred, self.runs, slot, body, len(self._stack) - 1)
        finally:
            self._stack.pop()
        full = [a - b for a, b in zip(snapshot(), before)]
        if new:
            self.deltas[slot] = [f - c for f, c in zip(full, child.delta)]
        frame.delta = [d + f for d, f in zip(frame.delta, full)]
        return out


@contextlib.contextmanager
def recording(device, census: Census):
    """The :class:`Record` of a capture of a program whose warm-up passed
    ``census``: its ``runs`` and the body streams, made before the capture
    begins."""
    device = torch.device(device)
    if device.type == "cuda":
        for depth in range(1, census.max_depth + 1):
            _body_stream(device, depth)
    rec = Record(torch.zeros((census.gates,), dtype=torch.int64,
                             device=device))
    _RECORD.append(rec)
    try:
        yield rec
    finally:
        _RECORD.pop()


# ---------------------------------------------------------------- the node

def _lib():
    from .build import load_kernel_lib
    lib = load_kernel_lib("graph_cond")
    if not getattr(lib, "_rr_typed", False):
        vp = ctypes.c_void_p
        lib.rr_versions.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.rr_stream_create.argtypes = [ctypes.POINTER(vp)]
        lib.rr_if_begin.argtypes = [vp, vp, vp, vp, ctypes.c_longlong]
        lib.rr_if_end.argtypes = [vp]
        for f in (lib.rr_versions, lib.rr_stream_create, lib.rr_if_begin,
                  lib.rr_if_end):
            f.restype = ctypes.c_int
        lib._rr_typed = True
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"graph_cond: {what} failed with cudaError_t "
                           f"{err}")


def versions():
    """(CUDA runtime version, driver version), as the CUDA API reports
    them (e.g. 12090)."""
    rt, drv = ctypes.c_int(), ctypes.c_int()
    _check(_lib().rr_versions(ctypes.byref(rt), ctypes.byref(drv)),
           "cudaRuntimeGetVersion/cudaDriverGetVersion")
    return rt.value, drv.value


def _body_stream(device, depth: int):
    key = (device, depth)
    if key not in _BODY_STREAMS:
        ptr = ctypes.c_void_p()
        _check(_lib().rr_stream_create(ctypes.byref(ptr)), "cudaStreamCreate")
        _BODY_STREAMS[key] = torch.cuda.ExternalStream(ptr.value,
                                                       device=device)
    return _BODY_STREAMS[key]


def _if_node(pred, runs, site: int, body, depth: int) -> None:
    """Append set_if and an IF node on ``pred`` to the graph the current
    stream captures, and capture ``body()`` into the node's body on the
    stream of ``depth``.  A refused node raises with its CUDA error."""
    lib = _lib()
    dev = pred.device
    stream = torch.cuda.current_stream(dev)
    child = _body_stream(dev, depth)
    _check(lib.rr_if_begin(stream.cuda_stream, child.cuda_stream,
                           pred.data_ptr(), runs.data_ptr(), site),
           "opening a conditional node")
    try:
        with torch.cuda.stream(child):
            body()
    finally:
        _check(lib.rr_if_end(child.cuda_stream), "closing a conditional node")


def route_to_pool(device, pool) -> None:
    """Inside ``torch.cuda.graph(..., pool=pool)``: send this thread's
    allocations on every stream to ``pool``, the body streams' included
    (the capture's own rule takes only the capturing stream's).  The
    capture's end stops it; call :func:`release_pool` after that."""
    idx = torch.device(device).index
    torch._C._cuda_endAllocateToPool(idx, pool)
    torch._C._cuda_beginAllocateCurrentThreadToPool(idx, pool)


def release_pool(device, pool) -> None:
    torch._C._cuda_releasePool(torch.device(device).index, pool)


# ------------------------------------------------------------ the counters

def _counters():
    from .ops import block_trace as bt
    from .ops import octet_trace as ot
    return ([(d, k) for d in (bt.launches, bt.ungated_launches, bt.selected,
                              bt.list_launches, ot.launches, ot.rounds)
             for k in d]
            + [(bt.census[m], k) for m in bt.census
               for k in ("calls", "blocks")]
            + [(ot.fallback, "calls"), (launches, "set_if")])


def _device_counts():
    """The counts that the sample program adds to on the device: the octet
    fallback's rays, the block walks' census entries and the shading
    census (render/wavefront.shading)."""
    from .ops import block_trace as bt
    from .ops import octet_trace as ot
    from .render import wavefront as wf
    return ([(ot.fallback, "rays")]
            + [(c, "entries") for c in bt.census.values()]
            + [(wf.shading, k) for k in wf.shading])


def count_on_device(d, k, n) -> None:
    """Add ``n``, a 0-dim tensor, to the count ``d[k]`` with no host sync:
    in place where the count is a tensor on ``n``'s device (so that a
    captured graph adds to it at every replay), else as a new tensor."""
    r = d[k]
    if isinstance(r, torch.Tensor) and r.device == n.device:
        r.add_(n)
    else:
        d[k] = r + n


def zero_count(d, k) -> None:
    """Zero a count of :func:`count_on_device` (a tensor in place)."""
    if isinstance(d[k], torch.Tensor):
        d[k].zero_()
    else:
        d[k] = 0


def device_counts(device):
    """Before a capture: every device count an int64 tensor on ``device``
    (a graph adds to the tensors it was captured with).  Returns
    ((dict, key), tensor) pairs, for :func:`carry_over`."""
    device = torch.device(device)
    for d, k in _device_counts():
        r = d[k]
        if not (isinstance(r, torch.Tensor) and r.device == device):
            d[k] = torch.full((), int(r), dtype=torch.int64, device=device)
    return [((d, k), d[k]) for d, k in _device_counts()]


def carry_over(counts) -> None:
    """Before a replay: put back the tensors ``counts`` of
    :func:`device_counts` where a count moved to another tensor since (a
    walk on another device), with the count it holds."""
    for (d, k), t in counts:
        if d[k] is not t:
            t.copy_(torch.as_tensor(d[k]))
            d[k] = t


def reset_launches() -> None:
    launches["set_if"] = 0


def snapshot():
    """The integer launch and call counters, in a fixed order (set_if's
    last)."""
    return [d[k] for d, k in _counters()]


def restore(values) -> None:
    for (d, k), v in zip(_counters(), values):
        d[k] = v


def add(delta) -> None:
    """Add counts (in :func:`snapshot` order) to the counters."""
    for (d, k), v in zip(_counters(), delta):
        d[k] += v


def defer(runs, settle) -> None:
    """Register a graph's replays: at the next :func:`fetch`,
    ``settle(host copy of runs)`` adds what they launched."""
    _PENDING.append((runs, settle))


def fetch(x):
    """``x`` (an int64 tensor) as a numpy array, copied to the host in one
    copy with the ``runs`` of every graph replayed since the last fetch,
    whose launches it adds to the counters."""
    parts = [x.reshape(-1)] + [r.to(x.device) for r, _ in _PENDING]
    host = torch.cat(parts).cpu().numpy()
    off = x.numel()
    for runs, settle in _PENDING:
        settle(host[off:off + runs.numel()])
        off += runs.numel()
    _PENDING.clear()
    return host[:x.numel()].reshape(tuple(x.shape))


def settle() -> None:
    """Add the launches of the graphs replayed since the last fetch (a
    host sync; for a direct caller of a chunk program)."""
    fetch(torch.zeros((0,), dtype=torch.int64))
