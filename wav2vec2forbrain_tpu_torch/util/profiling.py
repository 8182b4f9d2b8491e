"""Step-time accounting and the port's span recorder.

- `StepTimer`: per-epoch step-time and throughput accounting (counterpart
  of wav2vec2forbrain_tpu/util/profiling.py::StepTimer), logged under the
  same metric names: train_step_ms, train_samples_per_sec,
  train_samples_per_sec_per_chip.
- The span recorder (`span`, `start`, `stop`): host spans inside the train
  and eval steps, the input path and the evaluator. It is off by default:
  then `span()` tests one module global and hands back a shared no-op
  context (no clock read, no allocation, no list append). On, each span
  records its name, its start and end in `time.time_ns()` (the clock
  torch.profiler stamps device events with, so spans and a device trace
  line up), the index of its parent span on the same thread, its thread
  (`threading.get_ident()`, pthread_self on Linux, whose low 32 bits the
  profiler's CUDA runtime events carry as their resource id) and the id of
  the batch it serves (the batch's index in its epoch or pass; a span that
  names none takes its parent's). Spans stay in memory, at most CAP of
  them (later ones are counted as dropped), and `stop()` hands them over.
  The step roots (`train_step`, `eval_step`) open inside the step
  functions, not around their call, since callers wrap the step (the
  benchmark's wrapper starts and stops the device profiler inside its
  call); so the loops name the batch with `serve(i)` and the roots take
  it as `span(name, SERVED)`.
- `trace()`: the recorder on around a whole run, its spans written to a
  directory as one JSON file (the counterpart of the JAX package's
  `trace()`, under the same variable, WAV2VEC2FORBRAIN_TPU_TRACE_DIR).

The spans the port records (README, "Tracing"):
  train_step > forward, backward (> grad_allreduce), optimizer
  eval_step > forward
  hash_mask (each dropout mask's generation; the backward's on autograd's
    device thread on a card)
  input_wait (the consumer's next()) > collate, place when inline;
    collate, place on the `host-prefetch` worker under --host_prefetch
  fetch (the lag-1 reads of a step's outputs), evaluator (track_batch, and
    the epoch's or pass's evaluate())
"""

import contextlib
import json
import os
import threading
import time
from typing import Optional


class StepTimer:
    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time = 0.0
        self.steps = 0
        self.samples = 0

    def add(self, dt: float, batch_size: int, steps: int = 1):
        self.total_time += dt
        self.steps += steps
        self.samples += batch_size

    @property
    def step_ms(self) -> float:
        return 1000.0 * self.total_time / self.steps if self.steps else 0.0

    @property
    def samples_per_sec(self) -> float:
        return self.samples / self.total_time if self.total_time > 0 else 0.0

    def metrics(self, prefix: str, n_chips: int = 1) -> dict:
        if self.steps == 0:
            return {}
        return {
            f"{prefix}_step_ms": round(self.step_ms, 2),
            f"{prefix}_samples_per_sec": round(self.samples_per_sec, 2),
            f"{prefix}_samples_per_sec_per_chip": round(self.samples_per_sec / max(n_chips, 1), 2),
        }


TRACE_DIR_ENV = "WAV2VEC2FORBRAIN_TPU_TRACE_DIR"
CAP = 500_000  # ~1,500 conformer train steps of ~300 spans; ~100 B a span
FIELDS = ("name", "start_ns", "end_ns", "parent", "thread", "id")
SERVED = object()  # span(name, SERVED): the id of the batch the thread serves (`serve`)

_on = False
_spans: list = []  # [name, start, end, parent record, thread, id] records, in the order they opened
_dropped = 0
_lock = threading.Lock()
_local = threading.local()  # .stack: the thread's open records; .batch: what `serve` set
_threads: dict = {}  # thread id -> thread name, of the threads that recorded


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "stack")

    def __init__(self, name, span_id):
        self.rec = [name, 0, None, None, 0, span_id]

    def __enter__(self):
        global _dropped
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        tid = threading.get_ident()
        rec = self.rec
        parent = stack[-1] if stack else None
        if rec[5] is SERVED:
            rec[5] = getattr(_local, "batch", None)
        elif rec[5] is None and parent is not None:
            rec[5] = parent[5]
        rec[3], rec[4] = parent, tid
        with _lock:
            if len(_spans) < CAP:
                _spans.append(rec)
                if tid not in _threads:
                    _threads[tid] = threading.current_thread().name
            else:
                _dropped += 1
        stack.append(rec)
        self.stack = stack
        rec[1] = time.time_ns()
        return None

    def __exit__(self, *exc):
        self.rec[2] = time.time_ns()
        self.stack.pop()
        return False


def span(name: str, id=None):
    """A context that records one span while the recorder is on (`id`: the
    batch it serves; None takes the parent's, SERVED the thread's `serve`)."""
    if not _on:
        return _OFF
    return _Span(name, id)


def serve(batch_id: Optional[int]) -> None:
    """The batch the calling thread serves from now on: the id its spans
    opened with `id=SERVED` take (the epoch and pass loops set it)."""
    _local.batch = batch_id


def start() -> None:
    """Turn the recorder on, with nothing recorded yet."""
    global _on, _dropped
    with _lock:
        _spans.clear()
        _threads.clear()
        _dropped = 0
    _on = True


def stop() -> dict:
    """Turn the recorder off and hand over what it recorded:
    {"clock", "fields", "spans", "threads", "dropped", "cap"}. Each span is
    a row of `fields`; `parent` is the row of the enclosing span on the same
    thread (-1: none recorded), `end_ns` None where the span was still open."""
    global _on
    _on = False
    with _lock:
        recs = list(_spans)
        _spans.clear()
        threads = dict(_threads)
        dropped = _dropped
    row = {id(r): i for i, r in enumerate(recs)}
    spans = [[name, t0, t1, -1 if parent is None else row.get(id(parent), -1), tid, span_id]
             for name, t0, t1, parent, tid, span_id in recs]
    return {"clock": "time.time_ns", "fields": list(FIELDS), "spans": spans, "threads": threads,
            "dropped": dropped, "cap": CAP}


def summarize(recording: dict) -> dict:
    """{name: {"count", "host_ms", "self_ms"}} over the closed spans: self
    time is a span's duration less what its recorded children cover."""
    spans = recording["spans"]
    child_ns = [0] * len(spans)
    for name, t0, t1, parent, _, _ in spans:
        if parent >= 0 and t1 is not None:
            child_ns[parent] += t1 - t0
    out: dict = {}
    for i, (name, t0, t1, _, _, _) in enumerate(spans):
        if t1 is None:
            continue
        s = out.setdefault(name, {"count": 0, "host_ms": 0.0, "self_ms": 0.0})
        s["count"] += 1
        s["host_ms"] += (t1 - t0) / 1e6
        s["self_ms"] += (t1 - t0 - child_ns[i]) / 1e6
    return out


@contextlib.contextmanager
def trace():
    """With $WAV2VEC2FORBRAIN_TPU_TRACE_DIR set, the recorder on around the
    block, and at its end one JSON file there, spans-<pid>.json: stop()'s
    fields, the summary by span name and the port's kernel launches
    (ops/kernels.py::LAUNCHES) in the block. Unset: nothing is recorded."""
    log_dir = os.environ.get(TRACE_DIR_ENV)
    if not log_dir:
        yield
        return
    from wav2vec2forbrain_tpu_torch.ops import kernels

    before = dict(kernels.LAUNCHES)
    start()
    try:
        yield
    finally:
        recording = stop()
        recording["summary"] = summarize(recording)
        recording["launches"] = {k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items()}
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"spans-{os.getpid()}.json")
        with open(path, "w") as f:
            json.dump(recording, f)
        print(f"spans: {len(recording['spans'])} recorded ({recording['dropped']} dropped) in {path}")
