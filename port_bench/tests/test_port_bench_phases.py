"""port_bench/phases.py: the program's spans laid over made-up device
events and launch calls (gaps put down to the innermost main-thread phase,
launches counted per span by thread), the trace's reduction unchanged by
the spans, the consistency figures from the harness's own gap labels, and a
tiny traced run on the CPU whose recorder is on over the traced steps
only."""

import time
from types import SimpleNamespace

import pytest
import torch

from port_bench import harness, phases, trace
from port_bench.tests import tiny

MS = 1_000_000
MAIN, AUTOGRAD, WORKER = 11, 12, 13
# name, start, end, parent row, thread, id (util/profiling.py::FIELDS), in ms
SPANS = [
    ("train_step", 0, 100, -1, MAIN, 0),   # 0
    ("forward", 5, 40, 0, MAIN, 0),        # 1
    ("hash_mask", 10, 20, 1, MAIN, 0),     # 2
    ("backward", 40, 80, 0, MAIN, 0),      # 3
    ("optimizer", 80, 95, 0, MAIN, 0),     # 4
    ("hash_mask", 50, 60, -1, AUTOGRAD, 0),  # 5: the backward's regeneration on autograd's thread
    ("collate", 0, 30, -1, WORKER, 1),     # 6
    ("place", 30, 45, -1, WORKER, 1),      # 7
    ("fetch", 100, 110, -1, MAIN, 0),      # 8
    ("evaluator", 110, 120, -1, MAIN, 0),  # 9
]
BUSY = [(0, 12), (22, 45), (70, 90), (112, 125)]  # gaps 12-22, 45-70, 90-112, 125-130
LAUNCHES = [(15, MAIN), (55, AUTOGRAD), (85, MAIN), (35, WORKER), (105, MAIN), (200, MAIN)]


def _recording():
    spans = [[n, a * MS, b * MS, p, t, i] for n, a, b, p, t, i in SPANS]
    return {"spans": spans, "dropped": 0, "threads": {MAIN: "MainThread", AUTOGRAD: "Dummy-1",
                                                      WORKER: "host-prefetch"}}


def _section():
    device = [("k", a * MS, (b - a) * MS) for a, b in BUSY]
    launches = [("cudaLaunchKernel", t * MS, 1000, tid) for t, tid in LAUNCHES]
    return phases.reduce(device, launches, (0, 130 * MS), _recording())


def test_gaps_go_to_the_innermost_main_thread_phase():
    s = _section()
    assert s["steps"] == 1 and s["root"] == "train_step" and s["main_thread"] == MAIN and s["workers"] == [WORKER]
    # 12-22 inside forward > hash_mask: forward; 45-70 backward; 90-112 (middle 101) fetch; 125-130 no span
    assert s["idle_s"] == {"forward": 10e-3, "backward": 25e-3, "fetch": 22e-3, phases.OUTSIDE: 5e-3}
    assert s["gaps"] == {"forward": 1, "backward": 1, "fetch": 1, phases.OUTSIDE: 1}
    per = s["per_name"]
    assert per["train_step"]["self_ms"] == pytest.approx(10) and per["forward"]["self_ms"] == pytest.approx(25)
    assert per["train_step"]["idle_ms"] == pytest.approx(35) and per["collate"]["idle_ms"] == pytest.approx(10)


def test_launches_count_per_span_by_thread():
    s = _section()
    assert s["launch_calls"] == {"cudaLaunchKernel": 5}  # the one past the segment left out
    assert s["launches"]["in_steps"] == 3
    assert s["launches"]["by_phase"] == {"forward": 1, "backward": 1, "optimizer": 1, "input worker": 1, "fetch": 1}
    got = {name: p["launches"] for name, p in s["per_name"].items()}
    # autograd's launch: its own hash_mask, and the main thread's backward and step; the worker's: place alone
    assert got == {"train_step": 3, "forward": 1, "hash_mask": 2, "backward": 1, "optimizer": 1, "collate": 0,
                   "place": 1, "fetch": 1, "evaluator": 0}


def test_readings_of_the_section():
    r = phases.readings(_section())
    assert r["step.forward_ms.train"] == pytest.approx(35) and r["step.backward_ms.train"] == pytest.approx(40)
    assert r["idle.backward_ms.train"] == pytest.approx(25) and r["idle.optimizer_ms.train"] == 0
    assert r["step.launches.train"] == 3 and r["step.mask_launches.train"] == 2
    assert r["input.collate_ms.train"] == pytest.approx(30) and r["input.place_ms.train"] == pytest.approx(15)
    assert phases.reduce([], [], (0, 130 * MS), {"spans": [], "dropped": 0}) == {}
    no_launch = phases.readings(phases.reduce([], [], (0, 130 * MS), _recording()))
    # no device event: one gap over the segment, whose middle (65 ms) is in the backward
    assert "step.launches.train" not in no_launch and no_launch["idle.backward_ms.train"] == pytest.approx(130)


class _Event:
    def __init__(self, name, start, dur, device, thread=MAIN):
        self._v = (name, start, dur, device, thread)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return False

    def device_resource_id(self):
        return self._v[4]


def test_the_trace_reduction_is_the_same_with_spans_and_consistency_reads_its_gaps():
    events = [_Event(name, a * MS, (b - a) * MS, torch.autograd.DeviceType.CUDA)
              for name, (a, b) in zip(("ampere_sgemm", "layernorm_fwd_vec_kernel") * 2, BUSY)]
    events.append(_Event("cudaLaunchKernel", 15 * MS, 1000, torch.autograd.DeviceType.CPU))
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))
    host = {"input_wait": [], "dispatch": [(0, 100 * MS)]}
    steps = [{"dispatch_s": 0.1, "batch_rows": 2, "width": 80, "lens": [80, 60], "tgt_lens": [3, 2], "tgt_width": 3,
              "train": True, "launches": {"layernorm": 3}}]
    plain = trace.reduce(prof, (0, 130 * MS), host, steps)
    reports = []
    with phases.recorded(lambda section, checks: reports.append((section, checks))) as state:
        state["recording"], state["prof"] = _recording(), prof
        spanned = trace.reduce(prof, (0, 130 * MS), host, steps)
    assert trace.reduce_events.__module__ == "port_bench.trace"
    assert harness.Window.maybe_start_trace.__module__ == "port_bench.harness"
    assert spanned == plain and "program" not in spanned
    section, checks = reports[0]
    assert section["launch_calls"] == {"cudaLaunchKernel": 1} and section["idle_s"]["backward"] == 25e-3
    # the harness's dispatch span (0-100 ms) holds the gaps at 12-22 and 45-70; 90-112 and 125-130 are the rest
    assert plain["breakdown"]["idle_gaps"][0] == ["host: dispatching a step (2 gaps)", pytest.approx(35e-3)]
    assert checks["harness_dispatch_idle_ms_a_step"] == pytest.approx(35) and checks["dispatch_gaps_a_step"] == 2
    assert checks["phases_idle_ms_a_step"] == pytest.approx(35) and checks["idle_share_of_dispatch"] == 1
    assert checks["harness_dispatch_ms_a_step"] == pytest.approx(100)
    assert checks["host_share_of_dispatch"] == pytest.approx(0.9) and checks["launches_a_step"] == 1
    assert "harness_other_idle_s" not in checks


def test_a_tiny_traced_run_records_only_the_traced_steps():
    from wav2vec2forbrain_tpu_torch.util import profiling

    cell = tiny.cell("conformer", "train")
    with tiny.tiny_program(cell.config), phases.recorded() as state:
        harness.run_cell(cell, 2**31 + 7, 2.0, True, time.perf_counter(), device="cpu")
    assert not profiling._on
    spans = state["recording"]["spans"]
    roots = [s for s in spans if s[0] == "train_step"]
    assert 1 <= len(roots) <= harness.TRACE_STEPS["train"]
    assert {"forward", "backward", "optimizer", "hash_mask"} <= {s[0] for s in spans}
    assert state["section"]["steps"] == len(roots) and state["section"]["launch_calls"] == {}
