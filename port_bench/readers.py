"""What the per-layer metrics read, one function a quantity; each file
port_bench/metrics/<name>.py binds one of them to the kind of cell (train
or serve) whose end-to-end metric it moves. A reader returns None where
the run has nothing for it, and the metric is left out of the line."""

from port_bench.counts import model_flops, ops


def for_kind(kind: str, quantity):
    def read(ctx):
        return quantity(ctx) if ctx["kind"] == kind else None

    return read


def input_wait_ms(ctx):
    """Host ms a step waited for its batch (the harness's span around each
    next() of the Trainer's stream), over the window's steps."""
    steps = ctx["steps"]
    return 1e3 * sum(s["wait_s"] for s in steps) / len(steps) if steps else None


def dispatch_ms(ctx):
    """Host ms to dispatch a step (the harness's span around each call of the
    Trainer's step), over the window's steps: near the step's time where the
    host sets the pace."""
    steps = ctx["steps"]
    return 1e3 * sum(s["dispatch_s"] for s in steps) / len(steps) if steps else None


def mfu(ctx):
    """The whole step's share of the chip's f32 peak (the split-TF32 rate,
    peaks.json): the products a forward needs on each sample's valid frames,
    encoder layers as many as ran (LayerDrop's dropped ones not counted),
    three times that for a train step, over the whole window's host-clock
    time."""
    if not ctx["steps"]:
        return None
    cfg, n_layers = ctx["config"], ctx["config"]["encoder"]["num_hidden_layers"]
    drops = ctx["layerdrop"] or [[]] * len(ctx["steps"])
    flops = sum(model_flops.step_flops(cfg, s["lens"], n_layers - sum(d), s["train"])
                for s, d in zip(ctx["steps"], drops))
    return 100.0 * flops / ctx["window_s"] / ops.PEAKS["flops_per_s"]["tf32x3"]


def kernels_roofline(ctx):
    """The port's kernels' share of their roofline in the traced steps: the
    least time of every kernel call (counts/ops.py, from each step's shapes
    and launch counts) over those kernels' device time. A family whose calls
    or device time the trace lacks is left out of both sums."""
    if not ctx["trace"]:
        return None
    from port_bench.trace import FAMILIES

    times = ops.family_times(ctx["trace"], ctx["config"], FAMILIES).values()
    device = sum(d for _, d in times)
    return 100.0 * sum(least for least, _ in times) / device if device > 0 else None


def idle_pct(ctx):
    """Share of the traced steps' span in which no kernel, copy or set ran on
    the device (port_bench/trace.py)."""
    tr = ctx["trace"]
    if not tr or tr["span_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["span_s"])
