"""Share of the traced train steps' span the device was idle (readers.idle_pct); moves train_samples_per_s."""

from port_bench import readers

read = readers.for_kind("train", readers.idle_pct)
