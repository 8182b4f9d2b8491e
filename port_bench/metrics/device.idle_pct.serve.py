"""Share of the traced serve steps' span the device was idle (readers.idle_pct); moves serve_samples_per_s."""

from port_bench import readers

read = readers.for_kind("serve", readers.idle_pct)
