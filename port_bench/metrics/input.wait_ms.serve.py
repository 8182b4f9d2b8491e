"""Host ms a serve step waited for its batch (readers.input_wait_ms); moves serve_samples_per_s."""

from port_bench import readers

read = readers.for_kind("serve", readers.input_wait_ms)
