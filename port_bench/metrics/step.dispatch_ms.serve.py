"""Host ms to dispatch a serve step (readers.dispatch_ms); moves serve_samples_per_s."""

from port_bench import readers

read = readers.for_kind("serve", readers.dispatch_ms)
