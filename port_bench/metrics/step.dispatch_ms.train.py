"""Host ms to dispatch a train step (readers.dispatch_ms); moves train_samples_per_s."""

from port_bench import readers

read = readers.for_kind("train", readers.dispatch_ms)
