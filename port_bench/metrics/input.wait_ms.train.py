"""Host ms a train step waited for its batch (readers.input_wait_ms); moves train_samples_per_s."""

from port_bench import readers

read = readers.for_kind("train", readers.input_wait_ms)
