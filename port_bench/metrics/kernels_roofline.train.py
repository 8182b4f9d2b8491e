"""The port's kernels' share of their roofline in the traced train steps (readers.kernels_roofline);
moves train_samples_per_s."""

from port_bench import readers

read = readers.for_kind("train", readers.kernels_roofline)
