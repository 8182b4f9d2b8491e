"""The port's kernels' share of their roofline in the traced serve steps (readers.kernels_roofline);
moves serve_samples_per_s."""

from port_bench import readers

read = readers.for_kind("serve", readers.kernels_roofline)
