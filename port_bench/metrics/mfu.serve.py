"""The whole serve step's share of the f32 peak (readers.mfu); moves serve_samples_per_s."""

from port_bench import readers

read = readers.for_kind("serve", readers.mfu)
