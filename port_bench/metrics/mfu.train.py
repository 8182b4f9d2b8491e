"""The whole train step's share of the f32 peak (readers.mfu); moves train_samples_per_s."""

from port_bench import readers

read = readers.for_kind("train", readers.mfu)
