"""Per-epoch step-time and throughput accounting (counterpart of
wav2vec2forbrain_tpu/util/profiling.py::StepTimer), logged under the same
metric names: train_step_ms, train_samples_per_sec,
train_samples_per_sec_per_chip."""


class StepTimer:
    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time = 0.0
        self.steps = 0
        self.samples = 0

    def add(self, dt: float, batch_size: int, steps: int = 1):
        self.total_time += dt
        self.steps += steps
        self.samples += batch_size

    @property
    def step_ms(self) -> float:
        return 1000.0 * self.total_time / self.steps if self.steps else 0.0

    @property
    def samples_per_sec(self) -> float:
        return self.samples / self.total_time if self.total_time > 0 else 0.0

    def metrics(self, prefix: str, n_chips: int = 1) -> dict:
        if self.steps == 0:
            return {}
        return {
            f"{prefix}_step_ms": round(self.step_ms, 2),
            f"{prefix}_samples_per_sec": round(self.samples_per_sec, 2),
            f"{prefix}_samples_per_sec_per_chip": round(self.samples_per_sec / max(n_chips, 1), 2),
        }
