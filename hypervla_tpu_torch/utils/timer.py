"""Wall-clock phase timer (parity: octo/utils/train_utils.py:80-127); the
port's copy of hypervla_tpu/utils/timer.py."""
import time
from collections import defaultdict
from contextlib import contextmanager


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self.counts = defaultdict(int)
        self.times = defaultdict(float)
        self.start_times = {}

    @contextmanager
    def __call__(self, key: str):
        self.tick(key)
        try:
            yield
        finally:
            self.tock(key)

    def tick(self, key: str):
        if key in self.start_times:
            raise ValueError(f"Timer is already ticking for key: {key}!")
        self.start_times[key] = time.time()

    def tock(self, key: str):
        if key not in self.start_times:
            raise ValueError(f"Timer is not ticking for key: {key}!")
        self.counts[key] += 1
        self.times[key] += time.time() - self.start_times[key]
        del self.start_times[key]

    def get_average_times(self, reset: bool = True):
        ret = {key: self.times[key] / self.counts[key] for key in self.counts}
        if reset:
            self.reset()
        return ret
