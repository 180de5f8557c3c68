"""A small threaded data-flow engine (the tf.data replacement).

tf.data's C++ graph (interleave/map/shuffle/batch with thread pools) is
replaced by a compact Python pipeline of iterators with:
  * thread-pooled map stages (PIL decode and numpy transforms release the
    GIL for the heavy parts),
  * a reservoir-style shuffle buffer holding still-encoded frames,
  * weighted sampling across component pipelines,
  * background prefetch queues.

The TPU-heavy work (resize/augment/normalize, encoders) does NOT happen here:
it runs inside the jitted device program (see ops/preprocess.py), so the host
pipeline only has to move bytes.

The port's copy of hypervla_tpu/data/pipeline.py: only its imports differ.
"""
import itertools
import queue
import random
import threading
from typing import Any, Callable, Iterable, Iterator, List, Optional, Sequence

import numpy as np


class Pipeline:
    """Lazily-evaluated iterator pipeline. Each transform returns a new
    Pipeline; iteration starts the chain."""

    def __init__(self, source_fn: Callable[[], Iterator[Any]]):
        self._source_fn = source_fn

    def __iter__(self):
        return self._source_fn()

    # ----------------------------- transforms -----------------------------

    def map(self, fn: Callable, num_threads: int = 0) -> "Pipeline":
        if num_threads and num_threads > 1:
            return self._threaded_map(fn, num_threads)

        def gen():
            for x in self:
                yield fn(x)

        return Pipeline(gen)

    def _threaded_map(self, fn, num_threads) -> "Pipeline":
        def gen():
            from concurrent.futures import ThreadPoolExecutor

            src = iter(self)
            with ThreadPoolExecutor(max_workers=num_threads) as pool:
                pending = []
                try:
                    for _ in range(num_threads * 2):
                        pending.append(pool.submit(fn, next(src)))
                except StopIteration:
                    pass
                while pending:
                    fut = pending.pop(0)
                    yield fut.result()
                    try:
                        pending.append(pool.submit(fn, next(src)))
                    except StopIteration:
                        continue

        return Pipeline(gen)

    def filter(self, pred: Callable) -> "Pipeline":
        def gen():
            for x in self:
                if pred(x):
                    yield x

        return Pipeline(gen)

    def flat_map(self, fn: Callable) -> "Pipeline":
        def gen():
            for x in self:
                yield from fn(x)

        return Pipeline(gen)

    def flatten_frames(self) -> "Pipeline":
        """Splits trajectory dicts into per-frame dicts (leading axis)."""

        def gen():
            for traj in self:
                n = len(traj["action"])
                for i in range(n):
                    yield _index_tree(traj, i)

        return Pipeline(gen)

    def repeat(self, count: Optional[int] = None) -> "Pipeline":
        def gen():
            it = itertools.count() if count is None else range(count)
            for _ in it:
                yield from self

        return Pipeline(gen)

    def shuffle(self, buffer_size: int, seed: Optional[int] = None) -> "Pipeline":
        """Streaming shuffle with a fixed-size buffer (tf.data semantics)."""

        def gen():
            rng = random.Random(seed)
            buf: List[Any] = []
            for x in self:
                if len(buf) < buffer_size:
                    buf.append(x)
                else:
                    idx = rng.randrange(buffer_size)
                    yield buf[idx]
                    buf[idx] = x
            rng.shuffle(buf)
            yield from buf

        return Pipeline(gen)

    def batch(self, batch_size: int, drop_remainder: bool = True) -> "Pipeline":
        def gen():
            items = []
            for x in self:
                items.append(x)
                if len(items) == batch_size:
                    yield _stack_tree(items)
                    items = []
            if items and not drop_remainder:
                yield _stack_tree(items)

        return Pipeline(gen)

    def prefetch(self, size: int = 2) -> "Pipeline":
        def gen():
            q: queue.Queue = queue.Queue(maxsize=size)
            done = object()
            error: List[BaseException] = []

            def worker():
                try:
                    for x in self:
                        q.put(x)
                except BaseException as e:  # propagate to consumer
                    error.append(e)
                finally:
                    q.put(done)

            t = threading.Thread(target=worker, daemon=True)
            t.start()
            while True:
                x = q.get()
                if x is done:
                    if error:
                        raise error[0]
                    return
                yield x

        return Pipeline(gen)

    def ignore_errors(self, log_warning: bool = True) -> "Pipeline":
        def gen():
            import logging

            it = iter(self)
            while True:
                try:
                    yield next(it)
                except StopIteration:
                    return
                except Exception as e:
                    if (
                        isinstance(e, RuntimeError)
                        and "interpreter shutdown" in str(e)
                    ):
                        # worker raced the interpreter teardown; not data
                        return
                    if log_warning:
                        logging.warning(f"Ignoring pipeline error: {e!r}")

        return Pipeline(gen)

    def take(self, n: int) -> "Pipeline":
        def gen():
            yield from itertools.islice(iter(self), n)

        return Pipeline(gen)

    # ------------------------------- sinks --------------------------------

    def iterator(self):
        return iter(self)

    @staticmethod
    def from_iterable(iterable_factory: Callable[[], Iterable]) -> "Pipeline":
        return Pipeline(lambda: iter(iterable_factory()))

    @staticmethod
    def sample_from_pipelines(
        pipelines: Sequence["Pipeline"],
        weights: Sequence[float],
        seed: Optional[int] = None,
        stop_on_empty_dataset: bool = False,
    ) -> "Pipeline":
        """Weighted sampling across component pipelines (the interleave)."""

        def gen():
            rng = np.random.default_rng(seed)
            iters = [iter(p) for p in pipelines]
            w = np.asarray(weights, dtype=np.float64)
            w = w / w.sum()
            alive = [True] * len(iters)
            while any(alive):
                probs = np.where(alive, w, 0.0)
                total = probs.sum()
                if total == 0:
                    return
                idx = int(rng.choice(len(iters), p=probs / total))
                try:
                    yield next(iters[idx])
                except StopIteration:
                    if stop_on_empty_dataset:
                        return
                    alive[idx] = False

        return Pipeline(gen)


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) or hasattr(tree, "__getitem__"):
        return tree[i]
    return tree


def _stack_tree(items):
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack_tree([it[k] for it in items]) for k in first}
    arrs = [np.asarray(it) for it in items]
    return np.stack(arrs)
