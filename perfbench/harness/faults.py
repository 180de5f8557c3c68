"""Faults planted under a run, for the checks that `correct` catches them
(perfbench/tests) and for their readings on the card (calibrate.py):
each wraps the program's step or answer."""
import torch


def unchanged(step):
    """A step that returns its state unchanged."""
    def wrapped(state, batch, **kwargs):
        _, info = step(state, batch, **kwargs)
        return state, info
    return wrapped


def _rows(tree, rows: slice, batch: int):
    if isinstance(tree, dict):
        return {k: _rows(v, rows, batch) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.dim() and \
            tree.shape[0] == batch:
        return tree[rows]
    return tree


def half_batch(step):
    """Half of the batch left out: the step's mean over the rest."""
    def wrapped(state, batch, **kwargs):
        b = batch["action"].shape[0]
        return step(state, _rows(batch, slice(0, b // 2), b), **kwargs)
    return wrapped


def altered_answer(answer):
    """An answer altered where it is produced: one action of a chunk."""
    def wrapped(*args, **kwargs):
        out = answer(*args, **kwargs).clone()
        out[..., 0, 0] += 0.5
        return out
    return wrapped


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered_answer": altered_answer}
