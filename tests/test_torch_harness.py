"""What the port's CPU tests share to run side by side under pytest-xdist:

  * `torch_threads`, a module-scope autouse fixture that each
    tests/test_torch_*.py file imports: torch's intra-op pool at one
    thread while the file's tests run (the worker's own count again
    after). Six test workers on eight cores, each with a pool of a
    thread per core beside XLA's, spent most of their time waiting on
    each other's spinning threads;
  * `within(seconds, fn, ...)`, which fails the calling test when fn has
    not returned in time: the tests that wait on another process or a
    socket call through it (pytest-timeout is not installed).

The tests below hold the two helpers to what they say.
"""
import threading
import time

import pytest
import torch

#: torch intra-op threads while a port test file runs
TEST_THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(TEST_THREADS)
    yield
    torch.set_num_threads(before)


def within(seconds: float, fn, *args, **kwargs):
    """fn(*args, **kwargs) in a daemon thread; its result, or its
    exception raised here, or a failed test if it has not returned after
    `seconds` (the thread is left to end on its own)."""
    out = {}

    def run():
        try:
            out["value"] = fn(*args, **kwargs)
        except BaseException as e:  # handed to the caller
            out["error"] = e

    thread = threading.Thread(target=run, daemon=True,
                              name=f"within:{getattr(fn, '__name__', fn)}")
    thread.start()
    thread.join(seconds)
    if thread.is_alive():
        pytest.fail(f"{getattr(fn, '__name__', fn)} did not return within "
                    f"{seconds} s")
    if "error" in out:
        raise out["error"]
    return out.get("value")


def test_the_fixture_caps_torch_threads():
    assert torch.get_num_threads() == TEST_THREADS


def test_within_returns_the_result_and_raises_the_error():
    assert within(5, lambda a, b=0: a + b, 1, b=2) == 3
    with pytest.raises(KeyError, match="boom"):
        within(5, lambda: {}["boom"])


def test_within_fails_a_call_past_its_deadline():
    with pytest.raises(pytest.fail.Exception, match="within 0.2 s"):
        within(0.2, time.sleep, 2)
