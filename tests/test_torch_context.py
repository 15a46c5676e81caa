"""``with ctx:`` scopes of the port's Context: what each entry replaced
comes back at its exit, also when one Context object is entered twice,
nested or from two threads at once.

A test module that keeps one ``CPU = mt.cpu()`` and nests ``with CPU:``
(a helper that enters it, called inside a test's own ``with CPU:``) used
to leave the thread's default context at ``cpu(0)`` after the outer
exit: the inner entry overwrote the previous context the object kept.
Every later test in that worker process then ran on the host where it
expected the card; ``test_torch_transformer.py``'s entry-point test,
which needs the card default, failed when it ran after such a test.
"""
import threading

import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.context import Context, current_context

CPU = mt.cpu()


def _helper():
    """A helper that builds on the host, as a test module's helpers do."""
    with CPU:
        return mt.nd.zeros((2,))


@pytest.mark.parametrize("depth", [2, 3])
def test_nested_entries_of_one_context_restore_the_default(depth):
    before = current_context()
    assert before == mt.gpu(0)

    def enter(n):
        with CPU:
            assert current_context() == CPU
            if n > 1:
                enter(n - 1)
            assert current_context() == CPU
    enter(depth)
    with CPU:
        assert _helper().context == CPU
    assert current_context() == mt.gpu(0)
    assert getattr(Context._default_ctx, "value", None) is None


def test_one_context_entered_from_two_threads():
    """Two threads inside ``with CPU:`` at once, exiting in either order:
    each thread gets its own previous context back."""
    inside, release = threading.Barrier(2), threading.Event()
    seen = {}

    def worker(name):
        with CPU:
            inside.wait(timeout=10)
            seen[name] = current_context()
            release.wait(timeout=10)
        seen[name + "_after"] = current_context()

    t = threading.Thread(target=worker, args=("thread",))
    t.start()
    with CPU:
        inside.wait(timeout=10)
        release.set()
        t.join(timeout=10)
    assert seen == {"thread": CPU, "thread_after": mt.gpu(0)}
    assert current_context() == mt.gpu(0)


def test_after_nesting_the_entry_points_still_default_to_the_card(
        monkeypatch):
    """The leak, reproduced in one process: a nested ``with CPU:`` and
    then an entry point with no device and no card must raise (as
    ``test_transformer_entry_points_default_to_the_card`` asserts), not
    run on the host."""
    with CPU:
        _helper()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA"):
        mt.nd.zeros((2,))
    with CPU:
        assert mt.nd.zeros((2,)).context == CPU
