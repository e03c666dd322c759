"""Marks where a kernel's plain PyTorch version runs, for the dry-run's op
accounting (``roofline/op_stats.py``).

On the card a kernel keeps its intermediates on chip, in shared memory and
registers; its plain version, which the CPU and the dry-run run in its place,
forms them as tensors. ``plain_kernel`` decorates a plain version: while a
listener is installed (``op_stats`` installs one for the length of a dry-run),
the listener hears the call's entry with its arguments and its exit with its
outputs, so that it can count the call's own inputs and outputs as memory
traffic and what is formed between them as kernel-internal. A plain version
whose dot products are not the kernel's work (K1's forms every masked block, the
kernel skips them) states the kernel's flops with ``plain_kernel(flops=...)``,
and the listener hears that count with the entry. Without a listener the
decorated function only calls the plain version. The kernels' CUDA wrappers are
not decorated: nothing changes on the card's path.
"""
from __future__ import annotations

import contextlib
import functools
import threading

# the listener of this thread: an object with enter(args, kwargs, flops) and
# exit(out); the dry-run runs in one thread (a CPU backward runs in the thread
# that calls it)
_local = threading.local()


def plain_kernel(fn=None, *, flops=None):
    """Decorate a kernel's plain version. ``flops(*args, **kwargs)``, where
    given, is the kernel's own dot-product flops for the call; the listener hears
    it (or None) with the entry."""
    if fn is None:
        return functools.partial(plain_kernel, flops=flops)

    @functools.wraps(fn)
    def run(*args, **kwargs):
        listener = getattr(_local, "listener", None)
        if listener is None:
            return fn(*args, **kwargs)
        listener.enter(args, kwargs, None if flops is None else flops(*args, **kwargs))
        out = None
        try:
            out = fn(*args, **kwargs)
            return out
        finally:
            listener.exit(out)
    return run


@contextlib.contextmanager
def listening(listener):
    """Install ``listener`` for the plain kernels' regions that this thread runs
    inside the block."""
    if getattr(_local, "listener", None) is not None:
        raise RuntimeError("a kernel-region listener is installed already")
    _local.listener = listener
    try:
        yield listener
    finally:
        _local.listener = None
