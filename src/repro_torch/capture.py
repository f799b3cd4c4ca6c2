"""What the port's CUDA-graph steps share: the capture context and the
address check (``serve/captured.py``'s decode and chunked-prefill steps,
``train/captured.py``'s training step)."""
from __future__ import annotations

import contextlib
import gc

import torch

from repro_torch.models.common import tree_items


def leaf_ptrs(tree) -> list[int]:
    """The data pointers of ``tree``'s leaves, in sorted-path order: what a
    graph that captured a step over ``tree`` holds."""
    return [t.data_ptr() for _, t in tree_items(tree)]


@contextlib.contextmanager
def capturing(graph, stream, pool=None):
    """``torch.cuda.graph`` as the port captures, with
    ``capture_error_mode="thread_local"``: an unsafe call (a sync, a host
    read) from this thread fails the capture, while other threads go on: the
    serving engine's admission pipeline (prefill, host reads), a training
    run's checkpoint writer.  The capture is the stream's, not the thread's,
    so the kernels autograd's device thread launches for a backward (onto
    each forward op's stream, here the capture stream) are captured too.
    The garbage collector is held off, since a collection that frees
    another graph (an engine is a reference cycle) destroys it on this
    thread, which is not permitted while a stream captures and invalidates
    the capture."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            yield
    finally:
        if collecting:
            gc.enable()
