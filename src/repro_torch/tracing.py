"""Named spans of the model and co-inference layers.

``span(name, device)`` marks a piece of work: the prefill of a partition
(``prefill``), an encoder pass (``encode``), an sLSTM block's time loop
(``slstm``), a decode block (``recurrent`` or ``attention``), an exit
pass (``exit``), and a train step's forward and backward passes
(``gradients``, around the training forward's ``prefill``) and its
AdamW update (``optimizer``).  Under
``torch.profiler`` it is a ``record_function`` range named ``PREFIX +
name``, so a profile attributes the operators and kernels launched inside
it to that work.  While ``timed(*names)`` is open, the spans it names also
record their time: two CUDA events on the current stream (the host clock
on the CPU), read when ``timed`` closes, so the timed work runs without a
synchronisation.  A CUDA span lasts from the moment its stream reached
its start to the end of its last kernel.  Otherwise a span costs a flag
test.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, Tuple

import torch
from torch.profiler import record_function

PREFIX = "repro:"
_timed: List[Tuple[frozenset, list]] = []      # the open ``timed`` blocks


def _mark(device: torch.device):
    if device.type != "cuda":
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


@contextlib.contextmanager
def span(name: str, device: torch.device) -> Iterator[None]:
    ranged = torch._C._autograd._profiler_enabled()
    marks = [m for names, m in _timed if name in names]
    with (record_function(PREFIX + name) if ranged
          else contextlib.nullcontext()):
        start = _mark(device) if marks else None
        yield
        if marks:
            end = _mark(device)
            for m in marks:
                m.append((name, start, end))


@contextlib.contextmanager
def timed(*names: str) -> Iterator[Dict[str, float]]:
    """While open, the spans called ``names`` are timed; yields a dict
    that holds, once closed, each name's seconds summed over its spans.
    Blocks may nest: a span counts in every open block that names it."""
    out = dict.fromkeys(names, 0.0)
    entry = (frozenset(names), [])
    _timed.append(entry)
    try:
        yield out
    finally:
        _timed[:] = [e for e in _timed if e is not entry]
        for name, start, end in entry[1]:
            if isinstance(start, float):
                out[name] += end - start
            else:
                end.synchronize()
                out[name] += start.elapsed_time(end) / 1e3
