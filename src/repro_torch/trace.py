"""Spans and host-read counters of the LPA loop.

``span(name)`` marks a stretch of the program as ``lpa.<name>`` for
torch's profiler: a ``record_function`` span, so it lands in the
profiler's Chrome trace on the same clock as the CUDA kernels, and each
kernel's launch and each idle gap of the device can be put down to the
innermost program span around it. Spans nest on the thread, which is how
a reader finds a span's parent. While the profiler is not recording,
``span`` returns one shared null context.

``host_read(value, site)`` is where a device value of the LPA path
reaches the host (``.item()``, ``.tolist()``): each such read waits for
the device to finish the work queued before it. It counts one read under
``site`` in :data:`HOST_READS`, traced or not, and while tracing wraps
the read in the span ``lpa.read.<site>``.

A :class:`Detection` gives the reads one detection made; :data:`DETECTIONS`
sums them, and the iterations, over the process. :data:`PLAN_BYTES` holds
the bytes of each plan the newest plan bundle holds, by kind.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Union

import torch

__all__ = ["PREFIX", "HOST_READS", "DETECTIONS", "PLAN_BYTES", "span",
           "host_read", "reset_host_reads", "Detection"]

#: the prefix of every program span's name
PREFIX = "lpa."

#: host reads by site since the last reset_host_reads()
HOST_READS: dict = {}

#: the iterations and host reads of the process's detections that ended
#: (a benchmark reads their ratio)
DETECTIONS = {"iterations": 0, "host_reads": 0}

#: the bytes of the tensors of each plan that the newest plan bundle
#: (``core.plan_bundle.build_plan_bundle`` on a graph) holds, by kind:
#: "bucketed", "fused" or "stream" (a benchmark reads their sum)
PLAN_BYTES: dict = {}

_NULL = contextlib.nullcontext()


def span(name: str):
    """The span ``lpa.<name>`` while torch's profiler records, else a
    shared null context."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return torch.profiler.record_function(PREFIX + name)


def host_read(value: Union[torch.Tensor, Callable[[], torch.Tensor]],
              site: str):
    """``value`` on the host: a Python number for a 0-d tensor, else a
    list. ``value`` may be a function of no arguments that returns the
    tensor, so that the kernels computing it run inside the read's
    span."""
    HOST_READS[site] = HOST_READS.get(site, 0) + 1
    if not torch.autograd._profiler_enabled():
        return _read(value)
    with torch.profiler.record_function(PREFIX + "read." + site):
        return _read(value)


def _read(value):
    t = value() if callable(value) else value
    return t.item() if t.dim() == 0 else t.tolist()


def reset_host_reads() -> None:
    HOST_READS.clear()


class Detection:
    """One detection: from :meth:`finish`, the host reads it made, by
    site."""

    def __init__(self):
        self._before = dict(HOST_READS)

    def finish(self, iterations: int) -> dict:
        """The reads since this detection began, by site; adds them and
        ``iterations`` to :data:`DETECTIONS`."""
        reads = {}
        for site, n in HOST_READS.items():
            if n > self._before.get(site, 0):
                reads[site] = n - self._before.get(site, 0)
        DETECTIONS["iterations"] += iterations
        DETECTIONS["host_reads"] += sum(reads.values())
        return reads
