"""Profiler hooks: named ranges around the slab phases and the trace.

Counterpart of ``repro.obs.profiling``, on ``torch.profiler``:

* :func:`scope` -- ``torch.profiler.record_function`` (and, with a CUDA
  device, an NVTX range) around a consensus slab phase (``consensus.pack``,
  ``.encode``, ``.decode``, ``.combine``, ``.unpack``) when
  ``ObsConfig.annotate`` is set; a no-op otherwise, ``obs=None`` included;
* :func:`annotation` -- a host range around a piece of a run (a train
  chunk);
* :func:`trace` -- a ``torch.profiler`` session that writes a Chrome trace
  (``trace.json``, ``chrome://tracing`` or Perfetto) into a directory; a
  no-op without one.
"""
from __future__ import annotations

import contextlib
import os

import torch


def scope(obs, name: str):
    """A profiler range named ``name`` when ``obs`` asks for annotation,
    else a ``nullcontext``."""
    if obs is None or not getattr(obs, "annotate", False):
        return contextlib.nullcontext()
    return annotation(name)


@contextlib.contextmanager
def annotation(name: str):
    """A ``record_function`` range, and an NVTX range where CUDA is
    available."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


@contextlib.contextmanager
def trace(profile_dir):
    """Profile the block (host, and the card where there is one) and write
    ``<profile_dir>/trace.json``; a no-op when ``profile_dir`` is falsy.
    Yields the profiler (``None`` when off)."""
    if not profile_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(str(profile_dir), exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(str(profile_dir), "trace.json"))
