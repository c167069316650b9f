"""Profiler spans of the port.

``span(name)`` is ``torch.profiler.record_function(name)`` while a profiler
runs and a no-op otherwise, so a span costs nothing outside a trace.  The
spans: ``repro.mamba`` around each Mamba-2 mixer call (``models.ssm``),
``repro.analog.fail_planes`` around each draw of write-error planes
(``imc.analog_pipeline.write_ber_masks``) and ``repro.attn.tile``, one a
(query block, key chunk) tile that ``models.attention.chunked_attention``
computes, nested around each key chunk's work on its query blocks (the
forward; autograd launches the backward outside the spans).
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch.profiler import record_function


def span(name: str):
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return contextlib.nullcontext()


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
