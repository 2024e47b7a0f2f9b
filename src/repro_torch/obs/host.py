"""Wall-clock host spans, on the profiler's clock.

The ``Tracer`` measures the simulated cluster; this module measures the
host work the real process does while serving: fetching and checking
blocks, staging tiles, waiting on the card, assembling and hashing
payloads. A span is both a profiler range named ``repro_torch.<name>``,
so it lands in the profiler's trace on the same clock as the device's
copies and kernels, and four counters in the serving call's
``MetricsRegistry``:

  ``host_s{span=...}``       inclusive wall seconds
  ``host_self_s{span=...}``  those seconds less the span's child spans
  ``host_bytes{span=...}``   the bytes the span's work touched
  ``host_calls{span=...}``   how many times the span ran

Besides spans, ``count`` adds to a plain counter of the same registry
under the same rule, for what a span's work did inside it: the batched
crc32 check (``storage/blockstore.py``) counts the blocks it hashed,
``host_verify_blocks{path=pooled|inline}``, and the threads it hashed
them on, ``host_verify_workers{span=...}`` under the innermost open span;
every digest counts the bytes it hashed by the routine that hashed them,
``host_crc32_bytes{impl=fold|zlib}``.

Spans record only inside ``recording(metrics, root)``, which the serving
entry point opens once per call, and only while a profiler is running.
Everywhere else ``span()`` returns one shared no-op context, so an
untraced run pays one function call per span site and its reports gain
no counters. The registry being recorded into is module state, as the
profiler's own is: the span sites (the coalescer, the fixer) hold no
handle to the call's report, and ``recording`` sets it and puts the
previous one back. Single-threaded, as the gateway is: worker threads
neither open spans nor count.

The range has function scope (``_RecordFunctionFast``), as an operator's
has, and not the user scope of ``torch.profiler.record_function``: the
profiler copies a user-scope range onto the device's annotation track
over the device work it encloses, where a reader of the trace would take
it for device time. A function-scope range stays on the host.
"""

from __future__ import annotations

import contextlib
import time

import torch

_registry = None  # the MetricsRegistry spans record into, while recording
_open: list["_Span"] = []  # spans entered and not yet left, innermost last


class _NullSpan:
    """The shared no-op span: ``nbytes`` may be set and is dropped."""

    __slots__ = ("nbytes",)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "nbytes", "child_s", "_range", "_t0", "_registry")

    def __init__(self, name: str, nbytes: int, attrs: dict):
        self.name = name
        self.nbytes = nbytes
        self.child_s = 0.0
        self._range = torch._C._profiler._RecordFunctionFast("repro_torch." + name, (), attrs)
        self._registry = _registry

    def __enter__(self):
        self._range.__enter__()
        _open.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        _open.pop()
        self._range.__exit__(*exc)
        if _open:
            _open[-1].child_s += dur
        m, name = self._registry, self.name
        m.counter("host_s", span=name).inc(dur)
        m.counter("host_self_s", span=name).inc(dur - self.child_s)
        m.counter("host_bytes", span=name).inc(self.nbytes)
        m.counter("host_calls", span=name).inc()
        return None


def span(name: str, nbytes: int = 0, **attrs):
    """A host span named ``name`` while recording (``attrs`` become the
    profiler range's keyword inputs, ``nbytes`` may also be set on the span before
    it closes), else the shared no-op context."""
    if _registry is None:
        return _NULL
    return _Span(name, nbytes, attrs)


def count(name: str, value: float = 1, **labels) -> None:
    """Add ``value`` to the counter ``name{labels}`` while recording,
    else nothing."""
    if _registry is not None:
        _registry.counter(name, **labels).inc(value)


def innermost() -> str | None:
    """The name of the innermost open span while recording, else None."""
    return _open[-1].name if _open else None


@contextlib.contextmanager
def _recording(metrics, root: str):
    global _registry
    prev, _registry = _registry, metrics
    try:
        with _Span(root, 0, {}) as sp:
            yield sp
    finally:
        _registry = prev


def recording(metrics, root: str):
    """Record spans into ``metrics`` under a root span named ``root`` for
    the ``with`` block, when a profiler is running (checked here, once);
    else the no-op context."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return _recording(metrics, root)
