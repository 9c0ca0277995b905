"""Readings of the program's own trace (``r2dm_tpu_torch/utils/trace.py``).

Under ``--trace 1`` each driver runs one more short segment after its
profiled windows, with the program's tracing on for that segment alone, and
keeps ``observed["program"]``: the program's ``snapshot()`` (``spans``, and
``counters`` counted over the segment), ``t0`` and ``t1``, the host clock at
the segment's start and end, and ``units``, the steps or requests it ran.
A per-layer metric of ``source: program_span`` or ``program_counter`` is a
file of ``metrics/`` that calls one of these functions. Each returns None
when the run kept no segment or the segment holds nothing of what it reads.
"""

from __future__ import annotations

from statistics import fmean


def _spans(observed: dict, name: str) -> list:
    program = observed.get("program")
    return [s for s in program["spans"] if s["name"] == name] if program else []


def span_ms(observed: dict, name: str):
    """The mean host milliseconds of the spans ``name``."""
    spans = _spans(observed, name)
    return 1e3 * fmean(s["t1"] - s["t0"] for s in spans) if spans else None


def lead_ms(observed: dict, name: str):
    """The mean milliseconds from a span's start on the host to its start on
    the device (``d0 - t0``), over the spans ``name`` that carry device
    events: how long their work waited in the stream behind earlier work."""
    spans = [s for s in _spans(observed, name) if s["d0"] is not None]
    return 1e3 * fmean(s["d0"] - s["t0"] for s in spans) if spans else None


def unit_gap_ms(observed: dict, name: str):
    """The mean device milliseconds from one request's last span ``name``
    ending on the device to the next request's first one starting there,
    over consecutive requests of the segment (the spans' ``request``)."""
    by_request: dict = {}
    for s in _spans(observed, name):
        if s["request"] is not None and s["d0"] is not None:
            by_request.setdefault(s["request"], []).append(s)
    units = [by_request[r] for r in sorted(by_request)]
    gaps = [min(s["d0"] for s in b) - max(s["d1"] for s in a) for a, b in zip(units, units[1:])]
    return 1e3 * fmean(gaps) if gaps else None


def count(observed: dict, name: str):
    """The counter ``name`` over the segment."""
    program = observed.get("program")
    return program["counters"].get(name) if program else None


def share(observed: dict, name: str):
    """The share of the segment's host time that the spans ``name`` cover,
    summed (on any thread), in percent."""
    program, spans = observed.get("program"), _spans(observed, name)
    if not spans or program["t1"] <= program["t0"]:
        return None
    t0, t1 = program["t0"], program["t1"]
    covered = sum(max(0.0, min(s["t1"], t1) - max(s["t0"], t0)) for s in spans)
    return 100.0 * covered / (t1 - t0)
