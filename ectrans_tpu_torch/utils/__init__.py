"""Utilities: tracing/timing (DR_HOOK + GSTATS analogue), grid-point
blocking (NPROMA layout), checksums.  Counterpart of ``ectrans_tpu/utils``."""

from .blocking import blocked_to_fields, fields_to_blocked
from .checksum import field_checksum
from .timing import (count, counters, counts, disable, enable, gstats,
                     gstats_report, hook, reset_gstats, spans)

__all__ = [
    "blocked_to_fields",
    "count",
    "counters",
    "counts",
    "disable",
    "enable",
    "field_checksum",
    "fields_to_blocked",
    "gstats",
    "gstats_report",
    "hook",
    "reset_gstats",
    "spans",
]
