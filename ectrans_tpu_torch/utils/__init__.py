"""Utilities: tracing/timing (DR_HOOK + GSTATS analogue), grid-point
blocking (NPROMA layout), checksums.  Counterpart of ``ectrans_tpu/utils``."""

from .blocking import blocked_to_fields, fields_to_blocked
from .checksum import field_checksum
from .timing import gstats, gstats_report, hook, reset_gstats, timed

__all__ = [
    "blocked_to_fields",
    "field_checksum",
    "fields_to_blocked",
    "gstats",
    "gstats_report",
    "hook",
    "reset_gstats",
    "timed",
]
