"""The one generator of every traffic mix.

A mix is a data file ``perfbench/traffic/<name>.json`` of parameters: the
field set of one step (levels of vorticity and divergence, scalars per
level, surface scalars), the levels a transform call carries (the IFS's
NPROMATR packets), the inverse flags, and how many steps warm up, are
traced and are kept for the check.  A step is the packet loop of one IFS
time step (``ectrans-benchmark-ifs``): each packet is one inverse and one
direct transform of its levels, and the direct outputs, reassembled, are
the next step's input.  Between the two transforms the harness adds a
fixed grid-point update drawn from the seed, ``grid_update`` times the
geometry's (as the IFS's grid-point work changes the fields between the
transforms), with a sign of its own for each field of a call and the
opposite sign on every other step, so that the state stays bounded and
the direct transform never gets back just the inverse's output.  One
round trip of one field is the mix with one level, one scalar and no
winds.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

TRAFFIC_DIR = pathlib.Path(__file__).resolve().parent / "traffic"


@dataclasses.dataclass(frozen=True)
class Packet:
    lo: int                 # vorticity/divergence levels [lo, hi)
    hi: int
    sc_rows: tuple          # the rows of the scalar state it carries

    @property
    def nuv(self) -> int:
        return self.hi - self.lo

    @property
    def nsc(self) -> int:
        return len(self.sc_rows)


@dataclasses.dataclass(frozen=True)
class Traffic:
    name: str
    levels: int
    packet_levels: int
    vordiv: bool
    scalars_per_level: int
    surface_scalars: int
    scders: bool
    uvders: bool
    grid_update: float      # the update's amplitude; 0: none
    warmup_steps: int
    trace_steps: int
    kept_steps: int         # steps kept for the check besides the first

    @property
    def nuv(self) -> int:
        return self.levels if self.vordiv else 0

    @property
    def nsc(self) -> int:
        return self.scalars_per_level * self.levels + self.surface_scalars

    def packets(self) -> list:
        """The packet loop over levels: levels [lo, hi) of each
        per-level scalar, and the surface scalars in the first packet."""
        out = []
        n, s = self.levels, self.scalars_per_level
        for lo in range(0, n, self.packet_levels):
            hi = min(n, lo + self.packet_levels)
            rows = [b * n + k for b in range(s) for k in range(lo, hi)]
            if lo == 0:
                rows += list(range(s * n, s * n + self.surface_scalars))
            out.append(Packet(lo if self.vordiv else 0,
                              hi if self.vordiv else 0, tuple(rows)))
        return out

    def outputs(self, p: Packet) -> int:
        """Grid fields of a packet's inverse transform."""
        n = 2 * p.nuv + p.nsc
        if self.uvders:
            n += 2 * p.nuv
        if self.scders:
            n += 2 * p.nsc
        return n

    def families(self, p: Packet) -> list:
        """(name, first, stop) rows of each family of the inverse output
        (u and v, the scalars, their N-S derivatives, the E-W derivatives
        of u and v, those of the scalars)."""
        out, i = [], 0
        for name, k, on in (("inv.uv", 2 * p.nuv, True),
                            ("inv.sc", p.nsc, True),
                            ("inv.sc_ns", p.nsc, self.scders),
                            ("inv.uv_ew", 2 * p.nuv, self.uvders),
                            ("inv.sc_ew", p.nsc, self.scders)):
            if on and k:
                out.append((name, i, i + k))
                i += k
        return out

    def calls(self) -> list:
        """Each transform call of a step: (direction, nuv, nsc)."""
        out = []
        for p in self.packets():
            out += [("inv", p.nuv, p.nsc), ("dir", p.nuv, p.nsc)]
        return out


def load(name: str, directory: pathlib.Path = TRAFFIC_DIR) -> Traffic:
    d = json.loads((directory / f"{name}.json").read_text())
    return from_dict(name, d)


def from_dict(name: str, d: dict) -> Traffic:
    keys = {f.name for f in dataclasses.fields(Traffic)} - {"name"}
    return Traffic(name=name, **{k: d[k] for k in keys})
