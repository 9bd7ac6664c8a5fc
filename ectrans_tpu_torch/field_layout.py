"""PGP output field-group bookkeeping: a copy of ``ectrans_tpu/field_layout.py``.

The inverse transform emits its grid fields in the reference's PGP order
(``inv_trans.F90:58-106``): vor?, div?, u, v, scalars, N-S derivs of
scalars?, E-W derivs of u and v?, E-W derivs of scalars?.  The NPROMATR
packet loop of ``transform.py`` reassembles its packets' outputs with it;
the v-padding strips and the KVSET un-permutation serve the distributed
transforms.  The group list lives here exactly once.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: group name -> which input family ("uv" or "sc") its field count follows
KIND = {
    "vor": "uv", "div": "uv", "u": "uv", "v": "uv",
    "ewu": "uv", "ewv": "uv",
    "sc": "sc", "nsd": "sc", "ewsc": "sc",
}


@dataclasses.dataclass(frozen=True)
class FieldLayout:
    """Ordered PGP output groups with real and padded per-group sizes."""

    #: tuple of (name, nreal, npadded) in output order
    groups: tuple

    @classmethod
    def inv(cls, nuv: int, nsc: int, flags, pad_uv: int | None = None,
            pad_sc: int | None = None) -> "FieldLayout":
        """Layout of the inverse-transform output for ``nuv`` vor/div pairs
        and ``nsc`` scalars under ``flags``; per-group padded sizes default
        to the real sizes."""
        Fuv = nuv if pad_uv is None else pad_uv
        Fsc = nsc if pad_sc is None else pad_sc
        g = []
        if nuv and flags.vorgp:
            g.append(("vor", nuv, Fuv))
        if nuv and flags.divgp:
            g.append(("div", nuv, Fuv))
        if nuv:
            g += [("u", nuv, Fuv), ("v", nuv, Fuv)]
        if nsc:
            g.append(("sc", nsc, Fsc))
        if nsc and flags.scders:
            g.append(("nsd", nsc, Fsc))
        if nuv and flags.uvders:
            g += [("ewu", nuv, Fuv), ("ewv", nuv, Fuv)]
        if nsc and flags.scders:
            g.append(("ewsc", nsc, Fsc))
        return cls(groups=tuple(g))

    # -- sizes ----------------------------------------------------------
    @property
    def names(self) -> tuple:
        return tuple(n for n, _, _ in self.groups)

    @property
    def sizes_padded(self) -> tuple:
        return tuple(p for _, _, p in self.groups)

    @property
    def total_real(self) -> int:
        return sum(r for _, r, _ in self.groups)

    @property
    def total_padded(self) -> int:
        return sum(p for _, _, p in self.groups)

    # -- indexing ---------------------------------------------------------
    def split(self, out) -> dict:
        """Slice a padded-layout leading axis into {name: real-size block}."""
        parts = {}
        off = 0
        for name, real, pad in self.groups:
            parts[name] = out[off : off + real]
            off += pad
        return parts

    def strip_index(self) -> np.ndarray | None:
        """Leading-axis index selecting the real fields out of the padded
        layout, or None when no padding exists."""
        if self.total_real == self.total_padded:
            return None
        sel = []
        off = 0
        for _, real, pad in self.groups:
            sel.extend(range(off, off + real))
            off += pad
        return np.asarray(sel)

    def kvset_index(self, pos_uv: dict | None, pos_sc: dict | None,
                    nslots_uv: int, nslots_sc: int) -> np.ndarray:
        """Leading-axis index un-permuting a KVSET slot-major padded output
        back to the caller's field order.  ``pos_*[field] = slot``;
        ``nslots_*`` is the padded slot count per group of that kind."""
        sel = []
        off = 0
        for name, real, _ in self.groups:
            pos, nslots = ((pos_uv, nslots_uv) if KIND[name] == "uv"
                           else (pos_sc, nslots_sc))
            sel.extend(off + pos[i] for i in range(real))
            off += nslots
        return np.asarray(sel)
