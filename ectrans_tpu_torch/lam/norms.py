"""LAM spectral and grid-point norms (ESPECNORM / EGPNORM_TRANS).

Counterpart of ``ectrans_tpu/lam/norms.py``:

* ``especnorm``: per-field sqrt of the metric-weighted sum of squares of all
  four components per elliptic (m, n) pair — the reference ESPNORMD
  accumulation (``espnormd_mod.F90:40-55``: met(m,n) * (c0^2+c1^2+c2^2+c3^2)).
* ``egpnorm``: per-field (average, min, max).  ``full_domain=True``
  (default) covers the whole extended domain — the reference
  EGPNORM_TRANS statistics run over NGPTOT, i.e. including the extension
  zone; ``full_domain=False`` restricts to the C+I zone.

Both run on the device of their input tensor.
"""

from __future__ import annotations

import torch

from .resolution import LamResolution


def especnorm(res: LamResolution, spec: torch.Tensor, met=None):
    """spec: (nfld, nspec2); met: per-(m,n) weights (M, N) or None."""
    sq = spec * spec
    if met is not None:
        t = res.device_tables(torch.float64, spec.device)
        w = torch.as_tensor(met, device=spec.device)[t["packed_m"],
                                                     t["packed_n"]]
        sq = sq * w[None, :].to(spec.dtype)
    return torch.sqrt(torch.sum(sq, dim=1))


def egpnorm(res: LamResolution, grid: torch.Tensor, ave_only: bool = False,
            full_domain: bool = True):
    """grid: (nfld, ny, nx) -> per-field (ave, min, max); (ave, None, None)
    with ave_only.

    full_domain=True matches the reference EGPNORM_TRANS (statistics over
    the whole extended domain, NGPTOT); full_domain=False restricts to
    the C+I zone."""
    g = res.grid
    ci = grid if full_domain else grid[:, : g.nyux, : g.nxux]
    ave = torch.mean(ci, dim=(1, 2))
    if ave_only:
        return ave, None, None
    return ave, torch.amin(ci, dim=(1, 2)), torch.amax(ci, dim=(1, 2))
