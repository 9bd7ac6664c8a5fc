"""Spectral-layout conversions: packed NASM0 <-> dense (c, m, n) <-> parity.

Counterpart of ``ectrans_tpu/ops/layout.py`` (reference PRFI1B/UPDSP per-m
copies, ``prfi1b_mod.F90``, ``updsp_mod.F90``), as index gathers with the
maps of ``resolution.build_packed_maps``, and the parity split of the
"xla"/"pallas" Legendre engines as pad + reshape realignments.  Only the
"xla" engine's direct transform uses ``dense_to_packed``: the others pack
with the compaction kernel of ``ops.pack``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class _PackedToDense(torch.autograd.Function):
    """The gather of ``packed_to_dense``, with its transpose as a scatter
    without accumulation: every packed value has one dense position, and
    the appended zero slot, which takes every position outside the
    triangle, is dropped.  (Autograd's own transpose of the gather adds
    the ~nspec2 duplicates of that slot one after another on a GPU.)"""

    @staticmethod
    def forward(ctx, spec, gather):
        ctx.save_for_backward(gather)
        ctx.nspec2 = spec.shape[1]
        return F.pad(spec, (0, 1))[:, gather]

    @staticmethod
    def backward(ctx, grad):
        (gather,) = ctx.saved_tensors
        out = grad.new_zeros((grad.shape[0], ctx.nspec2 + 1))
        out[:, gather] = grad
        return out[:, : ctx.nspec2], None


def packed_to_dense(spec: torch.Tensor, tables) -> torch.Tensor:
    """(nfld, nspec2) -> (nfld, 2, M, NP); exact zeros outside
    m <= n <= nsmax (those entries gather the appended zero slot)."""
    return _PackedToDense.apply(spec, tables.dense_gather)


def dense_to_packed(dense: torch.Tensor, res) -> torch.Tensor:
    """(nfld, 2, M, NP) -> (nfld, nspec2): a per-element gather."""
    idx = res.cached(("packed_gather", str(dense.device)), lambda: tuple(
        torch.as_tensor(a, device=dense.device) for a in
        (res.packed_gather_c, res.packed_gather_m, res.packed_gather_n)))
    return dense[:, idx[0], idx[1], idx[2]]


def diag_realign(dense: torch.Tensor) -> torch.Tensor:
    """(nfld, 2, M, NP) -> (nfld, 2, M, NP+1) with d2[..., m, j] =
    dense[..., m, m+j]: a pad + reshape (m*(W+1) + j = m*W + (m+j)); entries
    past each row's diagonal end are neighbouring rows' data."""
    f, c, M, W = dense.shape
    flat = F.pad(dense.reshape(f, c, M * W), (0, M))
    return flat.reshape(f, c, M, W + 1)


def diag_unalign(d2: torch.Tensor, NP: int) -> torch.Tensor:
    """Inverse of diag_realign: dense[..., m, n] = d2[..., m, n-m] (entries
    at n < m are neighbouring rows' data)."""
    f, c, M, W1 = d2.shape
    return d2.reshape(f, c, M * W1)[..., : M * NP].reshape(f, c, M, NP)


def dense_to_parity(dense: torch.Tensor, kmax: int):
    """(nfld, 2, M, NP) -> sym, asym each (nfld, 2, M, kmax):
    sym[..., m, k] = dense[..., m, m+2k], asym at n = m+1+2k.

    The diagonal realignment (no gather) and a stride-2 split.  Entries past
    the m-th diagonal's end are neighbouring rows' data; the Legendre tables
    are exactly zero there, and every n+-1 coefficient vanishes at the
    parity boundary (eps(m, m) = 0)."""
    d2 = diag_realign(dense)
    return d2[..., 0::2][..., :kmax], d2[..., 1::2][..., :kmax]


def parity_to_dense(sym: torch.Tensor, asym: torch.Tensor,
                    NP: int) -> torch.Tensor:
    """Inverse of dense_to_parity on the valid (n >= m) region:
    (nfld, 2, M, K) pair -> (nfld, 2, M, NP).  Entries at n < m are
    neighbouring rows' coefficients, not zeros: every consumer masks with
    the (n >= m) validity table or gathers valid positions only."""
    f, c, M, K = sym.shape
    d2 = torch.stack([sym, asym], dim=-1).reshape(f, c, M, 2 * K)
    return diag_unalign(F.pad(d2, (0, NP + 1 - 2 * K)), NP)
