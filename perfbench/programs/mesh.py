"""The program under test for the mesh cells: the port's distributed
transforms, ``SpectralTransform(mesh=make_mesh(w, v))``'s ``inv_trans``
and ``dir_trans``, on a (w, v) mesh of w*v ranks, one a card, over NCCL.

The harness's process is rank 0 (``cuda:0``); the other ranks are spawned
on ``cuda:1`` .. and follow it (``ectrans_tpu_torch.programs.driven``).
The harness holds global fields, so each ``inv`` is a rooted DIST_SPEC of
the call's spectra, the distributed inverse transform and a rooted
GATH_GRID of its output, and each ``dir`` a rooted DIST_GRID, the direct
transform and a rooted GATH_SPEC, all on the device.

A mesh changes the distribution, not the mathematics: the geometry, and so
the reference, is the whole globe's, as ``octahedral.py``'s; it carries
the mesh's shape for the readers that count rank 0's share of the work.
"""

import dataclasses

import torch

from perfbench import reference


@dataclasses.dataclass(frozen=True)
class MeshGeometry(reference.Geometry):
    """``reference.Geometry`` and the (w, v) shape of the mesh."""

    mesh: tuple = (1, 1)


def _shape(config: dict) -> tuple:
    w, v = (int(x) for x in config["mesh"].lower().split("x"))
    return w, v


def geometry(config: dict) -> MeshGeometry:
    return MeshGeometry(config["gauss_number"], config["truncation"],
                        mesh=_shape(config))


class Program:
    def __init__(self, config: dict, traffic, device: str = "cuda"):
        import ectrans_tpu_torch as ett
        from ectrans_tpu_torch.programs.driven import DrivenTransform

        self.ett = ett
        w, v = _shape(config)
        self.driven = DrivenTransform(
            config["grid"], config["truncation"], w, v,
            dtype=getattr(torch, config["dtype"]),
            precision=config["precision"],
            flags=ett.InvFlags(scders=traffic.scders, uvders=traffic.uvders),
            device=device)

    def inv(self, vor, div, sc):
        return self.driven.inv(vor, div, sc)

    def dir(self, u, v, sc):
        return self.driven.dir(u, v, sc)

    def close(self):
        try:
            self.driven.close()
        finally:
            self.ett.trans_end()
