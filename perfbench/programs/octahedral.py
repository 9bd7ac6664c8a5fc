"""The program under test for the global cells: the port's public entry
points, ``ectrans_tpu_torch.setup``, ``inv_trans`` and ``dir_trans``, on
one card and one Resolution of a cubic octahedral Gaussian grid, in the
configuration's dtype and precision tier.  The entry points are looked up
on the package at every call, so that a traced run's spans see them.

A program file gives ``geometry(config)``, whose object the harness and
the reference share (``perfbench/reference.py`` for this one), and
``Program(config, traffic)`` with ``inv``, ``dir`` and ``close``.
"""

import torch

from perfbench import reference


def geometry(config: dict) -> reference.Geometry:
    return reference.Geometry(config["gauss_number"], config["truncation"])


class Program:
    def __init__(self, config: dict, traffic):
        import ectrans_tpu_torch as ett

        self.ett = ett
        self.res = ett.setup(config["grid"], config["truncation"])
        self.dtype = getattr(torch, config["dtype"])
        self.precision = config["precision"]
        self.flags = ett.InvFlags(scders=traffic.scders,
                                  uvders=traffic.uvders)

    def inv(self, vor, div, sc):
        return self.ett.inv_trans(self.res, spvor=vor, spdiv=div,
                                  spscalar=sc, flags=self.flags,
                                  dtype=self.dtype, precision=self.precision)

    def dir(self, u, v, sc):
        return self.ett.dir_trans(self.res, u=u, v=v, scalars=sc,
                                  dtype=self.dtype, precision=self.precision)

    def close(self):
        self.ett.trans_end()
