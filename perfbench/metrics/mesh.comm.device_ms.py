"""mesh.comm.device_ms: device time a step, on rank 0's card, of the
activities launched inside the distributed transforms' transpositions
(TRMTOL, TRLTOM over "w"; TRLTOG, TRGTOL over "v") and the all_reduce
after the packing (UPDSP): the port's ``parallel.comm.all_to_all`` and
``all_reduce_sum``.  A collective's kernels wait there for the other
ranks, so the metric holds their lateness too."""

SPANS = {"mesh.comm": ["ectrans_tpu_torch.parallel.comm:all_to_all",
                       "ectrans_tpu_torch.parallel.comm:all_reduce_sum"]}


def read(s):
    t = s.device_s.get("mesh.comm", 0.0)
    return s.per_step_ms(t) if t > 0 else None
