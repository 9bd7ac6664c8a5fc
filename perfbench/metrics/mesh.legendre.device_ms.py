"""mesh.legendre.device_ms: device time a step, on rank 0's card, of the
activities launched inside the Legendre layer's calls on its share (K1
and K2 on its w-rank's m's, for its v-rank's fields)."""

SPANS = {"legendre": [
    "ectrans_tpu_torch.parallel.sharded:_inv_rows_in_place",
    "ectrans_tpu_torch.ops.legendre_dense:legendre_dir_rows"]}


def read(s):
    t = s.device_s.get("legendre", 0.0)
    return s.per_step_ms(t) if t > 0 else None
