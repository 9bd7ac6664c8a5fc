"""legendre.device_ms: device time a step of the activities launched
inside the Legendre layer's calls (the dense engine's inverse and direct
transforms, kernels K1 and K2)."""

SPANS = {"legendre": [
    "ectrans_tpu_torch.ops.legendre_dense:legendre_inv_dense",
    "ectrans_tpu_torch.ops.legendre_dense:legendre_dir_rows"]}


def read(s):
    t = s.device_s.get("legendre", 0.0)
    return s.per_step_ms(t) if t > 0 else None
