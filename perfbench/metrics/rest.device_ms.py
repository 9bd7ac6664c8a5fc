"""rest.device_ms: device time a step outside the Fourier and Legendre
layers' calls: the spectral operators, the layout changes, the packing
(K3) and the step's own reassembly."""

SPANS = {"fourier": ["ectrans_tpu_torch.transform:synthesis",
                     "ectrans_tpu_torch.transform:analysis"],
         "legendre": [
             "ectrans_tpu_torch.ops.legendre_dense:legendre_inv_dense",
             "ectrans_tpu_torch.ops.legendre_dense:legendre_dir_rows"]}


def read(s):
    rest = sum(v for k, v in s.device_s.items()
               if k not in ("fourier", "legendre"))
    return s.per_step_ms(rest) if s.busy_s > 0 else None
