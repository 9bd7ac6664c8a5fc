"""The benchmark of ectrans_tpu_torch (see README.md)."""
