"""fourier.device_ms: device time a step of the activities launched
inside the Fourier layer's calls (synthesis and analysis)."""

SPANS = {"fourier": ["ectrans_tpu_torch.transform:synthesis",
                     "ectrans_tpu_torch.transform:analysis"]}


def read(s):
    t = s.device_s.get("fourier", 0.0)
    return s.per_step_ms(t) if t > 0 else None
