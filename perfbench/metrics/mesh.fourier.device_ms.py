"""mesh.fourier.device_ms: device time a step, on rank 0's card, of the
activities launched inside the Fourier layer's calls on its share (the
bucketed chirp-z synthesis and analysis of its v-rank's fields on its
w-rank's latitude rows)."""

SPANS = {"fourier": [
    "ectrans_tpu_torch.ops.fourier:synthesis_bucketed",
    "ectrans_tpu_torch.ops.fourier:analysis_bucketed"]}


def read(s):
    t = s.device_s.get("fourier", 0.0)
    return s.per_step_ms(t) if t > 0 else None
