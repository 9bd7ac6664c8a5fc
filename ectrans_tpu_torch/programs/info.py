"""``info`` command (counterpart of ``ectrans_tpu/programs/info.py``, the
installed ``ectrans`` script analogue, reference
``src/programs/ectrans.in:19-40``): prints the version, torch and its CUDA
build, the card, whether the kernels and the native Legendre builder are
built, the table knobs and the features.  It builds nothing and runs on a
machine without a card.

    python -m ectrans_tpu_torch.programs.info
"""

from __future__ import annotations

import os


def main():
    import torch

    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch import _build, native, resolution

    print(f"ectrans_tpu_torch version {ett.__version__}")
    print(f"torch {torch.__version__}, CUDA build "
          f"{torch.version.cuda or 'none (CPU only)'}")
    if torch.cuda.is_available():
        print(f"device: {torch.cuda.get_device_name(0)}, devices: "
              f"{torch.cuda.device_count()}")
    else:
        print("device: no CUDA device")
    lib = _build.library_path()
    print(f"kernels (csrc/, sm_90a): "
          f"{'built, ' + lib.name if lib.exists() else 'not built'} in "
          f"{_build.BUILD_DIR} (built by nvcc at first use on a card)")
    print(f"native legendre builder: {native.state()}")
    src = os.environ.get("ECTRANS_TPU_TABLE_SOURCE") or "auto"
    print(f"legendre tables: source {src} (auto: the table kernel K4 on the "
          "card, the host builder on the CPU), groups "
          f"{os.environ.get('ECTRANS_TPU_LEG_GROUPS') or 'default (<= 16)'}, "
          f"fp64 host tables up to nsmax {resolution.fp64_table_limit()}")
    print("features: global spherical harmonics (full/reduced/octahedral "
          "Gaussian grids), Legendre engines dense/xla/pallas/planes with "
          "hand-written CUDA kernels, LAM bi-Fourier (etrans), adjoints, "
          "distributed (w, v) mesh transforms (torch.distributed), lat-lon "
          "output, stretched-sphere Legendre polynomials")


if __name__ == "__main__":
    main()
