"""``info`` command (counterpart of ``ectrans_tpu/programs/info.py``, the
installed ``ectrans`` script analogue, reference
``src/programs/ectrans.in:19-40``): prints the version, torch and its CUDA
build, the card, whether the kernels are built, the table source and the
features.  It builds nothing and runs on a machine without a card.

    python -m ectrans_tpu_torch.programs.info
"""

from __future__ import annotations


def main():
    import torch

    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch import _build

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
    print("legendre tables: the table kernel K4 on the card, the fp64 "
          "recurrence in torch/numpy on the CPU")
    print("features: global spherical harmonics (full/reduced/octahedral "
          "Gaussian grids), Legendre engines dense/xla/pallas/planes with "
          "hand-written CUDA kernels, LAM bi-Fourier (etrans), adjoints, "
          "distributed (w, v) mesh transforms (torch.distributed), lat-lon "
          "output, stretched-sphere Legendre polynomials")


if __name__ == "__main__":
    main()
