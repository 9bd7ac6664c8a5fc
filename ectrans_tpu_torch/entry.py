"""Entry points: a single-device step and a multi-rank dry run.

Counterpart of the JAX package's ``__graft_entry__.py``:

* ``entry(device="cuda")`` returns ``(step, args)``: the flagship round
  trip (vor/div -> winds -> grid -> vor/div, with scalars and derivatives)
  at T47 on the O48 reduced octahedral grid, on the inputs of the JAX
  entry (``default_rng(0)``, fp32, the imaginary parts of m = 0 zeroed);
* ``dryrun_multichip(n, device="cuda")`` runs the distributed round trip
  at T159 on O160 and a 32 x 24 LAM on a (w, v) mesh of n ranks of one
  gloo world (``programs/world.py``), each within 1e-3 of its input.

Neither moves to the CPU on its own: without a card they raise unless
``device="cpu"`` is given.

    python -m ectrans_tpu_torch.entry        # entry() on the card
"""

from __future__ import annotations

import numpy as np
import torch

NUV, NSC = 2, 3
KVSET_TOL = 1e-3


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on "
                           "the CPU")
    return device


def _packed(rng, n: int, res, zero_mean: bool = False) -> torch.Tensor:
    x = rng.standard_normal((n, res.nspec2)).astype(np.float32)
    x[:, 1: 2 * (res.nsmax + 1): 2] = 0.0
    if zero_mean:
        x[:, 0] = 0.0
    return torch.from_numpy(x)


def entry(device="cuda"):
    """(step, args): step(spvor, spdiv, spscalar) -> (vor, div, scalars)
    after an inverse transform with N-S and E-W derivatives and a direct
    transform, fp32, at T47 on O48; args on ``device``."""
    import ectrans_tpu_torch as ett

    device = _device(device)
    res = ett.setup("O48", 47)
    flags = ett.InvFlags(scders=True, uvders=True)

    def step(spvor, spdiv, spscalar):
        grid = ett.inv_trans(res, spvor=spvor, spdiv=spdiv,
                             spscalar=spscalar, flags=flags)
        u, v = grid[0:NUV], grid[NUV: 2 * NUV]
        sc = grid[2 * NUV: 2 * NUV + NSC]
        return ett.dir_trans(res, u=u, v=v, scalars=sc)

    rng = np.random.default_rng(0)
    return step, tuple(_packed(rng, n, res).to(device)
                       for n in (NUV, NUV, NSC))


def _dryrun_rank(rank: int, dev: torch.device, n: int) -> dict:
    """One rank of ``dryrun_multichip``: the errors of its shards."""
    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch.lam import make_lam_grid, setup_lam
    from ectrans_tpu_torch.lam.sharded import ShardedLamTransform
    from ectrans_tpu_torch.parallel import ShardedTransform, make_mesh

    v = 2 if n % 2 == 0 and n > 1 else 1
    mesh = make_mesh(n // v, v, device=dev)
    res = ett.setup("O160", 159)
    st = ShardedTransform(res, mesh, dtype=torch.float32)
    rng = np.random.default_rng(0)
    spvor, spdiv, spsc = (_packed(rng, k, res, zero_mean=True)
                          for k in (NUV, NUV, NSC))
    kvuv, kvsc = [0, v - 1], [v - 1, 0, 0]
    grid = st.inv_trans(spvor=st.dist_spec(spvor, kvuv),
                        spdiv=st.dist_spec(spdiv, kvuv),
                        spscalar=st.dist_spec(spsc, kvsc),
                        flags=ett.InvFlags(scders=True, uvders=True),
                        kvsetuv=kvuv, kvsetsc=kvsc)
    _, _, sc2 = st.dir_trans(u=grid[0:NUV], v=grid[NUV: 2 * NUV],
                             scalars=grid[2 * NUV: 2 * NUV + NSC])
    err = float(np.abs(st.gath_spec(sc2) - spsc.numpy()).max())
    assert err < KVSET_TOL, f"multichip round trip error {err}"

    # the distributed LAM on the same mesh
    lres = setup_lam(make_lam_grid(32, 24))
    lst = ShardedLamTransform(lres, mesh, dtype=torch.float32)
    lsp = np.random.default_rng(1).standard_normal(
        (3, lres.nspec2)).astype(np.float32)
    pm, pn, pc = lres.packed_m, lres.packed_n, lres.packed_c
    lsp[:, ((pm == 0) & (pc >= 2)) | ((pn == 0) & (pc % 2 == 1))] = 0.0
    lg = lst.inv_trans(spscalar=lst.dist_spec(lsp))
    lsp2 = lst.dir_trans(scalars=lg)[2]
    lerr = float(np.abs(lst.gath_spec(lsp2) - lsp).max())
    assert lerr < KVSET_TOL, f"multichip LAM round trip error {lerr}"
    return dict(rank=rank, err=err, lam_err=lerr)


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """The full distributed round trip on an n-rank (w, v) mesh (v = 2 for
    an even n > 1, else 1) of one gloo world on ``device`` (the ranks share
    the cards round-robin): O160 T159 in fp32 with derivatives and the
    KVSET vectors [0, v-1] / [v-1, 0, 0], then a 32 x 24 LAM; each round
    trip within 1e-3 of its input on every rank.  Returns the ranks'
    errors."""
    from ectrans_tpu_torch.programs.world import run

    device = _device(device)
    return run(_dryrun_rank, n_devices, device.type, (n_devices,))


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry() ok:", [tuple(o.shape) for o in out])
