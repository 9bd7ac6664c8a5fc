"""mesh.boundary.device_ms: device time a step, on rank 0's card, of the
rooted DIST_SPEC, GATH_GRID, DIST_GRID and GATH_SPEC at the harness's
boundary (``ectrans_tpu_torch.programs.driven``): the scatter of each
call's global fields from rank 0 and the gather of its results there,
point to point, with the copies of the blocks.  The IFS keeps its grid
fields distributed between steps; the harness holds them whole."""

SPANS = {"mesh.boundary": [
    "ectrans_tpu_torch.programs.driven:dist_spec",
    "ectrans_tpu_torch.programs.driven:gath_grid",
    "ectrans_tpu_torch.programs.driven:dist_grid",
    "ectrans_tpu_torch.programs.driven:gath_spec"]}


def read(s):
    t = s.device_s.get("mesh.boundary", 0.0)
    return s.per_step_ms(t) if t > 0 else None
