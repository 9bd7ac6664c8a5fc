"""A traced run whose span names a function the program no longer has
names it and leaves out the metrics that read that span; the others
stand."""

from perfbench import spec, tracing

from .small import STEP, cell, run


def test_a_renamed_span_leaves_its_metrics_out(monkeypatch):
    real = spec.reader

    def renamed(name, *a, **k):
        mod = real(name, *a, **k)
        if name == "fourier.device_ms":
            mod.SPANS = {"fourier_v2": ["ectrans_tpu_torch.transform:"
                                        "synthesis_renamed"]}
        return mod

    monkeypatch.setattr(spec, "reader", renamed)
    said = []
    c = cell(STEP, "tco1279-l137-step")
    c.per_layer = [m for m in c.per_layer
                   if m["name"] in ("api.host_ms", "fourier.device_ms")]
    r = run(c, trace=True, say=said.append)
    assert r["correct"]
    assert "api.host_ms" in r["metrics"]
    assert "fourier.device_ms" not in r["metrics"]
    assert any("synthesis_renamed" in s for s in said)


def test_wrapping_is_undone():
    import ectrans_tpu_torch as ett

    orig = ett.inv_trans
    with tracing.wrapped({"api": ["ectrans_tpu_torch:inv_trans"]}) as broken:
        assert ett.inv_trans is not orig and not broken
    assert ett.inv_trans is orig
