"""The import guard compares whole top-level names."""

from perfbench import run


def test_forbidden_modules_match_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax", "ectrans_tpu",
             "ectrans_tpu.transform", "ectrans_tpu_torch",
             "ectrans_tpu_torch.transform", "jaxtyping", "numpy"]
    assert run.forbidden_modules(names) == [
        "ectrans_tpu", "ectrans_tpu.transform", "flax", "jax", "jax.numpy",
        "jaxlib.xla_client"]
    assert run.forbidden_modules(["ectrans_tpu_torch.ops"]) == []


def test_a_run_without_a_card_fails_before_any_result(capsys, monkeypatch):
    import os

    import torch

    monkeypatch.setattr(os, "environ", dict(os.environ))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "tco639-f1-rt", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
