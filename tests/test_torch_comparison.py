"""The port's Table 5 harness (``repro_torch.launch.comparison``) end to
end on the CPU at ``Scale.quick()``: all five methods report through the
``DSEMethod`` protocol, RandomSearch runs at GANDSE's candidate budget,
the report lands on disk, and the reproduction's exit rule holds (GANDSE
satisfies at least as many tasks as RandomSearch).  About 15 s."""
import json

import numpy as np
import pytest

from repro_torch.launch import comparison as C
from repro_torch.launch import quality as Q

METHODS = {"GANDSE", "LargeMLP", "DRL", "SA", "RandomSearch"}


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    out = tmp_path_factory.mktemp("comparison")
    return out, C.run_comparison("dnnweaver", C.Scale.quick(), seed=0,
                                 results_dir=str(out), device="cpu")


def test_comparison_harness_end_to_end(report):
    out, rep = report
    scale = C.Scale.quick()
    rows = {r["method"]: r for r in rep["rows"]}
    assert set(rows) == METHODS
    for name, r in rows.items():
        assert r["n_tasks"] == scale.n_tasks, name
        assert np.isfinite(r["dse_time_s"]), name
        assert 0 <= r["n_satisfied"] <= r["n_tasks"], name
    # random search runs at GANDSE's candidate budget
    assert rows["RandomSearch"]["n_candidates"] == pytest.approx(
        max(1, round(rows["GANDSE"]["n_candidates"])))
    # the reproduction's headline claim, at an equal evaluation budget
    assert C.gandse_beats_random_search(rep)
    with open(out / "comparison_dnnweaver.json") as f:
        emitted = json.load(f)
    assert emitted["model"] == "dnnweaver" and len(emitted["rows"]) == 5
    assert emitted["device"] == "cpu"


def test_comparison_reuses_a_finished_row(report, tmp_path):
    """A row passed in ``done`` is reported as given, not run again (how
    the card's smoke run reuses GANDSE's quality row)."""
    rows = {r["method"]: r for r in report[1]["rows"]}
    fake = dict(rows["GANDSE"], n_candidates=3.0, dse_time_s=-1.0)
    rep = C.run_comparison("dnnweaver", C.Scale(n_tasks=8), seed=0,
                           results_dir=str(tmp_path), device="cpu",
                           done={"GANDSE": fake, "LargeMLP": fake,
                                 "DRL": fake})
    by = {r["method"]: r for r in rep["rows"]}
    assert by["GANDSE"]["dse_time_s"] == -1.0
    assert by["RandomSearch"]["n_candidates"] == 3.0   # fake's budget
    assert by["SA"]["n_tasks"] == 8


def test_comparison_registry_and_the_quality_row_share_one_scale():
    assert set(C.MODELS) == set(C.MODEL_PRESETS) == {"dnnweaver", "im2col",
                                                    "tpu_mesh"}
    for cls in C.MODELS.values():
        assert cls().has_torch_oracle       # every model serves the batch
    assert not hasattr(Q, "N_DATA") and not hasattr(Q, "gan_config")
    cfg = C.gan_config(C.MODELS["dnnweaver"](), C.Scale())
    assert (cfg.g_hidden_layers, cfg.g_neurons, cfg.batch_size) == (3, 256, 512)


def test_main_writes_results_and_exits_by_the_rule(monkeypatch, tmp_path):
    monkeypatch.setattr(C, "RESULTS_DIR", str(tmp_path))
    seen = {}
    real = C.run_comparison

    def short(name, scale, **kw):
        seen.update(kw, n_tasks=scale.n_tasks)
        return real(name, C.Scale(n_tasks=8, n_data=1024, iters=1), **kw)

    monkeypatch.setattr(C, "run_comparison", short)
    rc = C.main(["--models", "dnnweaver", "--device", "cpu", "--quick"])
    with open(tmp_path / "comparison.json") as f:
        combined = json.load(f)
    assert rc == (0 if C.gandse_beats_random_search(combined["dnnweaver"])
                  else 1)
    assert seen["device"] == "cpu" and seen["results_dir"] == str(tmp_path)
    assert seen["n_tasks"] == 50
