"""What `correct` must refuse, at a size the CPU holds: the control (the
reference a precision step down, TF32, in the program's place), and each
fault a cell can have planted under a run's timed path, with the run
driven from set-up to its check as the harness drives it once it has
found its card."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from perfbench.tests import smallrun

EXPLORE = ["im2col.explore.t1024", "dnnweaver.explore.t1024"]
TRAIN = ["im2col.train.b1024", "dnnweaver.train.b1024"]
CELLS = [w["name"] for w in smallrun.bench()["workloads"]]


def cells(names):
    return [n for n in names if n in CELLS]


def run_checks(workload, seed=7):
    """A run's checks; a window of no length makes one call (one epoch)."""
    driver, run = smallrun.make(workload, seed=seed)
    st = driver.setup(run)
    return driver.check(st, driver.window(st, 0.0, None))


@pytest.mark.parametrize("workload", cells(EXPLORE + TRAIN))
@pytest.mark.parametrize("seed", [3, 2**32 + 9])
def test_the_control_is_not_correct(workload, seed):
    # TF32 moves a decision of a few tasks in a few hundred at this size
    driver, run = smallrun.make(workload, seed=seed, tasks=256)
    st = driver.setup(run)
    checks = driver.control_checks(st, driver.window(st, 0.0, None), "tf32")
    assert not smallrun.correct(checks), checks


@pytest.mark.parametrize("workload", cells(EXPLORE))
def test_an_answer_altered_where_it_is_produced(workload, monkeypatch):
    from repro_torch.core import fused_select
    real = fused_select.select_batch

    def altered(*args, **kw):
        sels = real(*args, **kw)
        return [dataclasses.replace(s, latency=s.latency * (1 + 1e-12))
                if s.cfg_idx is not None else s for s in sels]

    monkeypatch.setattr(fused_select, "select_batch", altered)
    assert not smallrun.correct(run_checks(workload))


@pytest.mark.parametrize("workload", cells(EXPLORE))
def test_half_the_tasks_left_out(workload, monkeypatch):
    from repro_torch.core.explorer import Explorer
    real = Explorer.generator_probs_device

    def half(self, net_idx, lat_obj, pow_obj, seed=0):
        n = len(net_idx) // 2
        probs = real(self, net_idx[:n], lat_obj[:n], pow_obj[:n],
                     seed=seed[:n])
        return torch.cat([probs, probs])

    monkeypatch.setattr(Explorer, "generator_probs_device", half)
    assert not smallrun.correct(run_checks(workload))


@pytest.mark.parametrize("workload", cells(TRAIN))
def test_a_step_that_returns_its_state_unchanged(workload, monkeypatch):
    from repro_torch.core import train
    real = train.make_epoch_fn

    def stuck(*args, **kw):
        g_optim, d_optim, epoch = real(*args, **kw)

        def same(carry, data, perm):
            return carry, epoch(carry, data, perm)[1]

        return g_optim, d_optim, same

    monkeypatch.setattr(train, "make_epoch_fn", stuck)
    checks = {c.name: c.value for c in run_checks(workload)}
    assert checks["update_gap"] == checks["epoch_update_gap"] == 1.0


@pytest.mark.parametrize("workload", cells(TRAIN))
@pytest.mark.parametrize("fault", ["unchanged", "half batch"])
def test_a_fault_only_at_the_windows_shape(workload, fault, monkeypatch):
    """An epoch call that is sound for the first steps' one and two batches
    and faulty for the window's full epochs."""
    from repro_torch.core import train
    real = train.make_epoch_fn

    def faulty(*args, **kw):
        g_optim, d_optim, epoch = real(*args, **kw)

        def at_shape(carry, data, perm):
            if perm.shape[0] <= 2:
                return epoch(carry, data, perm)
            if fault == "unchanged":
                return carry, epoch(carry, data, perm)[1]
            return epoch(carry, data, perm[:, : perm.shape[1] // 2])

        return g_optim, d_optim, at_shape

    monkeypatch.setattr(train, "make_epoch_fn", faulty)
    checks = {c.name: c for c in run_checks(workload)}
    assert checks["first_loss_gap"].ok and checks["update_gap"].ok
    assert not all(c.ok for name, c in checks.items()
                   if name.startswith("epoch_"))


@pytest.mark.parametrize("workload", cells(TRAIN))
def test_half_the_batch_left_out(workload, monkeypatch):
    from repro_torch.core import train
    real = train._make_step_body

    def halved(*args, **kw):
        g_optim, d_optim, body = real(*args, **kw)

        def half(carry, batch):
            n = batch["net_enc"].shape[0] // 2
            return body(carry, {k: v[:n] for k, v in batch.items()})

        return g_optim, d_optim, half

    monkeypatch.setattr(train, "_make_step_body", halved)
    assert not smallrun.correct(run_checks(workload))


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    """One short run of the first cell through run.py on the card."""
    import json
    import subprocess
    import sys
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        CELLS[0], "--seed", str(2**31 + 11), "--seconds",
                        "2", "--trace", "0"], cwd=smallrun.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
