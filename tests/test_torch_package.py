"""Package rules of the PyTorch/CUDA port.

- No module under ``src/repro_torch/``, and not ``chip_smoke.py``, imports
  ``jax`` or the reference package ``repro`` (checked on the AST, so a
  lazy import inside a function counts too).
- Entry points run on the card unless the caller asks for the CPU:
  ``GANDSE(..., device=None)``, ``Explorer(...)``, ``train_gan(...)``, the
  LM ``Engine(...)``, the serving launchers ``launch/dse_serve`` and
  ``launch/online`` and the training launcher ``launch/train`` without a
  device raise where no CUDA device is present.
- Importing the kernel module builds nothing (the CPU tests import every
  module; the kernel is built at its first launch, on the card).
"""
import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = [ROOT / "examples" / f"{name}_torch.py"
            for name in ("quickstart", "serve_lm", "mesh_dse", "train_lm")]
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0], node.lineno


def test_port_files_are_found():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "src/repro_torch/kernels/fused_mlp.py" in names
    assert "src/repro_torch/kernels/fused_dense.py" in names
    assert "src/repro_torch/core/train.py" in names
    assert "src/repro_torch/optim/adamw.py" in names
    assert "src/repro_torch/core/dse_api.py" in names
    for mod in ("kernels/flash_attention", "kernels/ssm_scan", "nn/ssm",
                "configs/hymba_1_5b", "kernels/ops", "nn/attention",
                "nn/blocks", "models/base", "models/builders",
                "configs/__init__", "configs/gemma3_1b", "train/step",
                "launch/serve", "convert", "baselines/mlp", "baselines/sa",
                "baselines/drl", "baselines/random_search",
                "launch/comparison", "launch/quality", "launch/dse_serve",
                "launch/online", "checkpoint/manager", "serve/__init__",
                "serve/request", "serve/cache", "serve/batcher",
                "serve/server", "serve/faults", "serve/frontend",
                "serve/online", "data/synthetic", "optim/schedule",
                "optim/compress", "launch/train", "nn/xlstm",
                "kernels/slstm_scan", "configs/xlstm_1_3b",
                "configs/whisper_small", "configs/qwen2_vl_7b",
                "utils/roofline", "utils/op_cost", "launch/dryrun",
                "launch/perf", "launch/mesh", "train/shardings",
                "core/shard", "train/parallel"):
        assert f"src/repro_torch/{mod}.py" in names
    assert "chip_smoke.py" in names
    assert all(p.relative_to(ROOT).as_posix() in names for p in EXAMPLES)


@pytest.mark.parametrize("path", FILES,
                         ids=[p.relative_to(ROOT).as_posix() for p in FILES])
def test_no_jax_or_reference_imports(path):
    bad = [(m, ln) for m, ln in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_gandse_defaults_to_the_card(monkeypatch):
    from repro_torch.core.dse_api import GANDSE
    from repro_torch.design_models import DnnWeaverModel
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GANDSE(DnnWeaverModel())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GANDSE(DnnWeaverModel(), device="cuda")
    assert GANDSE(DnnWeaverModel(), device="cpu").device.type == "cpu"


def test_explorer_defaults_to_the_card(monkeypatch):
    from repro_torch.core.explorer import Explorer
    from repro_torch.core.gan import GANConfig
    from repro_torch.design_models import DnnWeaverModel
    model = DnnWeaverModel()
    cfg = GANConfig(n_net=model.net_space.n_dims)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Explorer(model, None, {"layers": []}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Explorer(model, None, {"layers": []}, cfg, device="cuda")
    ex = Explorer(model, None, {"layers": []}, cfg, device="cpu")
    assert ex.device == torch.device("cpu")


def test_train_gan_defaults_to_the_card(monkeypatch):
    """Training is ported now; what this still pins is where it runs:
    ``train_gan(device=None)`` means the card and raises without one, and
    the CPU trains only when it is named."""
    from repro_torch.core import gan as G
    from repro_torch.core.dse_api import GANDSE
    from repro_torch.core.train import train_gan
    from repro_torch.dataset.generator import generate_dataset
    from repro_torch.design_models import DnnWeaverModel
    model = DnnWeaverModel()
    cfg = G.GANConfig(n_net=model.net_space.n_dims).scaled(1, 8,
                                                            batch_size=32)
    ds = generate_dataset(model, 32, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_gan(model, ds, cfg, iters=1)
    st = GANDSE(model, cfg, device="cpu").train(32, 1, ds=ds)
    assert st.rng.device.type == "cpu" and len(st.history) == 1


def test_engine_defaults_to_the_card(monkeypatch):
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.launch.serve import Engine
    from repro_torch.models import base as MB
    m = configs.get_reduced("gemma3-1b")
    params = MB.init_params(prng.prng_key(torch.tensor(0)), m, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(m, params, 2, 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(m, params, 2, 64, device="cuda")
    assert Engine(m, params, 2, 64, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("launcher", ["dse_serve", "online"])
def test_serving_launchers_default_to_the_card(launcher, monkeypatch):
    """``launch/dse_serve`` and ``launch/online`` take ``--device``: the
    card by default (raising without one), the CPU only when named."""
    import importlib
    mod = importlib.import_module(f"repro_torch.launch.{launcher}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = ["--requests", "4", "--max-batch", "2", "--data", "64"] \
        if launcher == "dse_serve" else \
        ["--waves", "1", "--wave-size", "2", "--data", "64", "--min-hard",
         "99", "--replay", "4"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(small)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(small + ["--device", "cuda"])
    assert mod.main(small + ["--device", "cpu"]) == 0


def test_train_launcher_defaults_to_the_card(monkeypatch, tmp_path):
    """``launch/train --device``: the card by default (raising without
    one), the CPU only when named."""
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = ["--steps", "1", "--batch", "2", "--seq", "8",
             "--ckpt-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(small)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(small + ["--device", "cuda"])
    assert train.main(small + ["--device", "cpu"]) == 0


def test_kernel_module_import_builds_nothing():
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_dense as FD
    from repro_torch.kernels import fused_mlp as FM
    from repro_torch.kernels import slstm_scan as SL
    assert set(build._LIBS) == set(build.build_info)
    for mod in (FM, FD, FA, SL):
        assert mod.SOURCE.exists() and mod.SOURCE.suffix == ".cu"
        assert mod.SOURCE.parent == build.CSRC
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def _example(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_lm_example_twin_runs_on_the_cpu(capsys, monkeypatch):
    """``examples/serve_lm_torch.py`` at its reduced gemma3: all 12
    requests served, each its own number of new tokens; without
    ``--device`` it wants the card."""
    example = _example("serve_lm_torch")
    eng = example.main(["--device", "cpu"])
    assert len(eng.finished) == 12
    assert all(len(r.out) == r.max_new for r in eng.finished)
    assert "served 12 requests" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])


def test_train_lm_example_twin_runs_on_the_cpu(capsys, monkeypatch, tmp_path):
    """``examples/train_lm_torch.py --small --device cpu``: a few steps
    under ``make_host_mesh()``, the loss falling (the reference's check);
    without ``--device`` it wants the card."""
    example = _example("train_lm_torch")
    losses = example.main(["--small", "--device", "cpu", "--steps", "21",
                           "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 2 and losses[-1] < losses[0]
    assert "done: loss" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main(["--small"])
