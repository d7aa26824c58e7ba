"""What both drivers build the same way: the design model's two sides
(the program's model object and the reference's oracle), the program's
dataset object over the benchmark's own rows, and the GAN's settings."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

import numpy as np

from perfbench.lib import inputs
from perfbench.reference.oracles import Oracle


def program_model(config: dict):
    """The program's design model, from ``"module:Class"``."""
    mod, cls = config["program_model"].split(":")
    return getattr(importlib.import_module(mod), cls)()


def gan_dims(config: dict, oracle: Oracle):
    """(G's widths, D's widths), input first."""
    g = config["gan"]
    n_net = oracle.net.n_dims
    g_dims = inputs.mlp_dims(n_net + g["n_obj"] + g["noise_dim"],
                             g["g_hidden_layers"], g["g_neurons"],
                             oracle.cfg.width)
    d_dims = inputs.mlp_dims(n_net + oracle.cfg.width + g["n_obj"],
                             g["d_hidden_layers"], g["d_neurons"], 2)
    return g_dims, d_dims


def gan_config(config: dict, oracle: Oracle):
    """The program's GANConfig with the configuration's widths."""
    from repro_torch.core.gan import GANConfig
    g = config["gan"]
    fields = {f.name for f in dataclasses.fields(GANConfig)}
    return GANConfig(n_net=oracle.net.n_dims,
                     **{k: v for k, v in g.items() if k in fields})


def program_dataset(model, rows: inputs.DatasetRows):
    """The program's Dataset over the benchmark's rows and normalizers."""
    from repro_torch.core.encoding import Normalizer
    from repro_torch.dataset.generator import Dataset

    def norm(n: inputs.Norm):
        return Normalizer(mean=np.asarray(n.mean), std=np.asarray(n.std))

    return Dataset(model_name=model.name, net_idx=rows.net_idx,
                   cfg_idx=rows.cfg_idx, latency=rows.latency,
                   power=rows.power, lat_norm=norm(rows.lat_norm),
                   pow_norm=norm(rows.pow_norm), net_norm=norm(rows.net_norm))


def params_tree(layers) -> Dict[str, List[dict]]:
    return {"layers": [{"w": w, "b": b} for w, b in layers]}


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))
