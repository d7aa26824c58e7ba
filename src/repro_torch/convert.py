"""Carry params and whole train states between the two packages as numpy:
G's and D's params and train states, and the LM substrate's params and
optimizer state.

The reference keeps params as ``{"layers": [{"w": (in, out), "b": (out,)},
...]}`` pytrees and its train state as ``TrainState(g_params, d_params,
g_opt, d_opt, rng)`` with ``AdamState(step, mu, nu)`` optimizer states.
Converted to numpy (``jax.tree.map(np.asarray, ...)``) they come here, so
this package never sees a ``jax.Array``.  The numpy form of a train state
is ``{"g_params", "d_params", "g_opt": {"step", "mu", "nu"}, "d_opt":
{...}, "rng"}``: float32 leaves, an int32 step, and the uint32 (2,) key.

Use it to start both packages from one given state.  G's and D's own
initialisation, and the LM substrate's (``models/base.init_params`` on
``prng_key(seed)``), already reproduce the reference's from a seed.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.train import TrainState
from repro_torch.optim import AdamState, tree_map


def params_from_numpy(tree, device):
    """numpy float32 leaves -> the port's float32 tensors on `device`."""
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32),
                                           device=device), tree)


def params_to_numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def lm_params_from_numpy(tree: Dict, device) -> Dict:
    """The reference's LM params as numpy (``jax.tree.map(np.asarray,
    params)``: ``{"embed": {"table"}, "segments": [[per-spec (repeats,
    ...) stacks], ...], "ln_f": {"scale"}[, "lm_head"]}``) -> the port's
    float32 tensors on `device`, in the same layout."""
    return params_from_numpy(tree, device)


def lm_params_to_numpy(params: Dict) -> Dict:
    """The port's LM params -> numpy, in the reference's layout."""
    return params_to_numpy(params)


def opt_state_from_numpy(o, device) -> AdamState:
    """An optimizer state as numpy — ``{"step", "mu", "nu"}``, or the
    reference's ``AdamState`` of numpy leaves (``jax.tree.map(np.asarray,
    state)``) — -> the port's `AdamState` on `device`."""
    if not isinstance(o, dict):
        o = {"step": o.step, "mu": o.mu, "nu": o.nu}
    return AdamState(
        step=torch.tensor(int(o["step"]), dtype=torch.int32, device=device),
        mu=params_from_numpy(o["mu"], device),
        nu=params_from_numpy(o["nu"], device))


def opt_state_to_numpy(o: AdamState) -> Dict:
    """The port's `AdamState` -> ``{"step": int32, "mu", "nu"}`` numpy."""
    return {"step": np.int32(int(o.step)), "mu": params_to_numpy(o.mu),
            "nu": params_to_numpy(o.nu)}


#: the LM's optimizer state (``adamw``'s ``AdamState``, mu and nu in the
#: params' layout) is carried the same way
lm_opt_state_from_numpy = opt_state_from_numpy
lm_opt_state_to_numpy = opt_state_to_numpy


def g_params_from_numpy(tree: Dict, device) -> Dict:
    """numpy ``{"layers": [{"w", "b"}, ...]}`` -> the port's float32
    params on `device`."""
    return params_from_numpy({"layers": tree["layers"]}, device)


def g_params_to_numpy(params: Dict) -> Dict:
    """The port's params -> numpy ``{"layers": [{"w", "b"}, ...]}``."""
    return params_to_numpy({"layers": params["layers"]})


def train_state_from_numpy(tree: Dict, device) -> TrainState:
    """The numpy form of a train state (see the module note) -> a
    `TrainState` on `device`, with an empty history."""
    rng = torch.tensor(np.asarray(tree["rng"], np.uint32).astype(np.int64),
                       device=device)
    return TrainState(params_from_numpy(tree["g_params"], device),
                      params_from_numpy(tree["d_params"], device),
                      opt_state_from_numpy(tree["g_opt"], device),
                      opt_state_from_numpy(tree["d_opt"], device), rng)


def train_state_to_numpy(state: TrainState) -> Dict:
    """A `TrainState` -> its numpy form (see the module note)."""
    return {"g_params": params_to_numpy(state.g_params),
            "d_params": params_to_numpy(state.d_params),
            "g_opt": opt_state_to_numpy(state.g_opt),
            "d_opt": opt_state_to_numpy(state.d_opt),
            "rng": state.rng.cpu().numpy().astype(np.uint32)}
