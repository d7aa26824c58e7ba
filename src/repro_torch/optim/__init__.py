from repro_torch.optim.adamw import (AdamState, Optimizer, adam, adamw,
                                     apply_updates, clip_by_global_norm,
                                     global_norm, tree_leaves, tree_map,
                                     tree_unflatten)
from repro_torch.optim.schedule import constant, cosine, linear_warmup_cosine

__all__ = ["AdamState", "Optimizer", "adam", "adamw", "apply_updates",
           "clip_by_global_norm", "constant", "cosine", "global_norm",
           "linear_warmup_cosine", "tree_leaves", "tree_map", "tree_unflatten"]
