from repro_torch.optim.adamw import (AdamState, Optimizer, adam, adamw,
                                     apply_updates, clip_by_global_norm,
                                     global_norm, tree_leaves, tree_map)

__all__ = ["AdamState", "Optimizer", "adam", "adamw", "apply_updates",
           "clip_by_global_norm", "global_norm", "tree_leaves", "tree_map"]
