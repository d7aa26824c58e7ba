"""hymba-1.5b [hybrid] — 32L d=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
parallel attention + mamba heads (ssm_state=16); full attention only at
first/middle/last layers, sliding window elsewhere.  [arXiv:2411.13676]"""
from repro_torch.models.builders import sandwich_arch

FULL = sandwich_arch(
    "hymba-1.5b", "hybrid", 32, 1600, 25, 5, 5504, 32001,
    head_dim=64, local_window=1024, ssm_state=16, n_globals=3, tied=True,
    notes="hybrid attn+SSM -> long_500k runs (3 global layers keep a "
          "full-length KV cache)",
)

REDUCED = sandwich_arch(
    "hymba-reduced", "hybrid", 5, 64, 4, 2, 128, 512,
    head_dim=16, local_window=32, ssm_state=8, n_globals=3, tied=True,
)
