"""gemma3-1b [dense] — 26L d=1152 4H (GQA kv=1) d_ff=6912 vocab=262144,
5:1 local(1024):global interleave, 128k context.  [hf:google/gemma-3-1b-pt]"""
from repro_torch.models.builders import local_global_arch

FULL = local_global_arch(
    "gemma3-1b", "dense", 26, 1152, 4, 1, 6912, 262144,
    head_dim=256, local_window=1024, locals_per_global=5,
    tied=True, theta=1e6,
    notes="dominantly sliding-window -> long_500k runs; 4 global layers "
          "keep a full-length KV cache",
)

REDUCED = local_global_arch(
    "gemma3-1b-reduced", "dense", 7, 64, 4, 1, 128, 512,
    head_dim=16, local_window=32, locals_per_global=5, tied=True,
)
