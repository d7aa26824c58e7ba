"""xlstm-1.3b [ssm] — 48L d=2048 4H, mLSTM:sLSTM = 7:1, d_ff=0 (blocks
carry their own projections), vocab=50304.  [arXiv:2405.04517]"""
from repro_torch.models.builders import xlstm_arch

FULL = xlstm_arch(
    "xlstm-1.3b", 48, 2048, 4, 50304, slstm_every=8, tied=True,
    notes="recurrent state decode: O(1)/token -> long_500k runs",
)

REDUCED = xlstm_arch(
    "xlstm-reduced", 4, 64, 4, 512, slstm_every=2, tied=True,
)
