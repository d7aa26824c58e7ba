"""whisper-small [audio] — 12L enc + 12L dec, d=768 12H (kv=12) d_ff=3072
vocab=51865, enc-dec with the conv front end a STUB.  [arXiv:2212.04356]

The model is handed precomputed frame embeddings (B, S_enc, D): the two
conv layers of the real front end halve the mel frame count, and the stub
gives the backbone the post-conv sequence directly (a 30 s window is 1500
frames, ``max_enc_len``).  The decoder trains on its native 448-token
context, ``DECODER_TRAIN_LEN``."""
from repro_torch.models.builders import encdec_arch

FULL = encdec_arch(
    "whisper-small", 12, 12, 768, 12, 12, 3072, 51865,
    max_enc_len=1500, tied=True,
    notes="enc-dec; long_500k skipped (full-attention enc-dec family)",
)

REDUCED = encdec_arch(
    "whisper-small-reduced", 2, 2, 64, 4, 4, 128, 512,
    max_enc_len=64, tied=True,
)

DECODER_TRAIN_LEN = 448
