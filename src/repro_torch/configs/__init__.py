"""Architecture registry: ``get_arch(name)`` / ``get_reduced(name)``.

Every assigned architecture of the reference is listed and ported: the
dense decoders (gemma3-1b, stablelm-1.6b, qwen3-14b, deepseek-coder-33b),
the vision-language decoder qwen2-vl-7b (M-RoPE), the MoE decoders
(mixtral-8x7b, phi3.5-moe), the attention + SSM hybrid hymba-1.5b, the
recurrent xlstm-1.3b (mLSTM and sLSTM blocks) and the encoder-decoder
whisper-small, each a module exposing FULL and REDUCED ModelCfg objects
equal field for field to the reference's (whisper's also
``DECODER_TRAIN_LEN``).
Shapes live in ``repro_torch.configs.shapes``.
"""
from __future__ import annotations

import importlib
from typing import List

_ARCHS = (
    "mixtral_8x7b",
    "phi35_moe",
    "stablelm_1_6b",
    "qwen3_14b",
    "gemma3_1b",
    "deepseek_coder_33b",
    "qwen2_vl_7b",
    "whisper_small",
    "xlstm_1_3b",
    "hymba_1_5b",
)

#: the archs whose every block is ported: all of them
PORTED = _ARCHS

_ALIASES = {
    "mixtral-8x7b": "mixtral_8x7b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "stablelm-1.6b": "stablelm_1_6b",
    "qwen3-14b": "qwen3_14b",
    "gemma3-1b": "gemma3_1b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "whisper-small": "whisper_small",
    "xlstm-1.3b": "xlstm_1_3b",
    "hymba-1.5b": "hymba_1_5b",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def list_archs() -> List[str]:
    return list(_ARCHS)


def _module(name: str):
    arch = canonical(name)
    if arch not in _ARCHS:
        raise ValueError(f"unknown arch {name!r}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_arch(name: str):
    return _module(name).FULL


def get_reduced(name: str):
    return _module(name).REDUCED
