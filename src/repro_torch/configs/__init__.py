"""Architecture registry: one module per architecture, each with
``config()`` (the published dimensions) and ``smoke_config()`` (a reduced
same-family config for CPU tests).  Counterpart of
``repro/configs/__init__.py``, over the same ten architectures."""
from __future__ import annotations

import importlib

ARCHS = [
    "llava_next_34b",
    "llama4_scout_17b_a16e",
    "llama4_maverick_400b_a17b",
    "mistral_nemo_12b",
    "chatglm3_6b",
    "minicpm_2b",
    "qwen3_4b",
    "zamba2_1p2b",
    "musicgen_medium",
    "xlstm_1p3b",
]
# the dense family's architectures (the port's first served family)
DENSE = ["mistral_nemo_12b", "chatglm3_6b", "minicpm_2b", "qwen3_4b"]

_ALIAS = {a.replace("_", "-"): a for a in ARCHS}
_ALIAS.update({"zamba2-1.2b": "zamba2_1p2b", "xlstm-1.3b": "xlstm_1p3b"})


def _module(name: str):
    mod_name = _ALIAS.get(name, name)
    if mod_name not in ARCHS:
        raise ValueError(f"unknown architecture {name!r}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str, smoke: bool = False):
    m = _module(name)
    return m.smoke_config() if smoke else m.config()


def list_archs():
    return list(ARCHS)
