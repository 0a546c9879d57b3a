"""Architecture registry: one module per ported architecture, each with
``config()`` (the published dimensions) and ``smoke_config()`` (a reduced
same-family config for CPU tests).  Counterpart of
``repro/configs/__init__.py``; the port serves the dense family, so the
other architectures of the reference raise."""
from __future__ import annotations

import importlib

DENSE = ["mistral_nemo_12b", "chatglm3_6b", "minicpm_2b", "qwen3_4b"]
NOT_PORTED = ["llava_next_34b", "llama4_scout_17b_a16e",
              "llama4_maverick_400b_a17b", "zamba2_1p2b", "musicgen_medium",
              "xlstm_1p3b"]

_ALIAS = {a.replace("_", "-"): a for a in DENSE + NOT_PORTED}
_ALIAS.update({"mistral-nemo-12b": "mistral_nemo_12b",
               "chatglm3-6b": "chatglm3_6b", "minicpm-2b": "minicpm_2b",
               "qwen3-4b": "qwen3_4b", "zamba2-1.2b": "zamba2_1p2b",
               "xlstm-1.3b": "xlstm_1p3b"})


def get_config(name: str, smoke: bool = False):
    mod_name = _ALIAS.get(name, name)
    if mod_name in NOT_PORTED:
        raise NotImplementedError(
            f"{name}: the port serves the dense family only; MoE, VLM, audio "
            "and SSM architectures are ROADMAP queue 1 item 14")
    if mod_name not in DENSE:
        raise ValueError(f"unknown architecture {name!r}")
    m = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return m.smoke_config() if smoke else m.config()


def list_archs():
    return list(DENSE)
