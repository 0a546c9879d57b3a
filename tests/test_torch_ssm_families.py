"""The port's hybrid-SSM (zamba2: Mamba2 layers and one shared attention
block) and xLSTM (mLSTM and sLSTM blocks) families against the JAX
package's on the CPU: the drive of ``tests/torch_family_cases.py`` in fp32
and bf16 (prefill over two chunks, an extend continuing the states through
a padded chunk, decodes).

Run as a script, it prints the JAX pins Z7 and X8 of
``repro_torch.check_runs`` (zamba2-1.2b at full width and 7 layers,
xlstm-1.3b at full width and 8; a 1,280-token prompt and 4 greedy decodes;
held on the card by ``chip_smoke.py``), X8 in bf16 and fp32 compute with
the distance between the two along the bf16 run's tokens, and X8S, X8 in
bf16 on the prompt's first ``X8S_PROMPT_LEN`` tokens with that distance:
``PYTHONPATH=src python tests/test_torch_ssm_families.py``, ~2 min and
~10 GB.
"""
import pytest
import torch

from torch_family_cases import check_drive

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["zamba2_1p2b", "xlstm_1p3b"])
def test_prefill_extend_decode_match(arch, dtype):
    check_drive(arch, dtype)


if __name__ == "__main__":
    from repro_torch.check_runs import X8S_PROMPT_LEN
    from torch_family_cases import print_depth_pins
    print_depth_pins("Z7", "zamba2-1.2b", 7)
    print_depth_pins("X8", "xlstm-1.3b", 8, spread=True, fp32=True)
    print_depth_pins("X8S", "xlstm-1.3b", 8, spread=True,
                     prompt_len=X8S_PROMPT_LEN)
