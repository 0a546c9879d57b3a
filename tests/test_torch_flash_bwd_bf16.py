"""The flash attention backward against JAX's VJP in bf16 (CPU): the
cases and the bound of tests/test_torch_flash_bwd.py, split off so that
each file runs in well under half a minute."""
import pytest

from test_torch_flash_bwd import CASES, IDS, check_against_jax_vjp


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bwd_matches_jax_vjp_bf16(case):
    check_against_jax_vjp(case, "bfloat16")
