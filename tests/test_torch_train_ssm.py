"""The port's training path against the JAX package's (CPU), part 2: the
audio, hybrid_ssm and xlstm families' losses and every gradient leaf in
fp32, within 1e-4 relative (tests/test_torch_train.py has the bound and
the attention families)."""
import pytest

from test_torch_train import check_family_grads


@pytest.mark.parametrize("family", ["audio", "hybrid_ssm", "xlstm"])
def test_family_grads_match_jax_fp32(family):
    check_family_grads(family)
