"""The stale mesh mode's scan-then-hotspot golden on a two-rank gloo mesh
(C=400, warmup 5,000, ``merge_every=512``: within 0.01 of 0.4837 and of the
exact mode's result); see ``test_torch_mesh_goldens.py``, which holds the
Zipf golden and the check both run."""
import pytest

from test_torch_mesh_goldens import check_golden


@pytest.mark.parametrize("name", ["scanhot"])
def test_stale_goldens_two_ranks(name, tmp_path):
    check_golden(name, str(tmp_path))
