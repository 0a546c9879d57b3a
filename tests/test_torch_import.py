"""The port stands alone: it imports neither jax nor anything of ``repro``."""
import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "ab_timing.py",
    ROOT / "tests" / "torch_mesh_ranks.py"]
MODULES = ["repro_torch", "repro_torch.check_runs",
           "repro_torch.core.adaptive", "repro_torch.core.hashing",
           "repro_torch.core.simulate", "repro_torch.core.device_simulate",
           "repro_torch.core.sketch",
           "repro_torch.core.policies", "repro_torch.core.tinylfu",
           "repro_torch.core.wtinylfu",
           "repro_torch.kernels.sketch_common",
           "repro_torch.kernels.sketch_step",
           "repro_torch.kernels.sketch_merge", "repro_torch.kernels._build",
           "repro_torch.kernels.phase_timing",
           "repro_torch.kernels.sketch_update",
           "repro_torch.kernels.sketch_estimate",
           "repro_torch.kernels.admission",
           "repro_torch.kernels.sketch_reset", "repro_torch.kernels.ops",
           "repro_torch.traces", "repro_torch.traces.synthetic",
           "repro_torch.serve",
           "repro_torch.serve.prefix_cache",
           "repro_torch.kernels.flash_attention", "repro_torch.configs",
           "repro_torch.configs.qwen3_4b", "repro_torch.configs.chatglm3_6b",
           "repro_torch.configs.minicpm_2b",
           "repro_torch.configs.mistral_nemo_12b",
           "repro_torch.models", "repro_torch.models.common",
           "repro_torch.models.layers", "repro_torch.models.transformer",
           "repro_torch.models.api", "repro_torch.models.convert",
           "repro_torch.serve.extend", "repro_torch.serve.engine",
           "repro_torch.serve.driver", "repro_torch.checkpoint",
           "repro_torch.checkpoint.store", "repro_torch.core.faults",
           "repro_torch.distributed", "repro_torch.distributed.mesh",
           "repro_torch.distributed.launch"]


# the host engine runs, not only imports, with jax and repro blocked
HOST_ENGINE_DRIVE = """
from repro_torch import core
from repro_torch.traces import oltp_like_trace
tr = oltp_like_trace(3000, seed=1)
for cache in (core.WTinyLFU(64), core.WTinyLFU(64, assoc=8),
              core.AdaptiveWTinyLFU(64, epoch_len=500),
              core.tinylfu_cache(64, "lfu"), core.SetAssocARC(64)):
    assert 0 < core.run_trace(cache, tr).hits < len(tr)
"""


def test_imports_with_jax_and_repro_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + HOST_ENGINE_DRIVE
            + "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_jax_or_repro_import_anywhere_in_the_port():
    assert len(PORT_FILES) > 8
    for path in PORT_FILES:
        bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
