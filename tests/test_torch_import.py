"""The port stands alone: it imports neither jax nor anything of ``repro``."""
import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "ab_timing.py",
    ROOT / "tests" / "torch_mesh_ranks.py",
    ROOT / "tests" / "torch_sharded_ranks.py"]
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
           "repro_torch.configs.llava_next_34b",
           "repro_torch.configs.llama4_scout_17b_a16e",
           "repro_torch.configs.llama4_maverick_400b_a17b",
           "repro_torch.configs.zamba2_1p2b",
           "repro_torch.configs.musicgen_medium",
           "repro_torch.configs.xlstm_1p3b",
           "repro_torch.models", "repro_torch.models.common",
           "repro_torch.models.layers", "repro_torch.models.transformer",
           "repro_torch.models.api", "repro_torch.models.convert",
           "repro_torch.models.moe", "repro_torch.models.mamba2",
           "repro_torch.models.zamba", "repro_torch.models.mlstm",
           "repro_torch.models.xlstm",
           "repro_torch.serve.extend", "repro_torch.serve.engine",
           "repro_torch.serve.driver", "repro_torch.checkpoint",
           "repro_torch.checkpoint.store", "repro_torch.core.faults",
           "repro_torch.distributed", "repro_torch.distributed.mesh",
           "repro_torch.distributed.launch",
           "repro_torch.distributed.shardings",
           "repro_torch.distributed.pipeline",
           "repro_torch.distributed.compression", "repro_torch.optim",
           "repro_torch.optim.optimizers", "repro_torch.optim.schedules",
           "repro_torch.train", "repro_torch.train.losses",
           "repro_torch.train.train_step", "repro_torch.train.driver",
           "repro_torch.data", "repro_torch.data.pipeline",
           "repro_torch.launch", "repro_torch.launch.hillclimb",
           "repro_torch.analysis", "repro_torch.analysis.report",
           "repro_torch.analysis.program_trace",
           "repro_torch.analysis.program_lint",
           "repro_torch.analysis.lint_fixtures"]


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

# and so does every model family, through the serving engine
FAMILY_DRIVE = """
import torch
from repro_torch.check_runs import numpy_leaves
from repro_torch.configs import get_config, list_archs
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import ServeEngine
for arch in list_archs():
    cfg = get_config(arch, smoke=True)
    eng = ServeEngine(Model(cfg, device="cpu"),
                      params_from_numpy(cfg, numpy_leaves(cfg, 0),
                                        device="cpu"),
                      max_batch=2, max_len=64, block_size=8, pool_slots=8)
    for p in ([1] * 20, [1] * 16 + [2] * 4):
        eng.submit(p, 2)
    assert len(eng.run()) == 2, arch
"""

# and the training driver, one step with a checkpoint
TRAIN_DRIVE = """
import tempfile
from repro_torch.train.driver import train
out = train("qwen3-4b", steps=1, out_dir=tempfile.mkdtemp(), global_batch=2,
            seq_len=8, device="cpu")
assert out["step"] == 1 and out["loss"] > 0
"""

# and the window-adaptation CLI and its report
HILLCLIMB_DRIVE = """
import contextlib, io, os, tempfile
from repro_torch.analysis.report import adaptive_table
from repro_torch.launch.hillclimb import main
d = tempfile.mkdtemp()
with contextlib.redirect_stdout(io.StringIO()):
    rows = main(["--trace", "fickle", "--capacity", "50", "--length", "300",
                 "--epoch-len", "128", "--device", "cpu", "--out",
                 os.path.join(d, "fickle.json")])
assert len(rows[0]["extra"]["trajectory"]["quota"]) == 2
assert len(adaptive_table(d).splitlines()) == 3
"""


def test_imports_with_jax_and_repro_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + HOST_ENGINE_DRIVE + FAMILY_DRIVE + TRAIN_DRIVE + HILLCLIMB_DRIVE
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
