"""The port's ``distributed/pipeline.py`` and ``distributed/compression.py``
on gloo ranks (CPU), against the sequential stack and the reference's
functions.

* ``pipeline_apply`` on 4 ranks with 2 and 4 microbatches: every rank's
  output equals the sequential stack and the reference's
  ``pipeline_apply`` (run in a subprocess with 4 forced host devices, as
  tests/test_pipeline_compression.py runs it) at rtol 1e-5.
* ``compressed_allreduce_int8`` on 8 ranks: its int8 values and scales
  equal the reference's ``_quantize_int8`` bit for bit, its means and
  residuals the reference's under ``jax.vmap(..., axis_name="data")``
  within 1e-6 relative, and 30 calls with error feedback accumulate to the
  true mean within 1% (the reference test's bound).
"""
import concurrent.futures
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharded_ranks as R
from repro.distributed import compression as jax_compression
from repro_torch.distributed import compression
from repro_torch.distributed.launch import run_ranks
from repro_torch.distributed.mesh import make_debug_mesh
from repro_torch.distributed.pipeline import pipeline_apply

N_MICROS = (2, 4)
STEPS = 30

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.distributed.pipeline import pipeline_apply
d = np.load(sys.argv[1])
mesh = jax.make_mesh((4,), ("stage",), devices=jax.devices()[:4])
params = {"w": jnp.asarray(d["w"]), "b": jnp.asarray(d["b"])}
def block(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])
out = {str(m): np.asarray(pipeline_apply(mesh, "stage", block, params,
                                          jnp.asarray(d["x"]), m))
       for m in (2, 4)}
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pc"))
    params, x = R.pipeline_case()
    np.savez(os.path.join(root, "in.npz"), x=x, **params)
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    pool = concurrent.futures.ThreadPoolExecutor(3)
    ref = pool.submit(subprocess.run, [
        sys.executable, "-c", REFERENCE, os.path.join(root, "in.npz"),
        os.path.join(root, "ref.npz")], capture_output=True, text=True,
        env=env, timeout=240)
    pipe = pool.submit(run_ranks, R.pipeline_ranks, 4, root, N_MICROS,
                       timeout=240)
    comp = pool.submit(run_ranks, R.compression_ranks, 8, root, STEPS,
                       timeout=240)

    def reference():
        r = ref.result()
        assert r.returncode == 0, r.stderr[-2500:]
        return np.load(os.path.join(root, "ref.npz"))
    yield {"ref": reference, "pipe": pipe.result, "comp": comp.result}
    pool.shutdown(wait=True)


@pytest.mark.parametrize("n_micro", N_MICROS)
def test_pipeline_equals_sequential_and_reference(runs, n_micro):
    params, x = R.pipeline_case()
    want = R.sequential(params, x)
    ref = runs["ref"]()[str(n_micro)]
    np.testing.assert_allclose(ref, want, rtol=1e-5, atol=1e-6)
    for rank_out in runs["pipe"]():
        got = rank_out[N_MICROS.index(n_micro)]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_pipeline_one_stage_without_torch_distributed():
    params, x = R.pipeline_case()
    got = pipeline_apply(make_debug_mesh((1,), ("stage",), device="cpu"),
                         "stage",
                         R.block_fn,
                         {k: torch.from_numpy(v) for k, v in params.items()},
                         torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got.numpy(), R.sequential(params, x))


def test_quantize_int8_bit_equal():
    xs = R.compression_inputs()
    xs = np.concatenate([xs, xs * 1e-3, np.zeros_like(xs[:1]),
                         np.round(xs[:1] * 4) / 2])    # ties at .5
    for x in xs:
        q, s = compression._quantize_int8(torch.from_numpy(x))
        jq, js = jax_compression._quantize_int8(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert q.dtype == torch.int8
        assert np.float32(s.item()).tobytes() == np.asarray(
            js, np.float32).tobytes()


def reference_allreduce(xs, errs):
    return jax.vmap(lambda x, e: jax_compression.compressed_allreduce_int8(
        x, "data", e), axis_name="data")(jnp.asarray(xs), jnp.asarray(errs))


def test_compressed_allreduce_equals_reference(runs):
    xs = R.compression_inputs()
    mean, err = (np.asarray(a) for a in reference_allreduce(
        xs, np.zeros_like(xs)))
    out = runs["comp"]()
    for r, got in enumerate(out):
        np.testing.assert_allclose(got["mean"], mean[r], rtol=1e-6,
                                   atol=1e-6 * np.abs(mean[r]).max())
        np.testing.assert_allclose(got["error"], err[r], rtol=1e-6,
                                   atol=1e-6 * np.abs(err[r]).max())
        np.testing.assert_array_equal(got["mean"], out[0]["mean"])


def test_error_feedback_converges(runs):
    """30 calls with error feedback: the accumulated mean within 1% of the
    true one (the reference test's bound)."""
    true = R.compression_inputs().astype(np.float64).mean(0)
    for got in runs["comp"]():
        rel = np.abs(got["acc"] - true).max() / np.abs(true).max()
        assert rel < 0.01, rel


def test_tree_allreduce_threads_errors():
    tree = {"a": torch.ones(3), "b": {"c": torch.arange(4.0)}}
    means, errs = compression.compressed_tree_allreduce(tree)
    assert means.keys() == errs.keys() == {"a", "b"}
    means2, _ = compression.compressed_tree_allreduce(tree, None, errs)
    torch.testing.assert_close(means2["b"]["c"], tree["b"]["c"],
                               rtol=0, atol=0.02)
