"""The port's trace engine against the JAX engine: sizing, validation, and
hit counts and final state on short prefixes of both golden traces."""
from dataclasses import fields

import numpy as np
import pytest
import torch

from repro.core import device_simulate as jds
from repro_torch.core import device_simulate as pds
from repro_torch.kernels.sketch_step import StepSpec
from repro_torch.traces.synthetic import zipf_trace, scan_then_hotspot_trace

# the plain step issues thousands of tiny ops: intra-op threads only spin,
# and under parallel test workers they contend for every core
torch.set_num_threads(1)

SIZING = ("window_cap", "main_cap", "window_cap_max", "main_cap_max",
          "prot_cap", "sample_size", "cap", "width", "dk_bits", "merge_epoch",
          "ways")


def _spec_dict(spec):
    return {f.name: getattr(spec, f.name) for f in fields(StepSpec)}


@pytest.mark.parametrize("capacity", [1, 3, 64, 200, 400, 1000, 65536])
@pytest.mark.parametrize("assoc", [None, 1, 4, 8, 16])
def test_sizing_matches_reference(capacity, assoc):
    for kw in ({}, {"counter_bits": 8, "sample_factor": 20},
               {"doorkeeper": False, "window_frac": 0.2}):
        p = pds.DeviceWTinyLFU(capacity, assoc=assoc, **kw)
        j = jds.DeviceWTinyLFU(capacity, assoc=assoc, **kw)
        for name in SIZING:
            assert getattr(p, name) == getattr(j, name), name
        assert _spec_dict(p.spec()) == _spec_dict(j.spec())
        np.testing.assert_array_equal(p.params(warmup=5,
                                               device="cpu").numpy(),
                                      np.asarray(j.params(warmup=5)))


@pytest.mark.parametrize("kw", [
    dict(capacity=0), dict(capacity=10, window_frac=1.0),
    dict(capacity=10, protected_frac=0.0), dict(capacity=10, sample_factor=0),
    dict(capacity=10, counter_bits=6), dict(capacity=10, rows=0),
    dict(capacity=10, assoc=0), dict(capacity=10, shards=3),
    dict(capacity=10, merge_every=-1), dict(capacity=10, mesh_exchange="x"),
    dict(capacity=10, integrity=True), dict(capacity=10, streams=0),
    dict(capacity=10, policy="lru"), dict(capacity=10, policy="arc"),
    dict(capacity=10, policy="lfu", assoc=4, adaptive=True),
    dict(capacity=10, policy="arc", assoc=4, doorkeeper=False),
])
def test_validation_errors_match(kw):
    with pytest.raises(ValueError) as pe:
        pds.DeviceWTinyLFU(**kw)
    with pytest.raises(ValueError) as je:
        jds.DeviceWTinyLFU(**kw)
    assert str(pe.value) == str(je.value)


# 3,000 accesses of each golden trace: the Zipf prefix, and for
# scan-then-hotspot the window across its scan/hotspot boundary (its first
# 25,000 accesses are a one-shot scan that never hits)
TRACES = {"zipf": lambda: zipf_trace(60_000, n_items=50_000, alpha=0.9,
                                     seed=7)[:3000],
          "scanhot": lambda: scan_then_hotspot_trace()[24_000:27_000]}


@pytest.mark.parametrize("trace", sorted(TRACES))
@pytest.mark.parametrize("assoc", [None, 8])
def test_simulate_trace_equals_jax_engine(trace, assoc):
    tr = TRACES[trace]()
    kw = dict(warmup=1000, assoc=assoc, trace_name=trace)
    jr, js, jh = jds.simulate_trace(tr, 100, return_state=True, **kw)
    pr, ps, ph = pds.simulate_trace(tr, 100, return_state=True,
                                    device="cpu", chunk=512, **kw)
    assert (pr.hits, pr.accesses, pr.hit_ratio, pr.policy, pr.trace) == (
        jr.hits, jr.accesses, jr.hit_ratio, jr.policy, jr.trace)
    assert pr.extra["device"] == "cpu" and pr.extra["assoc"] == assoc
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    for k in js:
        np.testing.assert_array_equal(ps[k].numpy(), np.asarray(js[k]),
                                      err_msg=f"state[{k}]")


@pytest.mark.parametrize("kw,what", [
    (dict(adaptive=True), "item 7"),
    (dict(shards=2), "item 6"), (dict(shards=2, integrity=True), "item 6"),
    (dict(assoc=4, policy="s3fifo"), "item 9"),
])
def test_unported_options_raise(kw, what):
    tr = np.arange(10)
    with pytest.raises(NotImplementedError, match=what):
        pds.simulate_trace(tr, 16, device="cpu", **kw)


@pytest.mark.parametrize("assoc", [None, 8])
def test_climb_is_ignored_without_adaptive(assoc):
    """As in the reference, climb= changes nothing when adaptive=False."""
    from repro.core.device_simulate import ClimbSpec
    tr = TRACES["zipf"]()[:600]
    a = pds.simulate_trace(tr, 50, assoc=assoc, device="cpu",
                           climb=ClimbSpec(epoch_len=128))
    b = pds.simulate_trace(tr, 50, assoc=assoc, device="cpu")
    j = jds.simulate_trace(tr, 50, assoc=assoc,
                           climb=ClimbSpec(epoch_len=128))
    assert a.hits == b.hits == j.hits and a.extra == b.extra


def test_unported_run_options_raise():
    cfg = pds.DeviceWTinyLFU(16)
    with pytest.raises(NotImplementedError, match="item 11"):
        cfg.run(np.arange(10), device="cpu", checkpoint_dir="ckpt")
    with pytest.raises(NotImplementedError, match="item 11"):
        cfg.run(np.arange(10), device="cpu", fault_hook=lambda c, s: None)

    class Mesh:
        axis_names = ("shard",)
        devices = np.zeros(2)
    with pytest.raises(NotImplementedError, match="item 12"):
        pds.DeviceWTinyLFU(16, shards=2, mesh=Mesh()).run(np.arange(10),
                                                          device="cpu")


def test_run_equals_simulate_trace():
    tr = TRACES["zipf"]()[:800]
    a = pds.DeviceWTinyLFU(50, assoc=4).run(tr, warmup=100, device="cpu")
    b = pds.simulate_trace(tr, 50, warmup=100, assoc=4, device="cpu")
    assert (a.hits, a.accesses, a.extra) == (b.hits, b.accesses, b.extra)


def test_no_card_and_no_device_raises():
    """Without a card the engine refuses to run rather than fall back to the
    CPU; asking for the CPU is explicit."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pds.simulate_trace(np.arange(10), 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        pds.simulate_trace(np.arange(10), 16, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pds.DeviceWTinyLFU(16).params()


def test_trace_shape_checked():
    with pytest.raises(ValueError, match="lane axis"):
        pds.simulate_trace(np.zeros((2, 5), np.int64), 16, device="cpu")
