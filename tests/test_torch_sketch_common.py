"""The port's hashing, packed-counter helpers and traces against the JAX
package's, elementwise: random lanes plus sign-bit and all-ones adversaries,
saturated 4-bit and 8-bit fields, and key-for-key equal traces."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import hashing as jhash
from repro.core.sketch import _pow2ceil as j_pow2ceil
from repro.kernels import sketch_common as jsc
from repro.traces import synthetic as jsyn
from repro_torch.core import hashing as phash
from repro_torch.kernels import sketch_common as psc
from repro_torch.traces import synthetic as psyn

ADVERSARIES = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF,
                        0xFFFFFFFE, 0x80000001], np.uint32)


def lanes():
    rng = np.random.default_rng(0)
    r = rng.integers(0, 2**32, size=(2, 2000), dtype=np.uint64).astype(
        np.uint32)
    lo = np.concatenate([r[0], ADVERSARIES, np.repeat(ADVERSARIES, 7)])
    hi = np.concatenate([r[1], ADVERSARIES, np.tile(ADVERSARIES, 7)])
    return lo, hi


def as_port(x):
    return torch.from_numpy(x.view(np.int32).copy())


def test_constants_and_geometry_match():
    for name in ("MIX32_M1", "MIX32_M2", "PROBE_SALTS", "WSET_SALT",
                 "MSET_SALT", "MSET2_SALT", "SHARD_SALT"):
        assert getattr(phash, name) == getattr(jhash, name), name
    assert psc.POLICIES == jsc.POLICIES
    for c in [1, 2, 3, 7, 8, 9, 100, 990, 4096, 64881, 10**6]:
        assert phash._pow2ceil(c) == j_pow2ceil(c)
        assert phash._pow2floor(c) == jhash._pow2floor(c)
        for a in (1, 4, 8, 16):
            assert phash.assoc_geometry(c, a) == jhash.assoc_geometry(c, a)
            assert phash.slots_for(c, a) == jhash.slots_for(c, a)
        for s in (1, 4, 64):
            assert phash.set_ways(c, s) == jhash.set_ways(c, s)


def test_mix32_matches():
    lo, _ = lanes()
    got = psc.mix32(as_port(lo)).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(jsc.mix32(jnp.asarray(lo))))


def _probe_column(salts, n):
    """Column ``p`` of one ``probe_matrix`` call over all ``n`` salts: the
    port's only counter/doorkeeper hashing, held against the reference's
    per-probe function."""
    return lambda lo, hi, p, size: psc.probe_matrix(lo, hi, salts(n),
                                                    size - 1)[:, p]


PORT_HASHES = {"probe_index": _probe_column(psc.probe_salts, 8),
               "dk_probe_index": _probe_column(psc.dk_probe_salts, 3),
               "set_index": psc.set_index, "shard_index": psc.shard_index}


@pytest.mark.parametrize("fn,arg", [
    ("probe_index", [(p, w) for p in range(8) for w in (8, 256, 131072)]),
    ("dk_probe_index", [(p, w) for p in range(3) for w in (32, 2097152)]),
    ("set_index", [(n, s) for n in (1, 4, 4096) for s in (
        jhash.WSET_SALT, jhash.MSET_SALT, jhash.MSET2_SALT)]),
    ("shard_index", [(s,) for s in (1, 2, 16)]),
])
def test_hashes_match(fn, arg):
    lo, hi = lanes()
    jlo, jhi = jnp.asarray(lo), jnp.asarray(hi)
    plo, phi = as_port(lo), as_port(hi)
    for a in arg:
        got = PORT_HASHES[fn](plo, phi, *a)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(getattr(jsc, fn)(jlo, jhi, *a)),
            err_msg=f"{fn}{a}")


@pytest.mark.parametrize("bits", [4, 8])
def test_halve_words_matches(bits):
    rng = np.random.default_rng(bits)
    fields = 32 // bits
    sat = (1 << bits) - 1
    words = [rng.integers(-2**31, 2**31, size=500, dtype=np.int64)]
    # saturated fields everywhere, and one saturated field at each position
    words.append(np.array([sum(sat << (bits * f) for f in range(fields))]))
    words.append(np.array([sat << (bits * f) for f in range(fields)]))
    w = (np.concatenate(words) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    got = psc.halve_words(torch.from_numpy(w.copy()), bits).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jsc.halve_words(jnp.asarray(w), bits)))


def test_nibble_helpers_match():
    rng = np.random.default_rng(3)
    words = rng.integers(-2**31, 2**31, size=400, dtype=np.int64).astype(
        np.int32)
    nibs = rng.integers(0, 8, size=400).astype(np.int32)
    pw, pn = torch.from_numpy(words), torch.from_numpy(nibs)
    jw, jn = jnp.asarray(words), jnp.asarray(nibs)
    np.testing.assert_array_equal(psc.nibble_get(pw, pn).numpy(),
                                  np.asarray(jsc.nibble_get(jw, jn)))
    below = np.asarray(jsc.nibble_get(jw, jn)) < 15      # the caller's promise
    np.testing.assert_array_equal(psc.nibble_inc(pw, pn).numpy()[below],
                                  np.asarray(jsc.nibble_inc(jw, jn))[below])


def test_keys_to_lanes_bit_patterns():
    keys = np.array([0, 1, 2**32 - 1, 2**32, 2**63, 2**64 - 2], np.uint64)
    plo, phi = psc.keys_to_lanes(keys)
    jlo, jhi = jsc.keys_to_lanes(keys)
    np.testing.assert_array_equal(plo.view(np.uint32), np.asarray(jlo))
    np.testing.assert_array_equal(phi.view(np.uint32), np.asarray(jhi))


def test_traces_match():
    np.testing.assert_array_equal(
        psyn.zipf_trace(60_000, n_items=50_000, alpha=0.9, seed=7),
        jsyn.zipf_trace(60_000, n_items=50_000, alpha=0.9, seed=7))
    np.testing.assert_array_equal(psyn.zipf_probs(1000, 1.0),
                                  jsyn.zipf_probs(1000, 1.0))
    rng = np.random.default_rng(13)
    scan = np.arange(100_000, 125_000, dtype=np.int64)
    hot = jsyn._sample_from_probs(jsyn.zipf_probs(2_000, 1.0), 35_000, rng)
    np.testing.assert_array_equal(psyn.scan_then_hotspot_trace(),
                                  np.concatenate([scan, hot]))
