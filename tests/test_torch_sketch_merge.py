"""The port's sharded-sketch fold (repro_torch.kernels.sketch_merge) and its
packed-word helpers against the reference's, on the CPU.

The contracts of tests/test_sketch_merge.py and tests/test_merge_properties.py:
``merge_words`` is a per-field saturating add at both counter widths with no
borrow across fields; ``checksum_words`` changes with any flipped bit and
any swap of two unequal words; ``shard_checksums`` equals checksumming each
shard's slices directly; ``merge_halve`` on ``[global || delta]`` states
(one halving, a multi-halving catch-up, a saturated reset, integrity on a
clean state and with a flipped bit in shard 1's global slice, lanes with
per-lane params) leaves every leaf equal to the JAX fold's.  Each case gives
both packages the same numpy inputs.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import sketch_common as jsc
from repro.kernels import sketch_merge as jkm
from repro.kernels import sketch_step as jks
from repro_torch.kernels import sketch_common as psc
from repro_torch.kernels import sketch_merge as pkm
from repro_torch.kernels import sketch_step as pks

torch.set_num_threads(1)


def _pack(fields: np.ndarray, bits: int) -> np.ndarray:
    """(W, fields_per_word) int fields -> (W,) packed int32 words."""
    w = np.zeros(fields.shape[0], np.int64)
    for i in range(32 // bits):
        w |= fields[:, i].astype(np.int64) << (i * bits)
    return w.astype(np.uint32).view(np.int32)


def _unpack(words: np.ndarray, bits: int) -> np.ndarray:
    u = np.asarray(words).view(np.uint32).astype(np.int64)
    return np.stack([(u >> (i * bits)) & ((1 << bits) - 1)
                     for i in range(32 // bits)], axis=-1)


def _words(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        -2**31, 2**31, size=n, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("bits", [4, 8])
def test_merge_words_equals_reference_and_saturates(bits):
    fmax = (1 << bits) - 1
    rng = np.random.default_rng(bits)
    fa = rng.integers(0, fmax + 1, size=(512, 32 // bits))
    fb = rng.integers(0, fmax + 1, size=(512, 32 // bits))
    a, b = _pack(fa, bits), _pack(fb, bits)
    got = psc.merge_words(torch.from_numpy(a), torch.from_numpy(b),
                          bits).numpy()
    np.testing.assert_array_equal(got, _pack(np.minimum(fa + fb, fmax), bits))
    np.testing.assert_array_equal(
        got, np.asarray(jsc.merge_words(jnp.asarray(a), jnp.asarray(b),
                                        bits)))
    # arbitrary words (sign bit set, fields above any cap): still equal
    x, y = _words(10 + bits, 512), _words(20 + bits, 512)
    np.testing.assert_array_equal(
        psc.merge_words(torch.from_numpy(x), torch.from_numpy(y),
                        bits).numpy(),
        np.asarray(jsc.merge_words(jnp.asarray(x), jnp.asarray(y), bits)))


@pytest.mark.parametrize("bits", [4, 8])
def test_merge_words_no_borrow_leak(bits):
    """Saturated fields beside zero fields: a carry would land in the
    zeros."""
    fmax = (1 << bits) - 1
    fields = np.zeros((8, 32 // bits), np.int64)
    fields[:, ::2] = fmax
    w = torch.from_numpy(_pack(fields, bits))
    got = _unpack(psc.merge_words(w, w, bits).numpy(), bits)
    assert (got[:, ::2] == fmax).all() and (got[:, 1::2] == 0).all()


@pytest.mark.parametrize("n", [1, 7, 64, 1000])
def test_checksum_words_equals_reference(n):
    w = _words(n, 3 * n).reshape(3, n)
    np.testing.assert_array_equal(
        psc.checksum_words(torch.from_numpy(w)).numpy(),
        np.asarray(jsc.checksum_words(jnp.asarray(w))))


@pytest.mark.parametrize("seed", range(4))
def test_checksum_detects_bit_flip_and_word_swap(seed):
    rng = np.random.default_rng(seed)
    w = _words(100 + seed, 97)
    base = int(psc.checksum_words(torch.from_numpy(w)))
    for _ in range(16):
        f = w.copy()
        i, bit = int(rng.integers(97)), int(rng.integers(32))
        f.view(np.uint32)[i] ^= np.uint32(1 << bit)
        assert int(psc.checksum_words(torch.from_numpy(f))) != base
        i, j = rng.choice(97, size=2, replace=False)
        s = w.copy()
        s[[i, j]] = s[[j, i]]
        assert int(psc.checksum_words(torch.from_numpy(s))) != base


def test_bit_get_equals_reference():
    w = _words(5, 64)
    bits = np.random.default_rng(5).integers(0, 64 * 32, size=200).astype(
        np.int32)
    np.testing.assert_array_equal(
        psc.bit_get(torch.from_numpy(w), torch.from_numpy(bits)).numpy(),
        np.asarray(jsc.bit_get(jnp.asarray(w), jnp.asarray(bits))))


def _specs(**kw):
    return jks.StepSpec(**kw), pks.StepSpec(**kw)


@pytest.mark.parametrize("dk_bits", [0, 1024])
def test_shard_checksums_match_direct_slices(dk_bits):
    js, ps = _specs(width=512, rows=3, dk_bits=dk_bits, shards=4)
    c = _words(1, ps.counter_words)
    d = _words(2, ps.dk_words)
    got = pkm.shard_checksums(ps, torch.from_numpy(c),
                              torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jkm.shard_checksums(js, jnp.asarray(c),
                                            jnp.asarray(d))))
    cs = c.reshape(ps.rows, ps.shards, ps.wps_shard)
    for s in range(ps.shards):
        lane = cs[:, s].reshape(-1)
        if dk_bits:
            lane = np.concatenate([lane, d.reshape(ps.shards, -1)[s]])
        assert got[s] == int(psc.checksum_words(torch.from_numpy(lane)))


def test_halvings_equal_the_reference_loop():
    """k = (size // W).bit_length() (0 for W = 0) and size >> k: what the
    reference's halving loop gives."""
    rng = np.random.default_rng(0)
    size = rng.integers(0, 2**31, size=4000)
    size[:1000] = rng.integers(0, 5000, size=1000)
    w = rng.integers(0, 6000, size=4000)
    w[::7] = 0
    w[1::7] = 1
    k = pkm._halvings(torch.from_numpy(size), torch.from_numpy(w)).numpy()
    for s, ww, kk in zip(size.tolist(), w.tolist(), k.tolist()):
        n = 0
        while ww > 0 and s >= ww:
            s //= 2
            n += 1
        assert kk == n


def _state(spec, seed, sat=False):
    """A random [global || delta] state of ``spec`` (numpy leaves): random
    tables, a random size; with ``sat`` every counter field saturated."""
    rng = np.random.default_rng(seed)
    fmax = (1 << spec.counter_bits) - 1
    lanes = (spec.streams,) if spec.streams > 1 else ()
    st = {k: np.asarray(v) for k, v in jks.init_step_state(
        replace(spec, streams=1)).items()}
    st = {k: np.broadcast_to(v, lanes + v.shape).copy() for k, v in
          st.items()}
    n = spec.counter_words
    fields = rng.integers(0, fmax + 1 if sat else fmax // 2 + 1,
                          size=lanes + (2 * n, 32 // spec.counter_bits))
    if sat:
        fields[...] = fmax
    st["counters"] = _pack(fields.reshape(-1, fields.shape[-1]),
                           spec.counter_bits).reshape(lanes + (2 * n,))
    st["doorkeeper"] = _words(seed, int(np.prod(lanes + (
        2 * spec.dk_words,))))
    st["doorkeeper"] = st["doorkeeper"].reshape(lanes + (2 * spec.dk_words,))
    if not spec.dk_bits:
        st["doorkeeper"][...] = 0
    st["regs"][..., jks.R_SIZE] = rng.integers(0, 4000, size=lanes)
    return st


def _fold_both(js, ps, params, st):
    """merge_halve of both packages on the same numpy state; the port's
    fold is in place.  Returns (JAX leaves, port leaves) as numpy."""
    jp = jnp.asarray(np.asarray(params, np.int32))
    if js.streams > 1:
        jout = jax.vmap(lambda p, s: jkm.merge_halve(replace(js, streams=1),
                                                     p, s),
                        in_axes=(0 if jp.ndim == 2 else None, 0))(
            jp, {k: jnp.asarray(v) for k, v in st.items()})
    else:
        jout = jkm.merge_halve(js, jp, {k: jnp.asarray(v)
                                        for k, v in st.items()})
    pst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    pkm.merge_halve(ps, torch.from_numpy(np.asarray(params, np.int32)), pst)
    return ({k: np.asarray(v) for k, v in jout.items()},
            {k: v.numpy() for k, v in pst.items()})


def _assert_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _params(W, cap=15, bits=4):
    return np.asarray(pks.make_step_params(1, 8, 6, W, cap, 0,
                                           counter_bits=bits, device="cpu"))


@pytest.mark.parametrize("bits,W", [(4, 3000), (4, 500), (8, 100), (8, 0),
                                    (4, 1)],
                         ids=["one halving", "catch-up", "8-bit catch-up",
                              "W=0", "W=1"])
def test_merge_halve_equals_reference(bits, W):
    js, ps = _specs(width=512, rows=4, dk_bits=2048, shards=4,
                    counter_bits=bits)
    st = _state(js, bits + W)
    st["regs"][jks.R_SIZE] = 3500
    want, got = _fold_both(js, ps, _params(W, (1 << bits) - 1, bits), st)
    _assert_equal(got, want)
    H = ps.counter_words
    assert not got["counters"][H:].any() and not got["doorkeeper"][
        ps.dk_words:].any()


@pytest.mark.parametrize("bits", [4, 8])
def test_merge_halve_saturated_reset(bits):
    """Saturated global and delta fields, one halving owed: every field
    reads cap // 2, no borrow from the neighbours."""
    js, ps = _specs(width=256, rows=2, dk_bits=0, shards=2,
                    counter_bits=bits)
    st = _state(js, 3, sat=True)
    st["regs"][jks.R_SIZE] = 150
    fmax = (1 << bits) - 1
    want, got = _fold_both(js, ps, _params(100, fmax, bits), st)
    _assert_equal(got, want)
    fields = _unpack(got["counters"][:ps.counter_words], bits)
    assert (fields == fmax // 2).all()


def _integrity_state(js, seed, flip):
    st = _state(js, seed)
    H, HD = js.counter_words, js.dk_words
    st["csum"][:js.shards] = np.asarray(jkm.shard_checksums(
        js, jnp.asarray(st["counters"][:H]),
        jnp.asarray(st["doorkeeper"][:HD])))
    st["csum"][js.shards] = 2
    if flip:                                     # row 1, shard 1
        st["counters"].view(np.uint32)[js.words_per_row + js.wps_shard
                                       + 3] ^= np.uint32(1 << 6)
    return st


@pytest.mark.parametrize("dk_bits", [0, 1024])
@pytest.mark.parametrize("flip", [False, True], ids=["clean", "flipped"])
def test_merge_halve_integrity(dk_bits, flip):
    """Integrity: a clean state folds as without it and counts nothing; a
    bit flipped in shard 1's global slice zeroes that shard's global and
    delta slices and counts one quarantined shard."""
    js, ps = _specs(width=512, rows=3, dk_bits=dk_bits, shards=4,
                    integrity=True)
    st = _integrity_state(js, 7, flip)
    want, got = _fold_both(js, ps, _params(3000), st)
    _assert_equal(got, want)
    assert got["csum"][-1] == 2 + int(flip)
    g = got["counters"][:ps.counter_words].reshape(ps.rows, ps.shards, -1)
    assert (not g[:, 1].any()) == flip and g[:, 0].any()
    if dk_bits:
        d = got["doorkeeper"][:ps.dk_words].reshape(ps.shards, -1)
        assert (not d[1].any()) == flip
    np.testing.assert_array_equal(
        got["csum"][:ps.shards],
        pkm.shard_checksums(ps, torch.from_numpy(got["counters"][
            :ps.counter_words]), torch.from_numpy(got["doorkeeper"][
                :ps.dk_words])).numpy())


@pytest.mark.parametrize("per_lane", [False, True], ids=["shared", "per-lane"])
def test_merge_halve_lanes(per_lane):
    """With lanes each lane folds with its own size and params row, as the
    reference's vmapped fold does."""
    js, ps = _specs(width=256, rows=4, dk_bits=1024, shards=2, streams=3,
                    integrity=True)
    st = _state(js, 11)
    st["regs"][:, jks.R_SIZE] = [100, 2500, 900]
    params = (np.stack([_params(W) for W in (0, 300, 1000)]) if per_lane
              else _params(400))
    want, got = _fold_both(js, ps, params, st)
    _assert_equal(got, want)
