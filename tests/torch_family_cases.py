"""Shared by the tests of the port's model families against the JAX
package's (tests/test_torch_families.py, test_torch_moe_families.py,
test_torch_ssm_families.py): one drive of a smoke config through both
packages on the same ``check_runs.numpy_params`` weights and tokens, and its
checks.  Not a test module; it imports jax and is not part of the port.

A drive: prefill 21 tokens of two sequences (two 16-position chunks, the
second padded; llava with 8 vision embeddings in front), ``extend`` 12
more from the cache (one padded chunk from the states), then decode three.
The JAX side runs jitted (one compile per entry point) and is kept per
(architecture, dtype) for the process, so a bf16 test reuses the fp32
drive it measures the reference's own rounding against.

Tolerances, as max |port - JAX| over max |JAX|: 1e-4 with fp32 compute;
in fp32 a bf16 cache leaf (the KV, zamba's conv state before its first
widening) elementwise within a bf16 ulp (2^-7 of the value) plus 1e-4 of
the largest.  With bf16 compute, 0.05 (the reference's own bf16 bound,
tests/test_models.py) or, where the reference's bf16 run is itself
further from its fp32 run, 1.5x that distance: two bf16 runs that each
round differently stand about that far apart.  The recurrent states sum a
whole prompt of bf16-rounded terms (the sLSTM's c moves 0.22 of its
largest value between the reference's bf16 and fp32 runs), and zamba's
residual stream crosses seven mixers (its prefill output moves 0.042).
With experts, the bf16 K/V are held only at the layers before any MoE
output: the router's bf16 logits tie or nearly tie among the smoke
configs' 4-8 experts, so a rounding difference between XLA and PyTorch can
send a token to another expert, which moves every later layer's K/V of the
positions after it (the routing is held identical in fp32,
test_torch_moe_families.py; the outputs stay within the bound).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serve.extend import extend as jax_extend
from repro_torch.check_runs import numpy_params
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.extend import extend

TOL = {"float32": 1e-4, "bfloat16": 0.05}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
PREFILL, EXTEND, DECODE, MAX_LEN = 21, 12, 3, 48


def rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def pair(arch, dtype, **kw):
    """(JAX config, port config) of ``arch``'s smoke config in ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    return (jax_get_config(arch, smoke=True).replace(compute_dtype=jdt, **kw),
            get_config(arch, smoke=True).replace(compute_dtype=tdt, **kw))


def jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def state_leaves(cache) -> dict:
    """Every leaf of a cache but ``pos``, by name, as fp32 numpy copies
    (the port's caches are written in place by the later steps)."""
    out = {}
    for k, v in cache.items():
        for n, a in (v.items() if isinstance(v, dict) else [(k, v)]):
            if n != "pos":
                name = f"{k}/{n}" if isinstance(v, dict) else k
                out[name] = (a.float().numpy().copy()
                             if isinstance(a, torch.Tensor)
                             else np.asarray(jnp.asarray(a, jnp.float32)))
    return out


def inputs(cfg):
    """(tokens (2, 36[, K]), vision embeddings or None): codebook streams
    distinct, vision embeddings 0.02-scaled as the reference's tests make
    them."""
    n = PREFILL + EXTEND + DECODE
    t = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, n))
    if cfg.n_codebooks:
        t = (t[..., None] + np.arange(cfg.n_codebooks)) % cfg.vocab_size
    vis = (np.random.default_rng(5).standard_normal(
        (2, cfg.n_vis_tokens, cfg.d_model), dtype=np.float32) * 0.02
        if cfg.n_vis_tokens else None)
    return t, vis


@functools.lru_cache(maxsize=None)
def jax_drive(arch: str, dtype: str) -> dict:
    """The JAX package's drive (numpy results)."""
    jcfg, cfg = pair(arch, dtype)
    jm, jp = jax_build_model(jcfg), jax_tree(numpy_params(cfg, seed=3))
    toks, vis = inputs(cfg)
    batch = {"tokens": jnp.asarray(toks[:, :PREFILL])}
    if vis is not None:
        batch["vision_embeds"] = jnp.asarray(vis)
    start = PREFILL + cfg.n_vis_tokens
    pre, dec = jax.jit(jm.prefill), jax.jit(jm.decode)
    ext = jax.jit(lambda p, t, c: jax_extend(jm, p, t, c, start))
    out = {}
    c, h = pre(jp, batch, jm.init_cache(2, MAX_LEN))
    out["prefill"], out["prefill_cache"] = np.asarray(h, np.float32), \
        state_leaves(c)
    c, h = ext(jp, jnp.asarray(toks[:, PREFILL:PREFILL + EXTEND]), c)
    out["extend"], out["extend_cache"] = np.asarray(h, np.float32), \
        state_leaves(c)
    out["logits"] = []
    for i in range(PREFILL + EXTEND, PREFILL + EXTEND + DECODE):
        lg, c = dec(jp, jnp.asarray(toks[:, i:i + 1]), c)
        out["logits"].append(np.asarray(lg, np.float32))
    out["decode_cache"], out["pos"] = state_leaves(c), np.asarray(c["pos"])
    return out


def port_drive(arch: str, dtype: str) -> dict:
    """The port's drive on the CPU (torch results)."""
    _, cfg = pair(arch, dtype)
    m = Model(cfg, device="cpu")
    params = params_from_numpy(cfg, numpy_params(cfg, seed=3), device="cpu")
    toks, vis = inputs(cfg)
    toks = torch.from_numpy(toks)
    batch = {"tokens": toks[:, :PREFILL]}
    if vis is not None:
        batch["vision_embeds"] = torch.from_numpy(vis)
    start = PREFILL + cfg.n_vis_tokens
    out = {}
    c, h = m.prefill(params, batch, m.init_cache(2, MAX_LEN))
    out["prefill"], out["prefill_cache"] = h, state_leaves(c)
    out["cache_dtypes"] = {k: a.dtype for k, a in _leaves(c).items()}
    c, h = extend(m, params, toks[:, PREFILL:PREFILL + EXTEND], c, start)
    out["extend"], out["extend_cache"] = h, state_leaves(c)
    out["logits"] = []
    for i in range(PREFILL + EXTEND, PREFILL + EXTEND + DECODE):
        lg, c = m.decode(params, toks[:, i:i + 1], c)
        out["logits"].append(lg)
    out["decode_cache"], out["pos"] = state_leaves(c), c["pos"].numpy()
    return out


def _leaves(cache):
    return {(f"{k}/{n}" if isinstance(v, dict) else k): a
            for k, v in cache.items()
            for n, a in (v.items() if isinstance(v, dict) else [(k, v)])
            if n != "pos"}


def check_drive(arch: str, dtype: str) -> None:
    """The port's drive against the reference's, with the module's
    tolerances."""
    jcfg, cfg = pair(arch, dtype)
    want, got = jax_drive(arch, dtype), port_drive(arch, dtype)
    tol = TOL[dtype]
    ref32 = jax_drive(arch, "float32") if dtype == "bfloat16" else None

    def bound(w, w32):
        return tol if ref32 is None else max(tol, 1.5 * rel(w, w32))

    for what in ("prefill", "extend"):
        assert got[what].shape == want[what].shape
        b = bound(want[what], ref32 and ref32[what])
        assert rel(got[what], want[what]) < b, (what, rel(got[what],
                                                          want[what]), b)
    for step, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        shape = (2, 1) + ((cfg.n_codebooks,) if cfg.n_codebooks else ()) \
            + (cfg.vocab_size,)
        assert g.shape == shape and g.dtype == torch.float32
        b = bound(w, ref32 and ref32["logits"][step])
        assert rel(g, w) < b, (f"decode step {step}", rel(g, w), b)
    assert got["pos"].tolist() == want["pos"].tolist() == \
        [PREFILL + cfg.n_vis_tokens + EXTEND + DECODE] * 2
    for what in ("prefill_cache", "extend_cache", "decode_cache"):
        g_c, w_c = got[what], want[what]
        assert set(g_c) == set(w_c), what
        for k, w in w_c.items():
            g = g_c[k]
            assert g.shape == w.shape, (what, k)
            if dtype == "float32":
                if got["cache_dtypes"][k] == torch.bfloat16:
                    lim = 2.0 ** -7 * np.abs(w) + tol * np.abs(w).max()
                    assert np.all(np.abs(g - w) <= lim), (what, k)
                else:
                    assert rel(g, w) < tol, (what, k)
                continue
            b = bound(w, ref32[what][k])
            if cfg.n_experts and k in ("k", "v"):
                first = cfg.moe_every       # layers before any MoE output
                g, w, b = g[:first], w[:first], tol
            assert rel(g, w) < b, (what, k, rel(g, w), b)


def jax_depth_pins(arch: str, n_layers: int, seed: int = 0,
                   fp32: bool = False, follow=None, prompt_len=None):
    """A depth pin of ``check_runs`` (D2's procedure at another
    architecture): the published config cut to ``n_layers`` with the
    weights ``numpy_leaves(cfg, seed)`` (in bf16 compute each leaf is cast
    as ``cast_params`` casts it as it is drawn, so the fp32 tree is never
    whole; ``fp32``: fp32 compute and leaves), the first ``prompt_len``
    tokens of ``d2_prompt`` (all ``D2_PROMPT_LEN`` by default), then
    ``D2_STEPS`` greedy decodes.  Returns
    (per step, the JAX top-8 ids and their fp32 logits; with experts, the
    first MoE layer's expert per prompt token as a string of base-36
    digits, else None).  With ``follow`` (another run's pins) the decodes
    feed that run's greedy tokens and each step reports this run's logits
    at that run's ids."""
    from repro.models import transformer as JT
    from repro.models.common import NULL_POLICY
    from repro_torch.check_runs import (D2_MAX_LEN, D2_STEPS, d2_prompt,
                                        numpy_leaves)
    jcfg = jax_get_config(arch).replace(n_layers=n_layers)
    if fp32:
        jcfg = jcfg.replace(compute_dtype=jnp.float32)
    cfg = get_config(arch).replace(n_layers=n_layers)
    tree: dict = {}
    for path, a in numpy_leaves(cfg, seed):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = jnp.asarray(a, jnp.bfloat16 if a.ndim >= 2
                                     and not fp32 else a.dtype)
        del a
    m = jax_build_model(jcfg)
    prompt = jnp.asarray(d2_prompt(jcfg.vocab_size)[None, :prompt_len],
                         jnp.int32)
    cache, h = jax.jit(m.prefill)(tree, {"tokens": prompt},
                                  m.init_cache(1, D2_MAX_LEN))
    logits = m.lm_head(tree, h)[0, 0]
    dec = jax.jit(m.decode)
    out = []
    for step in range(D2_STEPS + 1):
        lg = np.asarray(logits, np.float32)
        ids = (follow[step][0] if follow
               else np.argsort(-lg, kind="stable")[:8])
        out.append((tuple(int(i) for i in ids),
                    tuple(float(lg[i]) for i in ids)))
        if step < D2_STEPS:
            logits, cache = dec(tree, jnp.asarray([[int(ids[0])]],
                                                  jnp.int32), cache)
            logits = logits[0, 0]
    routing = None
    if jcfg.n_experts:
        blk = jax.tree_util.tree_map(lambda a: a[0], tree["layers"])
        x = JT.embed_tokens(tree, prompt, jcfg)
        pos = jnp.arange(x.shape[1])[None]
        j = jcfg.moe_every - 1
        for i in range(j + 1):
            x, _ = JT.attn_block_train(blk[f"attn{i}"], x, jcfg, pos,
                                       NULL_POLICY)
            if i < j:
                x, _ = JT.ffn_or_moe(blk, i, x, jcfg, None, NULL_POLICY)
        hm = JT.rmsnorm(x, blk[f"moe{j}_norm"], jcfg.norm_eps)
        e = np.asarray(jnp.argmax((hm @ blk[f"moe{j}"]["router"]).astype(
            jnp.float32), -1))[0]
        routing = "".join(np.base_repr(int(i), 36).lower() for i in e)
    return out, routing


def print_pins(name: str, pins) -> None:
    print(f"{name} = [")
    for ids, lg in pins:
        print(f"    ({ids},\n     {tuple(round(x, 6) for x in lg)}),")
    print("]")


def print_depth_pins(name: str, arch: str, n_layers: int,
                     spread: bool = False, fp32: bool = False,
                     prompt_len=None) -> None:
    """Print a depth pin on the first ``prompt_len`` prompt tokens; with
    ``fp32`` also the fp32 pin (``{name}_FP32_PINS``); with ``spread``,
    per step, the distance of the bf16 pin's logits from the fp32 run's at
    the same ids along the same tokens (``{name}_BF16_SPREAD``)."""
    import time
    t0 = time.perf_counter()
    pins, routing = jax_depth_pins(arch, n_layers, prompt_len=prompt_len)
    print_pins(f"{name}_PINS", pins)
    if routing is not None:
        print(f"{name}_ROUTING = (")
        for i in range(0, len(routing), 64):
            print(f'    "{routing[i:i + 64]}"')
        print(")")
    if fp32:
        print_pins(f"{name}_FP32_PINS", jax_depth_pins(
            arch, n_layers, fp32=True, prompt_len=prompt_len)[0])
    if spread:
        along = jax_depth_pins(arch, n_layers, fp32=True, follow=pins,
                               prompt_len=prompt_len)[0]
        print(f"{name}_BF16_SPREAD = " + repr(tuple(
            round(float(np.max(np.abs(np.subtract(a[1], b[1])))
                        / np.max(np.abs(b[1]))), 6)
            for a, b in zip(pins, along))))
    print(f"# {time.perf_counter() - t0:.1f} s")
