"""The port's program lint lints itself: every rule must trip on its bad
program (``analysis/lint_fixtures.py``), and the real engine (a slice of the
configuration matrix) must lint clean.  Counterparts of
``tests/test_program_lint.py``; the full 15-entry matrix is
``python -m repro_torch.analysis.program_lint --device cpu``.  Also: the
port's rule table, contracts and matrix line up with the reference's,
recording changes no result (the engine against the JAX engine with the
recorder on), and the kernel's argument struct is packed as before.
"""
import ctypes
import hashlib
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.analysis import program_lint as ref_lint
from repro.core import device_simulate as jds
from repro_torch.analysis import program_lint as pl
from repro_torch.analysis import program_trace
from repro_torch.analysis.lint_fixtures import FIXTURES
from repro_torch.analysis.program_lint import (
    FINGERPRINT_CONTRACTS, LintBounds, MatrixEntry, _digest,
    check_fingerprints, default_matrix, env_key, lint_program,
    load_registry, run_matrix)
from repro_torch.core import device_simulate as pds
from repro_torch.kernels import sketch_step as ks

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# R0-R7: each fixture must trip its rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_fixture_trips_its_rule(rule):
    runs, bounds = FIXTURES[rule]("cpu")
    tripped = {v.rule for v in lint_program(runs, bounds,
                                            config=f"bad-{rule}")}
    assert rule in tripped, (
        f"fixture for {rule} no longer detected; rules tripped: {tripped}")


def test_violation_reports_are_actionable():
    runs, bounds = FIXTURES["R3"]("cpu")
    v = [x for x in lint_program(runs, bounds, config="bad-R3")
         if x.rule == "R3"][0]
    assert "bad-R3" in str(v) and "chunk 0" in v.where
    assert "aten.clone" in v.where           # config + the op at fault
    d = v.to_dict()
    assert set(d) == {"rule", "config", "where", "message"}


def test_r0_flags_missing_chunk_loop():
    # launches recorded with no engine loop around them, but bounds that
    # expect one
    spec = ks.StepSpec(**pl._FP_BASE)
    params = ks.make_step_params(4, 48, 38, 700, 7, 0, device="cpu")
    state = ks.init_step_state(spec, device="cpu")
    lo = torch.arange(16, dtype=torch.int32)
    run = pl.record_program(lambda: ks.step(spec, params, state, lo, lo),
                            "cpu")
    assert [e[0] for e in run.events] == ["launch"]
    v = lint_program([run], LintBounds(access_trips=(16,), accesses=16),
                     config="no-loop")
    assert "R0" in {x.rule for x in v}
    assert any("no chunk loop" in x.message for x in v)


def test_ops_per_chunk_must_not_grow_with_the_chunk():
    # the engine's chunk program is the same at both lengths; a loop of
    # small ops over the chunk's keys (no host read, nothing table-shaped)
    # is caught by the comparison across the two lengths alone
    runs, bounds = pl.engine_program(dict(capacity=2048, assoc=8), "cpu")
    assert not lint_program(runs, bounds, config="engine")
    per_chunk = {len(pl._ops(ev)) for r in runs
                 for ev in pl._scopes(r.events).chunks}
    assert len(per_chunk) == 1

    def fn_of(base):
        def fn(spec, params, state, lo, hi, n_valid, probes):
            for _ in range(lo.shape[-1]):
                state["regs"][ks.R_T].add_(0)
            return base(spec, params, state, lo, hi, n_valid, probes)
        return fn
    from repro_torch.analysis.lint_fixtures import _bad_runs
    one, b1 = _bad_runs(fn_of, "cpu", trips=(pl.T_STEP,))
    assert not lint_program(one, b1)        # one length: constant
    two, b2 = _bad_runs(fn_of, "cpu", trips=pl.TRIPS)
    assert {x.rule for x in lint_program(two, b2)} == {"R1"}


# ---------------------------------------------------------------------------
# R6 cadence: the mesh's two modes on two gloo ranks, judged under each
# contract
# ---------------------------------------------------------------------------

def test_r6_cadence_contracts_on_gloo_ranks():
    chunk, stale = pl.mesh_programs(["chunk", "stale"], "cpu")
    for mode, runs in (("chunk", chunk), ("stale", stale)):
        assert not lint_program(runs, pl.mesh_bounds(mode), mode), mode
    # single-device contract: any collective is a violation
    assert "R6" in {v.rule for v in lint_program(chunk, LintBounds())}
    assert "R6" in {v.rule for v in lint_program(stale, LintBounds())}
    # chunk contract: the stale fold's gathers are inside the loop
    bad = lint_program(stale, pl.mesh_bounds("chunk"))
    assert any(v.rule == "R6" and "fold" in v.where for v in bad)
    # stale contract: the chunk mode's entry gathers are outside the fold
    bad = lint_program(chunk, pl.mesh_bounds("stale"))
    assert any(v.rule == "R6" and "outside the loop" in v.message
               for v in bad)
    # the stale fold makes exactly two gathers an epoch: 4 folds at 96
    folds = pl._scopes(stale[0].events).folds
    assert [len(pl._ops(f, "collective")) for f in folds] == [2] * 4


# ---------------------------------------------------------------------------
# green run: the real engine lints clean
# ---------------------------------------------------------------------------

def test_default_matrix_covers_every_axis():
    labels = [e.label for e in default_matrix("cpu")]
    for needle in ("flat-static", "assoc-static", "streams4", "policy-",
                   "shards4", "adaptive", "mesh-chunk", "mesh-stale",
                   "integrity", "donated"):
        assert any(needle in label for label in labels), needle


def test_engine_slice_lints_clean():
    matrix = [e for e in default_matrix("cpu")
              if e.label in ("flat-static", "assoc-static",
                             "assoc-donated")]
    violations, rows = run_matrix(matrix)
    assert not violations, [str(v) for v in violations]
    assert {r["label"]: r["status"] for r in rows} == {
        "flat-static": "ok", "assoc-static": "ok", "assoc-donated": "ok"}
    for r in rows:                   # ceil(407 / 96) and ceil(407 / 192)
        assert r["launches"] == [5, 3] and r["trips"] == [96, 192]


def test_waived_rule_reports_but_does_not_fail():
    entry = MatrixEntry("waived-fixture", lambda: FIXTURES["R3"]("cpu"),
                        waive={"R3": "test waiver"})
    violations, rows = run_matrix([entry])
    assert not violations                     # waived -> non-fatal
    (row,) = rows
    assert row["status"] == "waived"
    assert row["waived"] and row["waived"][0]["reason"] == "test waiver"


def test_skip_entry_reports_skipped():
    def build():
        raise pl.SkipEntry("needs hardware")
    violations, rows = run_matrix([MatrixEntry("skippy", build)])
    assert not violations
    assert rows[0]["status"] == "skipped" and "hardware" in rows[0]["reason"]


# ---------------------------------------------------------------------------
# R7: the fingerprint registry
# ---------------------------------------------------------------------------

def test_r7_update_then_check_roundtrip(tmp_path):
    reg = tmp_path / "fp.json"
    v, notes = check_fingerprints(update=True, registry_path=reg,
                                  contracts={"shards1": {"shards": 1}},
                                  device="cpu")
    assert not v and any("updated" in n for n in notes)
    v, notes = check_fingerprints(registry_path=reg, device="cpu",
                                  contracts={"shards1": {"shards": 1}})
    assert not v, [str(x) for x in v]


def test_r7_tampered_digest_is_a_violation(tmp_path):
    reg = tmp_path / "fp.json"
    check_fingerprints(update=True, registry_path=reg, device="cpu",
                       contracts={"shards1": {"shards": 1}})
    data = json.loads(reg.read_text())
    data[env_key("cpu")]["shards1"] = "0" * 64
    reg.write_text(json.dumps(data))
    v, _ = check_fingerprints(registry_path=reg, device="cpu",
                              contracts={"shards1": {"shards": 1}})
    assert any(x.rule == "R7" and "drifted" in x.message for x in v)


def test_r7_non_default_override_breaks_pair_equality(tmp_path):
    # {"assoc": 4} is NOT a spelled-out default -> another instance -> the
    # pair-equality half of R7 must fire even with no registry
    v, _ = check_fingerprints(registry_path=tmp_path / "fp.json",
                              contracts={"bogus": {"assoc": 4}},
                              device="cpu")
    assert any(x.rule == "R7" and x.config == "bogus" for x in v)


def test_r7_missing_env_is_note_not_violation(tmp_path):
    v, notes = check_fingerprints(registry_path=tmp_path / "absent.json",
                                  contracts={"shards1": {"shards": 1}},
                                  device="cpu")
    assert not v
    assert any("skipped" in n for n in notes)


def test_committed_registry_is_valid_json_with_all_contracts():
    reg = load_registry()
    assert reg, "fingerprints.json missing or empty"
    assert any(k.endswith("-cpu") for k in reg), "no CPU entry"
    for env, digests in reg.items():
        assert env.startswith("torch-"), env
        assert "base" in digests
        for name in FINGERPRINT_CONTRACTS:
            assert name in digests, (env, name)
        for dg in digests.values():
            assert len(dg) == 64 and int(dg, 16) >= 0


def test_digest_is_sha256_of_text():
    assert _digest("abc") == hashlib.sha256(b"abc").hexdigest()


# ---------------------------------------------------------------------------
# the port against the reference, and recording against no recording
# ---------------------------------------------------------------------------

def test_port_lines_up_with_the_reference():
    assert list(pl.RULES) == list(ref_lint.RULES)
    assert pl.FINGERPRINT_CONTRACTS == ref_lint.FINGERPRINT_CONTRACTS
    assert pl._FP_BASE == ref_lint._FP_BASE
    assert [e.label for e in default_matrix("cpu")] == [
        e.label for e in ref_lint.default_matrix()]
    for name in ("T_STEP", "E_EPOCH", "NE_EPOCHS", "T_TAIL", "B_LANES"):
        assert getattr(pl, name) == getattr(ref_lint, name), name
    assert [r for r, text in pl.RULES.items()
            if text.startswith("not applicable")] == ["R4"]


@pytest.mark.parametrize("kw", [
    dict(assoc=8),
    dict(assoc=8, shards=4, adaptive=True),
], ids=["assoc", "sharded-adaptive"])
def test_recording_changes_nothing(kw):
    """The engine recorded (every dispatch point active) equals the JAX
    engine: hits, every hit flag and every state leaf."""
    tr = pl.entry_trace(1000)
    extra = ({"climb": pds.ClimbSpec(epoch_len=192), "merge_every": 192}
             if kw.get("adaptive") else {})
    jextra = ({"climb": jds.ClimbSpec(epoch_len=192), "merge_every": 192}
              if kw.get("adaptive") else {})
    rec = pl.record_program(lambda: pds.simulate_trace(
        tr, 300, chunk=96, device="cpu", return_state=True, **kw, **extra),
        "cpu")
    pr, ps, ph = rec.result
    jr, js, jh = jds.simulate_trace(tr, 300, chunk=96, return_state=True,
                                    **kw, **jextra)
    assert pr.hits == jr.hits
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    assert set(ps) == set(js)
    for k in js:
        np.testing.assert_array_equal(ps[k].numpy(), np.asarray(js[k]),
                                      err_msg=k)
    assert pl._launches(rec.events)
    assert program_trace.active is None


def test_scalar_store_into_one_element_is_a_host_read():
    """``t[i] = x`` copies a host scalar into one element (on the card a
    pageable copy that waits: ``set_sync_debug_mode("error")`` raises at
    it); ``t[a:b] = x`` is a fill and reads nothing."""
    t = torch.zeros((2, 6), dtype=torch.int32)
    with program_trace.record() as rec:
        t[0, 3] = -1
        t[:, 2] = 5
        t[1:, :4] = 0
    classes = [(e[1], e[2]) for e in rec.events if e[2] != "view"]
    assert classes == [("aten.copy_.default", "host_read"),
                       ("aten.fill_.Tensor", "write"),
                       ("aten.fill_.Tensor", "write")]


def test_set_rebalance_reads_nothing_in_the_fold():
    """The set tables' rebalance builds its empty record by tensor ops: the
    card found (chip_smoke phase 49) that the three element stores it made
    waited for the card in every climb epoch of assoc-adaptive and
    assoc-adaptive-streams4.  The entry now lints clean here too."""
    (entry,) = [e for e in default_matrix("cpu")
                if e.label == "assoc-adaptive"]
    runs, bounds = entry.build()
    assert not lint_program(runs, bounds, "assoc-adaptive")
    folds = [f for r in runs for f in pl._scopes(r.events).folds]
    assert len(folds) == 4 + 2
    assert not any(pl._ops(f, "host_read") for f in folds)


def test_a_profiler_session_that_saw_nothing_is_told_apart():
    """On the card a run is recorded again only when its profiler session
    delivered no device activity at all; a session that saw other kernels
    but fewer step kernels than launches is an R0 violation, and the CPU
    (no profiler) never redoes a run."""
    launch = [("launch", "sketch_step", ())] * 2
    assert pl._dropped(pl.Recording(launch, kernels=0, activities=0))
    assert not pl._dropped(pl.Recording(launch, kernels=1, activities=9))
    assert not pl._dropped(pl.Recording(launch))
    assert not pl._dropped(pl.Recording([], kernels=0, activities=0))
    v = lint_program([pl.Recording(launch, kernels=1, activities=9)],
                     LintBounds())
    assert any(x.rule == "R0" and "profiler" in x.message for x in v)


def test_first_launch_reads_an_unmarked_state_once():
    """A state whose tables were written by torch carries no in-range mark:
    the first launch reads its address table once (allowed by
    ``first_launch_reads``), and the plain version keeps the mark after."""
    spec = ks.StepSpec(**pl._FP_BASE)
    params = ks.make_step_params(4, 48, 38, 700, 7, 0, device="cpu")
    state = ks.init_step_state(spec, device="cpu")
    state["wtab"][0, ks.WT_MSET] = 0            # a torch write: no mark
    lo = torch.arange(40, dtype=torch.int32)
    run = pl.record_program(lambda: pds.run_chunks(spec, params, state, lo,
                                                   lo, 16), "cpu")
    reads = [(c, e[1]) for c, ev in enumerate(pl._scopes(run.events).chunks)
             for e in pl._ops(ev, "host_read")]
    assert [c for c, _ in reads] == [0]
    bounds = LintBounds(access_trips=(16,), accesses=40)
    assert {v.rule for v in lint_program([run], bounds)} == {"R1"}
    assert not lint_program([run], LintBounds(access_trips=(16,),
                                              accesses=40,
                                              first_launch_reads=1))


@pytest.mark.parametrize("kw,lanes,n_valid,rank", [
    (dict(pl._FP_BASE), 0, 7, 0),
    (dict(width=256, dk_bits=0, window_slots=5, main_slots=40), 0, 16, 0),
    (dict(pl._FP_BASE, streams=3), 3, [5, 9, 16], 0),
    (dict(pl._FP_BASE, shards=4, mesh_devices=2), 0, 16, 1),
    (dict(pl._FP_BASE, policy="arc"), 0, 16, 0),
    (dict(pl._FP_BASE, adaptive=True, streams=2), 2, 12, 0),
], ids=["set", "flat", "lanes", "mesh", "arc", "adaptive-lanes"])
def test_step_args_struct_field_by_field(kw, lanes, n_valid, rank):
    """The ``StepArgs`` bytes from ``_arg_ptrs`` and ``_arg_ints`` (the
    packing that also runs on CPU tensors for a recorded launch) equal the
    struct written out field by field from the spec."""
    spec = ks.StepSpec(**kw)
    state = ks.init_step_state(spec, device="cpu")
    shape = (lanes, 16) if lanes else (16,)
    lo = torch.zeros(shape, dtype=torch.int32)
    probes = ks.precompute_probes(spec, lo, lo)
    params = ks.make_step_params(4, 30, 24, 700, 7, 0, device="cpu")
    hits = torch.zeros(shape, dtype=torch.int32)
    nv = (torch.tensor(n_valid, dtype=torch.int32)
          if isinstance(n_valid, list) else n_valid)
    ptr = ks._arg_ptrs(spec, params, state, lo, lo, probes, nv, hits)
    got = ks._Args(**{k: v.data_ptr() for k, v in ptr.items()},
                   **ks._arg_ints(spec, params, lo, nv, rank=rank))
    want = ks._Args()
    for name, t in zip(("lo", "hi", "kidx", "kdkb", "kwset", "kmset",
                        "params", "hits"),
                       (lo, lo, *probes, params, hits)):
        setattr(want, name, t.data_ptr())
    for name, key in (("counters", "counters"), ("dk", "doorkeeper"),
                      ("ddk", "ddoorkeeper")):
        if key in state:
            setattr(want, name, state[key].data_ptr())
    for name in ("wlo", "whi", "wmeta", "widx", "wdkb", "mlo", "mhi",
                 "mmeta", "midx", "mdkb", "wtab", "mtab", "regs", "wsl",
                 "wuw", "ghost", "dcounters"):
        if name in state:
            setattr(want, name, state[name].data_ptr())
    if isinstance(nv, torch.Tensor):
        want.nvalid = nv.data_ptr()
    ints = dict(n_valid=0 if isinstance(nv, torch.Tensor) else nv, b=16,
                rows=spec.rows, dkp=spec.dkp, dk_bits=spec.dk_bits,
                counter_bits=spec.counter_bits,
                words_per_row=spec.words_per_row,
                counter_words=spec.counter_words, dk_words=spec.dk_words,
                window_slots=spec.window_slots, main_slots=spec.main_slots,
                assoc=spec.assoc or 0, wcols=spec.wcols if spec.assoc else 0,
                mcols=spec.mcols if spec.assoc else 0, lanes=lanes,
                params_stride=0, halves=(1 if spec.mesh_devices
                                         else spec.sketch_halves),
                adaptive=int(spec.adaptive),
                policy=("wtinylfu", "s3fifo", "arc", "lfu").index(
                    spec.policy),
                mesh=int(bool(spec.mesh_devices)),
                mesh_base=rank * spec.local_shards if spec.mesh_devices
                else 0, local_shards=spec.local_shards,
                width_shard=spec.width_shard,
                dk_bits_shard=spec.dk_bits_shard, wps_shard=spec.wps_shard,
                dkw_shard=spec.dkw_shard, exact=0)
    for name, value in ints.items():
        setattr(want, name, value)
    assert ctypes.sizeof(ks._Args) == ctypes.sizeof(want)
    assert bytes(got) == bytes(want)


def test_cli_list_rules_and_exit_codes(tmp_path, capsys, monkeypatch):
    assert pl.main(["--list-rules"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in out] == [f"R{i}" for i in range(8)]
    assert "not applicable" in out[4]
    report = tmp_path / "lint.json"
    assert pl.main(["--device", "cpu", "--configs", "policy-lfu",
                    "--report", str(report)]) == 0
    data = json.loads(report.read_text())
    assert data["ok"] and [r["label"] for r in data["configs"]] == [
        "policy-lfu"]
    monkeypatch.setattr(pl, "default_matrix", lambda device=None: [
        MatrixEntry("bad", lambda: FIXTURES["R3"]("cpu"))])
    assert pl.main(["--device", "cpu", "--skip-fingerprints"]) == 1
    assert "FAIL" in capsys.readouterr().out
    bad = subprocess.run([sys.executable, "-m",
                          "repro_torch.analysis.program_lint", "--device",
                          "tpu"], capture_output=True, text=True)
    assert bad.returncode == 2 and "internal error" in bad.stderr
