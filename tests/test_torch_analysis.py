"""The port's analysis CLI on the CPU, against the JAX package's
(``repro.analysis``): the independent certifier on every golden
schedule and on each mutation of ``tests/test_analysis.py``'s table,
the store audit on a store the port's service wrote, the determinism
linter over both source trees, and ``python -m repro_torch.analysis``'s
printed lines.

Tolerance: certificates equal field for field (``ok``, every
violation, every derived value); the dual bound within rel 1e-12.
Both certifiers are host float64 numpy in one summation order, so in
practice they agree bit for bit.
"""

import contextlib
import dataclasses
import io
import json
import pathlib

import pytest

import repro.analysis.__main__ as ref_cli
from repro.analysis.certify import certify as ref_certify
from repro.analysis.certify import certify_store as ref_certify_store
from repro.analysis.lint_determinism import lint_tree as ref_lint_tree
from repro.core import OrchestratorConfig as RefConfig
from repro.core import compile_power_schedule as ref_compile
from repro.hw.edge40nm import EDGE40NM_DEFAULT as REF_ACC
from repro.models.edge_cnn import edge_network as ref_network
from repro.service.store import ArtifactStore as RefStore
from test_analysis import MUTATIONS, N_RAILS, NETWORK
from conftest import max_rate
import repro_torch.analysis.__main__ as cli
from repro_torch.analysis import lint_determinism as lint
from repro_torch.analysis.certify import certify, certify_store
from repro_torch.core import MinEnergy, OrchestratorConfig
from repro_torch.core.schedule import PowerSchedule
from repro_torch.hw.edge40nm import EDGE40NM_DEFAULT as ACC
from repro_torch.models.edge_cnn import edge_network
from repro_torch.service import CompileService
from repro_torch.service.store import ArtifactStore

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN_KEYS = sorted(json.loads(
    (ROOT / "tests" / "golden" / "pipeline.json").read_text()))
REL = 1e-12


@pytest.fixture(scope="module")
def golden_scheds():
    """key → (reference schedule, network specs, n_rails) for every
    golden case, compiled once by the reference (infeasible: None)."""
    out = {}
    for key in GOLDEN_KEYS:
        net, frac, n_rails, policy = key.split("|")
        specs = ref_network(net)
        sched = ref_compile(
            specs, ref_cli._max_rate(net, REF_ACC) * float(frac),
            cfg=RefConfig(policy=policy, n_max_rails=int(n_rails),
                          backend="numpy"), network=net)
        out[key] = (sched, specs, int(n_rails))
    return out


def _port(sched) -> PowerSchedule:
    return PowerSchedule.from_json(sched.to_json())


def _same_certificate(got, want) -> None:
    assert got.ok == want.ok
    assert (got.network, got.policy) == (want.network, want.policy)
    assert [dataclasses.asdict(v) for v in got.violations] == \
        [dataclasses.asdict(v) for v in want.violations]
    assert [str(v) for v in got.violations] == \
        [str(v) for v in want.violations]
    assert got.derived == want.derived
    assert (got.dual is None) == (want.dual is None)
    if want.dual is not None:
        for field in ("lambda_star", "bound", "energy", "gap_abs",
                      "gap_rel"):
            a, b = getattr(got.dual, field), getattr(want.dual, field)
            assert abs(a - b) <= REL * max(abs(a), abs(b), 1e-30), field
    assert got.summary() == want.summary()


@pytest.mark.parametrize("key", GOLDEN_KEYS)
def test_certify_matches_reference_on_every_golden(golden_scheds, key):
    sched, _, n_rails = golden_scheds[key]
    assert sched is not None and sched.feasible
    net = key.split("|")[0]
    want = ref_certify(sched, ref_network(net), acc=REF_ACC,
                       n_max_rails=n_rails)
    got = certify(_port(sched), edge_network(net), acc=ACC,
                  n_max_rails=n_rails)
    assert got.ok and got.dual is not None
    _same_certificate(got, want)


@pytest.fixture(scope="module")
def base_sched():
    """The schedule ``tests/test_analysis.py`` mutates (pfdnn,
    squeezenet1.1 at 0.85 × max rate, 3 rails), from the reference."""
    sched = ref_compile(ref_network(NETWORK), max_rate(NETWORK) * 0.85,
                        cfg=RefConfig(policy="pfdnn", n_max_rails=N_RAILS,
                                      backend="numpy"), network=NETWORK)
    assert sched is not None and sched.feasible
    return sched


@pytest.mark.parametrize("name,mutate,expected", MUTATIONS,
                         ids=[m[0] for m in MUTATIONS])
def test_certify_matches_reference_on_each_mutation(base_sched, name,
                                                     mutate, expected):
    mutant = mutate(base_sched, ref_network(NETWORK))
    want = ref_certify(mutant, ref_network(NETWORK), acc=REF_ACC,
                       n_max_rails=N_RAILS)
    got = certify(_port(mutant), edge_network(NETWORK), acc=ACC,
                  n_max_rails=N_RAILS)
    assert not got.ok and expected in {v.kind for v in got.violations}
    _same_certificate(got, want)


def test_certify_options_match_reference(base_sched):
    """The overrides and the structural refusals take the reference's
    branches: no dual, a forced gating flag, a cut layer count, a
    calibrated artifact without its cost model."""
    specs, rspecs = edge_network(NETWORK), ref_network(NETWORK)
    sched = _port(base_sched)
    for kw in ({"dual": False}, {"gating": False, "allow_sleep": True},
               {"n_max_rails": 1}, {"rel_tol": 1e-15}):
        _same_certificate(certify(sched, specs, acc=ACC, **kw),
                          ref_certify(base_sched, rspecs, acc=REF_ACC, **kw))
    cut = dataclasses.replace(
        base_sched, layer_voltages=base_sched.layer_voltages[:-1],
        awake_banks=base_sched.awake_banks[:-1])
    _same_certificate(certify(_port(cut), specs, acc=ACC),
                      ref_certify(cut, rspecs, acc=REF_ACC))
    calibrated = dataclasses.replace(sched, cost_model="abc123")
    with pytest.raises(ValueError, match="cost_model"):
        certify(calibrated, specs, acc=ACC)


# ------------------------------------------------------- store audit

@pytest.fixture()
def port_store(tmp_path):
    """A disk tier the port's CompileService wrote: two real keys, with
    the port's ``("backend", "torch")`` config part."""
    store = ArtifactStore(disk_path=tmp_path / "tier")
    svc = CompileService(store=store)
    cfg = OrchestratorConfig(n_max_rails=2, device="cpu")
    for frac in (0.5, 1e3):
        rate = frac * max_rate(NETWORK)
        svc.compile(edge_network(NETWORK), cfg=cfg, network=NETWORK,
                    goal=MinEnergy(rate_hz=rate))
    return store, tmp_path / "tier"


def test_certify_store_audits_the_ports_keys(port_store):
    store, root = port_store
    entries = sorted((root / "schedules").glob("*.json"))
    assert len(entries) == 2
    keys = [json.loads(p.read_text())["key"] for p in entries]
    assert all("('backend', 'torch')" in k[2] for k in keys)
    want = ref_certify_store(root)
    assert want["ok"] and want["entries"] == 2
    for target in (store.disk, root, str(root)):
        assert certify_store(target) == want
    got = certify_store(store)                       # memory + disk
    assert got["ok"] and got["entries"] == 4


@pytest.mark.parametrize("fault", ["key", "ledger", "payload", "schema"])
def test_certify_store_flags_what_the_reference_flags(port_store, fault):
    _, root = port_store
    path = sorted((root / "schedules").glob("*.json"))[0]
    ent = json.loads(path.read_text())
    if fault == "key":
        ent["key"] = ["tampered"] + ent["key"][1:]
    elif fault == "schema":
        ent["schema"] = 99
    elif ent["payload"].startswith("__infeasible"):
        ent["payload"] = "{not json"
    elif fault == "ledger":
        d = json.loads(ent["payload"])
        d["e_total"] *= 2
        ent["payload"] = json.dumps(d)
    else:
        ent["payload"] = "{not json"
    path.write_text(json.dumps(ent))
    got, want = certify_store(root), ref_certify_store(root)
    assert not got["ok"]
    assert got == want


def test_certify_store_memory_tier_matches_reference(tmp_path, base_sched):
    port, ref = ArtifactStore(), RefStore()
    broken = dataclasses.replace(base_sched, e_total=base_sched.e_total * 2)
    for store, conv in ((port, _port), (ref, lambda s: s)):
        store.put_schedule(("content", "goal", "cfg"), conv(base_sched))
        store.put_schedule(("content2", "goal", "cfg"), None)
        store.put_schedule(("content3", "goal", "cfg"), conv(broken))
    got, want = certify_store(port), ref_certify_store(ref)
    assert got == want and not got["ok"] and got["entries"] == 3


# ----------------------------------------------------------- linter

def test_linter_over_the_reference_tree_matches_reference():
    root = ROOT / "src" / "repro"
    got = lint.lint_tree(root)
    want = ref_lint_tree(root)
    assert got and [dataclasses.asdict(f) for f in got] == \
        [dataclasses.asdict(f) for f in want]


def test_port_tree_is_clean_under_its_baseline():
    findings = lint.lint_tree(ROOT / "src" / "repro_torch")
    baseline = lint.load_baseline(cli.DEFAULT_BASELINE)
    new, suppressed = lint.apply_baseline(findings, baseline)
    assert not new, [str(f) for f in new]
    # every baseline entry is a finding the port really has
    assert {f.fingerprint() for f in suppressed} == baseline
    assert cli.DEFAULT_BASELINE.parent == \
        ROOT / "src" / "repro_torch" / "analysis"


def test_lint_rules_match_reference_on_snippets():
    from repro.analysis.lint_determinism import lint_source as ref_source
    src = ("import numpy as np\nimport time as t\nfrom datetime import "
           "datetime\nimport random\n"
           "a = np.random.rand(3)\nb = np.random.default_rng()\n"
           "c = np.random.default_rng(0)\nd = t.perf_counter()\n"
           "e = datetime.now()\nf = random.random()\n"
           "g = [x for x in {1, 2}]\nh = sum({1.0, 2.0})\n"
           "for y in set([1]) | {2}:\n    pass\n"
           "i = t.time()  # pfdnn: allow(wall-clock)\n"
           "j = {x for x in {1, 2}}\n")
    got = lint.lint_source(src, "m.py")
    assert [dataclasses.asdict(f) for f in got] == \
        [dataclasses.asdict(f) for f in ref_source(src, "m.py")]
    assert {f.rule for f in got} == set(lint.RULES)


# -------------------------------------------------------------- CLI

def _run(main, argv) -> tuple[int, list[str]]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue().splitlines()


def test_cli_certify_lines_match_reference_on_schedule_files(tmp_path,
                                                              base_sched):
    good = tmp_path / "good.json"
    good.write_text(base_sched.to_json())
    bad = tmp_path / "bad.json"
    bad.write_text(dataclasses.replace(
        base_sched, e_op=base_sched.e_op * 2).to_json())
    for argv in ([str(good), "--n-max-rails", str(N_RAILS)],
                 [str(good), "--no-dual"],
                 [str(good), str(bad), "--network", NETWORK]):
        got = _run(cli.main, ["certify", *argv])
        assert got == _run(ref_cli.main, ["certify", *argv])
    rc, lines = _run(cli.main, ["certify", str(bad)])
    assert rc == 1 and "FAIL" in lines[0]


def test_cli_certify_goldens_matches_reference(monkeypatch):
    two = [c for c in cli._golden_cases()
           if f"{c[0]}|{c[1]}|{c[2]}|{c[3]}" in (
               "squeezenet1.1|0.9|2|pfdnn", "mobilenetv3-small|0.85|2|greedy")]
    assert len(two) == 2 and cli._golden_cases() == ref_cli._golden_cases()
    monkeypatch.setattr(cli, "_golden_cases", lambda: two)
    monkeypatch.setattr(ref_cli, "_golden_cases", lambda: two)
    got = _run(cli.main, ["certify", "--goldens", "--device", "cpu"])
    want = _run(ref_cli.main, ["certify", "--goldens"])
    assert got == want and got[0] == 0 and len(got[1]) == 2
    assert all(": PASS  dual-gap=" in line for line in got[1])
    for net in ("squeezenet1.1", "resnet18", "mobilevit-xxs"):
        assert cli._max_rate(net, ACC) == ref_cli._max_rate(net, REF_ACC)


def test_cli_certify_store_and_nothing_to_do(port_store, capsys):
    _, root = port_store
    assert _run(cli.main, ["certify", "--store", str(root)]) == \
        _run(ref_cli.main, ["certify", "--store", str(root)])
    rc, lines = _run(cli.main, ["certify", "--store", str(root)])
    assert rc == 0 and lines == ["store audit: 2 entries, OK"]
    assert cli.main(["certify"]) == 2
    assert "nothing to certify" in capsys.readouterr().err


def test_cli_lint_defaults_and_exit_codes(tmp_path, capsys):
    rc, lines = _run(cli.main, ["lint"])
    assert rc == 0 and lines[-1].startswith("lint: 0 finding(s), ")
    assert lines[-1].endswith(f"root={ROOT / 'src' / 'repro_torch'}")
    tree = tmp_path / "pkg"
    tree.mkdir()
    (tree / "ok.py").write_text("x = 1\n")
    (tree / "bad.py").write_text("import time\nx = time.time()\n")
    for argv in (["--root", str(tree)],
                 ["--root", str(ROOT / "src" / "repro")],
                 ["--root", str(ROOT / "src" / "repro"), "--baseline",
                  str(ROOT / "tests" / "determinism_baseline.json")]):
        assert _run(cli.main, ["lint", *argv]) == \
            _run(ref_cli.main, ["lint", *argv])
    assert cli.main(["lint", "--root", str(tree), "--write-baseline"]) == 2
    bl = tmp_path / "bl.json"
    assert cli.main(["lint", "--root", str(tree), "--baseline", str(bl),
                     "--write-baseline"]) == 0
    assert cli.main(["lint", "--root", str(tree),
                     "--baseline", str(bl)]) == 0
    capsys.readouterr()


def test_cli_lockcheck_lines_match_reference(tmp_path):
    from repro_torch.analysis import lockcheck

    clean = tmp_path / "clean.jsonl"
    clean.write_text(json.dumps({"pid": 1, "locks": ["a._lock", "b._lock"],
                                 "edges": {"a._lock -> b._lock": 3},
                                 "hazards": {}}) + "\n")
    bad = tmp_path / "bad.jsonl"
    bad.write_text(clean.read_text() + json.dumps(
        {"pid": 2, "locks": ["a._lock", "b._lock"],
         "edges": {"b._lock -> a._lock": 1},
         "hazards": {"compile_many": ["a._lock"]}}) + "\n")
    assert lockcheck.merge_dumps(str(clean))["edges"] == \
        {("a._lock", "b._lock"): 3}
    root = str(ROOT / "src" / "repro_torch")
    for dump, rc in ((clean, 0), (bad, 1)):
        argv = ["lockcheck", "--dump", str(dump), "--root", root]
        got = _run(cli.main, argv)
        assert got == _run(ref_cli.main, argv) and got[0] == rc
        assert got[1][-1] == ("lockcheck: OK" if rc == 0
                              else "lockcheck: FAIL")
    assert _run(cli.main, ["lockcheck"])[1][-1] == "lockcheck: OK"
