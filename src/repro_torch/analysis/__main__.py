"""``python -m repro_torch.analysis`` — the verification CLI of the port.

Subcommands:

  certify    re-derive and certify compiled schedules
             ``--goldens`` recompiles every golden pipeline case
             through ``repro_torch.core`` on ``--device`` (``cuda`` by
             default, where the DP, k-best and gather kernels run;
             ``cpu`` runs their plain versions) and certifies the
             emitted artifacts; ``--store <root>`` audits an artifact
             store for key↔content consistency; positional args are
             schedule JSON files.
  lint       determinism lint over the port's source tree (see
             ``repro_torch.analysis.lint_determinism``), with
             ``--baseline`` / ``--write-baseline``; over its default
             root it reads the port's own baseline,
             ``repro_torch/analysis/determinism_baseline.json``.
  lockcheck  merge per-process lock-acquisition dumps
             (``PFDNN_LOCKCHECK=1 PFDNN_LOCKCHECK_DUMP=<p>``), detect
             cycles/barrier hazards, and cross-check the static
             ``with``-nesting scan against the recorded graph.

The printed lines are the JAX package's ``python -m repro.analysis``
lines.  Exit status is nonzero when any check fails.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

_REPO_SRC = pathlib.Path(__file__).resolve().parents[2]
_PORT_ROOT = _REPO_SRC / "repro_torch"
#: the port's committed lint baseline, read when linting its own tree
DEFAULT_BASELINE = pathlib.Path(__file__).resolve().with_name(
    "determinism_baseline.json")


def _golden_cases() -> list[tuple[str, float, int, str]]:
    """(network, rate_frac, n_rails, policy) for every golden case,
    parsed from the committed golden file so the CLI and the test
    suite can never disagree about coverage."""
    golden_path = (_REPO_SRC.parent / "tests" / "golden"
                   / "pipeline.json")
    cases = []
    for key in sorted(json.loads(golden_path.read_text())):
        network, frac, n_rails, policy = key.split("|")
        cases.append((network, float(frac), int(n_rails), policy))
    return cases


def _max_rate(network: str, acc) -> float:
    """1 / latency with every domain at V_max (the test suite's
    operating-point anchor, re-derived here from the hardware spec)."""
    from repro_torch.models.edge_cnn import edge_network
    from repro_torch.perfmodel import characterize_network

    costs = characterize_network(edge_network(network), acc)
    fs = [acc.dvfs(d).freq(acc.v_max) for d in range(3)]
    t = sum(max(cy / f for cy, f in zip(c.cycles, fs)) for c in costs)
    return 1.0 / t


def cmd_certify(args: argparse.Namespace) -> int:
    from repro_torch.analysis.certify import certify, certify_store
    from repro_torch.hw.edge40nm import EDGE40NM_DEFAULT as acc

    failures = 0

    if args.store:
        audit = certify_store(args.store)
        print(f"store audit: {audit['entries']} entries, "
              f"{'OK' if audit['ok'] else 'PROBLEMS'}")
        for p in audit["problems"]:
            print(f"  - {p['where']}: {p['detail']}")
        failures += 0 if audit["ok"] else 1

    if args.goldens:
        from repro_torch.core import (
            OrchestratorConfig,
            compile_power_schedule,
        )
        from repro_torch.models.edge_cnn import edge_network

        for network, frac, n_rails, policy in _golden_cases():
            specs = edge_network(network)
            rate = _max_rate(network, acc) * frac
            sched = compile_power_schedule(
                specs, rate,
                cfg=OrchestratorConfig(policy=policy,
                                       n_max_rails=n_rails,
                                       device=args.device),
                network=network)
            if sched is None:
                print(f"{network}|{frac}|{n_rails}|{policy}: infeasible "
                      f"(not certified)")
                continue
            cert = certify(sched, specs, acc=acc, n_max_rails=n_rails,
                           dual=not args.no_dual)
            tag = f"{network}|{frac}|{n_rails}|{policy}"
            gap = ("" if cert.dual is None
                   else f"  dual-gap={cert.dual.gap_rel * 100:.4f}%")
            print(f"{tag}: {'PASS' if cert.ok else 'FAIL'}{gap}")
            if not cert.ok:
                failures += 1
                for v in cert.violations:
                    print(f"  - {v}")

    for path in args.files:
        from repro_torch.core.schedule import PowerSchedule
        from repro_torch.models.edge_cnn import edge_network

        sched = PowerSchedule.from_json(
            pathlib.Path(path).read_text())
        network = args.network or sched.network
        cert = certify(sched, edge_network(network), acc=acc,
                       n_max_rails=args.n_max_rails,
                       dual=not args.no_dual)
        print(cert.summary())
        failures += 0 if cert.ok else 1

    if not (args.store or args.goldens or args.files):
        print("nothing to certify: pass --goldens, --store, or "
              "schedule JSON files", file=sys.stderr)
        return 2
    return 1 if failures else 0


def cmd_lint(args: argparse.Namespace) -> int:
    from repro_torch.analysis import lint_determinism as lint

    findings = lint.lint_tree(args.root)
    if args.write_baseline and not args.baseline:
        print("--write-baseline requires --baseline <path>",
              file=sys.stderr)
        return 2
    if args.write_baseline:
        lint.save_baseline(args.baseline, findings)
        print(f"wrote {len(findings)} baseline entries to "
              f"{args.baseline}")
        return 0
    baseline_path = args.baseline
    if baseline_path is None and \
            pathlib.Path(args.root).resolve() == _PORT_ROOT:
        baseline_path = DEFAULT_BASELINE
    baseline = lint.load_baseline(baseline_path) if baseline_path \
        else set()
    new, suppressed = lint.apply_baseline(findings, baseline)
    for f in new:
        print(f)
    print(f"lint: {len(new)} finding(s), {len(suppressed)} "
          f"baseline-suppressed, root={args.root}")
    return 1 if new else 0


def cmd_lockcheck(args: argparse.Namespace) -> int:
    from repro_torch.analysis import lockcheck

    edges: dict = {}
    hazards: list = []
    if args.dump:
        merged = lockcheck.merge_dumps(args.dump)
        edges = merged["edges"]
        hazards = merged["hazards"]
        print(f"runtime graph: {len(merged['locks'])} locks, "
              f"{len(edges)} edges, {len(hazards)} barrier hazard(s)")
        for (a, b), n in sorted(edges.items()):
            print(f"  {a} -> {b}  (x{n})")
    cycles = lockcheck.find_cycles(list(edges))
    rc = 0
    if cycles:
        print(f"LOCK-ORDER CYCLES: {cycles}")
        rc = 1
    if hazards:
        for h in hazards:
            print(f"BARRIER HAZARD: {h['barrier']} crossed holding "
                  f"{h['held']}")
        rc = 1

    static = lockcheck.static_lock_nesting(args.root)
    xc = lockcheck.cross_check(static, list(edges))
    print(f"static scan: {len(xc['static_pairs'])} nested "
          f"with-lock pair(s)")
    for a, b in xc["static_pairs"]:
        print(f"  {a} -> {b}")
    for u in xc["uncovered"]:
        print(f"  uncovered at runtime: {u['outer']} -> {u['inner']} "
              f"({u['path']}:{u['line']})")
    if xc["static_cycles"]:
        print(f"STATIC LOCK-ORDER CYCLES: {xc['static_cycles']}")
        rc = 1
    print("lockcheck:", "OK" if rc == 0 else "FAIL")
    return rc


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("certify", help="certify compiled schedules")
    p.add_argument("files", nargs="*", help="schedule JSON files")
    p.add_argument("--goldens", action="store_true",
                   help="recompile + certify every golden case")
    p.add_argument("--device", default="cuda",
                   help="torch device of the --goldens recompiles (cuda, "
                        "or cpu for the kernels' plain versions)")
    p.add_argument("--store", default=None,
                   help="audit an artifact-store root")
    p.add_argument("--network", default=None,
                   help="network name override for schedule files")
    p.add_argument("--n-max-rails", type=int, default=None)
    p.add_argument("--no-dual", action="store_true",
                   help="skip the λ-envelope dual bound")
    p.set_defaults(fn=cmd_certify)

    p = sub.add_parser("lint", help="determinism lint")
    p.add_argument("--root", default=str(_PORT_ROOT))
    p.add_argument("--baseline", default=None,
                   help="baseline file (default over the default root: "
                        "the port's determinism_baseline.json)")
    p.add_argument("--write-baseline", action="store_true")
    p.set_defaults(fn=cmd_lint)

    p = sub.add_parser("lockcheck", help="lock-order analysis")
    p.add_argument("--dump", default=None,
                   help="merged PFDNN_LOCKCHECK_DUMP file")
    p.add_argument("--root", default=str(_PORT_ROOT))
    p.set_defaults(fn=cmd_lockcheck)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
