"""graftlint CLI: ``python -m brpc_tpu_torch.analysis [paths...]``.

Exit code = the UNWAIVED finding count (capped at 100) so CI can gate
on zero and scripts can read severity without parsing; usage/internal
errors exit 120. Machine consumers pick ``--format=json`` or
``--format=sarif`` (SARIF 2.1.0 — editors and code-scanning UIs);
``--changed [BASE]`` lints only files touched vs a git base ref
(default HEAD) while still analyzing the whole tree for cross-module
context; ``--show-waivers`` audits every waiver in force (file:line,
rules, reason, and whether it suppressed anything this run).
``--baseline FILE`` suppresses the findings recorded by a previous
``--write-baseline FILE`` (keyed path+rule+message, line-drift-proof)
so CI fails only on NEW findings; ``--field-guards`` prints the
guarded-by rule's inferred field->guard registry — the table
analysis/INVARIANTS.md publishes. The JSON report also counts the files
read (``files``) and the native walker cases judge-defer checked
(``walker_cases``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional, Set

from brpc_tpu_torch.analysis.core import Analyzer, iter_source_files

EXIT_CAP = 100         # finding-count exit codes stay below...
EXIT_USAGE = 120       # ...the usage/internal-error code


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graftlint",
        description="framework-invariant static analysis for brpc_tpu_torch")
    p.add_argument("paths", nargs="*", default=["brpc_tpu_torch"],
                   help="files or directories to analyze "
                        "(default: brpc_tpu_torch)")
    p.add_argument("--rules", metavar="R1,R2",
                   help="run only these rules (comma-separated names)")
    p.add_argument("--list-rules", action="store_true",
                   help="list available rules and exit")
    p.add_argument("--format", choices=("text", "json", "sarif"),
                   default="text", dest="fmt",
                   help="output format (default text)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="alias for --format=json")
    p.add_argument("--changed", nargs="?", const="HEAD", default=None,
                   metavar="BASE",
                   help="report only findings in files changed vs the "
                        "git base ref (default HEAD); the whole tree "
                        "is still analyzed for cross-module context")
    p.add_argument("--show-waived", action="store_true",
                   help="also print waived findings (with reasons)")
    p.add_argument("--show-waivers", action="store_true",
                   help="list every waiver in force (file:line, rules, "
                        "reason, used/unused this run) and exit 0")
    p.add_argument("--field-guards", action="store_true",
                   help="print the inferred field->guard registry "
                        "(the analysis/INVARIANTS.md table) and exit 0")
    p.add_argument("--baseline", metavar="FILE", default=None,
                   help="suppress findings recorded in FILE (written "
                        "by --write-baseline): CI diffs against the "
                        "committed baseline instead of failing on "
                        "known rows")
    p.add_argument("--write-baseline", metavar="FILE", default=None,
                   help="write the current active findings to FILE "
                        "and exit 0")
    return p


def _baseline_key(f) -> tuple:
    """Baseline identity deliberately drops the line number: unrelated
    edits shift lines, and a baseline that churns on every edit gets
    regenerated blindly instead of reviewed."""
    return (f.path, f.rule, f.message)


def load_baseline(path: str) -> Optional[Set[tuple]]:
    try:
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return None
    keys: Set[tuple] = set()
    for row in data.get("findings", ()):
        keys.add((row.get("path", ""), row.get("rule", ""),
                  row.get("message", "")))
    return keys


def changed_files(base: str, repo_root: str) -> Optional[Set[str]]:
    """Absolute paths of .py/.cc files changed vs base (tracked diff +
    untracked); None when git is unavailable."""
    out: Set[str] = set()
    try:
        diff = subprocess.run(
            ["git", "diff", "--name-only", base, "--"],
            cwd=repo_root, capture_output=True, text=True, timeout=60)
        if diff.returncode != 0:
            return None
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            cwd=repo_root, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    names = diff.stdout.splitlines()
    if untracked.returncode == 0:
        names += untracked.stdout.splitlines()
    for n in names:
        if n.endswith((".py", ".cc")):
            out.add(os.path.abspath(os.path.join(repo_root, n)))
    return out


def _git_root() -> str:
    try:
        proc = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"],
            capture_output=True, text=True, timeout=30)
        if proc.returncode == 0 and proc.stdout.strip():
            return proc.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return os.getcwd()


def to_sarif(active, waived, rules) -> dict:
    """Minimal valid SARIF 2.1.0: one run, one result per ACTIVE
    finding (waived findings ride along as suppressed results)."""
    rule_meta = [{"id": r.name,
                  "shortDescription": {"text": r.description or r.name}}
                 for r in rules]

    def result(f, suppressed: bool) -> dict:
        out = {
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {"startLine": max(1, f.line)},
                },
            }],
        }
        if suppressed:
            out["suppressions"] = [{
                "kind": "inSource",
                "justification": f.reason or "",
            }]
        return out

    return {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "graftlint",
                "informationUri": "brpc_tpu_torch/analysis/INVARIANTS.md",
                "rules": rule_meta,
            }},
            "results": ([result(f, False) for f in active]
                        + [result(f, True) for f in waived]),
        }],
    }


def collect_waivers(paths: List[str], waived_findings) -> List[dict]:
    """Every waiver comment in force across the scanned files: location,
    rules, reason, and whether it suppressed a finding this run."""
    used_lines = {(f.path, f.line) for f in waived_findings}

    def filewide_used(sf, rule: str) -> bool:
        # a file-wide waiver only did the suppressing when no LINE
        # waiver covered the finding (waiver_reason matches the line
        # slot first) — keyed any looser, a stale disable-file hides
        # behind its line-level siblings and escapes the UNUSED audit
        for f in waived_findings:
            if f.path != sf.relpath:
                continue
            if rule != "all" and f.rule != rule:
                continue
            dis = sf.waivers.get(f.line, ())
            if f.rule not in dis and "all" not in dis:
                return True
        return False

    merged: dict = {}
    for sf in iter_source_files(paths):
        if "/analysis/" in sf.relpath:
            continue       # the linter's own docs show waiver EXAMPLES
        for slot, names in sorted(sf.waivers.items()):
            for name in sorted(names):
                reason = sf.reasons.get((slot, name), "")
                # a comment-above waiver occupies TWO slots (the
                # comment line and the covered code line): merge them
                # into one audit row, marked used if either fired
                key = (sf.relpath, name, reason)
                used = ((sf.relpath, slot) in used_lines if slot
                        else filewide_used(sf, name))
                row = merged.get(key)
                if row is None:
                    merged[key] = {
                        "path": sf.relpath,
                        "line": slot or 0,      # 0 = file-wide
                        "rule": name,
                        "reason": reason,
                        "file_wide": slot == 0,
                        "used": used,
                    }
                else:
                    row["used"] = row["used"] or used
                    if slot and (row["line"] == 0 or slot < row["line"]):
                        row["line"] = slot
    return sorted(merged.values(),
                  key=lambda w: (w["path"], w["line"], w["rule"]))


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    fmt = "json" if args.as_json else args.fmt
    from brpc_tpu_torch.analysis.rules import default_rules
    rules = default_rules()
    if args.list_rules:
        for r in rules:
            print(f"{r.name:24} {r.description}")
        return 0
    if args.rules:
        wanted = {n.strip() for n in args.rules.split(",") if n.strip()}
        unknown = wanted - {r.name for r in rules}
        if unknown:
            print(f"graftlint: unknown rules: {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return EXIT_USAGE
        rules = [r for r in rules if r.name in wanted]
    paths = args.paths or ["brpc_tpu_torch"]

    if args.field_guards:
        from brpc_tpu_torch.analysis.core import Context
        from brpc_tpu_torch.analysis.rules.guarded_by import (
            field_guard_table, render_field_guards,
        )
        ctx = Context(iter_source_files(paths))
        if fmt == "json":
            print(json.dumps({"field_guards": field_guard_table(ctx)}))
        else:
            print(render_field_guards(ctx))
        return 0

    analyzer = Analyzer(rules=rules)
    active, waived = analyzer.run(paths)

    if args.write_baseline:
        with open(args.write_baseline, "w", encoding="utf-8") as fh:
            json.dump({"findings": [f.to_dict() for f in active]},
                      fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"graftlint: baseline with {len(active)} finding(s) "
              f"written to {args.write_baseline}", file=sys.stderr)
        return 0
    if args.baseline:
        known = load_baseline(args.baseline)
        if known is None:
            print(f"graftlint: cannot read baseline {args.baseline}",
                  file=sys.stderr)
            return EXIT_USAGE
        active = [f for f in active if _baseline_key(f) not in known]

    if args.show_waivers:
        waivers = collect_waivers(paths, waived)
        if fmt == "json":
            print(json.dumps({"waivers": waivers}))
        else:
            for w in waivers:
                where = (f"{w['path']}:{'file-wide' if w['file_wide'] else w['line']}")
                mark = "" if w["used"] else " (UNUSED — stale?)"
                print(f"{where}: disable={w['rule']}{mark}"
                      f" -- {w['reason'] or '<no reason>'}")
            print(f"graftlint: {len(waivers)} waiver(s) in force",
                  file=sys.stderr)
        return 0

    if args.changed is not None:
        repo_root = _git_root()
        changed = changed_files(args.changed, repo_root)
        if changed is None:
            print("graftlint: --changed needs a git checkout",
                  file=sys.stderr)
            return EXIT_USAGE
        active = [f for f in active
                  if os.path.abspath(os.path.join(repo_root, f.path))
                  in changed]
        waived = [f for f in waived
                  if os.path.abspath(os.path.join(repo_root, f.path))
                  in changed]

    exit_code = min(len(active), EXIT_CAP)
    if fmt == "json":
        walkers = [r.examined_cases() for r in rules
                   if r.name == "judge-defer"]
        print(json.dumps({
            "active": [f.to_dict() for f in active],
            "waived": [f.to_dict() for f in waived],
            "rules": [r.name for r in rules],
            "files": analyzer.file_count,
            # the native meta walkers' cases judge-defer checked against
            # the field table (null when the rule did not run)
            "walker_cases": walkers[0] if walkers else None,
        }, indent=None))
        return exit_code
    if fmt == "sarif":
        print(json.dumps(to_sarif(active, waived, rules)))
        return exit_code
    for f in active:
        print(f.format())
    if args.show_waived:
        for f in waived:
            print(f.format() + (f" [reason: {f.reason}]"
                                if f.reason else ""))
    n_w = len(waived)
    if active:
        print(f"graftlint: {len(active)} finding(s)"
              f" ({n_w} waived)", file=sys.stderr)
    else:
        print(f"graftlint: clean ({n_w} waived)", file=sys.stderr)
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
