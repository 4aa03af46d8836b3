"""incident_replay: one-command deterministic local reproduction of a
frozen incident (the port of tools/incident_replay.py).

    python3 -m brpc_tpu_torch.tools.incident_replay \
        incident-3-1234-1700000000.brpcinc
    python3 -m brpc_tpu_torch.tools.incident_replay ART.brpcinc \
        --no-plan --expect quiet
    python3 -m brpc_tpu_torch.tools.incident_replay ART.brpcinc --json

Reads a ``.brpcinc`` artifact, derives the pressure the incident's
error classes imply (timeouts -> seeded chaos delay/stall faults,
connect errors -> refuse/flap, overload sheds -> open-loop press at a
multiple of estimated capacity), replays the captured corpus against a
fresh loopback server shaped from the artifact's /status snapshot, and
reports whether the anomaly watchdog re-fired on the incident's
trigger key.

``--expect refire`` (the default with a plan) exits 0 only if the
watchdog re-fired on a trigger key; ``--expect quiet`` (the default
with --no-plan: the fix-forward run) exits 0 only if it stayed green.
One JSON line on stdout with --json; a human summary otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="replay a .brpcinc incident artifact locally")
    ap.add_argument("artifact", help=".brpcinc incident artifact")
    ap.add_argument("--no-plan", action="store_true",
                    help="fix-forward run: replay WITHOUT the derived "
                         "fault plan / press pacing")
    ap.add_argument("--expect", choices=("refire", "quiet"),
                    default=None,
                    help="exit 0 only if the watchdog re-fired "
                         "(refire) or stayed green (quiet); default "
                         "refire with a plan, quiet with --no-plan")
    ap.add_argument("--seed", type=int, default=7,
                    help="chaos/pacing seed (default 7)")
    ap.add_argument("--conns", type=int, default=4,
                    help="replay connections (default 4)")
    ap.add_argument("--press-factor", type=float, default=4.0,
                    help="press offered load as a multiple of "
                         "estimated capacity (default 4.0)")
    ap.add_argument("--json", action="store_true",
                    help="one JSON report line instead of the summary")
    args = ap.parse_args(argv)

    if not os.path.exists(args.artifact):
        print(f"no such artifact: {args.artifact}", file=sys.stderr)
        return 2

    from brpc_tpu_torch.incident.replay import replay_incident
    report = replay_incident(
        args.artifact, use_plan=not args.no_plan, seed=args.seed,
        conns=args.conns, press_factor=args.press_factor)

    expect = args.expect or ("quiet" if args.no_plan else "refire")
    want_refire = expect == "refire"
    report["expect"] = expect
    passed = bool(report.get("ok")) and \
        bool(report.get("refired")) == want_refire
    report["passed"] = passed

    if args.json:
        print(json.dumps(report, sort_keys=True, default=str))
    else:
        rep = report.get("replay") or {}
        print(f"artifact   {args.artifact}")
        print(f"incident   #{report.get('incident_id')} "
              f"keys={report.get('trigger_keys')}")
        print(f"derived    {report.get('derived')}")
        print(f"replay     issued={rep.get('issued')} "
              f"ok={rep.get('ok')} fail={rep.get('fail')} "
              f"elapsed={rep.get('elapsed_s')}s "
              f"plan_fired={report.get('plan_fired', 0)}")
        if report.get("error"):
            print(f"error      {report['error']}")
        verdict = "RE-FIRED on " + str(report.get("matched_key")) \
            if report.get("refired") else "stayed quiet"
        print(f"watchdog   {verdict} (expected: {expect}) -> "
              f"{'PASS' if passed else 'FAIL'}")
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
