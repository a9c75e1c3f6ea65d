"""Report serializers: text (human), json (tooling), sarif (CI upload)."""
from __future__ import annotations

import json
from typing import List

from repro_torch.analysis.engine import Report
from repro_torch.analysis.registry import RULES

TOOL = "repro_torch.analysis"

_SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                 "master/Schemata/sarif-schema-2.1.0.json")


def summary_line(report: Report) -> str:
  n = len(report.findings)
  parts = [f"{n} finding{'s' if n != 1 else ''}",
           f"{len(report.new)} new",
           f"{len(report.baselined)} baselined",
           f"{report.inline_suppressed} inline-suppressed"]
  if report.stale_baseline:
    parts.append(f"{len(report.stale_baseline)} stale baseline entries")
  return f"{TOOL}: " + ", ".join(parts)


def to_text(report: Report) -> str:
  out: List[str] = []
  for f in report.findings:
    tag = " [baseline]" if f.baselined else ""
    out.append(f"{f.location()} {f.rule}{tag} {f.message}")
  for e in report.stale_baseline:
    out.append(f"{e['path']}:{e['line']}: stale baseline entry "
               f"{e['rule']} ({e['fingerprint']}) matches nothing — "
               "remove it from the baseline file")
  out.append(summary_line(report))
  return "\n".join(out) + "\n"


def to_json(report: Report) -> str:
  return json.dumps({
      "findings": [{
          "rule": f.rule, "path": f.path, "line": f.line, "col": f.col,
          "message": f.message, "fingerprint": f.fingerprint,
          "baselined": f.baselined,
      } for f in report.findings],
      "stale_baseline": report.stale_baseline,
      "counts": {
          "total": len(report.findings),
          "new": len(report.new),
          "baselined": len(report.baselined),
          "inline_suppressed": report.inline_suppressed,
      },
      "ok": report.ok,
  }, indent=2) + "\n"


def to_sarif(report: Report) -> str:
  rules = [{
      "id": rid,
      "shortDescription": {"text": rule.summary},
      "help": {"text": rule.instead},
      "properties": {"pack": rule.pack},
  } for rid, rule in sorted(RULES.items())]
  results = []
  for f in report.findings:
    res = {
        "ruleId": f.rule,
        "level": "error",
        "message": {"text": f.message},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": f.path},
                "region": {"startLine": f.line,
                           "startColumn": f.col + 1},
            },
        }],
        "fingerprints": {"reproAnalysis/v1": f.fingerprint},
    }
    if f.baselined:
      res["suppressions"] = [{"kind": "external",
                              "justification": "checked-in baseline"}]
    results.append(res)
  doc = {
      "$schema": _SARIF_SCHEMA,
      "version": "2.1.0",
      "runs": [{
          "tool": {"driver": {
              "name": TOOL,
              "informationUri": "README.md",
              "rules": rules,
          }},
          "results": results,
      }],
  }
  return json.dumps(doc, indent=2) + "\n"


FORMATTERS = {"text": to_text, "json": to_json, "sarif": to_sarif}
