"""CLI: ``python -m repro_torch.analysis [paths...] [options]``.

With no paths it scans ``src/repro_torch`` and, when present,
``chip_smoke.py`` (run from the repository root), against the baseline
checked in beside this file.

Exit codes: 0 = clean (modulo baseline), 1 = new findings (or stale
baseline entries under --strict-baseline), 2 = usage/IO error.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis.engine import Baseline, scan_paths
from repro_torch.analysis.formats import FORMATTERS, summary_line
from repro_torch.analysis.registry import iter_rules

DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"
SMOKE_SCRIPT = "chip_smoke.py"


def _build_parser() -> argparse.ArgumentParser:
  p = argparse.ArgumentParser(
      prog="python -m repro_torch.analysis",
      description="Exactness lint of the PyTorch port "
                  "(rule catalog: README.md, or --list-rules)")
  p.add_argument("paths", nargs="*", default=None,
                 help="files/directories to scan (default: src/repro_torch "
                      f"and {SMOKE_SCRIPT}, falling back to the package "
                      "directory)")
  p.add_argument("--format", choices=sorted(FORMATTERS),
                 default="text", help="report format (default: text)")
  p.add_argument("--output", metavar="FILE",
                 help="write the report to FILE instead of stdout "
                      "(a text summary still goes to stderr)")
  p.add_argument("--baseline", metavar="FILE",
                 help="baseline JSON (default: the package's "
                      "baseline.json; 'none' disables)")
  p.add_argument("--write-baseline", action="store_true",
                 help="write all current findings to the baseline file "
                      "and exit 0 (then edit in the justifications)")
  p.add_argument("--strict-baseline", action="store_true",
                 help="also fail when the baseline has stale entries")
  p.add_argument("--tests-dir", metavar="DIR",
                 help="tests directory for the contract rules "
                      "(default: auto-detect; 'none' disables)")
  p.add_argument("--rules", metavar="IDS",
                 help="comma-separated rule ids to run (default: all)")
  p.add_argument("--list-rules", action="store_true",
                 help="print the rule catalog and exit")
  return p


def _default_paths() -> list:
  if Path("src/repro_torch").is_dir():
    smoke = Path(SMOKE_SCRIPT)
    return [Path("src/repro_torch")] + ([smoke] if smoke.is_file() else [])
  return [Path(__file__).resolve().parents[1]]  # the repro_torch package


def main(argv=None) -> int:
  args = _build_parser().parse_args(argv)

  if args.list_rules:
    for rule in iter_rules():
      print(f"{rule.id}  [{rule.pack}]  {rule.summary}\n"
            f"        instead: {rule.instead}")
    return 0

  paths = [Path(p) for p in args.paths] if args.paths else _default_paths()
  for p in paths:
    if not p.exists():
      print(f"error: no such path: {p}", file=sys.stderr)
      return 2

  baseline_path = None
  if args.baseline != "none":
    baseline_path = Path(args.baseline) if args.baseline \
        else (DEFAULT_BASELINE if DEFAULT_BASELINE.is_file() else None)
  baseline = None
  if baseline_path is not None and baseline_path.is_file():
    try:
      baseline = Baseline.load(baseline_path)
    except (ValueError, OSError) as e:
      print(f"error: cannot load baseline {baseline_path}: {e}",
            file=sys.stderr)
      return 2

  tests_dir = None
  if args.tests_dir == "none":
    tests_dir = Path("/nonexistent")
  elif args.tests_dir:
    tests_dir = Path(args.tests_dir)

  rules = [r.strip() for r in args.rules.split(",")] if args.rules else None
  try:
    report = scan_paths(paths, tests_dir=tests_dir, baseline=baseline,
                        rules=rules)
  except KeyError as e:
    print(f"error: unknown rule id {e}", file=sys.stderr)
    return 2

  if args.write_baseline:
    out = baseline_path or DEFAULT_BASELINE
    Baseline.from_findings(report.findings).save(out)
    print(f"wrote {len(report.findings)} entries to {out} — edit in the "
          "justifications; the goal is an empty baseline", file=sys.stderr)
    return 0

  rendered = FORMATTERS[args.format](report)
  if args.output:
    Path(args.output).write_text(rendered)
    print(summary_line(report), file=sys.stderr)
  else:
    sys.stdout.write(rendered)
    if args.format != "text":
      print(summary_line(report), file=sys.stderr)

  if report.new:
    return 1
  if args.strict_baseline and report.stale_baseline:
    return 1
  return 0


if __name__ == "__main__":
  sys.exit(main())
