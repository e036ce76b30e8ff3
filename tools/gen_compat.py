#!/usr/bin/env python
"""Mechanically generate COMPAT_MATRIX.md from explicit autotest annotations.

Port of the reference's conformance harness
(/root/reference/compare-test.py:37-161 + test_macro/src/lib.rs:6-23): every
yagi_tpu test that ports a liquid autotest declares that identity with
``@autotest("name")`` (tests/autotest.py); this script collects the
emissions via the ``tools/autotest_dump.py`` pytest plugin and joins them
against the reference's LIQUID_COMPAT.md autotest list.

ONLY explicit annotations count as matches (a token matcher produces false
positives and negatives in both directions).
Annotated names that don't exist in the reference list are reported as
errors so annotations can't drift.

Usage:  python tools/gen_compat.py [--skip-run]
Output: COMPAT_MATRIX.md (committed artifact; regenerate after test changes).
"""

from __future__ import annotations

import argparse
import pathlib
import re
import subprocess
import sys
from collections import defaultdict

REPO = pathlib.Path(__file__).resolve().parent.parent
REF_COMPAT = pathlib.Path("/root/reference/LIQUID_COMPAT.md")


def parse_ref_compat(path: pathlib.Path):
    """→ {module: [(autotest, liquid_ok, yagi_ok)]} (compare-test.py:141-161
    wrote this file; we read it back)."""
    mod = None
    out = defaultdict(list)
    row = re.compile(r"^\|\s*(\w+)\s*\|\s*(✅|❌|❓)\s*\|\s*(✅|❌|❓)\s*\|")
    for line in path.read_text().splitlines():
        if line.startswith("## "):
            mod = line[3:].strip()
        elif mod and (m := row.match(line)):
            name = m.group(1)
            if name in ("Test",):
                continue
            out[mod].append((name, m.group(2) == "✅", m.group(3) == "✅"))
    return out


def collect_annotations():
    """→ ({autotest_name: [test ids]}, [all test ids]) via the dump plugin."""
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         "-p", "tools.autotest_dump", "tests/"],
        cwd=REPO, capture_output=True, text=True, timeout=900,
    )
    ann = defaultdict(list)
    all_ids = []
    pat = re.compile(r"^!! autotest: (\S+) -> (\S+) !!$")
    for line in r.stdout.splitlines():
        if m := pat.match(line):
            if m.group(2) not in ann[m.group(1)]:
                ann[m.group(1)].append(m.group(2))
        elif "::" in line and not line.startswith("!!"):
            all_ids.append(line.strip())
    if not all_ids:
        print(r.stdout[-2000:], file=sys.stderr)
        raise RuntimeError("pytest collection produced no test ids")
    return ann, all_ids


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-run", action="store_true",
                    help="don't run pytest; trust the committed CI state")
    args = ap.parse_args()

    ref = parse_ref_compat(REF_COMPAT)
    ann, all_ids = collect_annotations()

    ref_names = {name for tests in ref.values() for name, _, _ in tests}
    unknown = sorted(set(ann) - ref_names)
    if unknown:
        print("ERROR: annotations name unknown liquid autotests:",
              file=sys.stderr)
        for u in unknown:
            print(f"  {u}  ({ann[u][0]})", file=sys.stderr)
        return 2

    suite_green = None
    if not args.skip_run:
        r = subprocess.run(
            [sys.executable, "-m", "pytest", "tests/", "-q", "--tb=no"],
            cwd=REPO, capture_output=True, text=True, timeout=7200,
        )
        suite_green = r.returncode == 0
        tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
        print(f"pytest: {tail}", file=sys.stderr)

    annotated_ids = {tid for tids in ann.values() for tid in tids}
    lines = [
        "# COMPAT_MATRIX — conformance matrix from explicit annotations",
        "",
        "Generated by `tools/gen_compat.py`. Every match below is an EXPLICIT",
        "`@autotest(\"name\")` identity annotation on a yagi_tpu test",
        "(tests/autotest.py) — the reference declares the same identities via",
        "its `#[autotest_annotate(...)]` proc-macro (test_macro/src/lib.rs) and",
        "regenerates LIQUID_COMPAT.md from them (compare-test.py:141-161).",
        "No token guessing; regenerate after test changes; do not edit by hand.",
        "",
    ]
    if suite_green is not None:
        lines.append(f"Suite state at generation: "
                     f"{'ALL PASSING' if suite_green else 'FAILURES PRESENT'}.")
        lines.append("")

    total = covered = ref_ok = 0
    mod_rows = []
    detail = []
    for mod in sorted(ref):
        tests = ref[mod]
        mod_total = len(tests)
        mod_cov = 0
        rows = []
        for name, liq_ok, yagi_ok in tests:
            match = ann.get(name, [])
            if match:
                mod_cov += 1
            rows.append((name, yagi_ok, match))
        total += mod_total
        covered += mod_cov
        ref_ok += sum(1 for _, _, y in tests if y)
        mod_rows.append((mod, mod_total, mod_cov))
        detail.append((mod, rows))

    lines += [
        f"**Totals:** {total} liquid autotests · reference port passes "
        f"{ref_ok} ({ref_ok/total:.0%}) · yagi_tpu has an ANNOTATED "
        f"counterpart for {covered} ({covered/total:.0%}).",
        "",
        f"The suite holds {len(all_ids)} tests, {len(annotated_ids)} carrying "
        "annotations; the rest are yagi_tpu-specific (kernels, sharding, "
        "block-split invariance, golden vectors) with no liquid counterpart.",
        "",
        "## Per-module summary",
        "",
        "| Reference module | autotests | annotated here |",
        "|---|---|---|",
    ]
    for mod, t, c in mod_rows:
        lines.append(f"| {mod} | {t} | {c} |")

    lines += ["", "## Per-test matrix", ""]
    for mod, rows in detail:
        lines.append(f"### {mod}")
        lines.append("")
        lines.append("| liquid autotest | ref port | annotated yagi_tpu test |")
        lines.append("|---|---|---|")
        for name, yagi_ok, match in rows:
            m = "<br>".join(match) if match else "—"
            lines.append(f"| {name} | {'✅' if yagi_ok else '❓'} | {m} |")
        lines.append("")

    (REPO / "COMPAT_MATRIX.md").write_text("\n".join(lines) + "\n")
    print(f"COMPAT_MATRIX.md: {total} autotests, {covered} annotated "
          f"({covered/total:.0%})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
