r"""`python -m jaxmc_torch.analyze` — the static-analysis CLI.

    python -m jaxmc_torch.analyze lint SPEC.tla [CFG.cfg] [-I DIR]...
        lint one spec/cfg pair; exit 2 on error diagnostics, 1 on
        warnings (use --errors-only to gate on errors alone), 0 clean.

    python -m jaxmc_torch.analyze lint-corpus
        lint every corpus manifest pair (jaxmc_torch/corpus.py).  Repo-local
        pairs must be clean modulo per-case waivers (Case.lint_waive);
        lint-only fixtures (Case.lint_expect) must produce exactly
        their expected diagnostic classes.  Reference-rooted pairs emit
        a parseable SKIP line when the reference corpus is not mounted.
        Exit 1 on any violation.

    python -m jaxmc_torch.analyze pylint [PATH]...
        the builtin Python checker (analyze/pylint.py) over jaxmc_torch's own
        sources (ruff, where the host has it, covers the same rules).
"""

from __future__ import annotations

import argparse
import os
import sys


def cmd_lint(args) -> int:
    from .lint import lint_pair
    diags = lint_pair(args.spec, args.cfg, tuple(args.include))
    worst = 0
    for d in diags:
        print(d.render())
        worst = max(worst, {"info": 0, "warning": 1, "error": 2}
                    [d.severity])
    if not diags:
        print(f"{os.path.basename(args.spec)}: clean")
    if worst == 2:
        return 2
    if worst == 1 and not args.errors_only:
        return 1
    return 0


def cmd_lint_corpus(args) -> int:
    from ..corpus import CASES, reference_missing
    from .lint import lint_pair

    missing = reference_missing()
    failures = 0
    checked = 0
    skipped = 0
    seen = set()
    for case in CASES:
        needs_ref = case.root == "ref" or any(
            not inc.startswith("repo:") for inc in case.includes)
        name = case.cfg or case.spec
        if needs_ref and missing:
            skipped += 1
            print(f"[SKIP] {name}: {missing}")
            continue
        key = (case.spec_path(), case.cfg_path(), case.lint_waive,
               case.lint_expect)
        if key in seen:
            continue
        seen.add(key)
        checked += 1
        diags = lint_pair(case.spec_path(), case.cfg_path(),
                          tuple(case.include_dirs()))
        codes = sorted({d.code for d in diags})
        if case.lint_expect:
            missing = [c for c in case.lint_expect if c not in codes]
            if missing:
                failures += 1
                print(f"[FAIL] {name}: lint-only case missing expected "
                      f"diagnostics {missing} (got {codes})")
            else:
                print(f"[ok  ] {name}: lint-only case produced "
                      f"{codes}")
            continue
        unwaived = [d for d in diags if d.code not in case.lint_waive]
        if unwaived:
            failures += 1
            print(f"[FAIL] {name}: {len(unwaived)} unwaived "
                  f"diagnostic{'s' if len(unwaived) != 1 else ''}:")
            for d in unwaived:
                print(f"         {d.render()}")
        else:
            note = f" ({len(diags)} waived)" if diags else ""
            print(f"[ok  ] {name}: clean{note}")
    print(f"lint-corpus: {checked} pairs checked, {skipped} skipped, "
          f"{failures} failure{'s' if failures != 1 else ''}")
    return 1 if failures else 0


def cmd_pylint(args) -> int:
    from .pylint import main as pylint_main
    return pylint_main(args.paths)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="jaxmc_torch.analyze")
    sub = ap.add_subparsers(dest="cmd", required=True)

    li = sub.add_parser("lint", help="lint one spec/cfg pair")
    li.add_argument("spec")
    li.add_argument("cfg", nargs="?", default=None)
    li.add_argument("-I", "--include", action="append", default=[])
    li.add_argument("--errors-only", action="store_true",
                    help="exit nonzero only on error diagnostics "
                         "(warnings/infos still print)")
    li.set_defaults(fn=cmd_lint)

    lc = sub.add_parser("lint-corpus",
                        help="lint every corpus manifest pair against "
                             "its waivers/expectations")
    lc.set_defaults(fn=cmd_lint_corpus)

    py = sub.add_parser("pylint",
                        help="builtin Python unused-import/-local "
                             "checker (ruff fallback)")
    py.add_argument("paths", nargs="*", default=[])
    py.set_defaults(fn=cmd_pylint)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
