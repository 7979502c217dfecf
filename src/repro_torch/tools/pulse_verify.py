"""pulse-verify CLI: static verification + annotated disassembly for PULSE
ISA traversal programs, over the port's ``core.verify`` and
``structures.isa_programs``.

The same admission pass the serving layer runs (``core.verify``), as a
standalone tool -- point it at the shipped structure programs (or extend
``--all`` with your own registry) and it prints a per-program verdict with
instruction-level diagnostics, or the fully annotated disassembly.

Usage:

    PYTHONPATH=src python -m repro_torch.tools.pulse_verify --all
        verify every shipped ``isa_programs`` entry; exit 1 on any rejection

    PYTHONPATH=src python -m repro_torch.tools.pulse_verify list_find bst_update
        verify the named shipped programs

    PYTHONPATH=src python -m repro_torch.tools.pulse_verify --all --disasm
        print annotated disassembly (the golden-file format) instead of the
        one-line verdicts

    PYTHONPATH=src python -m repro_torch.tools.pulse_verify --all --golden tests/golden/pulse_verify
        check each program's annotated disassembly against
        ``<dir>/<name>.disasm``; exit 1 on drift (``--write-golden``
        regenerates the files)
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.core.structures import isa_programs
from repro_torch.core.verify import analyze_program, annotate_disasm


def _registry() -> dict:
    return dict(isa_programs.all_programs())


def _verdict_line(name: str, prog) -> tuple[str, bool]:
    facts, diags = analyze_program(prog)
    if diags:
        codes = ", ".join(sorted({d.code for d in diags}))
        return f"REJECT {name}: {len(diags)} finding(s) [{codes}]", False
    return f"OK     {name}: {facts.summary()}", True


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="pulse_verify", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("names", nargs="*", help="shipped program names to verify")
    ap.add_argument(
        "--all", action="store_true",
        help="verify every shipped isa_programs entry",
    )
    ap.add_argument(
        "--list", action="store_true", help="list shipped program names"
    )
    ap.add_argument(
        "--disasm", action="store_true",
        help="print annotated disassembly instead of one-line verdicts",
    )
    ap.add_argument(
        "--golden", metavar="DIR", default=None,
        help="compare annotated disassembly against DIR/<name>.disasm",
    )
    ap.add_argument(
        "--write-golden", metavar="DIR", default=None,
        help="(re)write DIR/<name>.disasm golden files and exit",
    )
    args = ap.parse_args(argv)

    registry = _registry()
    if args.list:
        for name in registry:
            print(name)
        return 0

    if args.all:
        names = list(registry)
    else:
        names = args.names
    if not names:
        ap.error("nothing to do: pass program names or --all")
    unknown = [n for n in names if n not in registry]
    if unknown:
        ap.error(
            f"unknown program(s) {unknown}; shipped: {sorted(registry)}"
        )

    if args.write_golden:
        out = Path(args.write_golden)
        out.mkdir(parents=True, exist_ok=True)
        for name in names:
            path = out / f"{name}.disasm"
            path.write_text(annotate_disasm(registry[name]))
            print(f"wrote {path}")
        return 0

    failures = 0
    for name in names:
        prog = registry[name]
        if args.golden:
            path = Path(args.golden) / f"{name}.disasm"
            got = annotate_disasm(prog)
            if not path.exists():
                print(f"DRIFT  {name}: missing golden {path}")
                failures += 1
            elif path.read_text() != got:
                print(
                    f"DRIFT  {name}: annotated disasm differs from {path} "
                    f"(regenerate with --write-golden)"
                )
                failures += 1
            else:
                print(f"OK     {name}: matches {path}")
            continue
        if args.disasm:
            print(annotate_disasm(prog))
            _, diags = analyze_program(prog)
            failures += bool(diags)
            continue
        line, ok = _verdict_line(name, prog)
        print(line)
        failures += not ok
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
