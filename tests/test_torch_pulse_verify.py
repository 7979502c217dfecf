"""Port parity: the ``pulse_verify`` CLI (``python -m
repro_torch.tools.pulse_verify``) against ``tools/pulse_verify.py``: the
same stdout and exit code for ``--all``, two named programs, ``--disasm``
and ``--list``; the golden files pass; ``--write-golden`` writes only into
the directory it is given, files equal to the golden ones.  Both CLIs run
in process through their ``main``."""

import importlib.util
from pathlib import Path

import pytest

from repro_torch.tools import pulse_verify as tcli

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "pulse_verify"


def _reference_cli():
    spec = importlib.util.spec_from_file_location("_jax_pulse_verify",
                                                  ROOT / "tools" / "pulse_verify.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JCLI = _reference_cli()


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--all"], ["list_find", "bst_update"], ["--all", "--disasm"],
                                  ["hash_find", "--disasm"], ["--list"]],
                         ids=lambda a: " ".join(a))
def test_output_and_exit_code_equal_the_reference(argv, capsys):
    got = _run(tcli.main, argv, capsys)
    want = _run(JCLI.main, argv, capsys)
    assert got == want
    assert got[1]


def test_golden_files_pass(capsys):
    rc, out = _run(tcli.main, ["--all", "--golden", str(GOLDEN)], capsys)
    assert rc == 0
    assert out.count("OK     ") == len(list(GOLDEN.glob("*.disasm")))


def test_golden_drift_is_refused(tmp_path, capsys):
    for p in GOLDEN.glob("*.disasm"):
        (tmp_path / p.name).write_text(p.read_text())
    (tmp_path / "bst_find.disasm").write_text("drift\n")
    (tmp_path / "list_find.disasm").unlink()
    argv = ["--all", "--golden", str(tmp_path)]
    got = _run(tcli.main, argv, capsys)
    assert got == _run(JCLI.main, argv, capsys)
    assert got[0] == 1 and "DRIFT  bst_find" in got[1] and "missing golden" in got[1]


def test_write_golden_writes_only_into_its_directory(tmp_path, capsys):
    out_dir = tmp_path / "golden"
    before = sorted(p.name for p in GOLDEN.iterdir())
    rc, out = _run(tcli.main, ["--all", "--write-golden", str(out_dir)], capsys)
    assert rc == 0
    assert sorted(p.name for p in GOLDEN.iterdir()) == before
    assert [p.name for p in tmp_path.iterdir()] == ["golden"]
    written = sorted(p.name for p in out_dir.iterdir())
    assert written == sorted(p.name for p in GOLDEN.glob("*.disasm"))
    for name in written:
        assert (out_dir / name).read_text() == (GOLDEN / name).read_text()
    assert out.count("wrote ") == len(written)
