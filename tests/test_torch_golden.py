"""The golden SQL files (tests/golden/*.sql) through the port.

Each file runs through `greptimedb_tpu_torch.instance.Standalone(tmp,
device="cpu")` with the parser and result format of tests/test_golden.py
(the files are read, never edited): one case per file. A file passes
whole, or it names the ROADMAP item that ports what it needs in WAITING,
and then its first statement that does not pass must raise
UnsupportedError naming that item (a wrong answer, another error or
another item fails the case). A statement whose golden answer is an
ERROR must raise an error of its own, not an UnsupportedError naming a
ROADMAP item (the JAX package's own UnsupportedErrors, such as an
unsupported window frame, are such errors of its own).
"""

import pytest

from greptimedb_tpu_torch.errors import UnsupportedError
from greptimedb_tpu_torch.instance import Standalone
from greptimedb_tpu_torch.session import QueryContext
from tests.test_golden import format_result, golden_files, parse_cases

WAITING = {
    "copy_roundtrip": "A2's tail",           # COPY
    "multi_region_partition": "A10",         # more than one region
    "partition_basic": "A10",
}


def _run_case(inst, path):
    """Run `path`; returns the UnsupportedError that stopped it, if any."""
    ctx = QueryContext()
    for stmt, expected, line_no in parse_cases(path.read_text()):
        if expected and expected[0].startswith("ERROR"):
            # the statement's own error: a refusal of an unported
            # statement stops the file as any other would
            with pytest.raises(Exception) as raised:
                inst.sql(stmt, ctx)
            if (isinstance(raised.value, UnsupportedError)
                    and "ROADMAP" in str(raised.value)):
                return raised.value
            continue
        try:
            res = inst.sql(stmt, ctx)
        except UnsupportedError as e:
            return e
        except Exception as e:
            raise AssertionError(
                f"{path.name}:{line_no}: {stmt!r} failed: {e}") from e
        if expected is None:
            continue
        got = format_result(res)
        assert got == expected, (
            f"{path.name}:{line_no}:\n{stmt}\nexpected:\n"
            + "\n".join(expected) + "\ngot:\n" + "\n".join(got))
    return None


def test_waiting_names_only_golden_files():
    assert set(WAITING) <= {p.stem for p in golden_files()}


@pytest.mark.parametrize("path", golden_files(), ids=lambda p: p.stem)
def test_golden_port(path, tmp_path):
    inst = Standalone(str(tmp_path / "data"), device="cpu", x64=True,
                      warm_start=False)
    try:
        stopped = _run_case(inst, path)
    finally:
        inst.close()
    item = WAITING.get(path.stem)
    if item is None:
        assert stopped is None, f"{path.name}: {stopped}"
    else:
        assert stopped is not None, (
            f"{path.name} passes whole: take it out of WAITING")
        assert f"ROADMAP {item}" in str(stopped), (
            f"{path.name} waits on {item} but stopped on: {stopped}")
