"""The port's line-protocol parsers against the JAX package's.

Three parsers read the same payloads: the port's native tokenizer
(greptimedb_tpu_torch/native/lineproto.c, built at first use), the port's
pure-Python parser (its plain version) and the JAX package's
`influx.parse_payload`. They must return equal structures with equal value
types, and reject the same lines with the same error class.
"""

import os

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from greptimedb_tpu.servers import influx as jax_influx
from greptimedb_tpu_torch import native
from greptimedb_tpu_torch.servers import influx

CASES = [
    "cpu,host=a,region=us usage=1.5 1000",
    "cpu usage=1.5",                                 # no tags, no ts
    'm,tag\\,x=va\\=l field=2i 5',                   # escaped , and =
    'm f1=1.5,f2=2i,f3=t,f4=F,f5="hi there" 7',      # every value type
    'weird\\ name,t=v f="a\\"b\\\\c" 9',             # escaped space, quote
    'm f="comma, inside" 1',
    "m value=-42i 2",
    "m value=1e-3 3",
    "m big=123456789012345678901234567890i 4",       # past int64
    "m u=7u,b=true,c=FALSE,d=T 4",
    "  m spaced=1 4  ",                              # surrounding space
    "m   many=1    5",                               # runs of spaces
    "m crlf=1 6\r\nm crlf=2 7\r\n",                  # \r line ends
    "# comment line\nm a=1 5\n\nm b=2 6",            # comments, blanks
    'm,empty= f=1 8',                                # empty tag value
    'm s="with \\"escaped\\" quotes and \\\\ slash" 9',
]

BAD = [
    "justonemeasurement",
    "m novalue 1",
    "m f=notanumber 1",
    "m f=1_000 1",
    "m f=0x10 1",
    "m,badtag f=1 1",
    "m f=12.5i 1",
]


def _all(payload):
    return (influx.parse_payload(payload),
            influx.parse_payload(payload, native=False),
            jax_influx.parse_payload(payload))


def _typed(parsed):
    """Values with their types (1 == 1.0 == True in Python)."""
    return [(m, tags, {k: (type(v).__name__, v) for k, v in f.items()}, ts)
            for m, tags, f, ts in parsed]


@pytest.mark.parametrize("payload", CASES)
def test_three_parsers_agree(payload):
    a, b, c = _all(payload)
    assert _typed(a) == _typed(b) == _typed(c)


@pytest.mark.parametrize("payload", BAD)
def test_three_parsers_reject_alike(payload):
    kinds = []
    for fn in (lambda: influx.parse_payload(payload),
               lambda: influx.parse_payload(payload, native=False),
               lambda: jax_influx.parse_payload(payload)):
        with pytest.raises(Exception) as ei:
            fn()
        kinds.append(type(ei.value).__name__)
    assert kinds[0] == kinds[1] == kinds[2] == "LineProtocolError"
    assert isinstance(
        pytest.raises(Exception, influx.parse_payload, payload).value,
        influx.InvalidArgumentError)


_name = st.text(alphabet="abcXYZ_ ,=\\é", min_size=1, max_size=6)
_value = st.one_of(
    st.integers(-2**70, 2**70).map(lambda i: f"{i}i"),
    st.floats(allow_nan=False, allow_infinity=False).map(repr),
    st.sampled_from(["t", "T", "true", "False", "f", "FALSE"]),
    st.text(alphabet='ab "\\,= \r', max_size=6).map(
        lambda s: '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'),
)


def _esc(s: str) -> str:
    return (s.replace("\\", "\\\\").replace(",", "\\,")
            .replace("=", "\\=").replace(" ", "\\ "))


@st.composite
def _line(draw):
    m = _esc(draw(_name))
    tags = draw(st.lists(st.tuples(_name, _name), max_size=3))
    fields = draw(st.lists(st.tuples(_name, _value), min_size=1, max_size=3))
    head = m + "".join(f",{_esc(k)}={_esc(v)}" for k, v in tags)
    body = ",".join(f"{_esc(k)}={v}" for k, v in fields)
    ts = draw(st.one_of(st.none(), st.integers(0, 2**62).map(str)))
    sep = draw(st.sampled_from([" ", "  ", "   "]))
    end = draw(st.sampled_from(["", "\r", " "]))
    return head + sep + body + ("" if ts is None else sep + ts) + end


@settings(max_examples=150, deadline=None)
@given(st.lists(_line(), min_size=1, max_size=4))
def test_generated_payloads_agree(lines):
    payload = "\n".join(lines)
    outs = []
    for fn in (lambda: influx.parse_payload(payload),
               lambda: influx.parse_payload(payload, native=False),
               lambda: jax_influx.parse_payload(payload)):
        try:
            outs.append(("ok", _typed(fn())))
        except Exception as e:  # noqa: BLE001 - the class is compared
            outs.append(("err", type(e).__name__))
    assert outs[0] == outs[1] == outs[2]


def test_native_build_lands_in_build_dir_and_is_reused():
    path = native.build()
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "greptimedb_tpu_torch"
    assert path.name.startswith("_lineproto-")
    mtime = os.stat(path).st_mtime_ns
    assert native.build() == path
    assert os.stat(path).st_mtime_ns == mtime
    assert native.load_lineproto() is native.load_lineproto()


def test_native_build_key_follows_the_source(monkeypatch, tmp_path):
    src = tmp_path / "lineproto.c"
    src.write_bytes(native.SOURCE.read_bytes() + b"\n/* edit */\n")
    before = native.lib_path()
    monkeypatch.setattr(native, "SOURCE", src)
    assert native.lib_path() != before


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    src = tmp_path / "lineproto.c"
    src.write_text("this is not C\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="lineproto.c build failed"):
        native.build()
    assert not list((tmp_path / "_build").glob("*.tmp"))
