"""JSON, geospatial and network scalar functions (a copy of the JAX
package's query/functions_ext.py).

Counterpart of upstream GreptimeDB's extended function families
(src/common/function/src/scalars/json/: json_get_*,
json_is_*, json_path_exists; src/common/function/src/scalars/geo/:
st_point/st_distance/haversine + geohash/h3 cell bucketing;
src/common/function/src/scalars/ip.rs).

Host-vectorized numpy like query/functions.py: these families are
string/object-dtype work with no device form — the device path
operates on their numeric OUTPUTS (e.g. GROUP BY geohash cell).
"""

from __future__ import annotations

import json

import numpy as np

from greptimedb_tpu_torch.errors import PlanError
from greptimedb_tpu_torch.query.expr import Col, ColumnSource, eval_expr
from greptimedb_tpu_torch.sql import ast as A


def _const_arg(e: A.Expr):
    from greptimedb_tpu_torch.query.functions import _const_arg as ca

    return ca(e)


# ----------------------------------------------------------------------
# json
# ----------------------------------------------------------------------

def _json_docs(col: Col) -> list:
    out = []
    for v in col.values:
        if isinstance(v, (dict, list)):
            out.append(v)
            continue
        try:
            out.append(json.loads(v) if isinstance(v, str) else None)
        except (ValueError, TypeError):
            out.append(None)
    return out


def _json_path_get(doc, path: str):
    """'$.a.b[0]' style paths (and bare 'a.b' like upstream)."""
    if doc is None:
        return None
    if path.startswith("$"):
        path = path[1:]
    cur = doc
    token = ""
    i = 0
    parts: list = []
    while i < len(path):
        ch = path[i]
        if ch == ".":
            if token:
                parts.append(token)
                token = ""
        elif ch == "[":
            if token:
                parts.append(token)
                token = ""
            j = path.index("]", i)
            idx = path[i + 1:j].strip("'\"")
            parts.append(int(idx) if idx.lstrip("-").isdigit() else idx)
            i = j
        else:
            token += ch
        i += 1
    if token:
        parts.append(token)
    for p in parts:
        if isinstance(cur, dict):
            cur = cur.get(str(p))
        elif isinstance(cur, list) and isinstance(p, int):
            cur = cur[p] if -len(cur) <= p < len(cur) else None
        else:
            return None
        if cur is None:
            return None
    return cur


def _json_family(name: str, args, src: ColumnSource) -> Col | None:
    if name in ("json_get_string", "json_get_int", "json_get_float",
                "json_get_bool", "json_path_exists"):
        if len(args) != 2:
            raise PlanError(f"{name}(json, path)")
        docs = _json_docs(eval_expr(args[0], src))
        path = str(_const_arg(args[1]))
        got = [_json_path_get(d, path) for d in docs]
        if name == "json_path_exists":
            return Col(np.asarray([g is not None for g in got], bool))
        validity = np.asarray([g is not None for g in got], bool)
        if name == "json_get_string":
            vals = np.asarray(
                ["" if g is None else
                 (g if isinstance(g, str) else json.dumps(g))
                 for g in got], object,
            )
        elif name == "json_get_bool":
            vals = np.asarray([bool(g) for g in got], bool)
            validity &= np.asarray(
                [isinstance(g, bool) for g in got], bool
            )
        elif name == "json_get_int":
            ok = [isinstance(g, (int, float)) and not isinstance(g, bool)
                  for g in got]
            vals = np.asarray(
                [int(g) if k else 0 for g, k in zip(got, ok)], np.int64
            )
            validity &= np.asarray(ok, bool)
        else:
            ok = [isinstance(g, (int, float)) and not isinstance(g, bool)
                  for g in got]
            vals = np.asarray(
                [float(g) if k else 0.0 for g, k in zip(got, ok)],
                np.float64,
            )
            validity &= np.asarray(ok, bool)
        return Col(vals, None if validity.all() else validity)
    if name in ("json_is_object", "json_is_array", "json_is_string",
                "json_is_number", "json_is_bool", "json_is_null"):
        docs = _json_docs(eval_expr(args[0], src))
        kind = name.removeprefix("json_is_")
        check = {
            "object": lambda g: isinstance(g, dict),
            "array": lambda g: isinstance(g, list),
            "string": lambda g: isinstance(g, str),
            "number": lambda g: isinstance(g, (int, float))
            and not isinstance(g, bool),
            "bool": lambda g: isinstance(g, bool),
            "null": lambda g: g is None,
        }[kind]
        return Col(np.asarray([check(g) for g in docs], bool))
    if name == "parse_json" or name == "to_json":
        docs = _json_docs(eval_expr(args[0], src))
        validity = np.asarray([d is not None for d in docs], bool)
        vals = np.asarray(
            ["null" if d is None else json.dumps(d) for d in docs],
            object,
        )
        return Col(vals, None if validity.all() else validity)
    return None


# ----------------------------------------------------------------------
# geo
# ----------------------------------------------------------------------

_EARTH_RADIUS_M = 6_371_008.8

_GEOHASH32 = "0123456789bcdefghjkmnpqrstuvwxyz"


def _haversine_m(lat1, lon1, lat2, lon2) -> np.ndarray:
    p1, p2 = np.radians(lat1), np.radians(lat2)
    dp = p2 - p1
    dl = np.radians(lon2 - lon1)
    a = (np.sin(dp / 2) ** 2
         + np.cos(p1) * np.cos(p2) * np.sin(dl / 2) ** 2)
    return 2 * _EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


def _geohash_encode(lat: float, lon: float, precision: int) -> str:
    lat_lo, lat_hi = -90.0, 90.0
    lon_lo, lon_hi = -180.0, 180.0
    out = []
    bit = 0
    ch = 0
    even = True
    while len(out) < precision:
        if even:
            mid = (lon_lo + lon_hi) / 2
            if lon >= mid:
                ch = (ch << 1) | 1
                lon_lo = mid
            else:
                ch <<= 1
                lon_hi = mid
        else:
            mid = (lat_lo + lat_hi) / 2
            if lat >= mid:
                ch = (ch << 1) | 1
                lat_lo = mid
            else:
                ch <<= 1
                lat_hi = mid
        even = not even
        bit += 1
        if bit == 5:
            out.append(_GEOHASH32[ch])
            bit = 0
            ch = 0
    return "".join(out)


def _latlng_cell(lat: float, lon: float, res: int) -> int:
    """Integer cell id on a res-refined lat/lon grid — the h3-style
    bucketing primitive (equal-angle, not equal-area; documented)."""
    n = 1 << res
    x = int((lon + 180.0) / 360.0 * n)
    y = int((lat + 90.0) / 180.0 * n)
    x = min(max(x, 0), n - 1)
    y = min(max(y, 0), n - 1)
    return (res << 52) | (y << 26) | x


def _geo_family(name: str, args, src: ColumnSource) -> Col | None:
    if name in ("st_distance", "st_distance_sphere_m", "haversine"):
        # (lat1, lon1, lat2, lon2) -> meters
        if len(args) != 4:
            raise PlanError(f"{name}(lat1, lon1, lat2, lon2)")
        cs = [eval_expr(a, src) for a in args]
        vals = [c.values.astype(np.float64) for c in cs]
        validity = None
        for c in cs:
            if c.validity is not None:
                validity = (c.validity if validity is None
                            else validity & c.validity)
        return Col(_haversine_m(*vals), validity)
    if name == "st_point":
        if len(args) != 2:
            raise PlanError("st_point(lat, lon)")
        la = eval_expr(args[0], src)
        lo = eval_expr(args[1], src)
        vals = np.asarray(
            [f"POINT({x} {y})" for x, y in
             zip(lo.values.astype(float), la.values.astype(float))],
            object,
        )
        return Col(vals, _and_validity(la, lo))
    if name == "geohash":
        if len(args) != 3:
            raise PlanError("geohash(lat, lon, precision)")
        la = eval_expr(args[0], src)
        lo = eval_expr(args[1], src)
        prec = int(_const_arg(args[2]))
        return Col(np.asarray(
            [_geohash_encode(a, b, prec) for a, b in
             zip(la.values.astype(np.float64),
                 lo.values.astype(np.float64))],
            object,
        ), _and_validity(la, lo))
    if name in ("h3_latlng_to_cell", "latlng_to_cell"):
        if len(args) != 3:
            raise PlanError(f"{name}(lat, lon, resolution)")
        la = eval_expr(args[0], src)
        lo = eval_expr(args[1], src)
        res = int(_const_arg(args[2]))
        return Col(np.asarray(
            [_latlng_cell(a, b, res) for a, b in
             zip(la.values.astype(np.float64),
                 lo.values.astype(np.float64))], np.int64,
        ), _and_validity(la, lo))
    return None


def _and_validity(*cols: Col):
    validity = None
    for c in cols:
        if c.validity is not None:
            validity = (c.validity if validity is None
                        else validity & c.validity)
    return validity


# ----------------------------------------------------------------------
# network
# ----------------------------------------------------------------------

def _net_family(name: str, args, src: ColumnSource) -> Col | None:
    import ipaddress

    if name in ("ipv4_string_to_num", "ipv4_to_num"):
        c = eval_expr(args[0], src)
        vals = np.zeros(len(c.values), np.int64)
        ok = np.ones(len(c.values), bool)
        for i, v in enumerate(c.values):
            try:
                vals[i] = int(ipaddress.IPv4Address(str(v)))
            except ValueError:
                ok[i] = False
        validity = ok if c.validity is None else (ok & c.validity)
        return Col(vals, None if validity.all() else validity)
    if name in ("ipv4_num_to_string", "ipv4_to_string"):
        c = eval_expr(args[0], src)
        vals = np.asarray([""] * len(c.values), object)
        ok = np.ones(len(c.values), bool)
        for i, v in enumerate(c.values):
            try:
                vals[i] = str(ipaddress.IPv4Address(int(v) & 0xFFFFFFFF))
            except (ValueError, TypeError):
                ok[i] = False
        validity = ok if c.validity is None else (ok & c.validity)
        return Col(vals, None if validity.all() else validity)
    if name == "ipv4_in_range":
        if len(args) != 2:
            raise PlanError("ipv4_in_range(ip, cidr)")
        c = eval_expr(args[0], src)
        net = ipaddress.IPv4Network(str(_const_arg(args[1])),
                                    strict=False)
        out = np.zeros(len(c.values), bool)
        for i, v in enumerate(c.values):
            try:
                out[i] = ipaddress.IPv4Address(str(v)) in net
            except ValueError:
                pass
        return Col(out, c.validity)
    return None


_FAMILIES = (_json_family, _geo_family, _net_family)

_ARITY = {
    "json_is_object": 1, "json_is_array": 1, "json_is_string": 1,
    "json_is_number": 1, "json_is_bool": 1, "json_is_null": 1,
    "parse_json": 1, "to_json": 1,
    "ipv4_string_to_num": 1, "ipv4_to_num": 1,
    "ipv4_num_to_string": 1, "ipv4_to_string": 1,
}


def try_eval(name: str, args, src: ColumnSource) -> Col | None:
    """Dispatch to the extended families; None -> not one of ours.
    Bad inputs surface as PlanError (a GreptimeError), never raw
    ValueError/IndexError — the fuzz tier's robustness invariant."""
    want = _ARITY.get(name)
    if want is not None and len(args) != want:
        raise PlanError(f"{name} takes {want} argument(s)")
    from greptimedb_tpu_torch.errors import GreptimeError

    for fam in _FAMILIES:
        try:
            out = fam(name, args, src)
        except GreptimeError:
            raise
        except (ValueError, TypeError, IndexError, KeyError) as e:
            raise PlanError(f"{name}: {e}") from None
        if out is not None:
            return out
    return None
