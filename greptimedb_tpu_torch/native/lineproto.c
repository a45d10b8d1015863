/* InfluxDB line-protocol tokenizer (CPython extension): the port's own
 * copy of greptimedb_tpu/native/lineproto.c.
 *
 * Byte-for-byte compatible with the pure-Python parser in
 * greptimedb_tpu_torch/servers/influx.py (its plain version):
 * parse_payload(text) returns a list of (measurement, tags_dict,
 * fields_dict, ts_or_None) tuples, raising ValueError with the offending
 * line on malformed input. Field values type exactly like the Python
 * parser: quoted strings (\" and \\ unescaped), t/true/f/false
 * booleans, <int>i/u integers, floats otherwise. Built at first use by
 * greptimedb_tpu_torch/native/__init__.py with the host C compiler.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdlib.h>
#include <string.h>

typedef struct { const char *p; Py_ssize_t n; } strview;

static PyObject *err_line(const char *msg, const char *line, Py_ssize_t n)
{
    int ln = n > 200 ? 200 : (int)n;   /* never print past the line */
    PyErr_Format(PyExc_ValueError, "%s: %.*s", msg, ln, line);
    return NULL;
}

/* split a line into head / fields / ts on unescaped spaces outside
 * quotes; backslash pairs are preserved (the Python splitter keeps
 * them; later stages unescape). Returns number of sections (<=3). */
static int split_sections(const char *s, Py_ssize_t n, strview out[3])
{
    int nsec = 0, quote = 0;
    Py_ssize_t i = 0, start = 0;
    while (i < n) {
        char c = s[i];
        if (c == '\\' && i + 1 < n) { i += 2; continue; }
        if (c == '"') { quote = !quote; i++; continue; }
        if (c == ' ' && !quote) {
            if (i > start && nsec < 3) {
                out[nsec].p = s + start; out[nsec].n = i - start; nsec++;
            }
            while (i < n && s[i] == ' ') i++;
            start = i;
            continue;
        }
        i++;
    }
    if (i > start && nsec < 3) {
        out[nsec].p = s + start; out[nsec].n = i - start; nsec++;
    }
    return nsec;
}

/* unescape backslash pairs into a python str */
static PyObject *unescaped(const char *s, Py_ssize_t n)
{
    char *buf = (char *)malloc(n > 0 ? (size_t)n : 1);
    Py_ssize_t j = 0, i = 0;
    PyObject *out;
    if (!buf) return PyErr_NoMemory();
    while (i < n) {
        if (s[i] == '\\' && i + 1 < n) { buf[j++] = s[i + 1]; i += 2; }
        else buf[j++] = s[i++];
    }
    out = PyUnicode_DecodeUTF8(buf, j, "replace");
    free(buf);
    return out;
}

/* head: measurement[,k=v...] — split on unescaped commas, then each
 * token on the first '=' */
static int parse_head(strview head, PyObject **measurement,
                      PyObject *tags, const char *line, Py_ssize_t ln)
{
    const char *s = head.p;
    Py_ssize_t n = head.n, i = 0, start = 0;
    int first = 1;
    while (1) {
        int end = (i >= n);
        if (!end && s[i] == '\\' && i + 1 < n) { i += 2; continue; }
        if (end || s[i] == ',') {
            Py_ssize_t tn = i - start;
            if (first) {
                *measurement = unescaped(s + start, tn);
                if (!*measurement) return -1;
                first = 0;
            } else if (tn > 0) {
                /* split on the first '=' AFTER unescaping (matches the
                 * python fallback's token.split("=", 1)) */
                PyObject *token = unescaped(s + start, tn);
                PyObject *k, *v;
                Py_ssize_t eq;
                if (!token) return -1;
                eq = PyUnicode_FindChar(token, '=', 0,
                    PyUnicode_GET_LENGTH(token), 1);
                if (eq < 0) {
                    Py_DECREF(token);
                    err_line("bad tag", line, ln);
                    return -1;
                }
                k = PyUnicode_Substring(token, 0, eq);
                v = PyUnicode_Substring(token, eq + 1,
                    PyUnicode_GET_LENGTH(token));
                Py_DECREF(token);
                if (!k || !v) { Py_XDECREF(k); Py_XDECREF(v); return -1; }
                if (PyDict_SetItem(tags, k, v) < 0) {
                    Py_DECREF(k); Py_DECREF(v); return -1;
                }
                Py_DECREF(k); Py_DECREF(v);
            }
            if (end) break;
            i++; start = i;
            continue;
        }
        i++;
    }
    return 0;
}

/* field value typing, mirroring _parse_field_value */
static PyObject *field_value(const char *s, Py_ssize_t n,
                             const char *line, Py_ssize_t ln)
{
    if (n >= 2 && s[0] == '"' && s[n - 1] == '"') {
        /* unescape \" and \\ only */
        char *buf = (char *)malloc((size_t)n);
        Py_ssize_t j = 0, i = 1;
        PyObject *out;
        if (!buf) return PyErr_NoMemory();
        while (i < n - 1) {
            if (s[i] == '\\' && i + 1 < n - 1 &&
                (s[i + 1] == '"' || s[i + 1] == '\\')) {
                buf[j++] = s[i + 1]; i += 2;
            } else buf[j++] = s[i++];
        }
        out = PyUnicode_DecodeUTF8(buf, j, "replace");
        free(buf);
        return out;
    }
    if ((n == 1 && (s[0] == 't' || s[0] == 'T')) ||
        (n == 4 && (strncasecmp(s, "true", 4) == 0)))
        Py_RETURN_TRUE;
    if ((n == 1 && (s[0] == 'f' || s[0] == 'F')) ||
        (n == 5 && (strncasecmp(s, "false", 5) == 0)))
        Py_RETURN_FALSE;
    /* '_' grouping and hex floats are rejected by the fallback spec */
    {
        Py_ssize_t ci;
        for (ci = 0; ci < n; ci++)
            if (s[ci] == '_' || s[ci] == 'x' || s[ci] == 'X')
                return err_line("bad field value", line, ln);
    }
    if (n >= 2 && (s[n - 1] == 'i' || s[n - 1] == 'u')) {
        char tmp[64];
        char *endp;
        long long v;
        if (n - 1 < (Py_ssize_t)sizeof(tmp)) {
            memcpy(tmp, s, (size_t)(n - 1)); tmp[n - 1] = 0;
            errno = 0;
            v = strtoll(tmp, &endp, 10);
            if (errno == 0 && endp == tmp + (n - 1))
                return PyLong_FromLongLong(v);
        }
        /* big ints (64+ digits): python-int parse of the full literal */
        {
            PyObject *str = PyUnicode_DecodeUTF8(s, n - 1, "replace");
            PyObject *out;
            if (!str) return NULL;
            out = PyLong_FromUnicodeObject(str, 10);
            Py_DECREF(str);
            if (out) return out;
            PyErr_Clear();
        }
        return err_line("bad field value", line, ln);
    }
    {
        char tmp[512];
        char *endp;
        double d;
        if (n < (Py_ssize_t)sizeof(tmp)) {
            memcpy(tmp, s, (size_t)n); tmp[n] = 0;
            errno = 0;
            d = strtod(tmp, &endp);
            if (endp == tmp + n && n > 0)
                return PyFloat_FromDouble(d);
        }
        return err_line("bad field value", line, ln);
    }
}

/* fields section: k=v pairs split on unescaped commas outside quotes */
static int parse_fields(strview fs, PyObject *fields,
                        const char *line, Py_ssize_t ln)
{
    const char *s = fs.p;
    Py_ssize_t n = fs.n, i = 0, start = 0;
    int quote = 0, any = 0;
    while (1) {
        int end = (i >= n);
        if (!end && s[i] == '\\' && i + 1 < n) { i += 2; continue; }
        if (!end && s[i] == '"') { quote = !quote; i++; continue; }
        if (end || (s[i] == ',' && !quote)) {
            Py_ssize_t tn = i - start;
            const char *t = s + start;
            const char *eq = memchr(t, '=', (size_t)tn);
            PyObject *k, *v;
            if (!eq) { err_line("bad field", line, ln); return -1; }
            k = unescaped(t, eq - t);
            if (!k) return -1;
            v = field_value(eq + 1, tn - (eq - t) - 1, line, ln);
            if (!v) { Py_DECREF(k); return -1; }
            if (PyDict_SetItem(fields, k, v) < 0) {
                Py_DECREF(k); Py_DECREF(v); return -1;
            }
            Py_DECREF(k); Py_DECREF(v);
            any = 1;
            if (end) break;
            i++; start = i;
            continue;
        }
        i++;
    }
    if (!any) { err_line("no fields", line, ln); return -1; }
    return 0;
}

static PyObject *parse_payload(PyObject *self, PyObject *arg)
{
    Py_ssize_t total;
    const char *text = PyUnicode_AsUTF8AndSize(arg, &total);
    PyObject *out;
    Py_ssize_t pos = 0;
    if (!text) return NULL;
    out = PyList_New(0);
    if (!out) return NULL;
    while (pos < total) {
        Py_ssize_t eol = pos;
        const char *line;
        Py_ssize_t n, a = 0, b;
        while (eol < total && text[eol] != '\n') eol++;
        line = text + pos;
        n = eol - pos;
        pos = eol + 1;
        /* strip */
        b = n;
        while (a < b && (line[a] == ' ' || line[a] == '\t' ||
                         line[a] == '\r')) a++;
        while (b > a && (line[b - 1] == ' ' || line[b - 1] == '\t' ||
                         line[b - 1] == '\r')) b--;
        if (b == a || line[a] == '#') continue;
        {
            strview secs[3];
            int nsec = split_sections(line + a, b - a, secs);
            PyObject *measurement = NULL, *tags, *fields, *ts, *tup;
            if (nsec < 2) {
                Py_DECREF(out);
                return err_line("invalid line", line + a, b - a);
            }
            tags = PyDict_New();
            fields = PyDict_New();
            if (!tags || !fields) {
                Py_XDECREF(tags); Py_XDECREF(fields); Py_DECREF(out);
                return NULL;
            }
            if (parse_head(secs[0], &measurement, tags,
                           line + a, b - a) < 0 ||
                parse_fields(secs[1], fields, line + a, b - a) < 0) {
                Py_XDECREF(measurement); Py_DECREF(tags);
                Py_DECREF(fields); Py_DECREF(out);
                return NULL;
            }
            if (nsec > 2) {
                ts = PyUnicode_DecodeUTF8(secs[2].p, secs[2].n,
                                          "replace");
            } else {
                ts = Py_None; Py_INCREF(Py_None);
            }
            if (!ts) {
                Py_DECREF(measurement); Py_DECREF(tags);
                Py_DECREF(fields); Py_DECREF(out);
                return NULL;
            }
            tup = PyTuple_Pack(4, measurement, tags, fields, ts);
            Py_DECREF(measurement); Py_DECREF(tags);
            Py_DECREF(fields); Py_DECREF(ts);
            if (!tup || PyList_Append(out, tup) < 0) {
                Py_XDECREF(tup); Py_DECREF(out);
                return NULL;
            }
            Py_DECREF(tup);
        }
    }
    return out;
}

static PyMethodDef methods[] = {
    {"parse_payload", parse_payload, METH_O,
     "parse_payload(text) -> [(measurement, tags, fields, ts|None)]"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_lineproto",
    "native influxdb line-protocol tokenizer", -1, methods,
};

PyMODINIT_FUNC PyInit__lineproto(void) { return PyModule_Create(&module); }
