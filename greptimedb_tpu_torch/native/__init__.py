"""The port's native host code: the line-protocol tokenizer (lineproto.c),
a CPython extension built at first use.

`load_lineproto()` compiles lineproto.c with the host C compiler (`CC`, else
`cc`) against this interpreter's headers (sysconfig's include directory
and extension suffix, as greptimedb_tpu/native/Makefile builds the JAX
package's copy) into greptimedb_tpu_torch/_build/, named by a hash of the
source, the flags, the headers' path and the suffix, so an edited source
rebuilds and an unchanged one is reused. The library is written to a
temporary name and moved into place with os.replace, so processes that
build at once do not collide. A failed build raises with the compiler's
output; nothing falls back quietly.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "lineproto.c"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CFLAGS = ("-O2", "-Wall", "-fPIC", "-shared")

_lock = threading.Lock()
_module = None


def _compiler() -> str:
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if not cc:
        raise RuntimeError("no host C compiler (cc) to build lineproto.c")
    return cc


def lib_path() -> Path:
    include = sysconfig.get_paths()["include"]
    suffix = sysconfig.get_config_var("EXT_SUFFIX")
    digest = hashlib.sha256(
        SOURCE.read_bytes()
        + " ".join((*CFLAGS, include, suffix)).encode()).hexdigest()
    return BUILD_DIR / f"_lineproto-{digest[:16]}{suffix}"


def build() -> Path:
    """Compile lineproto.c unless its library exists; returns its path."""
    out = lib_path()
    if out.exists():
        return out
    include = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(include, "Python.h")):
        raise RuntimeError(
            f"Python.h is not under {include}: lineproto.c cannot build")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    cmd = [_compiler(), *CFLAGS, f"-I{include}", str(SOURCE), "-o", str(tmp)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"lineproto.c build failed ({proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def load_lineproto():
    """The built tokenizer module (`parse_payload(text)`)."""
    global _module
    with _lock:
        if _module is None:
            path = str(build())
            loader = importlib.machinery.ExtensionFileLoader(
                "_lineproto", path)
            spec = importlib.util.spec_from_file_location(
                "_lineproto", path, loader=loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
            _module = mod
        return _module
