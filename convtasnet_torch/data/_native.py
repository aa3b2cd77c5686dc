"""Compile-and-load helper for the ctypes-bound C++ host libraries.

The port's own copy of convtasnet_tpu/data/_native.py. Both native
decoders (native/wavloader.cpp, native/sphio.cpp at the repo root) are read
from there and never edited; the port builds them with g++ into its own
git-ignored directory, convtasnet_torch/_native_build/, and never loads the
libraries that sit beside the sources. Lifecycle: an environment variable
may point at a prebuilt .so; otherwise a build older than its source is
rebuilt (to a temp file, then an atomic rename, so concurrent builds are
safe); then one lock-guarded CDLL load with the signatures configured.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Callable, Optional

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
NATIVE_SRC = os.path.join(REPO_ROOT, "native")
BUILD_DIR = os.path.join(REPO_ROOT, "convtasnet_torch", "_native_build")


class NativeLib:
    """Lazy builder / loader of one shared library."""

    def __init__(self, src_name: str, so_name: str, env_var: str,
                 configure: Callable[[ctypes.CDLL], None], extra_flags: tuple = ()):
        self._src = os.path.join(NATIVE_SRC, src_name)
        self._so = os.path.join(BUILD_DIR, so_name)
        self._env_var = env_var
        self._configure = configure
        self._extra_flags = tuple(extra_flags)
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._tried = False

    def _build(self) -> Optional[str]:
        so_env = os.environ.get(self._env_var)
        if so_env and os.path.exists(so_env):
            return so_env
        if not os.path.exists(self._src):
            return None
        so = self._so
        if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(self._src):
            return so
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                            *self._extra_flags, self._src, "-o", tmp],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
            return so
        except (subprocess.SubprocessError, OSError):
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None

    def get(self) -> Optional[ctypes.CDLL]:
        """The loaded library, building it first if needed; None when there
        is no toolchain (or the build or load failed)."""
        with self._lock:
            if self._tried:
                return self._lib
            self._tried = True
            so = self._build()
            if so is None:
                return None
            try:
                lib = ctypes.CDLL(so)
                self._configure(lib)
            except OSError:
                return None
            self._lib = lib
            return lib

    def available(self) -> bool:
        return self.get() is not None
