"""Where the program keeps what it builds at run time.

Both the JAX compile cache and the native helper libraries live inside the
checkout (directories listed in ``.gitignore``), so a run reads and writes
nothing outside it:

  * ``compile_cache_dir`` / ``enable_compile_cache`` — JAX's persistent
    compilation cache. ``JAX_COMPILATION_CACHE_DIR``, when set, is left to
    JAX (which reads it itself); otherwise the cache is ``<checkout>/.jax_cache``.
  * ``build_native`` — compiles ``csrc/<name>.cpp`` into
    ``<checkout>/.native_build``, keyed on the source's content and flags.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

__all__ = ["CHECKOUT", "compile_cache_dir", "enable_compile_cache",
           "build_native"]

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_BUILD_DIR = os.path.join(CHECKOUT, ".native_build")


def compile_cache_dir(environ=None):
    """The compile-cache directory this process uses."""
    environ = os.environ if environ is None else environ
    return (environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compile_cache():
    """Turn on JAX's persistent compilation cache; returns its directory.

    Sets nothing when ``JAX_COMPILATION_CACHE_DIR`` is set: JAX already
    uses that directory."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path


def build_native(name, flags=("-O3",)):
    """Path of ``lib<name>.so`` built from the committed ``csrc/<name>.cpp``.

    The file name carries a digest of the source and the flags, so an edit
    to either builds a fresh library and a stale one is never loaded.
    Concurrent builders each write a private temporary file and rename it
    into place. Returns None when the source is missing; raises
    ``OSError``/``subprocess.CalledProcessError`` when the compiler is
    missing or fails."""
    src = os.path.join(CHECKOUT, "csrc", f"{name}.cpp")
    if not os.path.exists(src):
        return None
    cmd = ["g++", *flags, "-shared", "-fPIC", "-std=c++17"]
    digest = hashlib.sha256()
    with open(src, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(cmd).encode())
    lib_path = os.path.join(NATIVE_BUILD_DIR,
                            f"lib{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(NATIVE_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=NATIVE_BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        subprocess.run([*cmd, src, "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib_path
