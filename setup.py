"""Build hook: bundle (and pre-compile) the native batch-crypto library.

The C++ batch verifier lives at native/secp256k1.cc in the repo layout
(built lazily by babble_tpu/native_crypto.py in dev checkouts). Wheels
must be self-contained, so build_py copies the source into
babble_tpu/_native/ and babble_tpu_torch/_native/ and, when a C++
compiler is available, pre-compiles libbabble_crypto.so there too —
installs without a toolchain still work (native_crypto falls back to a
user-cache build or the OpenSSL path).
All metadata is in pyproject.toml; this file only customizes the build.
"""

import os
import shutil
import subprocess

from setuptools import setup
from setuptools.command.build_py import build_py


class BuildPyWithNative(build_py):
    # the JAX package and the PyTorch/CUDA port each ship their own copy
    PACKAGES = ("babble_tpu", "babble_tpu_torch")

    def run(self):
        super().run()
        here = os.path.dirname(os.path.abspath(__file__))
        src = os.path.join(here, "native", "secp256k1.cc")
        if not os.path.exists(src):
            return
        dest_dirs = [os.path.join(self.build_lib, pkg, "_native")
                     for pkg in self.PACKAGES]
        for dest_dir in dest_dirs:
            os.makedirs(dest_dir, exist_ok=True)
            shutil.copy2(src, dest_dir)
        # one compile; the other package gets a copy of the library
        so = os.path.join(dest_dirs[0], "libbabble_crypto.so")
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-o", so,
                 os.path.join(dest_dirs[0], "secp256k1.cc")],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except (OSError, subprocess.SubprocessError):
            return  # runtime lazy build takes over
        for dest_dir in dest_dirs[1:]:
            shutil.copy2(so, dest_dir)


setup(cmdclass={"build_py": BuildPyWithNative})
