"""Plain PyTorch references of the benchmark's model families, in float32
with TF32 off.  They import nothing of the program: each reads the
benchmark's weights by key name and works out everything else itself.
A configuration file names its reference module by ``"reference"``."""
from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"perfbench.reference.{name}")
