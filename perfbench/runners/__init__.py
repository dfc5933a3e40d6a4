"""Runners: one per kind of entry point the window drives.  A traffic mix
names its runner by ``"runner"``."""
from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"perfbench.runners.{name}")
