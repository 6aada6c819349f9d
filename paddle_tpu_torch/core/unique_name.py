"""Unique name generator (reference: python/paddle/fluid/unique_name.py)."""

from __future__ import annotations

import contextlib
from collections import defaultdict


class UniqueNameGenerator:
    def __init__(self):
        self.ids = defaultdict(int)

    def __call__(self, key: str) -> str:
        tmp = self.ids[key]
        self.ids[key] += 1
        return f"{key}_{tmp}"


generator = UniqueNameGenerator()

# Active name-scope prefixes (fluid framework.py name_scope); prefixes are
# cosmetic namespacing applied to generated names.
_scope_stack: list = []


def generate(key: str) -> str:
    if _scope_stack:
        prefix = "/".join(_scope_stack)
        if not key.startswith(prefix + "/"):
            key = prefix + "/" + key
    return generator(key)


@contextlib.contextmanager
def guard(new_generator: UniqueNameGenerator | None = None):
    global generator
    old = generator
    generator = new_generator or UniqueNameGenerator()
    try:
        yield
    finally:
        generator = old
