"""Path anchoring for archive extraction (a copy of
pycricodecs_tpu/utils/paths.py, held equal by tests/test_torch_containers.py).

Container tables (CPK DirName/FileName, ACB cue names, USM CRID filenames)
are attacker-controlled data; joining them into an output path naively lets
a crafted archive write outside the extraction directory (absolute paths,
`..` segments, drive prefixes). The reference only strips drive-letter
absolutes (usm.py:205-220) and joins CPK names unsanitized — a traversal
hole we deliberately do not reproduce.
"""
from __future__ import annotations

import os
import re

_DRIVE_PREFIX = re.compile(r"^[A-Za-z]:[\\/]")


def safe_parts(name: str) -> list:
    """Split an archive-supplied name into traversal-free path segments."""
    name = str(name)
    # a drive prefix ("A:\\x", "C:/x") means everything before the colon is
    # not a real segment; the reference strips these too. Restrict the strip
    # to an actual drive-letter pattern — 'a:b/c.hca' is a legal POSIX name
    # whose prefix must not be silently discarded; neutralize its colon
    # instead.
    if _DRIVE_PREFIX.match(name):
        name = name[2:]
    name = name.replace(":", "_")
    name = name.replace("\\", "/")
    return [p for p in name.split("/") if p not in ("", ".", "..")]


def anchored_join(dirname: str, *names: str, fallback: str = "") -> str:
    """Join archive-supplied names under `dirname`, never escaping it.

    When every segment strips away (a name that is only separators or
    `..`), `fallback` supplies the member name — otherwise the bare
    directory comes back and a caller that open()s it would crash.
    """
    parts: list = []
    for n in names:
        parts.extend(safe_parts(n))
    if not parts and fallback:
        parts = [fallback]
    base = dirname if dirname else "."
    return os.path.join(base, *parts) if parts else base
