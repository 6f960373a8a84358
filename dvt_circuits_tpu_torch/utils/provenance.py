"""Git provenance banner.

The port's copy of ``dvt_circuits_tpu/utils/provenance.py``; its dirty
list covers the port's package.

The reference bakes the commit hash and dirty-file list into the binary at
build time (build.rs:6-60) and prints them at CLI startup
(src/main.rs:406-419).  Python has no build step, so the equivalent here is
computed at first use and cached for the process; outside a git checkout it
degrades to "unknown" exactly like the reference's `unwrap_or` fallbacks.
"""

from __future__ import annotations

import os
import subprocess
from functools import lru_cache
from typing import List, Tuple

#: the reference filters its dirty list to files under crates/ (build.rs:22);
#: the analogous source tree here is the package directory
_SOURCE_PREFIX = "dvt_circuits_tpu_torch/"


def _git(*args: str) -> str:
    repo_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    out = subprocess.run(
        ["git", *args],
        cwd=repo_root,
        capture_output=True,
        text=True,
        timeout=5,
    )
    return out.stdout.strip()


@lru_cache(maxsize=1)
def git_provenance() -> Tuple[str, List[str]]:
    """(commit hash, uncommitted source files) — "unknown" / [] on failure."""
    try:
        commit = _git("rev-parse", "HEAD") or "unknown"
    except Exception:
        commit = "unknown"
    try:
        dirty = [
            line[3:]
            for line in _git("status", "--porcelain").splitlines()
            if len(line) > 3 and line[3:].startswith(_SOURCE_PREFIX)
        ]
    except Exception:
        dirty = []
    return commit, dirty


def print_banner() -> None:
    """Startup banner (reference src/main.rs:406-419).

    Printed to STDERR so machine-parsed stdout (get-schema /
    validate-schema consumers) stays clean by default (advisor r4)."""
    import sys

    commit, dirty = git_provenance()
    print(f"🔗 Commit Hash: {commit}", file=sys.stderr)
    if dirty:
        print("\x1b[1;33m⚠️ WARNING:Uncommitted Changes\x1b[0m", file=sys.stderr)
        print(f"📂 Uncommitted Files in ./{_SOURCE_PREFIX}:", file=sys.stderr)
        for f in dirty:
            print(f"  📄 {f}", file=sys.stderr)
