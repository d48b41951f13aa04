"""Version stamping — this repo's equivalent of the reference's
build-time ``git describe`` stamp (``/root/reference/CMakeLists.txt:37-47``
writes ``tsl/version.h`` from ``git describe --always --dirty`` at build
time; the CPack packaging at ``CMakeLists.txt:110-125`` ships it).

Resolution order:

1. ``tsl_sdr_tpu/_version_stamp.py`` — baked by the sdist/wheel build
   (``setup.py``'s build_py hook), so installed artifacts carry the exact
   commit they were built from even without a git checkout.
2. Live ``git describe --tags --always --dirty`` when running from a
   checkout (normalized to a PEP 440 local version, e.g.
   ``0.1.0+gf5b2b22.dirty``).
3. The static base version.
"""

from __future__ import annotations

import os
import re
import subprocess

BASE_VERSION = "0.1.0"


def git_describe(repo_dir: str | None = None) -> str | None:
    """``git describe --tags --always --dirty`` of the containing repo,
    or None outside a checkout / without git."""
    if repo_dir is None:
        repo_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        out = subprocess.run(
            ["git", "-C", repo_dir, "describe", "--tags", "--always",
             "--dirty"],
            capture_output=True, text=True, timeout=10,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    desc = out.stdout.strip()
    return desc or None


def describe_to_pep440(desc: str, base: str = BASE_VERSION) -> str:
    """Normalize a git-describe string to PEP 440.

    ``v0.1.0`` -> ``0.1.0``; ``v0.1.0-3-gabc123`` -> ``0.1.0.post3+gabc123``;
    an untagged ``abc123[-dirty]`` -> ``<base>+gabc123[.dirty]``.
    """
    dirty = desc.endswith("-dirty")
    if dirty:
        desc = desc[: -len("-dirty")]
    m = re.fullmatch(r"v?(\d+(?:\.\d+)*)(?:-(\d+)-g([0-9a-f]+))?", desc)
    if m:
        ver, n, sha = m.groups()
        local = []
        if n and int(n):
            ver = f"{ver}.post{n}"
            local.append(f"g{sha}")
    else:
        # bare hash: no tag anywhere in history
        ver = base
        local = [f"g{desc}"]
    if dirty:
        local.append("dirty")
    return ver + (("+" + ".".join(local)) if local else "")


def resolve_version() -> str:
    try:
        from tsl_sdr_tpu._version_stamp import version as stamped  # noqa: PLC0415

        return stamped
    except ImportError:
        pass
    desc = git_describe()
    if desc:
        return describe_to_pep440(desc)
    return BASE_VERSION


__version__ = resolve_version()
