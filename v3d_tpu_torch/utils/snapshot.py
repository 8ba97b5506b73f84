"""Run-reproducibility snapshots (counterpart of v3d_tpu/utils/snapshot.py,
itself of the reference's mesh_recon/utils/callbacks.py
CodeSnapshotCallback :52-77 and ConfigSnapshotCallback :79).

The training CLIs (``recon_gs``, ``recon_neus``, ``train_diffusion``) call
``snapshot_run(output_dir, config=...)`` once.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import tarfile
from typing import Any, Optional


def _git(args, cwd):
    try:
        return subprocess.run(["git"] + args, cwd=cwd, text=True,
                              capture_output=True, timeout=30).stdout.strip()
    except Exception:
        return ""


def snapshot_run(output_dir: str, config: Any = None,
                 repo_dir: Optional[str] = None) -> str:
    """Write ``output_dir/snapshot/``: the resolved config (config.json),
    git HEAD and status (git.txt) and a code.tar.gz of the git-tracked
    sources.  Returns the snapshot directory; never raises for a missing
    git."""
    repo_dir = repo_dir or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    snap = os.path.join(output_dir, "snapshot")
    os.makedirs(snap, exist_ok=True)

    if config is not None:
        if dataclasses.is_dataclass(config):
            cfg = dataclasses.asdict(config)
        elif isinstance(config, dict):
            cfg = config
        else:
            cfg = {k: v for k, v in vars(config).items() if not k.startswith("_")}
        with open(os.path.join(snap, "config.json"), "w") as f:
            json.dump(cfg, f, indent=1, default=str)

    head = _git(["rev-parse", "HEAD"], repo_dir)
    status = _git(["status", "--short"], repo_dir)
    with open(os.path.join(snap, "git.txt"), "w") as f:
        f.write(f"HEAD {head}\n\n{status}\n")

    files = _git(["ls-files"], repo_dir).splitlines()
    code_files = [p for p in files if p.endswith((".py", ".cc", ".h", ".yaml",
                                                  ".md", ".toml", ".ini"))]
    if code_files:
        with tarfile.open(os.path.join(snap, "code.tar.gz"), "w:gz") as tar:
            for p in code_files:
                full = os.path.join(repo_dir, p)
                if os.path.exists(full):
                    tar.add(full, arcname=p)
    return snap
