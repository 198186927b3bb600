"""Source-tree backup per run: port of bilateral_driving_tpu/utils/backup.py
(reference project/utils/backup.py:39-56). The training CLI copies the
port's .py, .yaml and .md sources into <log_dir>/backup, so a run directory
records the code that produced it."""
from __future__ import annotations

import os
import shutil

SKIP_DIRS = ("__pycache__", ".git", "work_dirs", "_build")


def backup_project(log_dir: str, source_root: str | None = None,
                   exts=(".py", ".yaml", ".md")) -> str:
    """Copy every file of `source_root` (the port's package by default)
    with an extension in `exts` to the same relative path under
    <log_dir>/backup, skipping SKIP_DIRS (the nvcc build directory among
    them). Returns the backup directory."""
    if source_root is None:
        source_root = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
    dst_root = os.path.join(log_dir, "backup")
    for root, dirs, files in os.walk(source_root):
        dirs[:] = [d for d in dirs if d not in SKIP_DIRS]
        for f in files:
            if os.path.splitext(f)[1] in exts:
                src = os.path.join(root, f)
                dst = os.path.join(dst_root,
                                   os.path.relpath(src, source_root))
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.copy2(src, dst)
    return dst_root
