"""Project utilities (the reference's ``utils.py:61-90``).

Port of ``gobblet_rl_tpu/utils/helpers.py``.
"""

from __future__ import annotations

import glob
import os
import re
from pathlib import Path
from typing import Union


def get_project_root() -> Path:
    """Top folder of the repository: the parent of this package."""
    return Path(__file__).resolve().parents[2]


def find_file_in_subdir(
    parent_dir: Union[Path, str],
    file_str: Union[Path, str],
    regex_match: str | None = None,
) -> Union[str, None]:
    """Latest-sorted path of a file somewhere under ``parent_dir``, or
    ``None``; ``regex_match`` filters the paths first."""
    files = glob.glob(os.path.join(parent_dir, "**", file_str), recursive=True)
    if regex_match is not None:
        pattern = re.compile(regex_match)
        files = [s for s in files if pattern.match(s)]
    return sorted(files)[-1] if files else None
