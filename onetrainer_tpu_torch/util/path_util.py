"""Filename helpers matching the reference's path_util/time_util
(reference: modules/util/path_util.py:6-20, modules/util/time_util.py:4-5).

safe_filename feeds sample folder names (`samples/{i} - {safe_prompt}`)
and embedding-saver filenames, so matching the exact character filter
keeps workspace layouts interchangeable.
"""

from __future__ import annotations

from datetime import datetime

_LEGAL_CHARS = {' ', '.', '_', '-', '#'}


def safe_filename(text: str, allow_spaces: bool = True,
                  max_length: int | None = 32) -> str:
    if not allow_spaces:
        text = text.replace(' ', '_')
    text = ''.join(c for c in text
                   if c.isalnum() or c in _LEGAL_CHARS).strip()
    if max_length is not None:
        text = text[:max_length]
    return text.strip()


def get_string_timestamp() -> str:
    return datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
