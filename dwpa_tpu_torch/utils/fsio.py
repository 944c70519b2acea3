"""Durable-commit filesystem helpers shared by the persistence layers.

The resume checkpoint, found outbox, dict cache and PMK store all commit
with the same idiom: write a sibling tmp file, fsync it, ``os.replace``
over the final name, then fsync the directory so the rename itself is on
disk.  Without the two fsyncs a power loss can surface an older-but-valid
file after the rename appeared to succeed — for the resume checkpoint
that means double-counting ``skip``.
"""

import os


def fsync_dir(path: str):
    """fsync a directory so a completed rename/create within it is
    durable.  Best-effort: some filesystems (and platforms) refuse
    O_RDONLY directory fds — a refusal downgrades to the pre-fsync
    behavior rather than failing the commit."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def fsync_replace(tmp_path: str, final_path: str):
    """Durably commit ``tmp_path`` over ``final_path``.

    The tmp file must already be written and closed; this fsyncs its
    contents, renames it into place, and fsyncs the parent directory.
    """
    fd = os.open(tmp_path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp_path, final_path)
    fsync_dir(os.path.dirname(os.path.abspath(final_path)))
