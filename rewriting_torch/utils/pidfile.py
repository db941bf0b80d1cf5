"""Job-level mutual exclusion and done-markers for experiment directories.

The port's copy of the JAX package's ``utils/pidfile.py``: experiment
directories are claimed with a lockfile recording hostname+pid; stale
locks (a dead pid on the same host) are taken over; a completed job drops a
``done.txt`` marker so reruns skip it."""

from __future__ import annotations

import atexit
import errno
import os
import socket
import sys


def exit_if_job_done(directory: str, redo: bool = False, force: bool = False,
                     verbose: bool = True):
    """Claim `directory` as a work unit or exit: exits(0) if done.txt exists
    (unless redo), exits(0) if another live process holds the lock (unless
    force)."""
    donefile = os.path.join(directory, "done.txt")
    if os.path.isfile(donefile):
        if redo:
            os.remove(donefile)
        else:
            if verbose:
                with open(donefile) as f:
                    print(f"{directory} already done: {f.read().strip()}")
            sys.exit(0)
    holder = pidfile_taken(os.path.join(directory, "lockfile.pid"),
                           force=force, verbose=verbose)
    if holder:
        sys.exit(0)


def mark_job_done(directory: str):
    """Drop the done marker (reference pidfile.mark_job_done)."""
    with open(os.path.join(directory, "done.txt"), "w") as f:
        f.write(f"done by {socket.gethostname()}:{os.getpid()}\n")


def reserve_dir(directory: str, redo: bool = False, force: bool = False):
    """mkdir -p + exit_if_job_done; returns the directory for chaining."""
    os.makedirs(directory, exist_ok=True)
    exit_if_job_done(directory, redo=redo, force=force)
    return directory


def pidfile_taken(path: str, force: bool = False, verbose: bool = False):
    """Try to claim a pidfile.  Returns None on success (lock is ours, with
    an atexit cleanup) or the holder string if a live process owns it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    while True:
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR)
            break
        except FileExistsError:
            try:
                with open(path) as f:
                    holder = f.read().strip()
            except FileNotFoundError:
                continue  # holder vanished between open attempts; retry
            host_pid = holder.split(" ")[0] if holder else ""
            stale = False
            if ":" in host_pid:
                host, pid = host_pid.rsplit(":", 1)
                if host == socket.gethostname() and pid.isdigit():
                    try:
                        os.kill(int(pid), 0)
                    except OSError as e:
                        stale = e.errno == errno.ESRCH
            if force or stale:
                try:
                    os.remove(path)
                except FileNotFoundError:
                    pass
                continue
            if verbose:
                print(f"{path} held by {holder}")
            return holder or "unknown"
    me = f"{socket.gethostname()}:{os.getpid()}"
    with os.fdopen(fd, "w") as f:
        f.write(me + "\n")

    def cleanup():
        # ownership check: the lock may have been released early and
        # re-acquired by a peer since; never delete a lock we no longer hold
        try:
            with open(path) as f:
                if f.read().strip() != me:
                    return
            os.remove(path)
        except OSError:
            pass
    atexit.register(cleanup)
    return None
