"""End-to-end experiment orchestration (paper §5.1).

The port's counterpart of the JAX package's ``metrics/experiments.py``,
the reference's experiments.sh pipeline (reference experiments.sh:10-48):
sample clean images (and a FID split), sample edited images for each
published edit, segment all outputs, then report the effectiveness
(``seg_correct_mod``) and damage (``distances``) metrics.  Every stage is
a command line of the port (``python -m rewriting_torch.metrics.<module>``).

Unlike the reference's linear shell script, the pipeline is a small DAG:
each stage declares the stages it needs, carries its own done-marker
directory, and independent ready stages are distributed across hosts
(strided by the process's rank, ``utils/hostshard.py``) and claimed with
pidfile locks, so N hosts pointed at a shared results directory split the
grid and restarts resume where they stopped.  The default runner starts
each stage with this interpreter (``sys.executable``), whatever
``python`` the PATH holds.

Command line::

    python3 -m rewriting_torch.metrics.experiments [--dry_run]
        [--statedir results/experiments] [--process_index I
        --process_count N]
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils import hostshard, pidfile

# (name, command, dependencies); reference experiments.sh:10-48
STAGES: List[Tuple[str, str, Tuple[str, ...]]] = [
    ("sample_church", "python -m rewriting_torch.metrics.sample "
     "--dataset church", ()),
    ("sample_church_fid", "python -m rewriting_torch.metrics.sample "
     "--dataset church --fid_samples", ()),
    ("sample_faces", "python -m rewriting_torch.metrics.sample "
     "--dataset faces", ()),
    ("edit_smile", "python -m rewriting_torch.metrics.sample_edited "
     "--mask smile", ()),
    ("edit_dome2spire", "python -m rewriting_torch.metrics.sample_edited "
     "--mask dome2spire", ()),
    ("edit_dome2tree", "python -m rewriting_torch.metrics.sample_edited "
     "--mask dome2tree", ()),
    ("edit_dome2castle", "python -m rewriting_torch.metrics.sample_edited "
     "--mask dome2castle", ()),
    ("seg_church_clean", "python -m rewriting_torch.metrics.seg_stats "
     "church_clean", ("sample_church",)),
    ("seg_dome2spire", "python -m rewriting_torch.metrics.seg_stats "
     "dome2spire", ("edit_dome2spire",)),
    ("seg_faces_clean", "python -m rewriting_torch.metrics.seg_stats "
     "faces_clean", ("sample_faces",)),
    ("seg_smile", "python -m rewriting_torch.metrics.seg_stats smile",
     ("edit_smile",)),
    ("correct_dome2spire", "python -m rewriting_torch.metrics."
     "seg_correct_mod --exp_name dome2spire",
     ("seg_church_clean", "seg_dome2spire")),
    ("correct_smile", "python -m rewriting_torch.metrics.seg_correct_mod "
     "--exp_name smile", ("seg_faces_clean", "seg_smile")),
    # the damage metric masks with the clean images' labels
    # (distances.main reads <results>/seg/<dataset>_clean), so it waits
    # for their segmentation too
    ("dist_dome2spire", "python -m rewriting_torch.metrics.distances "
     "--exp_name dome2spire", ("sample_church", "edit_dome2spire",
                               "seg_church_clean")),
    ("dist_smile", "python -m rewriting_torch.metrics.distances "
     "--exp_name smile", ("sample_faces", "edit_smile", "seg_faces_clean")),
]


def _done(statedir: str, name: str) -> bool:
    return os.path.isfile(os.path.join(statedir, name, "done.txt"))


def ready_stages(statedir: str,
                 stages: Sequence[Tuple[str, str, Tuple[str, ...]]]
                 ) -> List[Tuple[str, str, Tuple[str, ...]]]:
    """Stages whose dependencies are all done and which are not done."""
    return [s for s in stages
            if not _done(statedir, s[0])
            and all(_done(statedir, d) for d in s[2])]


def run_command(cmd: str) -> int:
    """Run a stage's command line; a leading ``python`` is this
    interpreter.  Returns its exit code."""
    argv = shlex.split(cmd)
    if argv and argv[0] == "python":
        argv[0] = sys.executable
    print("+", cmd, flush=True)
    return subprocess.call(argv, env=os.environ)


def run_pipeline(statedir: str = "results/experiments",
                 stages=STAGES, dry_run: bool = False,
                 runner=None,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 max_rounds: Optional[int] = None) -> Dict[str, str]:
    """Drive the DAG to completion (for this host's share of the work).

    Each round: compute ready stages, take this host's strided share,
    claim each with a pidfile lock, run it, drop its done-marker.  Rounds
    repeat until this host finds nothing runnable (other hosts' pending
    stages are left to them).  Returns {stage_name: status}."""
    if runner is None:
        runner = run_command
    status: Dict[str, str] = {}
    rounds = 0
    while max_rounds is None or rounds < max_rounds:
        rounds += 1
        ready = ready_stages(statedir, stages)
        if not ready:
            break
        mine = hostshard.shard_units(ready, process_index, process_count)
        progressed = False

        def attempt(stages_subset):
            nonlocal progressed
            for (name, cmd, _), mark in hostshard.claim_units(
                    list(stages_subset), statedir,
                    unit_name=lambda s: s[0]):
                if dry_run:
                    print("+", cmd)
                    mark()
                    status[name] = "dry_run"
                    progressed = True
                    continue
                ret = runner(cmd)
                if ret != 0:
                    status[name] = f"failed({ret})"
                    print(f"stage {name} failed ({ret})", file=sys.stderr)
                    return False
                mark()
                status[name] = "done"
                progressed = True
            return True

        if not attempt(mine):
            return status
        if not progressed:
            # our strided share was empty or locked.  The frontier
            # shrinks as stages complete, so strided assignment over the
            # changing ready list is not stable: without stealing, a tail
            # stage can be orphaned with every host exiting successfully.
            # Steal: try to claim any unclaimed ready stage (the per-unit
            # locks arbitrate with concurrent hosts).
            others = [s for s in ready if s not in mine]
            if not attempt(others):
                return status
        if not progressed:
            # every ready stage is done or actively held by a live peer;
            # nothing left for this host
            break
    return status


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="the paper's experiment DAG")
    ap.add_argument("--dry_run", action="store_true",
                    help="mark stages done without running them")
    ap.add_argument("--statedir", default="results/experiments")
    ap.add_argument("--process_index", type=int, default=None)
    ap.add_argument("--process_count", type=int, default=None)
    args = ap.parse_args(argv)
    status = run_pipeline(args.statedir, dry_run=args.dry_run,
                          process_index=args.process_index,
                          process_count=args.process_count)
    for name, st in status.items():
        print(f"{name}: {st}")
    if any(st.startswith("failed") for st in status.values()):
        sys.exit(1)


if __name__ == "__main__":
    main()
