"""Job sharding across REAL processes, on the port's
``utils/{hostshard,pidfile}.py`` and ``metrics/experiments.py``: the
counterpart of tests/test_multiprocess.py, which holds the JAX package's.

The in-process tests (tests/test_torch_drivers.py) simulate process
identity; here real Python subprocesses share a workdir to exercise what
simulation cannot: O_EXCL lock races, stale-lock takeover of a crashed
(os._exit) or SIGKILLed worker, DAG orphan-stealing across process
boundaries, and the identity of a ``torch.distributed`` job.

Workers import only the port's ``utils`` and ``metrics.experiments`` and
synchronize on a barrier file so they genuinely contend.
"""

import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RACE_WORKER = r"""
import os, random, sys, time
sys.path.insert(0, %(repo)r)
from rewriting_torch.utils import hostshard

workdir, barrier, out = sys.argv[1], sys.argv[2], sys.argv[3]
units = [f"u{i:02d}" for i in range(12)]
# barrier: wait until every worker process is up before claiming anything
open(os.path.join(barrier, f"ready_{os.getpid()}"), "w").close()
for _ in range(2000):
    if os.path.isfile(os.path.join(barrier, "go")):
        break
    time.sleep(0.005)
random.seed(os.getpid())
completed = []
deadline = time.time() + 60
while time.time() < deadline:
    for unit, mark in hostshard.claim_units(units, workdir):
        time.sleep(random.uniform(0.02, 0.06))  # force overlap
        with open(os.path.join(workdir, unit, f"win_{os.getpid()}"),
                  "w") as f:
            f.write("x")
        mark()
        completed.append(unit)
    if all(os.path.isfile(os.path.join(workdir, u, "done.txt"))
           for u in units):
        break
    time.sleep(0.01)
with open(out, "w") as f:
    f.write(",".join(completed))
"""

CRASH_WORKER = r"""
import os, sys
sys.path.insert(0, %(repo)r)
from rewriting_torch.utils import pidfile
d = os.path.join(sys.argv[1], "u00")
os.makedirs(d, exist_ok=True)
assert pidfile.pidfile_taken(os.path.join(d, "lockfile.pid")) is None
open(os.path.join(sys.argv[1], "crashed"), "w").close()
os._exit(1)  # crash while holding the lock: skips atexit AND finally
"""

DAG_WORKER = r"""
import os, sys, time
sys.path.insert(0, %(repo)r)
from rewriting_torch.metrics import experiments

statedir, mode = sys.argv[1], sys.argv[2]
if mode == "slow":
    # claims stage 'a' then hangs inside the runner (to be SIGKILLed)
    stages = [("a", "slow_a", ())]

    def runner(cmd):
        open(os.path.join(statedir, "a_started"), "w").close()
        time.sleep(120)
        return 0
    experiments.run_pipeline(statedir, stages=stages, runner=runner)
else:
    stages = [("a", "cmd_a", ()), ("b", "cmd_b", ("a",)),
              ("c", "cmd_c", ("b",))]

    def runner(cmd):
        open(os.path.join(statedir, f"ran_{cmd}_{os.getpid()}"),
             "w").close()
        return 0
    deadline = time.time() + 60
    while time.time() < deadline:
        experiments.run_pipeline(statedir, stages=stages, runner=runner)
        if all(os.path.isfile(os.path.join(statedir, s, "done.txt"))
               for s in ("a", "b", "c")):
            break
        time.sleep(0.05)
"""


def _spawn(code, *args):
    return subprocess.Popen([sys.executable, "-c", code, *args],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.STDOUT)


def _wait_for(path, timeout=150.0, desc=""):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if os.path.exists(path):
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {path} {desc}")


def test_mp_process_identity_no_device_init(tmp_path):
    """process_identity in two real processes of a torch.distributed job
    (gloo, a file store) returns the job's identity, not the (0, 1)
    fallback, at once, and touches no device."""
    code = r"""
import sys, time
sys.path.insert(0, %(repo)r)
import torch
import torch.distributed as dist
dist.init_process_group("gloo", init_method="file://" + sys.argv[1],
                        rank=int(sys.argv[2]), world_size=2)
t0 = time.time()
from rewriting_torch.utils import hostshard
i, n = hostshard.process_identity()
assert not torch.cuda.is_initialized(), "identity initialized CUDA"
print("IDENTITY", i, n, round(time.time() - t0, 3))
dist.barrier()
dist.destroy_process_group()
""" % {"repo": REPO}
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", code, store, str(rank)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in (0, 1)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out
        outs.append(out)
    idents = set()
    for out in outs:
        line = [ln for ln in out.splitlines()
                if ln.startswith("IDENTITY")][0].split()
        idents.add((line[1], line[2]))
        assert float(line[3]) < 5.0, line
    assert idents == {("0", "2"), ("1", "2")}, idents


def test_mp_claim_units_each_unit_exactly_once(tmp_path):
    """3 real processes race over 12 units with pidfile locks: every unit
    completes exactly once (O_EXCL arbitration), and the work is actually
    split across processes."""
    workdir = str(tmp_path / "work")
    barrier = str(tmp_path / "barrier")
    os.makedirs(workdir)
    os.makedirs(barrier)
    outs = [str(tmp_path / f"out{i}") for i in range(3)]
    code = RACE_WORKER % {"repo": REPO}
    procs = [_spawn(code, workdir, barrier, o) for o in outs]
    try:
        deadline = time.time() + 60
        while time.time() < deadline and len(
                [f for f in os.listdir(barrier)
                 if f.startswith("ready_")]) < 3:
            time.sleep(0.02)
        open(os.path.join(barrier, "go"), "w").close()
        for p in procs:
            assert p.wait(timeout=240) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    units = [f"u{i:02d}" for i in range(12)]
    winners = {}
    for u in units:
        d = os.path.join(workdir, u)
        assert os.path.isfile(os.path.join(d, "done.txt")), u
        wins = [f for f in os.listdir(d) if f.startswith("win_")]
        assert len(wins) == 1, (u, wins)  # exactly one process did it
        winners[u] = wins[0]
    by_proc = {}
    for o in outs:
        with open(o) as f:
            done = [u for u in f.read().split(",") if u]
        for u in done:
            by_proc.setdefault(u, []).append(o)
    # the per-process completion reports agree and partition the units
    assert sorted(by_proc) == units
    assert all(len(v) == 1 for v in by_proc.values())
    # with the barrier + per-unit sleep, >=2 processes must have won work
    assert len(set(winners.values())) >= 2, winners


def test_mp_stale_lock_of_crashed_worker_is_stolen(tmp_path):
    """A worker that dies (os._exit — no atexit, no finally) while holding
    a unit lock leaves a stale pidfile; a later worker on the same host
    detects the dead pid and takes the unit over (reference
    pidfile.py:39-63 stale-takeover semantics)."""
    workdir = str(tmp_path / "work")
    barrier = str(tmp_path / "barrier")
    os.makedirs(workdir)
    os.makedirs(barrier)
    crash = _spawn(CRASH_WORKER % {"repo": REPO}, workdir)
    assert crash.wait(timeout=180) == 1
    lock = os.path.join(workdir, "u00", "lockfile.pid")
    assert os.path.isfile(lock)  # the stale lock survived the crash
    open(os.path.join(barrier, "go"), "w").close()  # no gating needed
    out = str(tmp_path / "out")
    worker = _spawn(RACE_WORKER % {"repo": REPO}, workdir, barrier, out)
    assert worker.wait(timeout=240) == 0
    for i in range(12):
        assert os.path.isfile(
            os.path.join(workdir, f"u{i:02d}", "done.txt")), i
    wins = [f for f in os.listdir(os.path.join(workdir, "u00"))
            if f.startswith("win_")]
    assert wins == [f"win_{worker.pid}"], wins  # stolen and completed


def test_mp_dag_stage_of_killed_worker_is_stolen(tmp_path):
    """DAG orphan-stealing across real process boundaries: worker A claims
    stage 'a' and is SIGKILLed mid-run; worker B detects the dead-pid lock,
    steals the stage, and drives the whole DAG (a -> b -> c) to done."""
    statedir = str(tmp_path / "state")
    os.makedirs(statedir)
    code = DAG_WORKER % {"repo": REPO}
    slow = _spawn(code, statedir, "slow")
    try:
        _wait_for(os.path.join(statedir, "a_started"), timeout=150,
                  desc="(slow worker claiming stage a)")
        lock = os.path.join(statedir, "a", "lockfile.pid")
        assert os.path.isfile(lock)
        slow.send_signal(signal.SIGKILL)
        slow.wait(timeout=120)
        assert os.path.isfile(lock)  # SIGKILL leaves the lock behind
        fast = _spawn(code, statedir, "fast")
        assert fast.wait(timeout=240) == 0
    finally:
        if slow.poll() is None:
            slow.kill()
    for s in ("a", "b", "c"):
        assert os.path.isfile(os.path.join(statedir, s, "done.txt")), s
    ran = sorted(f for f in os.listdir(statedir) if f.startswith("ran_"))
    assert len(ran) == 3 and all(
        any(f.startswith(f"ran_cmd_{s}_") for f in ran)
        for s in ("a", "b", "c")), ran
