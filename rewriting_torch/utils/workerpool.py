"""Worker pool for I/O-heavy side work (image saving).

The port's copy of the JAX package's ``utils/workerpool.py``: a pool of
workers drains a task queue so the thread that drives the device never
blocks on disk; ``join`` flushes and stops.

The default workers are threads, not processes: the work is file I/O and
zlib, which releases the GIL, so threads give the parallelism without
forking a process that holds a CUDA context.  Pass
``start_method='fork'|'spawn'|'forkserver'`` for CPU-bound pure-Python work
that needs real processes.
"""

from __future__ import annotations

import atexit
import os
import queue as _queue
import threading


def default_nworkers(cap: int = 4) -> int:
    """Worker count for the save pools: `cap`, lowered by the environment
    variable ``REWRITING_TPU_SAVE_WORKERS`` (which the test suite sets to
    the host's core count)."""
    env = os.environ.get("REWRITING_TPU_SAVE_WORKERS")
    if env:
        return max(1, min(cap, int(env)))
    return max(1, cap)


class WorkerBase:
    """Subclass and override work(*args); optionally setup()/finish()."""

    def __init__(self):
        self.setup()

    def setup(self):
        pass

    def work(self, *args, **kwargs):  # pragma: no cover - abstract
        raise NotImplementedError

    def finish(self):
        pass


def _drain(worker, q):
    while True:
        task = q.get()
        if task is None:
            break
        args, kwargs = task
        try:
            worker.work(*args, **kwargs)
        except Exception:
            import traceback
            traceback.print_exc()
    worker.finish()


def _process_main(worker_cls, init_args, q):  # pragma: no cover
    import signal
    signal.signal(signal.SIGINT, signal.SIG_IGN)  # parent handles ctrl-C
    _drain(worker_cls(*init_args), q)


class WorkerPool:
    def __init__(self, worker=WorkerBase, nworkers=None,
                 maxqueue: int = 64, init_args=(),
                 start_method: str = "thread"):
        if nworkers is None:
            nworkers = default_nworkers(4)
        self._closed = False
        if start_method == "thread":
            self.queue = _queue.Queue(maxsize=maxqueue)
            self.procs = [
                threading.Thread(target=_drain,
                                 args=(worker(*init_args), self.queue),
                                 daemon=True)
                for _ in range(nworkers)]
        else:
            import multiprocessing as mp
            ctx = mp.get_context(start_method)
            self.queue = ctx.Queue(maxsize=maxqueue)
            self.procs = [
                ctx.Process(target=_process_main,
                            args=(worker, init_args, self.queue),
                            daemon=True)
                for _ in range(nworkers)]
        for p in self.procs:
            p.start()
        atexit.register(self.close)

    def add(self, *args, **kwargs):
        assert not self._closed, "pool already joined"
        self.queue.put((args, kwargs))

    def join(self):
        """Flush the queue and stop all workers."""
        if self._closed:
            return
        for _ in self.procs:
            self.queue.put(None)
        for p in self.procs:
            p.join()
        self._closed = True

    def close(self):
        if not self._closed:
            try:
                self.join()
            except Exception:
                for p in self.procs:
                    if hasattr(p, "terminate") and p.is_alive():
                        p.terminate()
                self._closed = True
