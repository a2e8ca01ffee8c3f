"""Results that a test run computes once and every xdist worker reads.

A module- or session-scoped fixture runs once in every xdist worker that
runs one of its tests, so a costly fixture (a spawn of ranks, a set of
single-device references) would run once a worker.  ``shared`` follows
pytest-xdist's recipe instead: the first worker to ask computes the value
under a ``filelock.FileLock`` in the run's common temporary directory
(``tmp_path_factory.getbasetemp().parent``) and saves it there; every
other worker waits on the lock and loads it.  Without xdist the value is
computed in the process, as before.  The computation runs in a thread,
so the caller works on while it runs; ``.result()`` waits for it.

``share_jax_compiles`` does the same for the XLA programs that the JAX
references compile: one persistent compilation cache for the whole run.
"""
import atexit
import os
import shutil
import tempfile
from concurrent.futures import Future, ThreadPoolExecutor

import torch
from filelock import FileLock


def _load_or_compute(root, key: str, compute):
    path = root / f"shared-{key}.pt"
    with FileLock(str(path) + ".lock"):
        if path.exists():
            return torch.load(path, weights_only=False)
        out = compute()
        torch.save(out, path)
        return out


def shared(tmp_path_factory, key: str, compute) -> Future:
    """A future of ``compute()``'s value (``torch.save``-able), computed
    once a test run across the xdist workers under ``key``."""
    pool = ThreadPoolExecutor(1)
    if "PYTEST_XDIST_WORKER" not in os.environ:
        future = pool.submit(compute)
    else:
        root = tmp_path_factory.getbasetemp().parent
        future = pool.submit(_load_or_compute, root, key, compute)
    pool.shutdown(wait=False)
    return future


def share_jax_compiles() -> None:
    """Under xdist, give every worker of the run one JAX persistent
    compilation cache (a directory named after xdist's run id in the
    temporary directory), for every program however quick to compile.
    The workers compile the same small programs again and again (the
    parity tests' eager reference calls compile each JAX primitive at
    each shape, every jitted step each configuration); after the first,
    each is read back.  A program read back is the program compiled, so
    no result changes.  The last worker to exit removes the cache (every
    worker joins while it collects, before any test runs).  Without
    xdist nothing changes."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if not uid:
        return
    import jax
    from jax._src import compilation_cache
    path = os.path.join(tempfile.gettempdir(), f"repro-jax-cache-{uid}")
    _count(path, +1)
    atexit.register(_count, path, -1)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    compilation_cache.reset_cache()     # a compile before this one


def _count(path: str, step: int) -> None:
    """Add ``step`` to the count of workers using the cache at ``path``;
    the worker that takes it to 0 removes the cache."""
    users = path + ".users"
    with FileLock(path + ".lock"):
        n = step + (int(open(users).read()) if os.path.exists(users) else 0)
        with open(users, "w") as f:
            f.write(str(n))
        if n > 0:
            return
        shutil.rmtree(path, ignore_errors=True)
    for leftover in (users, path + ".lock"):
        os.remove(leftover)
