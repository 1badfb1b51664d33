"""Multi-host runtime test: 2 local processes, one jax.distributed CPU
cluster, one global mesh, one sharded train step across the process
boundary (SURVEY.md section 5 'Distributed communication backend':
dist/multihost.py must actually execute somewhere).

Each worker process (tests/_multihost_worker.py) plays one 'host' with 2
virtual CPU devices; the 4-device global mesh row-shards the image across
both processes, and the pmean gradient all-reduce crosses the coordinator-
brokered process boundary - the localhost analogue of a multi-host run.
"""
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_train_step():
    # Bounded by the workers' communicate(timeout=280) below.
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    # Isolate the workers from inherited site hooks and XLA flags; they
    # must be plain 2-device CPU processes.
    env["PYTHONPATH"] = REPO
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"

    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coordinator, "2", str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            cwd=REPO, env=env, text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=280)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:\n{out}\nstderr:\n{err}"
    losses = [
        line.split()[1]
        for rc, out, _ in outs
        for line in out.splitlines()
        if line.startswith("LOSS ")
    ]
    assert len(losses) == 2, outs
    # pmean-reduced loss must agree bit-for-bit across processes: the
    # cross-process collective really ran.
    assert losses[0] == losses[1], losses
