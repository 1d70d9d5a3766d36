"""Helpers of the port's multi-process tests: a gang of rank processes
started through the port's launcher on the CPU (gloo), each rank writing
its results as JSON, which the test module's fixture reads once."""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "tests", "torch_launch_scripts")


def scrubbed_env():
    """The rank processes' environment: no accelerator or JAX settings, one
    CPU thread a rank (the models are tiny and the ranks share the cores),
    the repo on the path (as ``tests/test_launch_multiprocess.py``'s
    ``_scrubbed_env``)."""
    env = dict(os.environ)
    for k in list(env):
        if k.startswith(("TPU_", "LIBTPU", "PJRT_", "JAX_", "XLA_", "PADDLE_",
                         "CUDA_")):
            env.pop(k)
    env["OMP_NUM_THREADS"] = "1"
    env["MKL_NUM_THREADS"] = "1"
    env["FLAGS_comm_timeout_seconds"] = "120"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def launch_cli(script, args=(), nproc=2, log_dir=None, extra=(),
               timeout=300):
    """``python -m paddle_tpu_torch.distributed.launch`` on ``script``."""
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           f"--nproc_per_node={nproc}", *extra]
    if log_dir:
        cmd.append(f"--log_dir={log_dir}")
    cmd += [str(script), *map(str, args)]
    return subprocess.run(cmd, env=scrubbed_env(), cwd=REPO,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=timeout)


def run_gang(script, out_dir, nproc=2, args=()):
    """One gang of ``nproc`` ranks running ``tests/torch_launch_scripts/
    <script>`` through the launcher's ``launch_gang`` (in this process: the
    launcher's CLI costs a second torch import); rank r writes
    ``out_dir/rank{r}.json``.  Returns the ranks' results, in rank order;
    a failed gang raises with every rank's log."""
    return start_gang(script, out_dir, nproc, args)()


def start_gang(script, out_dir, nproc=2, args=()):
    """:func:`run_gang` on a thread, so the caller computes its JAX oracle
    while the ranks run; returns the function that waits for the gang and
    gives (or raises) what ``run_gang`` does."""
    import threading
    from paddle_tpu_torch.distributed.launch import launch_gang
    log_dir = os.path.join(out_dir, "logs")
    cmd = [sys.executable, "-u", os.path.join(SCRIPTS, script), out_dir,
           *map(str, args)]
    box = {}

    def run():
        box["rc"] = launch_gang(cmd, nproc=nproc, env=scrubbed_env(),
                                log_dir=log_dir)
    th = threading.Thread(target=run, daemon=True)
    th.start()

    def wait():
        th.join(timeout=600)
        assert not th.is_alive(), f"gang {script} still running after 600 s"
        return _results(script, out_dir, nproc, box.get("rc"))
    return wait


def _results(script, out_dir, nproc, rc):
    log_dir = os.path.join(out_dir, "logs")
    logs = ""
    for r in range(nproc):
        p = os.path.join(log_dir, f"workerlog.{r}")
        if os.path.exists(p):
            logs += f"--- rank {r}\n" + open(p).read()
    if rc != 0:
        raise AssertionError(f"gang {script} failed rc={rc}:\n{logs}")
    out = []
    for r in range(nproc):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out
