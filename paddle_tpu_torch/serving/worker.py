"""Worker process entrypoint for the cross-process fleet.

Port of ``paddle_tpu/serving/worker.py``.  ``python -m
paddle_tpu_torch.serving.worker --name r0 --spec spec.json --portfile
/tmp/r0.port [--snapshot-root DIR --snapshot-every N]`` hosts one full
:class:`~paddle_tpu_torch.inference.paged.ServingEngine` behind the
length-prefixed loopback RPC of :mod:`paddle_tpu_torch.serving.rpc` and
speaks the fleet wire protocol:

=============  ============================================================
``hello``      identity + boot-restore report: pid, restored snapshot
               path/mode, the live rids the restore reinstated, the
               post-restore ``check_invariants()`` verdict (the supervisor
               files it as the final report of a generation that died
               mid-drill and can no longer answer), and the seconds of
               each boot stage (``boot_s``); it fails when the worker
               could not load its attention kernels on the card
``submit``     queue one request -> rid
``adopt``      queue with already-emitted tokens (migration re-prefill
               path; also the supervisor's unified placement primitive)
``poll``       incremental token stream: ``{rid: have_n}`` -> new tokens
               past ``have_n`` per rid + finished/timed-out flags — the
               supervisor's record only ever EXTENDS, so a retried poll
               (idempotency cache) can never double-stream a token
``cancel``     drop a request wherever it lives (KV parks in prefix cache)
``health``     heartbeat seq + step count + load + engine ``stats()`` +
               live invariants verdict (PagePool refcounts / page tables /
               cache accounting), every call — the leak guard's wire
``snapshot``   force one crash-consistent EngineSnapshotManager snapshot
``drain``      stop admitting, cancel all live work (zero-loss ladder:
               the supervisor has already adopted the streams elsewhere)
``trace``      the engine Tracer in wire form (stitched cross-process
               spans; worker telemetry runs on ``time.time`` so the
               supervisor's clock domain matches)
``stats``      engine ``stats()``, and under ``"kernels"`` this process's
               ragged paged-attention launch counters and the plain
               version's call count (:func:`kernel_counts`): the only way
               a supervisor sees which attention its workers ran
``stop``       final teardown report (release_cache + check_invariants),
               then process exit 0
=============  ============================================================

Determinism: the spec names the model's weights (:func:`build_from_spec`):
an npz of numpy arrays (:func:`save_weights_npz`), or the port's seeded
initialiser — the same bytes in every worker and in a supervisor-side
reference build, which is what makes the SIGKILL failover drill's
bit-equality bar meaningful.  (The JAX worker rebuilds its params from a
``jax.random`` key, which the port does not re-derive.)  A crash inside
``engine.step()`` exits the process non-zero: the supervisor observes a
real death, not an exception.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
import traceback

__all__ = ["build_from_spec", "main", "WORKER_CRASH_EXIT", "kernel_counts",
           "save_weights_npz", "load_weights_npz"]

WORKER_CRASH_EXIT = 13      # engine.step raised: distinguishable from OOM-kill

_TREES = ("embed", "block", "head")


def save_weights_npz(params, path: str) -> str:
    """Write ``(embed, block, head)`` dicts of tensors or numpy arrays to an
    uncompressed npz at ``path``, one array per leaf under
    ``"<tree>/<leaf>"``; a bf16 tensor travels as its uint16 bits (numpy
    has no bfloat16), any other leaf as its own numpy dtype.  Leaves are
    written one at a time (as ``np.savez`` lays them out), so the host
    never holds the whole model."""
    import zipfile

    import numpy as np
    import torch

    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for tree, leaves in zip(_TREES, params):
            for k, v in leaves.items():
                if isinstance(v, torch.Tensor):
                    v = v.detach()
                    v = (v.view(torch.int16).cpu().numpy().view(np.uint16)
                         if v.dtype == torch.bfloat16 else v.cpu().numpy())
                with zf.open(f"{tree}/{k}.npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, np.asarray(v),
                                              allow_pickle=False)
    return path


def _npz_members(path: str):
    """``(name, array)`` of every member of the npz at ``path``.  A stored
    (uncompressed) member, as :func:`save_weights_npz` writes them, is a
    read-only ``np.memmap`` of its bytes in the file: nothing is copied on
    the host before the upload (``np.load`` reads a member through the zip
    stream, several host copies of it, which at 7B widths cost a worker
    tens of seconds).  A compressed member is read by ``np.load``."""
    import zipfile

    import numpy as np

    with zipfile.ZipFile(path) as zf, open(path, "rb") as raw:
        infos = zf.infolist()
        for info in infos:
            name = info.filename.removesuffix(".npy")
            if info.compress_type != zipfile.ZIP_STORED:
                with np.load(path) as z:
                    yield name, z[name]
                continue
            raw.seek(info.header_offset + 26)
            n_name, n_extra = np.frombuffer(raw.read(4), "<u2")
            raw.seek(info.header_offset + 30 + int(n_name) + int(n_extra))
            version = np.lib.format.read_magic(raw)
            read_header = np.lib.format.read_array_header_1_0 \
                if version == (1, 0) else np.lib.format.read_array_header_2_0
            shape, fortran, dtype = read_header(raw)
            yield name, np.memmap(path, dtype=dtype, mode="r",
                                  offset=raw.tell(), shape=shape,
                                  order="F" if fortran else "C")


def load_weights_npz(path: str, device, dtype):
    """``(embed, block, head)`` from :func:`save_weights_npz`'s file on
    ``device`` in ``dtype``: uint16 arrays are bf16 bits (taken bit for bit
    into a bf16 tensor, then cast), every other array goes through
    ``models/convert.py params_from_numpy``.  Leaves are read one at a
    time, each straight from the file's pages (:func:`_npz_members`), so
    the host never holds the whole model."""
    import warnings

    import numpy as np
    import torch

    from ..models.convert import params_from_numpy

    trees = tuple({} for _ in _TREES)
    for key, a in _npz_members(path):
        tree, leaf = key.split("/", 1)
        dst = trees[_TREES.index(tree)]
        if a.dtype == np.uint16:
            with warnings.catch_warnings():
                # a read-only map: torch warns that it does not copy it,
                # and it only reads it, into the device copy
                warnings.simplefilter("ignore", UserWarning)
                host = torch.from_numpy(a.view(np.int16))
            # a copy even on the CPU: nothing keeps the file's map
            dst[leaf] = host.view(torch.bfloat16).to(
                device=device, dtype=dtype, copy=True)
        else:
            dst[leaf] = params_from_numpy(
                {leaf: a}, {}, {}, device=device, dtype=dtype)[0][leaf]
        del a
    return trees


def build_from_spec(spec: dict):
    """(params, cfg, engine_kwargs, device) from a fleet worker spec —
    shared by worker processes and supervisor-side reference builds so
    both sides hold bit-identical weights.  The spec names ``"device"``
    (``None``: the card, raising without one; the CPU tests pass
    ``"cpu"``), ``"model": {"config", "dtype", "weights"}`` with
    ``weights`` either ``{"npz": path}`` (:func:`load_weights_npz`) or
    ``{"init_seed": k}`` (``init_llama_params(..., seed=k)``), and
    ``"engine"`` (the ServingEngine's keyword arguments; a ``"dtype"``
    there is a torch dtype's name)."""
    import torch

    from .. import resolve_device
    from ..models.llama import LlamaConfig, init_llama_params

    model = spec["model"]
    device = resolve_device(spec.get("device"))
    cfg = LlamaConfig(**model["config"])
    dtype = getattr(torch, model.get("dtype") or "float32")
    weights = model["weights"]
    if "npz" in weights:
        params = load_weights_npz(weights["npz"], device, dtype)
    else:
        params = init_llama_params(cfg, dtype=dtype, device=device,
                                   seed=int(weights["init_seed"]))
    engine_kw = dict(spec.get("engine", {}))
    if isinstance(engine_kw.get("dtype"), str):
        engine_kw["dtype"] = getattr(torch, engine_kw["dtype"])
    return params, cfg, engine_kw, device


def warm_up(engine, requests, vocab: int) -> None:
    """Serve ``requests`` (``[prompt tokens, new tokens]`` pairs) of seeded
    random tokens to completion: on the card the decode horizons' CUDA
    graphs are captured before the worker says hello, so its first real
    requests do not pay for them."""
    import numpy as np
    r = np.random.default_rng(0)
    for n, m in requests:
        engine.submit(r.integers(1, vocab, int(n)).astype(np.int32),
                      max_new_tokens=int(m))
    engine.run()


def kernel_counts() -> dict:
    """This process's ragged paged-attention counters: row 1 and row 2
    launches, split merges, and the plain version's calls."""
    from ..ops import paged_attention as pa
    return {"launches": int(pa.ragged_paged_attention.launches),
            "quant_launches": int(pa.ragged_paged_attention.quant_launches),
            "combine_launches":
                int(pa.ragged_paged_attention.combine_launches),
            "plain_calls": int(pa.ragged_paged_attention_ref.calls)}


def load_kernels(cfg, engine_kw: dict, device) -> None:
    """On the card, load the ragged paged-attention library the engine
    will launch (row 2's for a quantized KV store, row 1's otherwise, at
    the model's head width) before serving: a worker that cannot load its
    kernel fails its ``hello`` instead of serving on anything else.
    Nothing on the CPU, where the wrapper runs the plain version."""
    if device.type != "cuda":
        return
    from ..ops import _build
    from ..ops.paged_attention import head_width
    d = cfg.hidden_size // cfg.num_attention_heads
    width = head_width(d)
    if width is None:
        raise RuntimeError(f"head dim {d}: no ragged paged-attention kernel")
    names = {"ragged_paged_attention"}
    if engine_kw.get("kv_dtype"):
        names.add("ragged_paged_attention_quant")
    for name in sorted(names):
        _build.library(_build.width_library(name, width))


class _FifoLock:
    """A reentrant lock granted in the order it was asked for.  The serve
    loop takes the engine's lock again the moment a step ends; a plain
    ``threading.RLock`` goes to whichever thread asks first after a
    release, so on the card (a 7B horizon holds it for ~0.1 s) the RPC
    handlers waiting for it starved until the engine ran dry: a ``poll``
    came back only once every request had finished.  With this lock each
    waiting call is served after at most one step."""

    def __init__(self):
        self._cv = threading.Condition(threading.Lock())
        self._next = 0          # the next ticket to hand out
        self._serving = 0       # the ticket that holds the lock
        self._owner = None
        self._depth = 0

    def __enter__(self):
        me = threading.get_ident()
        with self._cv:
            if self._owner == me:
                self._depth += 1
                return self
            ticket = self._next
            self._next += 1
            while self._serving != ticket:
                self._cv.wait()
            self._owner, self._depth = me, 1
        return self

    def __exit__(self, *exc):
        with self._cv:
            self._depth -= 1
            if self._depth == 0:
                self._owner = None
                self._serving += 1
                self._cv.notify_all()


class _WorkerHost:
    """The handler + serve loop around one engine."""

    def __init__(self, name: str, engine, snapshots=None,
                 snapshot_every: int = 0, snapshot_mode: str = "full_kv"):
        self.name = name
        self.engine = engine
        self.snapshots = snapshots
        self.snapshot_every = int(snapshot_every)
        self.snapshot_mode = snapshot_mode
        self.lock = _FifoLock()
        self.stop_event = threading.Event()
        self.draining = False
        self.hb = 0
        self.steps = 0
        self.restored = None          # (path, mode) | None
        self.restored_rids: list[int] = []
        self.restore_invariants_ok = True
        self.restore_error = ""
        self.kernel_error = ""        # the card's kernels failed to load
        self.boot_s: dict = {}        # seconds of each boot stage
        self.final_report: dict | None = None

    # -- engine helpers ----------------------------------------------------
    def _live_rids(self) -> list[int]:
        eng = self.engine
        rids = [r.rid for r in eng._queue]
        rids += [sl.req.rid for sl in eng._slots if sl is not None]
        rids += list(eng._finished)
        return sorted(int(r) for r in set(rids))

    def _invariants(self) -> tuple[bool, str]:
        try:
            self.engine.check_invariants()
            return True, ""
        except AssertionError as e:
            return False, str(e)

    def boot_restore(self):
        if self.snapshots is None:
            return
        with self.lock:
            got = self.snapshots.restore_engine(self.engine)
            if got is not None:
                self.restored = (str(got[0]), got[1])
                self.restored_rids = self._live_rids()
            ok, err = self._invariants()
            self.restore_invariants_ok = ok
            self.restore_error = err

    def _maybe_snapshot(self):
        if self.snapshots is None or self.snapshot_every <= 0:
            return
        if self.steps % self.snapshot_every:
            return
        try:
            self.snapshots.save_engine(self.engine, mode=self.snapshot_mode)
        except Exception:
            # durability is best-effort from inside the worker; a failed
            # snapshot must not take down live decode
            traceback.print_exc()

    # the serve thread owns the engine and the hb counter behind self.lock;
    # the RPC handler threads only touch them under the same lock
    def serve_loop(self):
        eng = self.engine
        while not self.stop_event.is_set():
            did = False
            with self.lock:
                self.hb += 1
                if eng._queue or eng.num_active or eng._inflight is not None:
                    try:
                        eng.step()
                    except BaseException:
                        traceback.print_exc()
                        os._exit(WORKER_CRASH_EXIT)
                    self.steps += 1
                    did = True
                    self._maybe_snapshot()
            if not did:
                self.stop_event.wait(0.002)

    # -- RPC handler -------------------------------------------------------
    def handle(self, method: str, p: dict):
        import numpy as np
        eng = self.engine
        if method == "hello":
            if self.kernel_error:
                raise RuntimeError(f"kernels not loaded: {self.kernel_error}")
            return {"name": self.name, "pid": os.getpid(),
                    "restored": self.restored is not None,
                    "restored_path": None if self.restored is None
                    else self.restored[0],
                    "restored_mode": None if self.restored is None
                    else self.restored[1],
                    "restored_rids": self.restored_rids,
                    "restore_invariants_ok": self.restore_invariants_ok,
                    "restore_error": self.restore_error,
                    "boot_s": self.boot_s}
        if method == "submit":
            if self.draining:
                raise RuntimeError("worker draining: admission closed")
            with self.lock:
                return int(eng.submit(
                    np.asarray(p["prompt"], np.int32),
                    max_new_tokens=int(p.get("max_new_tokens", 32)),
                    temperature=float(p.get("temperature", 0.0)),
                    top_p=float(p.get("top_p", 1.0)),
                    eos_token_id=p.get("eos_token_id"),
                    timeout=p.get("timeout"),
                    trace_id=p.get("trace_id")))
        if method == "adopt":
            if self.draining:
                raise RuntimeError("worker draining: admission closed")
            with self.lock:
                return int(eng.adopt(
                    np.asarray(p["prompt"], np.int32),
                    generated=tuple(int(t) for t in p.get("generated", ())),
                    max_new_tokens=int(p.get("max_new_tokens", 32)),
                    temperature=float(p.get("temperature", 0.0)),
                    top_p=float(p.get("top_p", 1.0)),
                    eos_token_id=p.get("eos_token_id"),
                    deadline=p.get("deadline"),
                    trace_id=p.get("trace_id")))
        if method == "poll":
            out = {}
            with self.lock:
                for rid_s, have in (p.get("have") or {}).items():
                    r = eng.lookup(int(rid_s))
                    if r is None:
                        out[rid_s] = None
                        continue
                    gen = r.generated
                    out[rid_s] = {
                        "new": [int(t) for t in gen[int(have):]],
                        "done": r.finish_time > 0.0,
                        "timed_out": bool(r.timed_out),
                        "n": len(gen)}
                load = {"active": int(eng.num_active),
                        "queued": len(eng._queue)}
            return {"rids": out, "hb": self.hb, "load": load}
        if method == "cancel":
            with self.lock:
                return bool(eng.cancel(int(p["rid"])))
        if method == "health":
            with self.lock:
                ok, err = self._invariants()
                return {"hb": self.hb, "steps": self.steps,
                        "pid": os.getpid(),
                        "load": {"active": int(eng.num_active),
                                 "queued": len(eng._queue)},
                        "draining": self.draining,
                        "invariants_ok": ok, "invariants_error": err,
                        "stats": {k: (float(v) if isinstance(v, float)
                                      else int(v))
                                  for k, v in eng.stats().items()
                                  if isinstance(v, (int, float))}}
        if method == "snapshot":
            if self.snapshots is None:
                raise RuntimeError("worker has no snapshot root")
            with self.lock:
                path = self.snapshots.save_engine(
                    eng, mode=p.get("mode") or self.snapshot_mode)
            return {"path": str(path)}
        if method == "drain":
            with self.lock:
                self.draining = True
                live = [r for r in self._live_rids()
                        if r not in eng._finished]
                for rid in live:
                    eng.cancel(rid)
                ok, err = self._invariants()
            return {"cancelled": live, "invariants_ok": ok,
                    "invariants_error": err}
        if method == "trace":
            from ..observability.tracing import tracer_to_wire
            with self.lock:
                if eng.telemetry is None:
                    return {"requests": [], "engine": [], "counters": []}
                return tracer_to_wire(eng.telemetry.tracer)
        if method == "stats":
            with self.lock:
                out = {k: (v if isinstance(v, (int, float, str, bool))
                           else str(v)) for k, v in eng.stats().items()}
                out["kernels"] = kernel_counts()
                return out
        if method == "stop":
            with self.lock:
                self.draining = True
                try:
                    eng.release_cache()
                except Exception as e:   # release must not mask the report
                    return self._finalize(False, f"release_cache: {e}")
                ok, err = self._invariants()
            return self._finalize(ok, err)
        raise RuntimeError(f"unknown rpc method {method!r}")

    def _finalize(self, ok: bool, err: str) -> dict:
        self.final_report = {"invariants_ok": bool(ok),
                             "invariants_error": err, "name": self.name}
        self.stop_event.set()
        return self.final_report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="paddle_tpu_torch.serving.worker")
    ap.add_argument("--name", required=True)
    ap.add_argument("--spec", required=True,
                    help="JSON file: {device, model, engine, warmup, "
                         "snapshot}")
    ap.add_argument("--portfile", required=True,
                    help="written atomically with the bound port")
    ap.add_argument("--port", type=int, default=0,
                    help="bind this port (0 = ephemeral); the supervisor "
                         "pre-assigns via the launcher's _free_port")
    ap.add_argument("--snapshot-root", default=None)
    ap.add_argument("--snapshot-every", type=int, default=0)
    ap.add_argument("--snapshot-mode", default="full_kv")
    args = ap.parse_args(argv)

    with open(args.spec) as f:
        spec = json.load(f)

    # seconds of each boot stage, reported in hello (``boot_s``)
    boot, t_lap = {}, [time.perf_counter()]

    def lap(stage):
        now = time.perf_counter()
        boot[stage] = round(now - t_lap[0], 3)
        t_lap[0] = now

    # Heavy imports AFTER argparse so --help stays fast.
    import torch

    from .. import resolve_device
    from ..inference.paged import ServingEngine
    from ..observability.telemetry import Telemetry
    from .rpc import RpcServer
    from .snapshot import EngineSnapshotManager
    lap("imports")
    if resolve_device(spec.get("device")).type == "cuda":
        torch.zeros(1, device=resolve_device(spec.get("device")))
        lap("cuda_context")
    params, cfg, engine_kw, device = build_from_spec(spec)
    lap("weights")
    kernel_error = ""
    try:
        load_kernels(cfg, engine_kw, device)
    except Exception as e:   # reported through hello, never served around
        kernel_error = f"{type(e).__name__}: {e}"
        traceback.print_exc()
    lap("kernels")
    # One clock domain fleet-wide: the supervisor stitches worker spans
    # with its own, so both must stamp wall-clock time.time.
    telemetry = Telemetry(clock=time.time)
    engine = ServingEngine(params, cfg, telemetry=telemetry, device=device,
                           **engine_kw)
    del params
    lap("engine")

    snaps = None
    if args.snapshot_root:
        os.makedirs(args.snapshot_root, exist_ok=True)
        snaps = EngineSnapshotManager(
            args.snapshot_root,
            keep_last=int(spec.get("snapshot", {}).get("keep_last", 2)))
    host = _WorkerHost(args.name, engine, snapshots=snaps,
                       snapshot_every=args.snapshot_every,
                       snapshot_mode=args.snapshot_mode)
    host.kernel_error = kernel_error
    if not kernel_error:
        host.boot_restore()
        # a replacement that restored live requests warms up on them
        if host.restored is None and spec.get("warmup"):
            warm_up(engine, spec["warmup"], cfg.vocab_size)
            lap("warmup")
    host.boot_s = boot

    server = RpcServer(host.handle, port=args.port).start()
    tmp = args.portfile + ".tmp"
    with open(tmp, "w") as f:
        f.write(f"{server.port}\n")
    os.replace(tmp, args.portfile)

    signal.signal(signal.SIGTERM, lambda *_: host.stop_event.set())

    loop = threading.Thread(target=host.serve_loop, name="serve-loop",
                            daemon=True)
    loop.start()
    host.stop_event.wait()
    # Grace so the in-flight `stop` reply flushes before the listener dies.
    time.sleep(0.2)
    server.stop()
    loop.join(timeout=2.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
