"""Serving plane: durable engine snapshots, the quantized KV codec, the
in-process replica fleet and its front door.

* :class:`EngineSnapshotManager` — crash-consistent
  ``ServingEngine.snapshot()`` persistence through the checkpoint commit
  protocol, keep-last-N rotation and torn-snapshot-skipping discovery.
* :class:`ReplicaFleet` — N engine replicas behind one ``submit()``:
  pluggable routing, a crash / wedge watchdog, snapshot-restore or
  re-prefill failover with zero request loss and greedy-bit-exact
  outputs, the degradation ladder (route -> queue -> reject), streaming
  that survives failover without double emission, and disaggregated
  ``roles=["prefill", "decode", ...]`` with ``export_kv`` / ``import_kv``
  page handoffs (re-prefill fallback on :class:`KVHandoffError`).
* :mod:`.routing` + :mod:`.autoscale` — :class:`LeastLoadedRouter`,
  :class:`PrefixAffinityRouter` (shared-prefix traffic to the replica
  holding its chain) and :class:`ElasticFleet` (sentinel-driven scale up
  on queue growth / SLO burn, scale down with a zero-loss drain).
* :class:`AsyncFrontend` — the asyncio transport: bounded per-client
  token streams, cancel on disconnect, SLO-aware admission
  (:class:`AdmissionController` / :class:`TTFTPredictor`), and the live
  exporter with ``POST /generate`` as Server-Sent Events.
* :class:`ProcessFleet` — the replica boundary as an OS process: each
  worker a ``python -m paddle_tpu_torch.serving.worker`` process behind
  the loopback RPC of :mod:`.rpc` (:class:`RpcClient`, :class:`RpcServer`:
  deadlines, backoff, idempotent retries), SIGKILL / SIGSTOP failover
  from snapshots, the retire and SIGTERM drain ladders, stitched traces.
* :mod:`.traffic` — seeded, replayable scenarios (bursty / diurnal
  arrivals, shared-prefix users, abandoning clients) with engine, fleet
  and virtual-clock replays reporting goodput under an SLO.
"""
import importlib

from .quant import (KV_DTYPES, dequantize_kv, kv_spec, logit_drift,
                    page_bytes, parity_report, parity_scenarios, quantize_kv,
                    quantize_params)
from .snapshot import EngineSnapshotManager, load_engine_snapshot

# the fleet modules import inference.paged, which imports models.llama,
# which imports .quant from this package: they load on first use, so
# importing the engine never cycles back through here
_LAZY = {
    "KVHandoffError": "..inference.paged",
    "AutoscaleDecision": ".autoscale", "AutoscalePolicy": ".autoscale",
    "ElasticFleet": ".autoscale",
    "FleetFailedError": ".fleet", "ReplicaFleet": ".fleet",
    "AdmissionController": ".frontend", "AdmissionView": ".frontend",
    "AsyncFrontend": ".frontend", "AsyncStream": ".frontend",
    "SLORejected": ".frontend", "TTFTPredictor": ".frontend",
    "admission_view": ".frontend",
    "LeastLoadedRouter": ".routing", "PrefixAffinityRouter": ".routing",
    "ProcessFleet": ".procfleet", "WorkerDiedError": ".procfleet",
    "RpcClient": ".rpc", "RpcServer": ".rpc", "RpcError": ".rpc",
    "RpcTimeout": ".rpc", "RpcRemoteError": ".rpc",
    "Router": ".routing", "RoutingDecision": ".routing",
    "ClientRequest": ".traffic", "Scenario": ".traffic",
    "VirtualClock": ".traffic", "goodput_report": ".traffic",
    "make_scenario": ".traffic", "replay_engine": ".traffic",
    "replay_fleet": ".traffic", "replay_sim": ".traffic",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(mod, __name__), name)
    globals()[name] = value
    return value


__all__ = ["ReplicaFleet", "FleetFailedError", "EngineSnapshotManager",
           "load_engine_snapshot", "AsyncFrontend", "AsyncStream",
           "SLORejected", "AdmissionController", "AdmissionView",
           "TTFTPredictor", "admission_view", "ClientRequest", "Scenario",
           "make_scenario", "replay_engine", "replay_fleet", "replay_sim",
           "goodput_report", "VirtualClock", "Router", "RoutingDecision",
           "LeastLoadedRouter", "PrefixAffinityRouter", "AutoscalePolicy",
           "AutoscaleDecision", "ElasticFleet", "KV_DTYPES", "quantize_kv",
           "dequantize_kv", "kv_spec", "page_bytes", "quantize_params",
           "parity_scenarios", "logit_drift", "parity_report",
           "KVHandoffError", "ProcessFleet", "WorkerDiedError", "RpcClient",
           "RpcServer", "RpcError", "RpcTimeout", "RpcRemoteError"]
