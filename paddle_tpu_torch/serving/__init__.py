"""Continuous-batching serving (port of paddle_tpu.serving): the engine,
its KV pools and prefix cache, the multi-tenant gateway with its SLO
policy objects and HTTP server, the run-transfer codec, the in-process
replica fleet, continuous weight refresh and the autoscaler."""
from .engine import NonFiniteLogitsError, PreemptedRun, ServingEngine
from .kv_pool import KVPoolExhaustedError, PagedKVPool
from .prefix_cache import PrefixCache
from .request import Request, RequestCancelled, Response
from .scheduler import (DeadlineExceededError, QueueFullError,
                        RequestScheduler)
from .slo import ShedPolicy, Signals, SLOTracker, TenantConfig, TokenBucket
from .gateway import (PRIORITY_HIGH, PRIORITY_LOW, GatewayServer,
                      RateLimitedError, ServingGateway, SheddedError,
                      serve_gateway)
from .fleet import (FleetRouter, RemoteReplica, Replica, ReplicaLostError,
                    ReplicaManager, RestartBackoff, SubprocessReplica)
from .transfer import (RunTransferError, decode_run, encode_run,
                       engine_config_hash, run_from_bytes, run_to_bytes)
from .refresh import FleetRefresher, WeightPublisher, latest_publish
from .autoscaler import Autoscaler
from .worker import (WIRE_VERSION, RemoteWorkerClient, StaleEpochError,
                     WeightShipError, WireFormatError, WorkerClient,
                     WorkerDiedError, build_gpt, pack_frame, unpack_frame)

__all__ = [
    "ServingEngine", "Request", "Response", "RequestScheduler",
    "QueueFullError", "DeadlineExceededError", "RequestCancelled",
    "NonFiniteLogitsError", "PreemptedRun",
    "PagedKVPool", "KVPoolExhaustedError", "PrefixCache",
    "ServingGateway", "GatewayServer", "serve_gateway", "TenantConfig",
    "TokenBucket", "ShedPolicy", "Signals", "SLOTracker",
    "RateLimitedError", "SheddedError", "PRIORITY_HIGH", "PRIORITY_LOW",
    "FleetRouter", "ReplicaManager", "Replica", "SubprocessReplica",
    "RemoteReplica", "RestartBackoff", "ReplicaLostError",
    "WorkerClient", "RemoteWorkerClient", "WorkerDiedError",
    "WireFormatError", "StaleEpochError", "WeightShipError",
    "pack_frame", "unpack_frame", "build_gpt", "WIRE_VERSION",
    "RunTransferError", "encode_run", "decode_run", "run_to_bytes",
    "run_from_bytes", "engine_config_hash",
    "WeightPublisher", "FleetRefresher", "latest_publish", "Autoscaler",
]
